"""Data layer (host-side numpy): datasets, images, point clouds, COLMAP
and Mip-NeRF 360 preparation, gaussian PLY export. Counterpart of
``gsplat_tpu/data``; tensors reach the device in ``fit()`` or through
``GaussianDataset.device_batches``."""

from .dataset import GaussianDataset, load_camera_parameters  # noqa: F401
from .images import load_image  # noqa: F401
from .pointcloud import load_point_cloud, read_ply, write_ply  # noqa: F401
