"""Training dataset: images, camera poses and intrinsics.

Counterpart of ``gsplat_tpu/data/dataset.py``: ``prefetch`` (``:31-86``),
``load_camera_parameters``, ``GaussianDataset`` (``:94``) with its holdout
split, ``batches`` (``:206``), ``device_batches`` (``:242``),
``size_bytes``, ``prefetched_batches`` and ``pointcloud_path``. The
on-disk layout:

    data_dir/
      images/          *.jpg / *.png / *.npy
      cam_meta.npy     dict: fx, fy [, cx, cy, height, width, c2w]
      poses.npy        [N, 4, 4] camera-to-world (optional; falls back to
                       cam_meta['c2w'], then identity)
      pointcloud.ply   initialization cloud (fit() loads it)

Views load as host numpy and are standardized to the first view's (H, W).
``batches()`` yields numpy batches; ``device_batches()`` keeps every view
on one device as a tensor and gathers each batch there. Shuffling is
numpy's ``default_rng(seed)``, so the port yields the JAX package's view
order.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np
import torch

from .images import list_images, load_image, resize_image


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run any (endless or finite) iterator in a daemon thread with a
    bounded queue; exceptions propagate to the consumer.

    The worker never blocks without a timeout on ``q.put``: consumers like
    fit() abandon the generator after N steps, and a daemon thread parked
    for good in ``q.put`` can hit CPython 3.12's fatal abort when it wakes
    during interpreter finalization. Closing or collecting the generator
    stops the worker within about 0.1 s."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    _END = object()
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded-queue put that gives up once the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not _put(item):
                    return
        except BaseException as e:  # surface in the consumer thread
            _put(("__prefetch_error__", e))
        _put(_END)

    threading.Thread(target=worker, daemon=True).start()

    def gen():
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if (
                    isinstance(item, tuple)
                    and len(item) == 2
                    and item[0] == "__prefetch_error__"
                ):
                    raise item[1]
                yield item
        finally:
            stop.set()  # abandoning the generator releases the worker

    return gen()


def load_camera_parameters(cam_meta_path: str) -> dict:
    """Load the cam_meta.npy dict."""
    return np.load(cam_meta_path, allow_pickle=True).item()


class GaussianDataset:
    """Posed multi-view image dataset with lazily cached, rescaled views."""

    def __init__(
        self,
        data_dir: str,
        image_dir: str = "images",
        cam_meta_path: str | None = None,
        scale_factor: float = 0.5,
        cache: bool = True,
        holdout_every: int = 0,
        split: str = "all",
    ):
        """Args (beyond the obvious):
            holdout_every: standard llffhold protocol — every Nth view is
                held out for evaluation (8 in the 3DGS papers; 0 disables).
            split: 'all' | 'train' (views NOT held out) | 'test' (held-out
                views only). Requires holdout_every > 0 for train/test.
        """
        self.data_dir = data_dir
        self.image_paths = list_images(os.path.join(data_dir, image_dir))
        if not self.image_paths:
            raise ValueError(f"no images under {data_dir}/{image_dir}")
        self.scale_factor = float(scale_factor)
        if cam_meta_path is None:
            cam_meta_path = os.path.join(data_dir, "cam_meta.npy")
        self.cam_params = load_camera_parameters(cam_meta_path)
        self.c2w = self._load_poses()

        if split not in ("all", "train", "test"):
            raise ValueError(f"split must be all/train/test, got {split!r}")
        if split != "all":
            if holdout_every <= 0:
                raise ValueError("train/test split needs holdout_every > 0")
            idx = np.arange(len(self.image_paths))
            test = idx % holdout_every == 0
            keep = test if split == "test" else ~test
            self.image_paths = [
                p for p, k in zip(self.image_paths, keep) if k
            ]
            self.c2w = self.c2w[keep]
        self.holdout_every = holdout_every
        self.split = split
        self._cache: dict[int, np.ndarray] | None = {} if cache else None

        # Standardize geometry from the first view (one shape for every
        # batch).
        first = self._load_view_image(0)
        self.height, self.width = first.shape[:2]
        if self._cache is not None:
            self._cache[0] = first

        s = self.scale_factor
        self.fx = float(self.cam_params["fx"]) * s
        self.fy = float(self.cam_params["fy"]) * s
        if "cx" in self.cam_params and "cy" in self.cam_params:
            self.cx = float(self.cam_params["cx"]) * s
            self.cy = float(self.cam_params["cy"]) * s
        else:
            # Default: the principal point at the image center.
            self.cx = self.width / 2.0
            self.cy = self.height / 2.0

    def _load_poses(self) -> np.ndarray:
        """poses.npy, else cam_meta['c2w'], else identity."""
        n = len(self.image_paths)
        pose_file = os.path.join(self.data_dir, "poses.npy")
        if os.path.exists(pose_file):
            poses = np.asarray(np.load(pose_file), np.float32)
        elif "c2w" in self.cam_params:
            poses = np.asarray(self.cam_params["c2w"], np.float32)
        else:
            poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        if poses.shape[0] < n:
            raise ValueError(
                f"{poses.shape[0]} poses for {n} images in {self.data_dir}"
            )
        return poses[:n]

    def _load_view_image(self, idx: int) -> np.ndarray:
        img = load_image(self.image_paths[idx], self.scale_factor)
        return img

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, idx: int) -> dict:
        """One view: image [H, W, 3] f32 in [0,1] + camera, all numpy."""
        if self._cache is not None and idx in self._cache:
            img = self._cache[idx]
        else:
            img = self._load_view_image(idx)
            if img.shape[:2] != (self.height, self.width):
                # Heterogeneous per-view sizes (common in raw COLMAP output):
                # rescale to the dataset's shape. Crop or pad would silently
                # corrupt the ground truth.
                img = resize_image(img, self.height, self.width)
            if self._cache is not None:
                self._cache[idx] = img
        return {
            "image": img,
            "c2w": self.c2w[idx],
            "fx": np.float32(self.fx),
            "fy": np.float32(self.fy),
            "cx": np.float32(self.cx),
            "cy": np.float32(self.cy),
            "H": self.height,
            "W": self.width,
            "idx": idx,
        }

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
    ) -> Iterator[dict]:
        """Endless iterator of stacked fixed-size view batches.

        Each batch is a dict of arrays with leading axis `batch_size`:
        image [B,H,W,3], c2w [B,4,4], fx/fy/cx/cy [B]. Batches wrap around
        epochs, reshuffled at each with ``default_rng(seed)``.
        """
        rng = np.random.default_rng(seed)
        n = len(self)
        order = np.arange(n)
        pos = n  # trigger reshuffle on first call
        while True:
            out = []
            while len(out) < batch_size:
                if pos >= n:
                    if shuffle:
                        rng.shuffle(order)
                    pos = 0
                out.append(self[int(order[pos])])
                pos += 1
            yield {
                "image": np.stack([v["image"] for v in out]),
                "c2w": np.stack([v["c2w"] for v in out]),
                "fx": np.asarray([v["fx"] for v in out], np.float32),
                "fy": np.asarray([v["fy"] for v in out], np.float32),
                "cx": np.asarray([v["cx"] for v in out], np.float32),
                "cy": np.asarray([v["cy"] for v in out], np.float32),
            }

    def device_batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        mesh=None,
        quantize: bool = False,
        device="cuda",
    ) -> Iterator[dict]:
        """Like :meth:`batches`, but every view is copied once to
        ``device`` (``[N, H, W, 3]``) and each batch is a gather there:
        no per-step host-to-device copy of images. Yields tensors on
        ``device``: image [B,H,W,3] f32, c2w [B,4,4], fx/fy/cx/cy [B], in
        :meth:`batches`' view order for the same ``seed``.

        Memory: num_views * H * W * 3 * 4 bytes on the device, or 1/4 of
        that with ``quantize=True``, which keeps the views as uint8 and
        dequantizes after the gather: lossless for unrescaled 8-bit
        sources, at most 1/510 per channel after a fractional rescale.
        fit() picks f32, uint8 or host batches under its
        ``device_cache_bytes``.

        With ``mesh`` (this rank's ``parallel.Mesh``) the views are
        replicated on the mesh's device (``device`` is ignored), every
        rank draws the same order from ``seed``, and each yields its data
        coordinate's share of every global batch (``batch_size`` must
        divide by the data size): the input of
        ``make_sharded_train_step``, with no per-step host upload.
        """
        from ..device import resolve_device

        if mesh is None:
            dev, lo, hi = resolve_device(device), 0, batch_size
        else:
            n_data = mesh.shape["data"]
            if batch_size % n_data:
                raise ValueError(f"batch_size {batch_size} not divisible by "
                                 f"the mesh's data axis ({n_data})")
            bl = batch_size // n_data
            dev, lo, hi = mesh.device, mesh.coord[0] * bl, \
                (mesh.coord[0] + 1) * bl
        n = len(self)
        imgs_np = np.stack([self[i]["image"] for i in range(n)])
        if quantize:
            imgs_np = np.clip(
                imgs_np * 255.0 + 0.5, 0.0, 255.0
            ).astype(np.uint8)
        imgs = torch.from_numpy(imgs_np).to(dev)  # [N, H, W, 3] on device
        c2ws = torch.from_numpy(np.ascontiguousarray(self.c2w[:n])).to(dev)
        del imgs_np
        intr = {k: torch.full((hi - lo,), getattr(self, k),
                              dtype=torch.float32, device=dev)
                for k in ("fx", "fy", "cx", "cy")}

        rng = np.random.default_rng(seed)
        order = np.arange(n)
        pos = n
        while True:
            idx = []
            while len(idx) < batch_size:
                if pos >= n:
                    if shuffle:
                        rng.shuffle(order)
                    pos = 0
                idx.append(int(order[pos]))
                pos += 1
            sel = torch.as_tensor(idx[lo:hi], device=dev)
            batch_img = imgs[sel]
            if quantize:
                batch_img = batch_img.to(torch.float32) * (1.0 / 255.0)
            yield {"image": batch_img, "c2w": c2ws[sel], **intr}

    def size_bytes(self, bytes_per_channel: int = 4) -> int:
        """Approximate device footprint of the full image set
        (bytes_per_channel=1 for the quantized uint8 cache)."""
        return len(self) * self.height * self.width * 3 * bytes_per_channel

    def prefetched_batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        depth: int = 2,
    ) -> Iterator[dict]:
        """`batches()` behind a background thread: image decode and rescale
        (PIL releases the GIL) overlap the device's step. Useful for the
        first epoch on large datasets; after that the in-memory cache makes
        plain `batches()` as fast."""
        return prefetch(self.batches(batch_size, shuffle, seed), depth)

    def pointcloud_path(self) -> str | None:
        for name in ("pointcloud.ply", "points.ply", "pointcloud.npy"):
            p = os.path.join(self.data_dir, name)
            if os.path.exists(p):
                return p
        return None
