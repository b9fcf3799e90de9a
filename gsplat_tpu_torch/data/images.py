"""Image writing (host-side numpy).

Counterpart of ``gsplat_tpu/data/images.py``: ``save_image`` (``:51-61``)
and its PIL guard. PIL is used when available; ``.npy`` output keeps the
module usable without it. The loaders come with the data layer.
"""

from __future__ import annotations

import numpy as np

try:  # stay importable without PIL
    from PIL import Image

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False


def save_image(path: str, img: np.ndarray) -> None:
    """Save a float [0,1] (or uint8) [H, W, 3] image."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if path.endswith(".npy"):
        np.save(path, arr)
        return
    if not _HAS_PIL:
        raise RuntimeError("PIL unavailable; use .npy output")
    Image.fromarray(arr).save(path)
