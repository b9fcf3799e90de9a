"""Image loading, resizing and writing (host-side numpy).

Counterpart of ``gsplat_tpu/data/images.py``: ``load_image`` (``:25``),
``save_image`` (``:51``), ``resize_image`` (``:64``), ``_to_rgb``
(``:82``), ``_rescale_bilinear`` (``:90``), ``_resize_bilinear_to``
(``:98``) and ``list_images`` (``:114``). PIL is used when available; the
``.npy`` path keeps the module usable without it.
"""

from __future__ import annotations

import os

import numpy as np

try:  # stay importable without PIL
    from PIL import Image

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".npy")


def load_image(path: str, scale_factor: float = 1.0) -> np.ndarray:
    """Load an image as float32 [H, W, 3] in [0, 1], optionally rescaled.

    ``scale_factor`` multiplies the resolution (0.5 = half size).
    """
    if path.endswith(".npy"):
        img = np.load(path)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = np.asarray(img, np.float32)
        if scale_factor != 1.0:
            img = _rescale_bilinear(img, scale_factor)
        return _to_rgb(img)
    if not _HAS_PIL:
        raise RuntimeError("PIL unavailable; only .npy images supported")
    with Image.open(path) as im:
        im = im.convert("RGB")
        if scale_factor != 1.0:
            w = max(int(round(im.width * scale_factor)), 1)
            h = max(int(round(im.height * scale_factor)), 1)
            im = im.resize((w, h), Image.BILINEAR)
        return np.asarray(im, np.float32) / 255.0


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


def resize_image(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of a float [H, W, 3] image to an exact (height,
    width): a dataset's views of other sizes are rescaled to its shape
    (cropping or padding would corrupt the ground truth)."""
    img = np.asarray(img, np.float32)
    if img.shape[:2] == (height, width):
        return img
    if _HAS_PIL:
        arr = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        with Image.fromarray(arr).resize((width, height), Image.BILINEAR) as im:
            return np.asarray(im, np.float32) / 255.0
    return _resize_bilinear_to(img, height, width)


def _to_rgb(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    return np.ascontiguousarray(img, np.float32)


def _rescale_bilinear(img: np.ndarray, scale: float) -> np.ndarray:
    """Separable bilinear resize by a scale factor (numpy)."""
    h, w = img.shape[:2]
    nh = max(int(round(h * scale)), 1)
    nw = max(int(round(w * scale)), 1)
    return _resize_bilinear_to(img, nh, nw)


def _resize_bilinear_to(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Separable bilinear resize to an exact target (numpy)."""
    h, w = img.shape[:2]
    ys = (np.arange(nh) + 0.5) * (h / nh) - 0.5
    xs = (np.arange(nw) + 0.5) * (w / nw) - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def list_images(directory: str) -> list[str]:
    """Sorted image paths under a directory."""
    out = []
    for name in sorted(os.listdir(directory)):
        if name.lower().endswith(IMAGE_EXTENSIONS):
            out.append(os.path.join(directory, name))
    return out
