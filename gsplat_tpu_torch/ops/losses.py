"""L1 + SSIM training losses.

Counterpart of ``gsplat_tpu/ops/losses.py:26-125``:

* L1 = mean |pred - target|,
* SSIM with an 11x11 Gaussian window (sigma=1.5), C1=0.01^2, C2=0.03^2,
  zero ("same") padding, computed per channel and averaged,
* combined loss = lambda_l1 * L1 + lambda_ssim * (1 - SSIM);
* Feature 3DGS's feature term (:func:`feature_loss`, the port's own): the
  feature map resized to the teacher map's size, decoded by a 1x1
  convolution, L1 to the teacher;
* 2D Gaussian Splatting's geometric terms (:func:`geometry_loss`, the
  port's own): the depth distortion and the normal consistency between
  the rendered normals and those of the expected depth map
  (:func:`depth_to_normal`).

All channels and all five filtered statistics (mu1, mu2, E[p^2], E[t^2],
E[pt]) go through one depthwise ``F.conv2d`` (``groups=C``), as the JAX
package runs one grouped convolution. SSIM is an XLA convolution there,
not a Pallas kernel, so the library convolution is the port too. It must
run in true float32: on CUDA, cuDNN convolutions default to TF32, which
``device.resolve_device`` turns off (the training entry points call it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import span


def gaussian_window(window_size: int = 11, sigma: float = 1.5,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """[window_size, window_size] normalized Gaussian window.

    Built in float64 on ``device`` itself (no host-to-device copy, which
    would wait for the stream), then cast, as the JAX package builds it in
    numpy float64.
    """
    coords = torch.arange(window_size, dtype=torch.float64,
                          device=device) - window_size // 2
    g = torch.exp(-(coords**2) / (2 * sigma**2))
    g = g / g.sum()
    return (g[:, None] * g[None, :]).to(dtype)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error."""
    return torch.mean(torch.abs(pred - target))


def _depthwise_blur(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise 'same' (zero-padded) 2D filter.

    Args:
        x: [B, C, H, W]
        window: [k, k]
    """
    c = x.shape[1]
    k = window.shape[0]
    kernel = window[None, None].expand(c, 1, k, k)
    return F.conv2d(x, kernel, padding=k // 2, groups=c)


def ssim(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM between images in [B?, H, W, C] layout."""
    if pred.dim() == 3:
        pred = pred[None]
        target = target[None]
    p = pred.permute(0, 3, 1, 2)  # [B, H, W, C] -> [B, C, H, W]
    t = target.permute(0, 3, 1, 2)
    window = gaussian_window(window_size, sigma, p.dtype, p.device)

    c1 = 0.01**2
    c2 = 0.03**2

    # One depthwise pass over the 5 statistics, stacked on the batch axis.
    stats = torch.cat([p, t, p * p, t * t, p * t], dim=0)
    f = _depthwise_blur(stats, window)
    b = p.shape[0]
    mu1, mu2, e_pp, e_tt, e_pt = (f[i * b:(i + 1) * b] for i in range(5))

    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = e_pp - mu1_sq
    sigma2_sq = e_tt - mu2_sq
    sigma12 = e_pt - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return torch.mean(ssim_map)


def ssim_loss(pred, target, window_size: int = 11) -> torch.Tensor:
    return 1.0 - ssim(pred, target, window_size)


def compute_loss(pred: torch.Tensor, target: torch.Tensor,
                 lambda_l1: float = 0.8, lambda_ssim: float = 0.2):
    """Combined loss; returns (total, {'l1', 'ssim', 'total'}) with the
    components as 0-d tensors."""
    with span("gs.loss"):
        l1 = l1_loss(pred, target)
        s = ssim_loss(pred, target)
        total = lambda_l1 * l1 + lambda_ssim * s
    return total, {"l1": l1, "ssim": s, "total": total}


def decode_features(fmap: torch.Tensor, size: tuple,
                    decoder: dict) -> torch.Tensor:
    """Feature 3DGS's decoder on a ``[C, H, W]`` feature map: resized
    bilinearly with ``align_corners=True`` to ``size`` (h, w), then the 1x1
    convolution with bias ``decoder`` (``dec_w`` [D, C], ``dec_b`` [D]) as
    one float32 matrix product. Returns [D, h, w]."""
    C = fmap.shape[0]
    h, w = size
    x = F.interpolate(fmap[None], size=(h, w), mode="bilinear",
                      align_corners=True)[0]
    W, b = decoder["dec_w"], decoder["dec_b"]
    return (W @ x.reshape(C, h * w)).reshape(W.shape[0], h, w) \
        + b[:, None, None]


def feature_loss(fmap: torch.Tensor, teacher: torch.Tensor,
                 decoder: dict) -> torch.Tensor:
    """Mean absolute difference between the decoded feature map
    (:func:`decode_features` at the teacher's size) and the teacher map
    ``[D, h, w]``: Feature 3DGS's distillation term, as a 0-d tensor."""
    with span("gs.feat_loss"):
        dec = decode_features(fmap, tuple(teacher.shape[1:]), decoder)
        return torch.mean(torch.abs(dec - teacher))


def depth_to_normal(depth: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """The normals [H, W, 3] (camera space) of a depth map [H, W], as the
    2D Gaussian Splatting authors' ``depth_to_normal`` makes them: each
    pixel (x, y) unprojected to ``depth * ((x - cx) / fx, (y - cy) / fy,
    1)``, central differences down the rows and along the columns, their
    cross product (rows x columns) normalised; zero on the border."""
    H, W = depth.shape
    dev = depth.device
    xs = (torch.arange(W, dtype=depth.dtype, device=dev) - cx) / fx
    ys = (torch.arange(H, dtype=depth.dtype, device=dev) - cy) / fy
    pts = torch.stack([depth * xs[None, :], depth * ys[:, None], depth],
                      dim=-1)
    dr = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dc = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = F.normalize(torch.cross(dr, dc, dim=-1), dim=-1)
    return F.pad(n, (0, 0, 1, 1, 1, 1))


def geometry_loss(aux, fx, fy, cx, cy, surfel):
    """2D Gaussian Splatting's geometric terms of a frame's maps (a surfel
    frame's ``RenderAux``): ``lambda_dist mean(D) + lambda_normal mean(1 -
    N_r . N_d)``, with ``D`` the distortion map, ``N_r`` the rendered
    normals (sum w n) and ``N_d`` the normals of the expected depth (sum
    w z / sum w, 0 where nothing was composited) times the detached alpha
    map, as the authors' training computes them with ``depth_ratio`` 0.
    ``surfel``: the ``config.SurfelConfig``. Returns (total, {'dist',
    'normal'}) as 0-d tensors."""
    with span("gs.geo_loss"):
        alpha = aux.alpha
        hit = alpha > 0.0
        depth = torch.where(hit, aux.depth / torch.where(hit, alpha, 1.0),
                            0.0)
        nd = depth_to_normal(depth, fx, fy, cx, cy) * alpha.detach()[..., None]
        dist = torch.mean(aux.distortion)
        normal = torch.mean(1.0 - torch.sum(aux.normal * nd, dim=-1))
        total = surfel.lambda_dist * dist + surfel.lambda_normal * normal
    return total, {"dist": dist, "normal": normal}
