"""Static render configuration for the PyTorch/CUDA port.

Counterpart of ``gsplat_tpu/config.py:18-296`` (``RenderConfig`` and
``TrainConfig``) with identical fields, defaults and derived properties,
so a config built for one package means the same render or training step
in the other.

Every option is ported: ``cull_mode="ellipse"`` (with ``max_rows``),
``tile_rank_cap`` (with ``occlusion_cull``, ``cull_chunks`` and
``trunc_pairs``), ``transmittance_math="log"``, ``bwd_pairs > 0`` (the
compacted backward), ``view_tile_rows > 0`` (batched views, set by
``render.stack_view_projections``), ``backend="xla"`` (with
``max_per_tile`` and ``tile_chunk``) and, in ``TrainConfig``,
``batched_render=True``. On the card the compositor kernels take tiles
16 and 32 (``ops/raster_cuda.py::check_kernel_config``); the XLA
compositor takes any tile. ``backend="auto"`` means the
compositor kernel (its plain version on the CPU), not JAX's XLA fallback
(``ops/rasterize.py::resolve_backend``).
"""

from __future__ import annotations

import dataclasses


def parse_background(s: str) -> tuple:
    """CLI background spec -> RGB tuple: 'black', 'white', or 'r,g,b'."""
    named = {"black": (0.0, 0.0, 0.0), "white": (1.0, 1.0, 1.0)}
    if s in named:
        return named[s]
    parts = tuple(float(x) for x in s.split(","))
    if len(parts) != 3:
        raise ValueError(
            f"background must be 'black', 'white' or 'r,g,b' — got {s!r}"
        )
    return parts


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration (hashable).

    Field meanings are documented at the JAX counterpart
    (``gsplat_tpu/config.py:35-162``).
    """

    height: int
    width: int
    tile: int = 16
    near: float = 0.01
    far: float = 100.0
    pix_guard: float = 32.0
    pix_guard_v: float | None = None
    min_conic: float = 1e-6
    chi2_clip: float = 6.25
    alpha_max: float = 0.99
    alpha_cutoff: float = 1.0 / 128.0
    transmittance_min: float = 5e-5
    max_pairs: int = 2**18
    max_per_tile: int = 1024
    tile_chunk: int = 16
    pair_block: int = 128
    backend: str = "auto"
    aa_mode: str = "none"
    aa_dilation: float = 0.3
    background: tuple = (0.0, 0.0, 0.0)
    transmittance_math: str = "cumprod"
    cull_mode: str = "rect"
    max_rows: int = 0
    tile_rank_cap: int = 0
    trunc_pairs: int = 0
    bwd_pairs: int = 0
    occlusion_cull: bool = True
    cull_chunks: int = 64
    view_tile_rows: int = 0

    def __post_init__(self):
        # Kept from the JAX package so both accept the same configs: its
        # binning packs tile coordinates into 10 bits (the port's int64
        # binning would not need the limit).
        if self.tiles_x >= 1024 or self.tiles_y >= 1024:
            raise ValueError(
                f"tile grid {self.tiles_x}x{self.tiles_y} exceeds the "
                f"1023-tile-per-axis limit of the packed binning encoding "
                f"(image {self.width}x{self.height}, tile {self.tile}); "
                f"use a larger tile size"
            )

    @property
    def row_capacity(self) -> int:
        """Static (gaussian, tile-row) capacity of the ellipse expansion."""
        return self.max_rows if self.max_rows else self.max_pairs // 2

    @property
    def padded_pairs(self) -> int:
        """Static capacity of the block-aligned pair list."""
        worst_pad = self.num_tiles * (self.pair_block - 1)
        return cdiv(self.max_pairs + worst_pad, self.pair_block) * self.pair_block

    @property
    def num_pair_blocks(self) -> int:
        return self.padded_pairs // self.pair_block

    @property
    def rank_cap_blocks(self) -> int:
        """Per-tile block cap of the rank truncation (0 = off)."""
        return cdiv(self.tile_rank_cap, self.pair_block)

    @property
    def trunc_padded_pairs(self) -> int:
        """Static capacity of the block-compacted truncated pair list."""
        if not self.tile_rank_cap:
            return self.padded_pairs
        if self.trunc_pairs:
            cap = cdiv(self.trunc_pairs, self.pair_block) * self.pair_block
        else:
            cap = self.num_tiles * self.rank_cap_blocks * self.pair_block
        return min(cap, self.padded_pairs)

    @property
    def num_trunc_blocks(self) -> int:
        return self.trunc_padded_pairs // self.pair_block

    @property
    def bwd_capacity(self) -> int:
        """Pair slots the compacted backward keeps (0 = off): ``bwd_pairs``
        rounded up to whole blocks, as the JAX package reports it
        (``RenderAux.bwd_capacity``)."""
        return cdiv(self.bwd_pairs, self.pair_block) * self.pair_block

    @property
    def tiles_x(self) -> int:
        return cdiv(self.width, self.tile)

    @property
    def tiles_y(self) -> int:
        return cdiv(self.height, self.tile)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def padded_width(self) -> int:
        return self.tiles_x * self.tile

    @property
    def padded_height(self) -> int:
        return self.tiles_y * self.tile

    def with_(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Static training hyperparameters (reference scripts/train.py:222-250).

    Field meanings are documented at the JAX counterpart
    (``gsplat_tpu/config.py:237-296``).
    """

    iterations: int = 30000
    batch_size: int = 1
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    adam_eps: float = 1e-15
    lambda_l1: float = 0.8
    lambda_ssim: float = 0.2
    grad_clip_pos: float = 1.0
    # Adaptive density control schedule.
    densify_until_iter: int = 15000
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    prune_opacity_threshold: float = 0.01
    max_grad: float = 0.01
    scale_threshold: float = 0.01
    adc_mode: str = "reference"
    densify_grad_threshold: float = 0.0002
    percent_dense: float = 0.01
    scene_extent: float = 5.0
    min_opacity: float = 0.005
    max_screen_size: int = 0  # px; 0 disables screen-size pruning
    checkpoint_interval: int = 1000
    capacity: int = 2**17
    num_sh_bands: int = 3
    sh_warmup_interval: int = 0
    nan_guard: bool = True
    batched_render: bool = False


# The pool leaf of per-gaussian features, and the decoder's leaves in
# ``train.trainer.TrainState.decoder`` (Feature 3DGS, below).
FEATURE_KEY = "f_sem"
DECODER_KEYS = ("dec_w", "dec_b")


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Feature 3DGS's training (Zhou et al., CVPR 2024, arXiv:2312.03203):
    each gaussian carries C feature floats (the pool's ``f_sem`` leaf [N,
    C]), composited with colour's own weights into a ``[C, H, W]`` map
    (``ops/raster_feat.py``); training resizes the map bilinearly
    (``align_corners=True``) to the teacher map's size, decodes it with a
    1x1 convolution with bias to D channels (``dec_w`` [D, C], ``dec_b``
    [D]) and adds ``semantic_loss_weight`` times the L1 distance to the
    teacher map to the photometric loss; Adam trains ``f_sem`` at
    ``semantic_feature_lr`` and the decoder at ``decoder_lr`` (the
    authors' code's values). C and D are the tensors' own.

    The port's own configuration: the JAX package has no features, so
    ``TrainConfig`` keeps its fields (and its ``feature_lr`` is the SH
    colour's rate)."""

    semantic_feature_lr: float = 0.001
    decoder_lr: float = 0.0001
    semantic_loss_weight: float = 1.0


# A pool whose ``scale_raw`` leaf has this many columns is a surfel pool
# (2D Gaussian Splatting, below); three columns is 3DGS.
SURFEL_SCALES = 2


def is_surfel_pool(params: dict) -> bool:
    """Whether ``params`` are a surfel pool's: a two-column ``scale_raw``."""
    s = params["scale_raw"]
    return s.dim() == 2 and s.shape[1] == SURFEL_SCALES


@dataclasses.dataclass(frozen=True)
class SurfelConfig:
    """2D Gaussian Splatting (Huang et al., SIGGRAPH 2024,
    arXiv:2403.17888): each primitive is a surfel, a flat disc with two
    scales in its tangent plane, composited by ray-splat intersection
    (``ops/surfel.py``, ``ops/raster_surfel.py``). Training adds the
    depth-distortion term at ``lambda_dist`` and the normal-consistency
    term at ``lambda_normal`` (``ops/losses.py::geometry_loss``). The
    distortion maps depth z to ``far / (far - near) * (1 - near / z)``
    with ``dist_near`` and ``dist_far``, and a ray-splat intersection
    nearer than ``dist_near`` adds nothing (the authors' code).
    ``filter_inv_square`` is the low-pass filter's ``1 / sigma^2`` in
    pixels (the authors' ``FilterInvSquare``, sigma = sqrt(2) / 2).

    The port's own configuration: the JAX package has no surfels, so
    ``RenderConfig`` and ``TrainConfig`` keep their fields."""

    lambda_dist: float = 100.0
    lambda_normal: float = 0.05
    dist_near: float = 0.2
    dist_far: float = 100.0
    filter_inv_square: float = 2.0


# An anchor pool (Scaffold-GS, below) holds these leaves; the presence of
# ``anchor_feat`` selects it. Its three MLPs, one flat tensor each, are
# the leaves ``train.trainer.TrainState.decoder`` holds beside it, as it
# holds Feature 3DGS's decoder; every leaf of a network has no slots.
ANCHOR_KEY = "anchor_feat"
ANCHOR_KEYS = ("pos", "offset", ANCHOR_KEY, "scale_raw")
MLP_KEYS = ("mlp_opacity", "mlp_cov", "mlp_color")
NETWORK_KEYS = DECODER_KEYS + MLP_KEYS
ANCHOR_SCALES = 6  # l[0:3] scales the offsets, l[3:6] the neural scales
SLOT_FIELDS = {"mlp_opacity": 1, "mlp_cov": 7, "mlp_color": 3}  # per slot


def is_anchor_pool(params: dict) -> bool:
    """Whether ``params`` are an anchor pool's: an ``anchor_feat`` leaf."""
    return ANCHOR_KEY in params


@dataclasses.dataclass(frozen=True)
class ScaffoldConfig:
    """Scaffold-GS (Lu et al., CVPR 2024, arXiv:2312.00109): each anchor
    (position, k offsets, an F-float feature, six scales
    ``exp(scale_raw)``) is decoded every view into k neural gaussians by
    three MLPs ``Linear(F + 3, H) -> ReLU -> Linear(H, m)`` conditioned on
    the viewing direction (``ops/scaffold.py``); k, F and H are the
    tensors' own (:func:`mlp_shapes`). Training adds ``scaling_reg`` times
    the mean
    over the kept slots of their scales' product to the photometric loss;
    Adam trains the offsets and the three MLPs on ``position_lr``'s
    schedule form (from ``*_lr_init`` to ``*_lr_final`` over
    ``lr_max_steps``, times 0.01 for the first ``lr_delay_mult *
    lr_max_steps`` updates), the features at ``feature_lr`` and the
    scales at ``scaling_lr``; the anchor positions take no update (the
    authors' rate is 0). The rates are the authors' code's.

    The port's own configuration: the JAX package has no anchors, so
    ``RenderConfig`` and ``TrainConfig`` keep their fields."""

    scaling_reg: float = 0.01
    feature_lr: float = 0.0075
    scaling_lr: float = 0.007
    offset_lr_init: float = 0.01
    offset_lr_final: float = 0.0001
    mlp_opacity_lr_init: float = 0.002
    mlp_opacity_lr_final: float = 0.00002
    mlp_cov_lr_init: float = 0.004
    mlp_cov_lr_final: float = 0.004
    mlp_color_lr_init: float = 0.008
    mlp_color_lr_final: float = 0.00005
    lr_delay_mult: float = 0.01
    lr_max_steps: int = 30000

    def schedules(self) -> dict:
        """{leaf: (init, final)} of the scheduled leaves."""
        return {k: (getattr(self, f"{k}_lr_init"),
                    getattr(self, f"{k}_lr_final"))
                for k in ("offset",) + MLP_KEYS}


# The published widths: the feature, the offsets (slots) an anchor, the
# hidden layer (what D1 and D2 are built for).
SCAFFOLD_WIDTHS = (32, 10, 32)


def mlp_shapes(feat_dim: int, n_offsets: int, hidden: int) -> dict:
    """{MLP leaf: (inputs, hidden, outputs)}: the input is the feature and
    the viewing direction; the heads give each slot's opacity, scale and
    rotation (3 + 4), and colour. A flat MLP holds ``W1`` [hidden, in],
    ``b1``, ``W2`` [out, hidden], ``b2``, in that order."""
    return {k: (feat_dim + 3, hidden, m * n_offsets)
            for k, m in SLOT_FIELDS.items()}
