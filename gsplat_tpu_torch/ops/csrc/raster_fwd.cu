// Forward tile compositor for Hopper (sm_90a).
//
// The kernel's body is raster_fwd_kernel.cuh (the body kK1), which
// raster_ablate.cu also instantiates for the profiler's ablations; this
// file holds K1's design, its instantiations and its launcher.
//
// Replaces the TPU kernel gsplat_tpu/ops/raster_pallas.py::_fwd_kernel
// (launched by _fwd_pallas). Same function: front-to-back alpha
// compositing of a tile-major, depth-ordered, block-aligned pair list,
// with the TPU kernel's block-granular saturation skip. Its plain PyTorch
// version is gsplat_tpu_torch/ops/raster_cuda.py::composite_pairs_plain,
// which it equals bit for bit.
//
// Design. The TPU kernel walks a sequential grid of (tile, block) steps
// and carries each tile's sums in its VMEM output block. CUDA blocks run
// in no order, so here one CTA owns one tile, one thread per pixel, and
// walks the tile's cdiv(tile_count, G) blocks itself, with T and the four
// sums in registers. The tile (16 or 32) and the largest pair block the
// CTA stages (kMaxG: 256 or 512 at tile 16, 512 at tile 32) are template
// parameters; the launcher picks the instantiation from (tile, G):
//   * a one-CTA kernel first lists the tiles by their number of blocks,
//     most first (tile_order_kernel), and CTA i takes the i-th: the tiles
//     with the longest serial walk start in the first wave instead of
//     wherever the image puts them, which shortens the tail of a frame
//     whose work sits in a few tiles;
//   * each warp owns an 8x4 pixel patch (with kWarpsX = tile / 8 patches
//     across, warp w at column (w % kWarpsX) * 8, row (w / kWarpsX) * 4 of
//     the tile; lane l at (l % 8, l / 8) in it): 8 warps at tile 16, 32 at
//     tile 32 (1,024 threads, the CTA limit). Output and state stay indexed
//     by pixel p = py * tile + px;
//   * staging: thread t holds pairs t, t + tile^2, ... (kStage =
//     cdiv(kMaxG, tile^2) of them: 2 at tile 16 with G = 512, else 1) of
//     the next block, 10 feature rows each, in registers (loaded coalesced,
//     the rows being feature-major, while the warps walk the previous
//     block) and stores each pair pair-major in shared
//     memory, 12 floats (u v a b | c op r g | b depth t m), so a pair is
//     three 16-byte broadcast loads. The store's 48-byte stride puts the
//     eight threads of a quarter-warp on 32 distinct banks. Slots 10-11
//     hold the pair's cull values (reach_threshold). 48 B x kMaxG of
//     static shared memory: 12 KiB at kMaxG 256, 24 KiB at 512. The
//     tile-16 kernel keeps kMaxG 256 for G <= 256, so its registers, shared
//     memory and CTAs per SM are those of the one-tile kernel before it;
//   * the read: the training forward stages the feature-major pair list
//     (rows gathered per pair before the launch); a frame that autograd
//     does not record passes the depth-ordered table ([N, 12] f32, a row a
//     gaussian: the 10 fields and two zero floats) and the pair list's
//     slots instead, and each thread loads its pair's slot, then the row
//     the slot names (two float4s and a float2; zeros at a padding slot),
//     into the same registers (kIndexed; raster_fwd_kernel.cuh). The
//     staged floats, and so every bit of the output, are the same; the
//     frame no longer writes a [10, pairs] list for the few blocks K1
//     reaches before its tiles saturate;
//     The table is built by pair_table_kernel below, one thread a row:
//     row i is gaussian order[i]'s fields (zeros where it is not valid),
//     ops/raster_cuda.py::pair_table_plain's concatenation, mask and
//     permutation in one pass;
//   * at tile 32 a CTA of 1,024 threads may hold at most 64 registers a
//     thread (the kernel needs about 40) and two CTAs share an SM;
//   * the per-warp pair cull: for the 32 pairs j = w0 + lane of a block,
//     lane `lane` tests whether pair j can reach any pixel of its warp's
//     patch, and __ballot_sync makes the 32-bit mask; the warp then walks
//     the set bits in ascending order (__ffs). A skipped pair has alpha
//     == 0 at all 32 pixels of the warp, where it would change nothing:
//     w = 0, acc + 0 * c == acc for finite c, T * (1 - 0) == T. So the
//     sums keep their order and every bit of the output. Warps of a CTA
//     finish a block at different times and meet at the next barrier;
//   * before a continuation block, __syncthreads_or(T > T_min) decides
//     whether the tile goes on. T multiplies through every pair of a
//     composited block, so row 4 (and the alpha plane) keeps the TPU
//     kernel's block-granular meaning, and row 5 counts the blocks
//     composited (the backward reads it as the active-block prefix);
//   * the [8, tile^2] output is written once, at the end;
//   * with a non-null `state` ([n_pairs / G, 5, tile^2] f32), each thread
//     writes its four sums (rows 0-3) and T (row 4) as they stand at the
//     start of every block it composites, at row base / G of the pair
//     list. Autograd asks for it: the backward (raster_bwd.cu) then runs
//     each composited block on its own. Serving passes null and writes
//     nothing; blocks not composited are left unwritten;
//   * with a non-null `skipped` (one u64), the kernel adds the number of
//     (pair, warp) it skipped in the composited blocks. Serving passes
//     null.
//
// The cull test. Pair j can give a non-zero alpha at a pixel only where
// the pixel's rounded q is at most min(chi2_clip, 2 ln(op / cutoff)):
// staging widens that to t (reach_threshold, with the margins the
// launcher passes: 1e-3 absolute, 1e-3 + 2^-17 / kappa relative, kappa =
// det / (a c), which bounds the float rounding of q and of the test
// itself), t = -inf where op <= 0 (skip everywhere:
// a_raw <= 0), t = +inf where a value is not finite, the cutoff is not
// positive, or the conic is not positive definite with kappa >= 1e-4
// (never skip). For each of the patch's 4 pixel rows, q is least along
// the row at du = m dv (m = -b / a), clamped to the patch's 8 columns: the
// warp skips the pair when that q exceeds t on all 4 rows (NaN reaches).
// This is the least q over each row's pixel segment, not the ellipse's
// bounding box: at the trained scene's 1080p bench pose it skips nearly
// every (pair, warp) whose alphas are all zero (raster_cuda.py::cull_audit
// counts both); a bounding-box test skips fewer. Its plain version is
// raster_cuda.py::pair_warp_reach.
//
// Transmittance, a compile-time template parameter (kLog), so the
// "cumprod" kernel keeps its own code:
//   * "cumprod": T is the running product, T = T * (1 - alpha) after each
//     pair; w = alpha * T before it;
//   * "log" (transmittance_math="log", the TPU kernel's _transmittance):
//     within a block s = log1pf(-alpha), S the running inclusive sum of s
//     from 0, T_excl = expf(S - s) * T_in and w = alpha * T_excl; at the
//     block's end T = T_in * expf(S). T carries by product from block to
//     block, so the block-start state and the saturation test keep their
//     meaning (T at the block's start). The cull stays exact: a skipped
//     pair has alpha == 0, so s = log1pf(-0.f) = -0.f, and S + -0.f == S
//     bit for bit; skipping it leaves S, and every later T_excl, as the
//     full walk has them.
//
// Arithmetic. Built with -fmad=false, and every expression of alpha, T,
// w and the sums is evaluated in the plain version's order, so each
// (pair, pixel) rounds as it does there: rows 0-5 and the state equal
// the plain version's bit for bit. exp(-q/2) is computed on every lane and
// then selected by q <= chi2_clip (the same value as a branch around it).
//
// Bound. The operations the function needs on a run's data: the (pair,
// pixel) of the (pair, warp) the cull reaches, about 26 f32 operations and
// one exp each, plus the cull itself (58 per (pair, warp) of a composited
// block, 14 per staged pair), over 67 TFLOP/s; bytes are the active feature
// blocks (10 x G x 4 B each) plus the 8 KiB output of every tile, empty
// ones included (gsplat_tpu_torch/profile_kernel.py: bound_ms). The bytes
// bind at the trained scene's 1080p bench pose, the operations on the
// profiler's denser workload. The TPU kernel computes every (pair, pixel)
// of a composited block; the profiler prints that figure beside the
// bound.
// Tiles stay unbalanced (a CTA's time grows with its tile's active depth);
// the tile order only starts the deepest first.
//
// Batched views (rows_mod > 0, RenderConfig.view_tile_rows). The views'
// tile rows are stacked, view v at rows [v * rows_mod, (v + 1) * rows_mod),
// and their uv stay view-local, so a tile's pixel row is its tile row
// modulo rows_mod (integers, as the TPU kernel's _pixel_grid wraps it).
// That row gives both the pixel centres and the warp patch the cull tests,
// so the cull stays exact and each view's tiles composite as the view alone
// would. rows_mod = 0 leaves the row as it is.
//
// The pair list's end. A tile walks cdiv(tile_count, G) blocks from
// tile_start and stops at the first block that does not lie wholly inside
// the n_pairs of the list: a rank-truncated list whose capacity overflowed
// (ops/binning.py) keeps a tile's first blocks only, as the TPU kernel
// walks only the blocks its block_meta lists.

#include "raster_fwd_kernel.cuh"

namespace {

// The instantiation of raster_fwd_kernel for (tile, G, log_t, indexed), or
// null where none is built: tile 16 stages up to 256 pairs a CTA or 512,
// tile 32 up to 512.
using FwdKernel = void (*)(const float*, int, int, const int*, const int*,
                           const int*, float*, float*, unsigned long long*,
                           int, int, int, float, float, float, float,
                           CullMargins, const int*);

template <bool kLog, bool kIndexed>
FwdKernel pick_kernel(int tile, int G) {
  if (G <= 0 || G % 32 != 0) return nullptr;
  if (tile == 16 && G <= 256)
    return raster_fwd_kernel<16, 256, kLog, kK1, kIndexed>;
  if (tile == 16 && G <= 512)
    return raster_fwd_kernel<16, 512, kLog, kK1, kIndexed>;
  if (tile == 32 && G <= 512)
    return raster_fwd_kernel<32, 512, kLog, kK1, kIndexed>;
  return nullptr;
}

FwdKernel pick_kernel(int tile, int G, int log_t, bool indexed) {
  if (indexed) {
    return log_t ? pick_kernel<true, true>(tile, G)
                 : pick_kernel<false, true>(tile, G);
  }
  return log_t ? pick_kernel<true, false>(tile, G)
               : pick_kernel<false, false>(tile, G);
}

constexpr int kTableThreads = 256;

// Row i of the [n, kTableRow] table: gaussian g = order[i]'s u v, conic
// (3), opacity, rgb, depth and two zeros, or 12 zeros where valid[g] is 0.
__global__ void __launch_bounds__(kTableThreads) pair_table_kernel(
    const int* __restrict__ order, const unsigned char* __restrict__ valid,
    const float* __restrict__ uv, const float* __restrict__ conic,
    const float* __restrict__ opacity, const float* __restrict__ rgb,
    const float* __restrict__ depth, int n, float4* __restrict__ table) {
  const int i = blockIdx.x * kTableThreads + threadIdx.x;
  if (i >= n) return;
  const int g = order[i];
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a, c = a;
  if (valid[g]) {
    a = make_float4(uv[2 * g], uv[2 * g + 1], conic[3 * g], conic[3 * g + 1]);
    b = make_float4(conic[3 * g + 2], opacity[g], rgb[3 * g], rgb[3 * g + 1]);
    c = make_float4(rgb[3 * g + 2], depth[g], 0.0f, 0.0f);
  }
  float4* row = table + (size_t)i * (kTableRow / 4);
  row[0] = a;
  row[1] = b;
  row[2] = c;
}

}  // namespace

// Builds K1's depth-ordered [n, 12] table (pair_table_kernel) on `stream`
// from the n-row order (int32 slots of the fields' rows) and the
// contiguous fields: valid [N] bool, uv [N, 2], conic [N, 3], opacity
// [N], rgb [N, 3], depth [N] f32. Returns cudaGetLastError().
extern "C" int pair_table(const void* order, const void* valid,
                          const void* uv, const void* conic,
                          const void* opacity, const void* rgb,
                          const void* depth, int n, void* table,
                          void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  pair_table_kernel<<<(n + kTableThreads - 1) / kTableThreads, kTableThreads,
                      0, (cudaStream_t)stream>>>(
      (const int*)order, (const unsigned char*)valid, (const float*)uv,
      (const float*)conic, (const float*)opacity, (const float*)rgb,
      (const float*)depth, n, (float4*)table);
  return (int)cudaGetLastError();
}

// Launches tile_order_kernel, then the compositor, on `stream` and returns
// cudaGetLastError() (0 on success). `pair_slot` null: `feat` is the
// feature-major pair list, row r of pair j at feat[r * stride + j];
// otherwise `feat` is the depth-ordered [N, 12] table, pair j's row
// pair_slot[j] (zeros where it is < 0), and stride is not read; n_pairs is
// the list's length either way. `order` is scratch for num_tiles ints.
// `state` may be null (nothing written); `skipped` may be null (nothing
// counted), else the kernel adds the (pair, warp) it skipped to *skipped. log_t selects the transmittance: 1 "log", 0 "cumprod".
// tile: 16 or 32; G: a multiple of 32, at most 512 (cudaErrorInvalidValue
// otherwise).
// rows_mod: the tile rows of one view for batched views, else 0 (see the
// header).
// margin_rel, margin_eps, margin_abs and kappa_min are the cull's (see the
// header).
extern "C" int raster_fwd(const void* feat, const void* pair_slot,
                          int n_pairs, int stride,
                          const void* tile_start, const void* tile_count,
                          void* order, void* out, void* state, void* skipped,
                          int log_t, int num_tiles, int tiles_x,
                          int rows_mod, int tile, int G,
                          float chi2_clip,
                          float alpha_max, float alpha_cutoff, float t_min,
                          float margin_rel, float margin_eps,
                          float margin_abs, float kappa_min, void* stream) {
  const FwdKernel kernel = pick_kernel(tile, G, log_t, pair_slot != nullptr);
  if (kernel == nullptr || num_tiles < 0 || rows_mod < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_tiles == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  tile_order_kernel<<<1, kOrderThreads, 0, s>>>(
      (const int*)tile_count, num_tiles, G, (int*)order);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const CullMargins cm = {margin_rel, margin_eps, margin_abs, kappa_min};
  kernel<<<num_tiles, tile * tile, 0, s>>>(
      (const float*)feat, n_pairs, stride, (const int*)tile_start,
      (const int*)tile_count, (const int*)order, (float*)out, (float*)state,
      (unsigned long long*)skipped, tiles_x, rows_mod, G, chi2_clip,
      alpha_max,
      alpha_cutoff, t_min, cm, (const int*)pair_slot);
  return (int)cudaGetLastError();
}

// The compositor's resident CTAs per SM on the current device for (tile,
// G, log_t) and the read (indexed: 1 with a pair_slot, 0 without) as
// raster_fwd takes them, from the occupancy API, into *n; returns the CUDA
// error (0 on success).
extern "C" int raster_fwd_ctas_per_sm(int tile, int G, int log_t,
                                      int indexed, int* n) {
  const FwdKernel kernel = pick_kernel(tile, G, log_t, indexed != 0);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, kernel, tile * tile, 0);
}
