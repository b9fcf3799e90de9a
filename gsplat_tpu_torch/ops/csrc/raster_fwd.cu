// Forward tile compositor for Hopper (sm_90a).
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
// in no order, so here one CTA owns one 16x16 tile, one thread per pixel,
// and walks the tile's cdiv(tile_count, G) blocks itself, with T and the
// four sums in registers:
//   * a one-CTA kernel first lists the tiles by their number of blocks,
//     most first (tile_order_kernel), and CTA i takes the i-th: the tiles
//     with the longest serial walk start in the first wave instead of
//     wherever the image puts them, which shortens the tail of a frame
//     whose work sits in a few tiles;
//   * each warp owns an 8x4 pixel patch (warp w at column (w % 2) * 8, row
//     (w / 2) * 4 of the tile; lane l at (l % 8, l / 8) in it). Output and
//     state stay indexed by pixel p = py * 16 + px;
//   * staging: thread j < G holds pair j's 10 feature rows in registers
//     (loaded coalesced, the rows being feature-major, while the warps
//     walk the previous block) and stores the pair pair-major in shared
//     memory, 12 floats (u v a b | c op r g | b depth t m), so a pair is
//     three 16-byte broadcast loads. The store's 48-byte stride puts the
//     eight threads of a quarter-warp on 32 distinct banks. Slots 10-11
//     hold the pair's cull values (reach_threshold);
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
//   * the [8, 256] output is written once, at the end;
//   * with a non-null `state` ([n_pairs / G, 5, 256] f32), each thread
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
// every (pair, warp) whose alphas are all zero (chip_smoke.py prints both
// shares); a bounding-box test skips fewer. Its plain version is
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
// of a composited block; chip_smoke.py and the profiler print that figure
// beside the bound.
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

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per CTA
constexpr int kRows = 10;               // u v a b c op r g b depth
constexpr int kMaxG = 256;
constexpr int kSlots = 3;               // float4s per staged pair
constexpr int kWarpW = 8, kWarpH = 4;   // a warp's pixel patch
constexpr int kOrderThreads = 1024;
constexpr int kBuckets = 32;  // tile_order: block counts 0..30, 31 and up

// The cull's margins, passed by the launcher from raster_cuda.py's
// CULL_MARGIN_REL, CULL_MARGIN_EPS, CULL_MARGIN_ABS and CULL_KAPPA_MIN.
struct CullMargins {
  float rel, eps, abs, kappa_min;
};

// The widened threshold t on a pixel's q beyond which pair f (10 rows)
// has alpha == 0, and the slope m = -b / a; see the header. Operation
// order is raster_cuda.py::_reach_threshold's.
__device__ __forceinline__ float reach_threshold(const float* f,
                                                 float chi2_clip,
                                                 float alpha_cutoff,
                                                 const CullMargins& cm,
                                                 float* m) {
  *m = 0.0f;
  bool finite = true;
#pragma unroll
  for (int r = 0; r < kRows; ++r) finite = finite && isfinite(f[r]);
  if (!finite || !(alpha_cutoff > 0.0f)) return INFINITY;
  const float a = f[2], b = f[3], c = f[4], op = f[5];
  if (op <= 0.0f) return -INFINITY;
  const float ac = a * c;
  const float det = ac - b * b;
  const float kappa = det / ac;
  if (!(a > 0.0f && c > 0.0f && kappa >= cm.kappa_min)) return INFINITY;
  *m = -b / a;
  const float t = fminf(2.0f * logf(op / alpha_cutoff), chi2_clip);
  return t + fabsf(t) * (cm.rel + cm.eps / kappa) + cm.abs;
}

// Bucket of a tile in tile_order: 0 for the most blocks.
__device__ __forceinline__ int order_bucket(int count, int G) {
  const int nblk = count > 0 ? (count + G - 1) / G : 0;
  return kBuckets - 1 - min(nblk, kBuckets - 1);
}

// order[0 .. num_tiles): the tiles by their number of pair blocks, most
// first (a counting sort in one CTA; within a bucket the order is the
// atomics', which changes only which CTA takes which tile).
__global__ void __launch_bounds__(kOrderThreads) tile_order_kernel(
    const int* __restrict__ tile_count, int num_tiles, int G,
    int* __restrict__ order) {
  __shared__ int next[kBuckets];
  if (threadIdx.x < kBuckets) next[threadIdx.x] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < num_tiles; i += kOrderThreads) {
    atomicAdd(&next[order_bucket(tile_count[i], G)], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int b = 0; b < kBuckets; ++b) {
      const int n = next[b];
      next[b] = sum;
      sum += n;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < num_tiles; i += kOrderThreads) {
    order[atomicAdd(&next[order_bucket(tile_count[i], G)], 1)] = i;
  }
}

template <bool kLog>
__global__ void __launch_bounds__(kPixels) raster_fwd_kernel(
    const float* __restrict__ feat, int n_pairs, int stride,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    const int* __restrict__ order, float* __restrict__ out,
    float* __restrict__ state, unsigned long long* __restrict__ skipped,
    int tiles_x, int rows_mod, int G, float chi2_clip, float alpha_max,
    float alpha_cutoff, float t_min, CullMargins cm) {
  __shared__ float4 sm[kSlots * kMaxG];

  const int tile = order[blockIdx.x];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int trow = rows_mod > 0 ? (tile / tiles_x) % rows_mod : tile / tiles_x;
  const int tx = (tile % tiles_x) * kTile + (warp % 2) * kWarpW;
  const int ty = trow * kTile + (warp / 2) * kWarpH;
  const int p = ((warp / 2) * kWarpH + lane / kWarpW) * kTile +
                (warp % 2) * kWarpW + lane % kWarpW;
  const float px = (float)(tx + lane % kWarpW);
  const float py = (float)(ty + lane / kWarpW);
  const float x0 = (float)tx, x1 = (float)(tx + kWarpW - 1);
  const float y0 = (float)ty;
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const int nblk = count > 0 ? (count + G - 1) / G : 0;

  float T = 1.0f;  // "log": T at the block's start, while in a block
  float S = 0.0f;  // "log": the block's running sum of log1pf(-alpha)
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  int blocks = 0;
  int reached = 0;  // (pair, warp) walked, uniform over the warp
  // Thread j < G holds pair j of the next block in registers, loaded
  // while the warps walk the current one.
  float f[kRows];
  if (tid < G && nblk > 0 && start + G <= n_pairs) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      f[r] = feat[(size_t)r * stride + start + tid];
  }

  for (int k = 0; k < nblk; ++k) {
    // Saturation skip for continuation blocks. The barrier also keeps the
    // previous block's shared pairs until every warp has walked them.
    if (k > 0 && !__syncthreads_or(T > t_min)) break;
    const int base = start + k * G;
    if (base + G > n_pairs) break;  // uniform over the CTA: the list's
                                    // end (see the header)
    if (state != nullptr) {
      float* s = state + (size_t)(base / G) * 5 * kPixels + p;
      s[0 * kPixels] = acc_r;
      s[1 * kPixels] = acc_g;
      s[2 * kPixels] = acc_b;
      s[3 * kPixels] = acc_d;
      s[4 * kPixels] = T;
    }
    if (tid < G) {
      float m;
      const float t = reach_threshold(f, chi2_clip, alpha_cutoff, cm, &m);
      sm[kSlots * tid + 0] = make_float4(f[0], f[1], f[2], f[3]);
      sm[kSlots * tid + 1] = make_float4(f[4], f[5], f[6], f[7]);
      sm[kSlots * tid + 2] = make_float4(f[8], f[9], t, m);
    }
    __syncthreads();
    if (tid < G && k + 1 < nblk && base + 2 * G <= n_pairs) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        f[r] = feat[(size_t)r * stride + base + G + tid];
    }

    for (int w0 = 0; w0 < G; w0 += 32) {
      // Lane `lane` tests pair w0 + lane against this warp's patch.
      const float4* s = sm + kSlots * (w0 + lane);
      const float4 A = s[0], B = s[1], C = s[2];
      const float lo = x0 - A.x, hi = x1 - A.x;
      bool reach = false;
#pragma unroll
      for (int r = 0; r < kWarpH; ++r) {
        const float dv = (y0 + (float)r) - A.y;
        const float du = fminf(fmaxf(C.w * dv, lo), hi);
        const float q = A.z * du * du + 2.0f * A.w * du * dv +
                        B.x * dv * dv;
        reach = reach || !(q > C.z);
      }
      unsigned mask = __ballot_sync(0xffffffffu, reach);
      reached += __popc(mask);
      while (mask != 0u) {
        const float4* sj = sm + kSlots * (w0 + __ffs(mask) - 1);
        mask &= mask - 1u;
        const float4 P = sj[0], Q = sj[1], R = sj[2];
        const float du = px - P.x;
        const float dv = py - P.y;
        const float q = P.z * du * du + 2.0f * P.w * du * dv +
                        Q.x * dv * dv;
        // exp on every lane, then a select: a branch around it was slower
        const float e = expf(-0.5f * q);
        const float g = q <= chi2_clip ? e : 0.0f;
        const float a_raw = Q.y * g;
        const float a = a_raw > alpha_max ? alpha_max : a_raw;
        const float alpha = a >= alpha_cutoff ? a : 0.0f;
        float Te = T;
        if (kLog) {
          const float sl = log1pf(-alpha);
          S = S + sl;
          Te = expf(S - sl) * T;
        }
        const float w = Te > t_min ? alpha * Te : 0.0f;
        acc_r = acc_r + w * Q.z;
        acc_g = acc_g + w * Q.w;
        acc_b = acc_b + w * R.x;
        acc_d = acc_d + w * R.y;
        if (!kLog) T = T * (1.0f - alpha);
      }
    }
    if (kLog) {
      T = T * expf(S);
      S = 0.0f;
    }
    blocks += 1;
  }

  float* o = out + (size_t)tile * 8 * kPixels + p;
  o[0 * kPixels] = acc_r;
  o[1 * kPixels] = acc_g;
  o[2 * kPixels] = acc_b;
  o[3 * kPixels] = acc_d;
  o[4 * kPixels] = T;
  o[5 * kPixels] = (float)blocks;
  o[6 * kPixels] = 0.0f;
  o[7 * kPixels] = 0.0f;
  if (skipped != nullptr && lane == 0 && blocks > 0) {
    atomicAdd(skipped, (unsigned long long)(blocks * G - reached));
  }
}

}  // namespace

// Launches tile_order_kernel, then the compositor, on `stream` and returns
// cudaGetLastError() (0 on success). `order` is scratch for num_tiles
// ints. `state` may be null (nothing written); `skipped` may be null
// (nothing counted), else the kernel adds the (pair, warp) it skipped to
// *skipped. log_t selects the transmittance: 1 "log", 0 "cumprod".
// rows_mod: the tile rows of one view for batched views, else 0 (see the
// header).
// margin_rel, margin_eps, margin_abs and kappa_min are the cull's (see the
// header).
extern "C" int raster_fwd(const void* feat, int n_pairs, int stride,
                          const void* tile_start, const void* tile_count,
                          void* order, void* out, void* state, void* skipped,
                          int log_t, int num_tiles, int tiles_x,
                          int rows_mod, int G,
                          float chi2_clip,
                          float alpha_max, float alpha_cutoff, float t_min,
                          float margin_rel, float margin_eps,
                          float margin_abs, float kappa_min, void* stream) {
  if (G <= 0 || G > kMaxG || G % 32 != 0 || num_tiles < 0 || rows_mod < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_tiles == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  tile_order_kernel<<<1, kOrderThreads, 0, s>>>(
      (const int*)tile_count, num_tiles, G, (int*)order);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const CullMargins cm = {margin_rel, margin_eps, margin_abs, kappa_min};
  auto kernel = log_t ? raster_fwd_kernel<true> : raster_fwd_kernel<false>;
  kernel<<<num_tiles, kPixels, 0, s>>>(
      (const float*)feat, n_pairs, stride, (const int*)tile_start,
      (const int*)tile_count, (const int*)order, (float*)out, (float*)state,
      (unsigned long long*)skipped, tiles_x, rows_mod, G, chi2_clip,
      alpha_max,
      alpha_cutoff, t_min, cm);
  return (int)cudaGetLastError();
}

// The compositor's resident CTAs per SM on the current device (log_t as
// raster_fwd's), from the occupancy API, into *n; returns the CUDA error
// (0 on success).
extern "C" int raster_fwd_ctas_per_sm(int log_t, int* n) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, log_t ? raster_fwd_kernel<true> : raster_fwd_kernel<false>, kPixels,
      0);
}
