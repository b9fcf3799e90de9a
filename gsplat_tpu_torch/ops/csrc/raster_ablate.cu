// Instruction-class ablations and alternative designs of the forward
// compositor (K1) for Hopper (sm_90a).
//
// Replace the eight bodies besides `full` that scripts/profile_kernel.py
// times through run_variant. One launcher, two sources:
//
// * empty, no-compute, no-transc, no-mxu, no-input and cumprod are K1's
//   own kernel (raster_fwd_kernel.cuh) instantiated at tile 16, kMaxG 256
//   with another body: K1 as serving runs it (tiles heaviest first,
//   pair-major staging, the per-warp pair cull, 8x4-pixel warps, the
//   output write) minus one class of work, so K1's time minus the body's
//   reads off that class and the two are built from one source. The
//   header describes each body.
//
// * pg-roll and pg-log (_kernel_pg) keep their own template below,
//   raster_pg_kernel<V>: not K1 minus a class but K1's function in the
//   TPU body's matrix form, redesigned for Hopper's tensor cores. The TPU
//   lays pairs along its matrix unit's reduction axis: T's prefix (log)
//   is a product with a triangular mask and the channel sums one
//   [P, G] @ [G, 4] product. Here every (pair, pixel) of every block is
//   computed (no cull, as the TPU body has none), so the time per (pair,
//   pixel) reads the cost of the formulation against K1's walk.
//     - One CTA per tile, 8 warps; warp w takes the tile's pixel rows 2w
//       and 2w+1, each the M = 16 rows of one mma.sync m16n8k8 (TF32
//       operands, f32 accumulator). A block's pairs go 8 at a time along
//       the reduction axis (k-steps). Lane 4g+q computes alpha for pixels
//       g and g+8 of each row and pairs 2q, 2q+1 of the k-step: its own
//       accumulator entries, which are also its A-operand entries when the
//       k slots q and q+4 stand for pairs 2q and 2q+1 (the B operands are
//       staged in that order). No (pair, pixel) value leaves the
//       registers.
//     - pg-log: s = log1p(-alpha); the inclusive prefix within the k-step
//       is s @ U on the tensor cores, U the 8x8 inclusive upper-triangular
//       mask (0 and 1 are exact in TF32), in two passes, s = s_hi + s_lo
//       with s_hi = cvt.rna.tf32(s) and s_lo = cvt.rna.tf32(s - s_hi), so
//       the f32 value survives to ~2^-22; the running sum S of the earlier
//       k-steps is added in f32 (cum = S + prefix) and S becomes cum at
//       the k-step's last pair (one shuffle per pixel). T_excl = exp(cum -
//       s) T_in; T_out = T_in exp(S). The TPU's [G, G] mask is G/8 times
//       this product's work.
//     - pg-roll has no matrix form: lane q multiplies its two 1 - alpha,
//       a two-step scan over the lane quad (shuffles up by 1 and 2) gives
//       the product through lane q, one shuffle the product before lane q
//       and one the k-step's total; T before the k-step (T_in times the
//       earlier totals, in order) carries across k-steps. Pair 2q has
//       T_excl = T_run x before, pair 2q + 1 that times 1 - alpha_2q.
//       Four shuffles per pixel and k-step: 1/16 per (pair, pixel) in a
//       warp, where a doubling scan with the pairs along a warp's lanes
//       takes 46 per 128.
//     - The channel sums for both: w = alpha T_excl where T_excl > T_min,
//       split w = w_hi + w_lo as s is, times B = the k-step's colours and
//       depth staged as [hi of r g b d | lo of r g b d] (8 columns), two
//       products a k-step accumulating in one C fragment over the block
//       (hi.hi, hi.lo, lo.hi and lo.lo); a shuffle adds the lo columns to
//       the hi ones and the block's sums are added to the tile's in f32.
//       T and the four sums stay in registers across the tile's blocks;
//       the output is written once per tile.
//     - Staging: the block's ten feature rows land by cp.async in one of
//       two buffers while the CTA computes the other block; after the
//       barrier that opens a block, the CTA writes its colours' TF32
//       splits as B fragments (one float2 a lane and k-step) before a
//       second barrier.
//
// Every variant writes its tile's whole [8, 256] output as K1 does: rows
// 0-3 the sums (0 where nothing is summed), row 4 T, row 5 the blocks
// composited, rows 6-7 zero. All but empty and no-compute skip a
// continuation block by K1's __syncthreads_or(T > T_min). The TPU bodies
// gate on "first block or max T > T_min" and ignore the dead bit, which is
// K1's rule on a layout with no dead blocks (the profiler's). Their plain
// PyTorch versions are gsplat_tpu_torch/ops/raster_ablate.py::ablate_plain.
//
// Arithmetic. Built with -fmad=false like K1, every expression in the
// plain version's order, so kernel and plain version round alike; in
// pg-roll and pg-log the tensor cores' sums do not follow IEEE order, so
// there the two agree within tolerance, not bit for bit.
//
// Bound. The bodies that walk K1's reached pairs (no-transc, no-mxu,
// cumprod) are bound as K1 is: the (pair, pixel) of the (pair, warp) their
// cull reaches plus the cull's own operations (no-transc by its own
// threshold), against 10 x G x 4 B per composited block and the output;
// no-input by every (pair, pixel), with no feature byte; no-compute and
// empty by bytes: the staged rows plus the 8 KiB output per tile, and the
// output alone (gsplat_tpu_torch/profile_kernel.py: bound_ms). pg-roll
// and pg-log are held to K1's bound (the least K1's function needs) and
// are bound by the instruction rate: about 40 (roll) and 80 (log)
// instructions per (pair, pixel), against a tensor-core share under 0.1
// ms. The six K1-shaped kernels measure K1's costs and are not tuned
// beyond K1.

#include "raster_fwd_kernel.cuh"

namespace {

constexpr int kPgTile = 16;
constexpr int kPgPixels = kPgTile * kPgTile;
constexpr int kPgMaxG = 256;
constexpr int kWarp = 32;
constexpr int kPgRowsPerWarp = 2;  // m16n8k8 row tiles (pixel rows) a warp
constexpr int kPgThreads = kPgTile / kPgRowsPerWarp * kWarp;
constexpr int kChunk = 8;  // pairs a k-step
constexpr unsigned kFull = 0xffffffffu;

enum PgMode { kPgRoll = 0, kPgLog = 1 };

// x rounded to TF32 by cvt.rna (to nearest, ties away from zero), as an
// f32 whose low 13 mantissa bits are zero; NaN and Inf pass through.
// raster_ablate.py::tf32_round is its plain version.
__device__ __forceinline__ float tf32_round(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// The hi (lo == false) or lo part of x = hi + lo, each TF32.
__device__ __forceinline__ float tf32_part(float x, bool lo) {
  const float hi = tf32_round(x);
  return lo ? tf32_round(x - hi) : hi;
}

// d += A B on the tensor cores, m16n8k8 with TF32 operands and an f32
// accumulator. Fragments (PTX ISA, lane = 4 g + q): a = A[g][q],
// A[g+8][q], A[g][q+4], A[g+8][q+4]; b = B[q][g], B[q+4][g]; d = D[g][2q],
// D[g][2q+1], D[g+8][2q], D[g+8][2q+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], float a0, float a1,
                                         float a2, float a3, float b0,
                                         float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)),
        "r"(__float_as_uint(a2)), "r"(__float_as_uint(a3)),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// Starts copying the 10 feature rows of the block at `base` into `dst`
// (row r at dst + r*G), one cp.async group.
__device__ __forceinline__ void stage_async(float* dst,
                                            const float* __restrict__ feat,
                                            int stride, int base, int G,
                                            int p) {
  for (int i = p; i < kRows * G; i += kPgThreads) {
    const int r = i / G;
    const unsigned to = (unsigned)__cvta_generic_to_shared(dst + i);
    const float* from = feat + (size_t)r * stride + base + (i - r * G);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(to),
                 "l"(from)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// K1's alpha for one (pair, pixel).
__device__ __forceinline__ float pair_alpha(float px, float py, float u,
                                            float v, float ca, float cb,
                                            float cc, float op,
                                            float chi2_clip, float alpha_max,
                                            float alpha_cutoff) {
  const float du = px - u;
  const float dv = py - v;
  const float q = ca * du * du + 2.0f * cb * du * dv + cc * dv * dv;
  float g = 0.0f;
  if (q <= chi2_clip) g = expf(-0.5f * q);
  const float a_raw = op * g;
  const float a = a_raw > alpha_max ? alpha_max : a_raw;
  return a >= alpha_cutoff ? a : 0.0f;
}

// Four resident CTAs a SM for pg-roll (64 registers), three for pg-log.
template <int V>
__global__ void __launch_bounds__(kPgThreads, V == kPgRoll ? 4 : 3)
    raster_pg_kernel(const float* __restrict__ feat, int n_pairs, int stride,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     float* __restrict__ out, int tiles_x, int G,
                     float chi2_clip, float alpha_max, float alpha_cutoff,
                     float t_min) {
  constexpr int M = kPgRowsPerWarp;
  // The feature rows of two blocks, and the colours of the current one as
  // B fragments: entry 32c + lane holds (B[q][g], B[q+4][g]) of k-step c,
  // column g < 4 the hi part of channel g, g >= 4 the lo part of g - 4.
  __shared__ __align__(16) float rows[2][kRows * kPgMaxG];
  __shared__ float2 bfrag[kPgMaxG / kChunk * kWarp];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & (kWarp - 1);
  const int warp = p / kWarp;
  const int g = lane >> 2;  // fragment row group: pixels g, g + 8
  const int q = lane & 3;   // fragment column group: pairs 2q, 2q + 1
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const int nblk = count > 0 ? (count + G - 1) / G : 0;
  const int steps = G / kChunk;
  const int x0 = (tile % tiles_x) * kPgTile;
  const int y0 = (tile / tiles_x) * kPgTile;
  const float px[2] = {(float)(x0 + g), (float)(x0 + g + 8)};
  float py[M];
#pragma unroll
  for (int i = 0; i < M; ++i) py[i] = (float)(y0 + M * warp + i);
  // U in the fragments' pair order: slot q is pair 2q, slot q + 4 pair
  // 2q + 1, column g pair g; U[i][j] = 1 where pair i <= pair j.
  const float tri0 = 2 * q <= g ? 1.0f : 0.0f;
  const float tri1 = 2 * q + 1 <= g ? 1.0f : 0.0f;

  // Row i, pixel h (g, g + 8): T; the sums as after the block's lo/hi
  // shuffle (q even: r, g; q odd: b, depth; [2h], [2h + 1]).
  float T[M][2], acc[M][4];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T[i][0] = T[i][1] = 1.0f;
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  }
  float blocks = 0.0f;

  if (nblk > 0 && start + G <= n_pairs) {
    stage_async(rows[0], feat, stride, start, G, p);
  }
  for (int k = 0; k < nblk; ++k) {
    const int base = start + k * G;
    if (base + G > n_pairs) break;  // uniform over the CTA
    bool live = k == 0;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      live = live || T[i][0] > t_min || T[i][1] > t_min;
    }
    wait_staged();
    if (!__syncthreads_or(live)) break;
    if (k + 1 < nblk && base + 2 * G <= n_pairs) {
      stage_async(rows[(k + 1) & 1], feat, stride, base + G, G, p);
    }
    const float* f = rows[k & 1];
    for (int e = p; e < steps * kWarp; e += kPgThreads) {
      const int n = (e & (kWarp - 1)) >> 2;
      const float* c = f + (6 + (n & 3)) * G + (e / kWarp) * kChunk +
                       2 * (e & 3);
      bfrag[e] = make_float2(tf32_part(c[0], n >= 4),
                             tf32_part(c[1], n >= 4));
    }
    __syncthreads();

    // d: the block's sums (C fragments); run: T before the k-step (roll)
    // or the running sum of s before it (log), per row and pixel.
    float d[M][4], run[M][2];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.0f;
      run[i][0] = V == kPgRoll ? T[i][0] : 0.0f;
      run[i][1] = V == kPgRoll ? T[i][1] : 0.0f;
    }
    for (int c = 0; c < steps; ++c) {
      const int j = c * kChunk + 2 * q;
      const float2 u = *reinterpret_cast<const float2*>(f + j);
      const float2 v = *reinterpret_cast<const float2*>(f + G + j);
      const float2 ca = *reinterpret_cast<const float2*>(f + 2 * G + j);
      const float2 cb = *reinterpret_cast<const float2*>(f + 3 * G + j);
      const float2 cc = *reinterpret_cast<const float2*>(f + 4 * G + j);
      const float2 op = *reinterpret_cast<const float2*>(f + 5 * G + j);
      const float2 b = bfrag[c * kWarp + lane];
      // Entry e = 2h + t of row i: pixel h, pair j + t (the D layout).
      float a[M][4];
#pragma unroll
      for (int i = 0; i < M; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          a[i][2 * h] = pair_alpha(px[h], py[i], u.x, v.x, ca.x, cb.x, cc.x,
                                   op.x, chi2_clip, alpha_max, alpha_cutoff);
          a[i][2 * h + 1] = pair_alpha(px[h], py[i], u.y, v.y, ca.y, cb.y,
                                       cc.y, op.y, chi2_clip, alpha_max,
                                       alpha_cutoff);
        }
      }
      float s[M][4];
      if constexpr (V == kPgLog) {
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][e] = log1pf(-a[i][e]);
      }
#pragma unroll
      for (int i = 0; i < M; ++i) {
        float te[4];
        if constexpr (V == kPgRoll) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float m0 = 1.0f - a[i][2 * h];
            const float m1 = 1.0f - a[i][2 * h + 1];
            float x = m0 * m1;
            float y = __shfl_up_sync(kFull, x, 1, 4);
            if (q >= 1) x = y * x;
            y = __shfl_up_sync(kFull, x, 2, 4);
            if (q >= 2) x = y * x;
            y = __shfl_up_sync(kFull, x, 1, 4);
            const float before = q >= 1 ? y : 1.0f;
            const float total = __shfl_sync(kFull, x, 3, 4);
            te[2 * h] = run[i][h] * before;
            te[2 * h + 1] = te[2 * h] * m0;
            run[i][h] = run[i][h] * total;
          }
        } else {
          float hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hi[e] = tf32_round(s[i][e]);
            lo[e] = tf32_round(s[i][e] - hi[e]);
          }
          float pre[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_tf32(pre, hi[0], hi[2], hi[1], hi[3], tri0, tri1);
          mma_tf32(pre, lo[0], lo[2], lo[1], lo[3], tri0, tri1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float cum0 = run[i][h] + pre[2 * h];
            const float cum1 = run[i][h] + pre[2 * h + 1];
            run[i][h] = __shfl_sync(kFull, cum1, 3, 4);
            te[2 * h] = expf(cum0 - s[i][2 * h]) * T[i][h];
            te[2 * h + 1] = expf(cum1 - s[i][2 * h + 1]) * T[i][h];
          }
        }
        float whi[4], wlo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float w = te[e] > t_min ? a[i][e] * te[e] : 0.0f;
          whi[e] = tf32_round(w);
          wlo[e] = tf32_round(w - whi[e]);
        }
        mma_tf32(d[i], whi[0], whi[2], whi[1], whi[3], b.x, b.y);
        mma_tf32(d[i], wlo[0], wlo[2], wlo[1], wlo[3], b.x, b.y);
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lohi = d[i][e] + __shfl_xor_sync(kFull, d[i][e], 2);
        acc[i][e] = acc[i][e] + lohi;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        T[i][h] = V == kPgRoll ? run[i][h] : T[i][h] * expf(run[i][h]);
      }
    }
    blocks += 1.0f;
  }

  // Lanes q = 0, 1 write channels 2q, 2q + 1; q = 2 T and the blocks;
  // q = 3 the zero rows 6, 7. Pixel h of row i is (M w + i) 16 + g + 8h.
  float* o = out + (size_t)tile * 8 * kPgPixels;
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pix = (M * warp + i) * kPgTile + g + 8 * h;
      const float r0 = q < 2 ? acc[i][2 * h] : (q == 2 ? T[i][h] : 0.0f);
      const float r1 = q < 2 ? acc[i][2 * h + 1] : (q == 2 ? blocks : 0.0f);
      o[(2 * q) * kPgPixels + pix] = r0;
      o[(2 * q + 1) * kPgPixels + pix] = r1;
    }
  }
}

// Rounds n floats to their TF32 (hi, lo) split as the pg kernels do; a
// probe that holds raster_ablate.py::tf32_split_plain to the card's
// cvt.rna.
__global__ void tf32_split_kernel(const float* __restrict__ x,
                                  float* __restrict__ hi,
                                  float* __restrict__ lo, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    hi[i] = tf32_part(x[i], false);
    lo[i] = tf32_part(x[i], true);
  }
}


// K1's kernel with one of its ablation bodies (tile 16, up to 256 pairs a
// block), after K1's tile order.
template <int kBody>
cudaError_t launch_body(const void* feat, int n_pairs, int stride,
                        const void* tile_start, const void* tile_count,
                        void* order, void* out, void* skipped, int num_tiles,
                        int tiles_x, int G, float chi2_clip, float alpha_max,
                        float alpha_cutoff, float t_min, CullMargins cm,
                        cudaStream_t s) {
  tile_order_kernel<<<1, kOrderThreads, 0, s>>>(
      (const int*)tile_count, num_tiles, G, (int*)order);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  raster_fwd_kernel<16, 256, false, kBody><<<num_tiles, 256, 0, s>>>(
      (const float*)feat, n_pairs, stride, (const int*)tile_start,
      (const int*)tile_count, (const int*)order, (float*)out, nullptr,
      (unsigned long long*)skipped, tiles_x, 0, G, chi2_clip, alpha_max,
      alpha_cutoff, t_min, cm);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_pg(const void* feat, int n_pairs, int stride,
                      const void* tile_start, const void* tile_count,
                      void* out, int num_tiles, int tiles_x, int G,
                      float chi2_clip, float alpha_max, float alpha_cutoff,
                      float t_min, cudaStream_t s) {
  raster_pg_kernel<V><<<num_tiles, kPgThreads, 0, s>>>(
      (const float*)feat, n_pairs, stride, (const int*)tile_start,
      (const int*)tile_count, (float*)out, tiles_x, G, chi2_clip, alpha_max,
      alpha_cutoff, t_min);
  return cudaGetLastError();
}

}  // namespace

// Launches the variant (0 empty, 1 no-compute, 2 no-transc, 3 no-mxu,
// 4 no-input, 5 cumprod, 6 pg-roll, 7 pg-log) on `stream` and returns
// cudaGetLastError() (0 on success). Tile 16 and G a multiple of 32 up to
// 256 (cudaErrorInvalidValue otherwise). `order` is scratch for num_tiles
// ints (variants 0-5: K1's tile order). `skipped` may be null, else
// variants 2-5 add the (pair, warp) their cull skipped to *skipped, as K1
// does (no-input culls nothing). margin_rel, margin_eps, margin_abs and
// kappa_min are K1's cull margins.
extern "C" int raster_ablate(int variant, const void* feat, int n_pairs,
                             int stride, const void* tile_start,
                             const void* tile_count, void* order, void* out,
                             void* skipped, int num_tiles, int tiles_x,
                             int tile, int G, float chi2_clip,
                             float alpha_max, float alpha_cutoff, float t_min,
                             float margin_rel, float margin_eps,
                             float margin_abs, float kappa_min,
                             void* stream) {
  if (tile != kPgTile || G <= 0 || G > kPgMaxG || G % kWarp != 0 ||
      num_tiles < 0 || variant < 0 || variant > 7) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_tiles == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const CullMargins cm = {margin_rel, margin_eps, margin_abs, kappa_min};
  if (variant >= 6) {
    const auto pg = variant == 6 ? launch_pg<kPgRoll> : launch_pg<kPgLog>;
    return (int)pg(feat, n_pairs, stride, tile_start, tile_count, out,
                   num_tiles, tiles_x, G, chi2_clip, alpha_max,
                   alpha_cutoff, t_min, s);
  }
  using Launch = cudaError_t (*)(const void*, int, int, const void*,
                                 const void*, void*, void*, void*, int, int,
                                 int, float, float, float, float,
                                 CullMargins, cudaStream_t);
  constexpr Launch kBodies[] = {
      launch_body<kEmpty>,   launch_body<kNoCompute>, launch_body<kNoTransc>,
      launch_body<kNoMxu>,   launch_body<kNoInput>,   launch_body<kCumprod>,
  };
  return (int)kBodies[variant](feat, n_pairs, stride, tile_start, tile_count,
                               order, out, skipped, num_tiles, tiles_x, G,
                               chi2_clip, alpha_max, alpha_cutoff, t_min, cm,
                               s);
}


// The pg kernel of `variant` (6 pg-roll, 7 pg-log) on the current device:
// out[0] registers, out[1] static shared bytes, out[2] local bytes a
// thread (spills), out[3] resident CTAs per SM (the occupancy API).
// Returns the first CUDA error (cudaErrorInvalidValue for another
// variant).
extern "C" int raster_ablate_pg_resources(int variant, int* out) {
  if (variant != 6 && variant != 7) return (int)cudaErrorInvalidValue;
  const void* fn = variant == 6 ? (const void*)raster_pg_kernel<kPgRoll>
                                : (const void*)raster_pg_kernel<kPgLog>;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], fn, kPgThreads, 0);
}

// hi[i], lo[i] = the TF32 split of x[i] as the pg kernels take it
// (tf32_part), for n floats on `stream`; returns cudaGetLastError().
extern "C" int raster_ablate_tf32_split(const void* x, void* hi, void* lo,
                                        int n, void* stream) {
  if (n <= 0) return n < 0 ? (int)cudaErrorInvalidValue : 0;
  tf32_split_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)hi, (float*)lo, n);
  return (int)cudaGetLastError();
}
