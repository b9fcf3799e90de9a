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
//   raster_pg_kernel<V>: they are not K1 minus a class but K1's function
//   in another layout, the TPU's "pairs on lanes" [P, G] orientation
//   (pairs along the lanes of a warp, one pixel at a time, T as a
//   doubling scan along the pairs), which has no warp patch to cull and
//   nothing of K1's walk to share.
//     - One CTA per tile, 8 warps. Warp w takes its 32 pixels 32w..32w+31
//       one after another; lane l holds the pairs j = l + 32s (s < G/32)
//       of that pixel in registers (kPgMaxG/32 = 8 slots). The features
//       stay in shared memory (a coalesced copy); lane l reads the columns
//       l+32s, consecutive across the warp, so there are no bank
//       conflicts.
//     - T along the pair axis is an inclusive doubling scan in the TPU
//       body's association: step k (1, 2, 4, ..., G/2) combines x[i] with
//       the old x[i-k] for every i >= k and with the identity elsewhere.
//       For k < 32 the partner comes from lane (l-k)&31 by __shfl_sync
//       (slot s-1 where l < k), for k >= 32 from slot s - k/32 of the same
//       lane. kPgRoll multiplies m = 1-alpha (identity 1); T_excl is the
//       scan shifted by one pair times T_in; T_out = T_in*x[G-1]. kPgLog
//       adds s = log1p(-alpha) (identity 0); T_excl = exp(cum - s)*T_in;
//       T_out = T_in*exp(cum[G-1]). The TPU body takes this cumsum as an
//       upper-triangular f32 (HIGHEST) matmul; TF32 wgmma would not keep
//       f32, and a [G, G] mask product per pixel is G times the scan's
//       work, so no tensor core is used.
//     - The channel sums of w*colour go in a fixed order: slots in order
//       within a lane, then xor shuffles 16, 8, 4, 2, 1; every lane ends
//       with the same float. Lane i keeps pixel 32w+i's four sums and T in
//       registers, and the output is written once per tile (the TPU body's
//       [P, 8] scratch and per-tile flush).
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
// plain version's order, so kernel and plain version round alike.
//
// Bound. The bodies that walk K1's reached pairs (no-transc, no-mxu,
// cumprod) are bound as K1 is: the (pair, pixel) of the (pair, warp) their
// cull reaches plus the cull's own operations (no-transc by its own
// threshold), against 10 x G x 4 B per composited block and the output;
// no-input by every (pair, pixel), with no feature byte; no-compute and
// empty by bytes: the staged rows plus the 8 KiB output per tile, and the
// output alone (gsplat_tpu_torch/profile_kernel.py: bound_ms). These
// kernels measure K1's costs and alternatives to its T chain; nothing in
// them is tuned.

#include "raster_fwd_kernel.cuh"

namespace {

constexpr int kPgTile = 16;
constexpr int kPgPixels = kPgTile * kPgTile;  // threads per CTA
constexpr int kPgMaxG = 256;
constexpr int kWarp = 32;
constexpr int kPgSlots = kPgMaxG / kWarp;  // pairs per lane
constexpr unsigned kFull = 0xffffffffu;

enum PgMode { kPgRoll = 0, kPgLog = 1 };

// Stages the 10 feature rows of the block at `base` into `sm` (row r at
// sm + r*G), one coalesced pass over the CTA.
__device__ __forceinline__ void stage_rows(float* sm,
                                           const float* __restrict__ feat,
                                           int stride, int base, int G,
                                           int p) {
  for (int i = p; i < kRows * G; i += kPgPixels) {
    const int r = i / G;
    const int c = i - r * G;
    sm[i] = feat[(size_t)r * stride + base + c];
  }
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

__device__ __forceinline__ void write_tile(float* __restrict__ out, int tile,
                                           int p, float acc_r, float acc_g,
                                           float acc_b, float acc_d, float T,
                                           float blocks) {
  float* o = out + (size_t)tile * 8 * kPgPixels + p;
  o[0 * kPgPixels] = acc_r;
  o[1 * kPgPixels] = acc_g;
  o[2 * kPgPixels] = acc_b;
  o[3 * kPgPixels] = acc_d;
  o[4 * kPgPixels] = T;
  o[5 * kPgPixels] = blocks;
  o[6 * kPgPixels] = 0.0f;
  o[7 * kPgPixels] = 0.0f;
}

// x combined with y by the scan's operation (kPgRoll: product, kPgLog: sum).
template <int V>
__device__ __forceinline__ float combine(float x, float y) {
  if constexpr (V == kPgRoll) {
    return x * y;
  } else {
    return x + y;
  }
}

template <int V>
__global__ void __launch_bounds__(kPgPixels) raster_pg_kernel(
    const float* __restrict__ feat, int n_pairs, int stride,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    float* __restrict__ out, int tiles_x, int G, float chi2_clip,
    float alpha_max, float alpha_cutoff, float t_min) {
  __shared__ float sm[kRows * kPgMaxG];
  constexpr float kIdentity = V == kPgRoll ? 1.0f : 0.0f;

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & (kWarp - 1);
  const int warp = p / kWarp;
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const int nblk = count > 0 ? (count + G - 1) / G : 0;
  const int slots = G / kWarp;
  const int ox = (tile % tiles_x) * kPgTile;
  const int oy = (tile / tiles_x) * kPgTile;

  // Pixel p = 32*warp + lane: its sums and T.
  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  float blocks = 0.0f;

  for (int k = 0; k < nblk; ++k) {
    if (k > 0 && !__syncthreads_or(T > t_min)) break;
    const int base = start + k * G;
    if (base + G > n_pairs) break;  // uniform over the CTA
    stage_rows(sm, feat, stride, base, G, p);
    __syncthreads();

    for (int i = 0; i < kWarp; ++i) {
      const int pix = warp * kWarp + i;
      const float px = (float)(ox + pix % kPgTile);
      const float py = (float)(oy + pix / kPgTile);
      const float t_in = __shfl_sync(kFull, T, i);

      float alpha[kPgSlots], x[kPgSlots], s0[kPgSlots];
#pragma unroll
      for (int s = 0; s < kPgSlots; ++s) {
        if (s < slots) {
          const int j = lane + kWarp * s;
          alpha[s] = pair_alpha(px, py, sm[j], sm[G + j], sm[2 * G + j],
                                sm[3 * G + j], sm[4 * G + j], sm[5 * G + j],
                                chi2_clip, alpha_max, alpha_cutoff);
          if constexpr (V == kPgRoll) {
            x[s] = 1.0f - alpha[s];
          } else {
            s0[s] = log1pf(-alpha[s]);
            x[s] = s0[s];
          }
        }
      }

      // Inclusive doubling scan along the pair axis, steps 1..16: the
      // partner of pair i = lane + 32s is pair i-k, in lane (lane-k)&31,
      // slot s (lane >= k) or s-1 (lane < k); pairs i < k take identity.
#pragma unroll
      for (int e = 0; e < 5; ++e) {
        const int step = 1 << e;
        float y[kPgSlots];
#pragma unroll
        for (int s = 0; s < kPgSlots; ++s) {
          if (s < slots) y[s] = __shfl_sync(kFull, x[s], (lane - step) & 31);
        }
#pragma unroll
        for (int s = 0; s < kPgSlots; ++s) {
          if (s < slots) {
            const float partner =
                lane >= step ? y[s] : (s >= 1 ? y[s >= 1 ? s - 1 : 0]
                                              : kIdentity);
            x[s] = combine<V>(x[s], partner);
          }
        }
      }
      // Steps 32, 64, 128: the partner is slot s - step/32 of this lane.
      // Slots go high to low so that each reads its partner's old value.
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const int q = 1 << e;
        if (q < slots) {
#pragma unroll
          for (int s = kPgSlots - 1; s >= 0; --s) {
            if (s < slots) {
              x[s] = combine<V>(x[s], s >= q ? x[s >= q ? s - q : 0]
                                             : kIdentity);
            }
          }
        }
      }

      // x[G-1] sits in lane 31, slot slots-1.
      float last = x[0];
#pragma unroll
      for (int s = 1; s < kPgSlots; ++s) {
        if (s == slots - 1) last = x[s];
      }
      last = __shfl_sync(kFull, last, kWarp - 1);

      float t_excl[kPgSlots];
      if constexpr (V == kPgRoll) {
        // Exclusive product: the inclusive scan shifted by one pair.
        float y[kPgSlots];
#pragma unroll
        for (int s = 0; s < kPgSlots; ++s) {
          if (s < slots) y[s] = __shfl_sync(kFull, x[s], (lane - 1) & 31);
        }
#pragma unroll
        for (int s = 0; s < kPgSlots; ++s) {
          if (s < slots) {
            const float excl =
                lane >= 1 ? y[s] : (s >= 1 ? y[s >= 1 ? s - 1 : 0] : 1.0f);
            t_excl[s] = excl * t_in;
          }
        }
      } else {
#pragma unroll
        for (int s = 0; s < kPgSlots; ++s) {
          if (s < slots) t_excl[s] = expf(x[s] - s0[s]) * t_in;
        }
      }
      const float t_out =
          V == kPgRoll ? t_in * last : t_in * expf(last);

      float sum_r = 0.0f, sum_g = 0.0f, sum_b = 0.0f, sum_d = 0.0f;
#pragma unroll
      for (int s = 0; s < kPgSlots; ++s) {
        if (s < slots) {
          const int j = lane + kWarp * s;
          const float w = t_excl[s] > t_min ? alpha[s] * t_excl[s] : 0.0f;
          const float cr = w * sm[6 * G + j];
          const float cg = w * sm[7 * G + j];
          const float cb = w * sm[8 * G + j];
          const float cd = w * sm[9 * G + j];
          if (s == 0) {
            sum_r = cr;
            sum_g = cg;
            sum_b = cb;
            sum_d = cd;
          } else {
            sum_r = sum_r + cr;
            sum_g = sum_g + cg;
            sum_b = sum_b + cb;
            sum_d = sum_d + cd;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum_r = sum_r + __shfl_xor_sync(kFull, sum_r, off);
        sum_g = sum_g + __shfl_xor_sync(kFull, sum_g, off);
        sum_b = sum_b + __shfl_xor_sync(kFull, sum_b, off);
        sum_d = sum_d + __shfl_xor_sync(kFull, sum_d, off);
      }
      if (lane == i) {
        acc_r = acc_r + sum_r;
        acc_g = acc_g + sum_g;
        acc_b = acc_b + sum_b;
        acc_d = acc_d + sum_d;
        T = t_out;
      }
    }
    blocks += 1.0f;
  }
  write_tile(out, tile, p, acc_r, acc_g, acc_b, acc_d, T, blocks);
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
  raster_pg_kernel<V><<<num_tiles, kPgPixels, 0, s>>>(
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
