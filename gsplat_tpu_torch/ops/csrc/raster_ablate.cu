// Instruction-class ablations and alternative designs of the forward
// compositor (K1) for Hopper (sm_90a).
//
// Replace the eight bodies besides `full` that scripts/profile_kernel.py
// times through run_variant. Two templates, one launcher.
//
// raster_ablate_kernel<V>, K1's skeleton (raster_fwd.cu) with one class of
// work taken out or done another way, so that K1's time minus the
// variant's reads off that class's cost:
//   * kEmpty (_kernel_empty): writes its tile's output and nothing else:
//     no feature read, no block walk. The launch and per-CTA floor.
//   * kNoCompute (_kernel_no_compute): stages each block's 10 feature rows
//     into shared memory exactly as K1 does, then reduces row 0 (u) in a
//     fixed order (each lane adds u[lane], u[lane+32], ... in turn, then
//     five xor shuffles; every warp does this for itself) and adds it to T.
//     No skip rule. The cost of staging the rows.
//   * kNoTransc (_kernel_no_transc): K1 with exp(-q/2) replaced by
//     1/(1+q/2) and the per-pair product T*(1-alpha) by T_in*(1 + exclusive
//     running sum of -alpha). The cost of expf on the special-function unit
//     (a divide stays).
//   * kNoMxu (_kernel_no_mxu): K1's alpha with w = alpha*T_in for every
//     pair of the block and T_out = T_in*exp(sum log1p(-alpha)). The
//     dependent per-pair T chain is gone (the TPU body removed its
//     matrix-unit cumsum; K1 on Hopper has no matrix product to remove).
//   * kNoInput (_kernel_no_input): K1's arithmetic on iota features (row r
//     of pair j of every block is j*1e-3 + r) with log-space transmittance
//     (run += log1p(-alpha), T_excl = exp(run - s)*T_in, T_out =
//     T_in*exp(run)). Nothing is read from `feat` and nothing is staged.
//     With these features alpha is non-zero only near pixel (0, 0), so in
//     every other tile q > chi2_clip at every (pair, pixel).
//   * kCumprod (_kernel_cumprod): K1's function with T_excl a two-level
//     exclusive product of (1 - alpha): serial within groups of 8 pairs,
//     then serial over the group totals, T_excl = (within*gpre)*T_in,
//     T_out = T_in*gpre after the last group. One serial pass per thread,
//     with a dependent multiply chain of about 8 + G/8 instead of G.
//
// raster_pg_kernel<V>, the TPU's "pairs on lanes" layout (_kernel_pg): K1's
// function in a [P, G] orientation.
//   * One CTA per tile, 8 warps. Warp w takes its 32 pixels 32w..32w+31
//     one after another; lane l holds the pairs j = l + 32s (s < G/32) of
//     that pixel in registers (kMaxG/32 = 8 slots). The features stay in
//     shared memory (K1's coalesced copy); lane l reads the columns l+32s,
//     consecutive across the warp, so there are no bank conflicts.
//   * T along the pair axis is an inclusive doubling scan in the TPU body's
//     association: step k (1, 2, 4, ..., G/2) combines x[i] with the old
//     x[i-k] for every i >= k and with the identity elsewhere. For k < 32
//     the partner comes from lane (l-k)&31 by __shfl_sync (slot s-1 where
//     l < k), for k >= 32 from slot s - k/32 of the same lane.
//       - kPgRoll multiplies m = 1-alpha (identity 1); T_excl is the scan
//         shifted by one pair times T_in; T_out = T_in*x[G-1].
//       - kPgLog adds s = log1p(-alpha) (identity 0); T_excl =
//         exp(cum - s)*T_in; T_out = T_in*exp(cum[G-1]). The TPU body takes
//         this cumsum as an upper-triangular f32 (HIGHEST) matmul; TF32
//         wgmma would not keep f32, and a [G, G] mask product per pixel is
//         G times the scan's work, so no tensor core is used.
//   * The channel sums of w*colour go in a fixed order: slots in order
//     within a lane, then xor shuffles 16, 8, 4, 2, 1; every lane ends with
//     the same float. Lane i keeps pixel 32w+i's four sums and T in
//     registers, and the output is written once per tile (the TPU body's
//     [P, 8] scratch and per-tile flush).
//
// Every variant writes its tile's whole [8, 256] output as K1 does: rows
// 0-3 the sums (0 where nothing is summed), row 4 T, row 5 the blocks
// composited, rows 6-7 zero. All but kEmpty and kNoCompute skip a
// continuation block by K1's __syncthreads_or(T > T_min). The TPU bodies
// gate on "first block or max T > T_min" and ignore the dead bit, which is
// K1's rule on a layout with no dead blocks (the profiler's). Their plain
// PyTorch versions are gsplat_tpu_torch/ops/raster_ablate.py::ablate_plain.
//
// Arithmetic. Built with -fmad=false like K1, every expression in the
// plain version's order, so kernel and plain version round alike.
//
// Bound. Every variant but kNoCompute and kEmpty is bound by operations,
// as K1 is (f32 operations per composited (pair, pixel) are counted in
// gsplat_tpu_torch/profile_kernel.py), against 10 x G x 4 B per block
// (none for kNoInput). kNoCompute and kEmpty are bound by bytes: the staged
// rows plus the 8 KiB output per tile, and the output alone. The design
// does nothing about either yet: these kernels measure K1's costs and
// alternatives to its T chain, they do not cut them.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per CTA
constexpr int kRows = 10;               // u v a b c op r g b depth
constexpr int kMaxG = 256;
constexpr int kWarp = 32;
constexpr int kMaxSlots = kMaxG / kWarp;  // pairs per lane (pg layout)
constexpr unsigned kFull = 0xffffffffu;

enum Variant {
  kEmpty = 0,
  kNoCompute = 1,
  kNoTransc = 2,
  kNoMxu = 3,
  kNoInput = 4,
  kCumprod = 5,
  kPgRoll = 6,
  kPgLog = 7,
};

// Stages the 10 feature rows of the block at `base` into `sm` (row r at
// sm + r*G), one coalesced pass over the CTA.
__device__ __forceinline__ void stage_rows(float* sm,
                                           const float* __restrict__ feat,
                                           int stride, int base, int G,
                                           int p) {
  for (int i = p; i < kRows * G; i += kPixels) {
    const int r = i / G;
    const int c = i - r * G;
    sm[i] = feat[(size_t)r * stride + base + c];
  }
}

// K1's alpha for one (pair, pixel); with kRational (kNoTransc) the falloff
// exp(-q/2) becomes 1/(1+q/2).
template <bool kRational = false>
__device__ __forceinline__ float pair_alpha(float px, float py, float u,
                                            float v, float ca, float cb,
                                            float cc, float op,
                                            float chi2_clip, float alpha_max,
                                            float alpha_cutoff) {
  const float du = px - u;
  const float dv = py - v;
  const float q = ca * du * du + 2.0f * cb * du * dv + cc * dv * dv;
  float g = 0.0f;
  if (q <= chi2_clip) {
    g = kRational ? 1.0f / (1.0f + 0.5f * q) : expf(-0.5f * q);
  }
  const float a_raw = op * g;
  const float a = a_raw > alpha_max ? alpha_max : a_raw;
  return a >= alpha_cutoff ? a : 0.0f;
}

__device__ __forceinline__ void write_tile(float* __restrict__ out, int tile,
                                           int p, float acc_r, float acc_g,
                                           float acc_b, float acc_d, float T,
                                           float blocks) {
  float* o = out + (size_t)tile * 8 * kPixels + p;
  o[0 * kPixels] = acc_r;
  o[1 * kPixels] = acc_g;
  o[2 * kPixels] = acc_b;
  o[3 * kPixels] = acc_d;
  o[4 * kPixels] = T;
  o[5 * kPixels] = blocks;
  o[6 * kPixels] = 0.0f;
  o[7 * kPixels] = 0.0f;
}

template <int V>
__global__ void __launch_bounds__(kPixels) raster_ablate_kernel(
    const float* __restrict__ feat, int n_pairs, int stride,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    float* __restrict__ out, int tiles_x, int G, float chi2_clip,
    float alpha_max, float alpha_cutoff, float t_min) {
  const int tile = blockIdx.x;
  const int p = threadIdx.x;

  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  float blocks = 0.0f;

  if constexpr (V != kEmpty) {
    __shared__ float sm[V == kNoInput ? 1 : kRows * kMaxG];
    const int start = tile_start[tile];
    const int count = tile_count[tile];
    const int nblk = count > 0 ? (count + G - 1) / G : 0;
    [[maybe_unused]] const float px =
        (float)((tile % tiles_x) * kTile + p % kTile);
    [[maybe_unused]] const float py =
        (float)((tile / tiles_x) * kTile + p / kTile);

    for (int k = 0; k < nblk; ++k) {
      // The barrier also keeps the previous block's shared rows until
      // every thread has used them.
      if constexpr (V == kNoCompute) {
        if (k > 0) __syncthreads();
      } else {
        if (k > 0 && !__syncthreads_or(T > t_min)) break;
      }
      if constexpr (V != kNoInput) {
        const int base = start + k * G;
        if (base + G > n_pairs) break;  // uniform over the CTA
        stage_rows(sm, feat, stride, base, G, p);
        __syncthreads();
      }

      if constexpr (V == kNoCompute) {
        const int lane = p & 31;
        float s = sm[lane];
        for (int c = lane + 32; c < G; c += 32) s = s + sm[c];
        for (int off = 16; off > 0; off >>= 1) {
          s = s + __shfl_xor_sync(kFull, s, off);
        }
        T = T + s;
      } else {
        // kNoTransc: running sum of s = -alpha; kNoMxu, kNoInput: of
        // log1p(-alpha). kCumprod: within-group and group-prefix products.
        float run = 0.0f;
        [[maybe_unused]] float within = 1.0f;
        [[maybe_unused]] float gpre = 1.0f;
        for (int j = 0; j < G; ++j) {
          float fu, fv, fa, fb, fc, fo, fr, fg, fbl, fd;
          if constexpr (V == kNoInput) {
            const float fj = (float)j * 1e-3f;
            fu = fj + 0.0f;
            fv = fj + 1.0f;
            fa = fj + 2.0f;
            fb = fj + 3.0f;
            fc = fj + 4.0f;
            fo = fj + 5.0f;
            fr = fj + 6.0f;
            fg = fj + 7.0f;
            fbl = fj + 8.0f;
            fd = fj + 9.0f;
          } else {
            fu = sm[j];
            fv = sm[G + j];
            fa = sm[2 * G + j];
            fb = sm[3 * G + j];
            fc = sm[4 * G + j];
            fo = sm[5 * G + j];
            fr = sm[6 * G + j];
            fg = sm[7 * G + j];
            fbl = sm[8 * G + j];
            fd = sm[9 * G + j];
          }
          const float alpha = pair_alpha<V == kNoTransc>(
              px, py, fu, fv, fa, fb, fc, fo, chi2_clip, alpha_max,
              alpha_cutoff);
          float w;
          if constexpr (V == kNoTransc) {
            const float s = -alpha;
            run = run + s;
            const float t_excl = (1.0f + (run - s)) * T;
            w = t_excl > t_min ? alpha * t_excl : 0.0f;
          } else if constexpr (V == kNoMxu) {
            w = T > t_min ? alpha * T : 0.0f;
            run = run + log1pf(-alpha);
          } else if constexpr (V == kNoInput) {
            const float s = log1pf(-alpha);
            run = run + s;
            const float t_excl = expf(run - s) * T;
            w = t_excl > t_min ? alpha * t_excl : 0.0f;
          } else {  // kCumprod
            const float m = 1.0f - alpha;
            const float t_excl = (within * gpre) * T;
            w = t_excl > t_min ? alpha * t_excl : 0.0f;
            within = within * m;
            if ((j & 7) == 7) {  // the group of 8 ends: within is its total
              gpre = gpre * within;
              within = 1.0f;
            }
          }
          acc_r = acc_r + w * fr;
          acc_g = acc_g + w * fg;
          acc_b = acc_b + w * fbl;
          acc_d = acc_d + w * fd;
        }
        if constexpr (V == kNoTransc) {
          T = T * (1.0f + run);
        } else if constexpr (V == kCumprod) {
          T = T * gpre;
        } else {
          T = T * expf(run);
        }
      }
      blocks += 1.0f;
    }
  }
  write_tile(out, tile, p, acc_r, acc_g, acc_b, acc_d, T, blocks);
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
__global__ void __launch_bounds__(kPixels) raster_pg_kernel(
    const float* __restrict__ feat, int n_pairs, int stride,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    float* __restrict__ out, int tiles_x, int G, float chi2_clip,
    float alpha_max, float alpha_cutoff, float t_min) {
  __shared__ float sm[kRows * kMaxG];
  constexpr float kIdentity = V == kPgRoll ? 1.0f : 0.0f;

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & (kWarp - 1);
  const int warp = p / kWarp;
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const int nblk = count > 0 ? (count + G - 1) / G : 0;
  const int slots = G / kWarp;
  const int ox = (tile % tiles_x) * kTile;
  const int oy = (tile / tiles_x) * kTile;

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
      const float px = (float)(ox + pix % kTile);
      const float py = (float)(oy + pix / kTile);
      const float t_in = __shfl_sync(kFull, T, i);

      float alpha[kMaxSlots], x[kMaxSlots], s0[kMaxSlots];
#pragma unroll
      for (int s = 0; s < kMaxSlots; ++s) {
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
        float y[kMaxSlots];
#pragma unroll
        for (int s = 0; s < kMaxSlots; ++s) {
          if (s < slots) y[s] = __shfl_sync(kFull, x[s], (lane - step) & 31);
        }
#pragma unroll
        for (int s = 0; s < kMaxSlots; ++s) {
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
          for (int s = kMaxSlots - 1; s >= 0; --s) {
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
      for (int s = 1; s < kMaxSlots; ++s) {
        if (s == slots - 1) last = x[s];
      }
      last = __shfl_sync(kFull, last, kWarp - 1);

      float t_excl[kMaxSlots];
      if constexpr (V == kPgRoll) {
        // Exclusive product: the inclusive scan shifted by one pair.
        float y[kMaxSlots];
#pragma unroll
        for (int s = 0; s < kMaxSlots; ++s) {
          if (s < slots) y[s] = __shfl_sync(kFull, x[s], (lane - 1) & 31);
        }
#pragma unroll
        for (int s = 0; s < kMaxSlots; ++s) {
          if (s < slots) {
            const float excl =
                lane >= 1 ? y[s] : (s >= 1 ? y[s >= 1 ? s - 1 : 0] : 1.0f);
            t_excl[s] = excl * t_in;
          }
        }
      } else {
#pragma unroll
        for (int s = 0; s < kMaxSlots; ++s) {
          if (s < slots) t_excl[s] = expf(x[s] - s0[s]) * t_in;
        }
      }
      const float t_out =
          V == kPgRoll ? t_in * last : t_in * expf(last);

      float sum_r = 0.0f, sum_g = 0.0f, sum_b = 0.0f, sum_d = 0.0f;
#pragma unroll
      for (int s = 0; s < kMaxSlots; ++s) {
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

template <int V>
void launch(const void* feat, int n_pairs, int stride, const void* tile_start,
            const void* tile_count, void* out, int num_tiles, int tiles_x,
            int G, float chi2_clip, float alpha_max, float alpha_cutoff,
            float t_min, cudaStream_t stream) {
  if constexpr (V == kPgRoll || V == kPgLog) {
    raster_pg_kernel<V><<<num_tiles, kPixels, 0, stream>>>(
        (const float*)feat, n_pairs, stride, (const int*)tile_start,
        (const int*)tile_count, (float*)out, tiles_x, G, chi2_clip,
        alpha_max, alpha_cutoff, t_min);
  } else {
    raster_ablate_kernel<V><<<num_tiles, kPixels, 0, stream>>>(
        (const float*)feat, n_pairs, stride, (const int*)tile_start,
        (const int*)tile_count, (float*)out, tiles_x, G, chi2_clip,
        alpha_max, alpha_cutoff, t_min);
  }
}

}  // namespace

// Launches the variant (0 empty, 1 no-compute, 2 no-transc, 3 no-mxu,
// 4 no-input, 5 cumprod, 6 pg-roll, 7 pg-log) on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int raster_ablate(int variant, const void* feat, int n_pairs,
                             int stride, const void* tile_start,
                             const void* tile_count, void* out,
                             int num_tiles, int tiles_x, int G,
                             float chi2_clip, float alpha_max,
                             float alpha_cutoff, float t_min, void* stream) {
  if (G <= 0 || G > kMaxG || G % kWarp != 0 || num_tiles < 0 ||
      variant < 0 || variant > kPgLog) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_tiles == 0) return 0;
  using Launch = void (*)(const void*, int, int, const void*, const void*,
                          void*, int, int, int, float, float, float, float,
                          cudaStream_t);
  constexpr Launch kLaunch[] = {
      launch<kEmpty>,   launch<kNoCompute>, launch<kNoTransc>,
      launch<kNoMxu>,   launch<kNoInput>,   launch<kCumprod>,
      launch<kPgRoll>,  launch<kPgLog>,
  };
  kLaunch[variant](feat, n_pairs, stride, tile_start, tile_count, out,
                   num_tiles, tiles_x, G, chi2_clip, alpha_max, alpha_cutoff,
                   t_min, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
