// The forward compositor's kernel (K1), the one source of K1 and of its
// instruction-class ablations.
//
// raster_fwd.cu instantiates raster_fwd_kernel<kTile, kMaxG, kLog> (the
// body kK1: K1 as serving and training run it; its design is described
// there). raster_ablate.cu instantiates the same template at tile 16,
// kMaxG 256, with one of the other bodies below, each K1 minus one class
// of work, so that K1's time minus the body's reads off that class's cost
// on the card and the two cannot drift apart. Every body keeps K1's launch
// (tile_order_kernel first: tiles heaviest first), its CTA of one thread
// per pixel in 8x4-pixel warps and its output write; the template
// parameter removes, at compile time, what the body leaves out:
//   * kEmpty (scripts/profile_kernel.py::_kernel_empty): the launch, the
//     tile order and the output write (T = 1, no block). Nothing read.
//   * kNoCompute (_kernel_no_compute): K1's staging of every block (the
//     registers' prefetch, the pair-major shared-memory store; the cull
//     values are not computed) and a fixed-order sum of the staged u (each
//     lane adds u[lane], u[lane + 32], ... in turn, then five xor shuffles;
//     every warp for itself), added to T. No cull, no alpha, no
//     saturation skip.
//   * kNoTransc (_kernel_no_transc): K1's walk with exp(-q/2) replaced by
//     1 / (1 + q/2) and the product T (1 - alpha) by a running sum of -alpha:
//     T_excl = (1 + (S - s)) T_in, T_out = T_in (1 + S). Its cull
//     threshold is derived for its own alpha (reach_threshold<true>):
//     1 / (1 + q/2) >= exp(-q/2), so K1's threshold would skip pairs that
//     are live here.
//   * kNoMxu (_kernel_no_mxu): K1's walk and alpha with no dependent
//     per-pair T chain: w = alpha T_in, T_out = T_in exp(sum log1p(-alpha)).
//     (The TPU body removed its matrix-unit cumsum; K1 on Hopper has no
//     matrix product, and its T chain is the serial dependence.)
//   * kNoInput (_kernel_no_input): K1's walk on iota features (row r of
//     pair j is j * 1e-3 + r, formed in registers) with the log-space T of
//     transmittance_math="log". Nothing is read or staged, so nothing can
//     be culled either: every warp walks every pair of every block.
//   * kCumprod (_kernel_cumprod): K1's walk with the two-level T: the
//     exclusive product within groups of 8 pairs (within) and over the
//     group totals (gpre), T_excl = (within gpre) T_in, T_out = T_in gpre.
//     A culled pair has 1 - alpha == 1, so folding a group into gpre when
//     the walk enters the next one it visits rounds as the full walk does.
// The read (kIndexed, K1's body only): false reads pair j's 10 rows from
// the feature-major pair list `feat` ([>= 10, stride] f32, row r at
// feat[r * stride + j]); true reads them from the depth-ordered table
// `feat` ([N, kTableRow] f32, one gaussian a row) at row pair_slot[j], as
// three aligned loads (two float4s and a float2), and zeros where
// pair_slot[j] < 0 (a padding slot). The staged floats are the same: the
// list is the table gathered by pair_slot, zeros at padding
// (ops/raster_cuda.py::gather_rows). Everything from the shared-memory
// store on is one code.
// A body skips a (pair, warp) only where its own alpha is exactly 0 at the
// warp's 32 pixels, where it changes no bit: w = 0, acc + 0 c == acc,
// T (1 - 0) == T, S + log1pf(-0) == S + -0 == S. Their plain PyTorch
// versions are gsplat_tpu_torch/ops/raster_ablate.py::ablate_plain.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kRows = 10;               // u v a b c op r g b depth
constexpr int kSlots = 3;               // float4s per staged pair
constexpr int kTableRow = 12;           // floats a row of the indexed table
constexpr int kWarpW = 8, kWarpH = 4;   // a warp's pixel patch
constexpr int kOrderThreads = 1024;
constexpr int kBuckets = 32;  // tile_order: block counts 0..30, 31 and up

// What an instantiation of raster_fwd_kernel computes (see the header).
enum Body {
  kK1 = 0,
  kEmpty = 1,
  kNoCompute = 2,
  kNoTransc = 3,
  kNoMxu = 4,
  kNoInput = 5,
  kCumprod = 6,
};

// The cull's margins, passed by the launcher from raster_cuda.py's
// CULL_MARGIN_REL, CULL_MARGIN_EPS, CULL_MARGIN_ABS and CULL_KAPPA_MIN.
struct CullMargins {
  float rel, eps, abs, kappa_min;
};

// The widened threshold t on a pixel's q beyond which pair f (10 rows)
// has alpha == 0, and the slope m = -b / a; see raster_fwd.cu's header.
// kRational: for alpha = op / (1 + q/2) (kNoTransc), which reaches the
// cutoff up to q = 2 (op / cutoff - 1) instead of 2 ln(op / cutoff).
// Operation order is raster_cuda.py::_reach_threshold's.
template <bool kRational = false>
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
  const float reach = kRational ? 2.0f * (op / alpha_cutoff - 1.0f)
                                : 2.0f * logf(op / alpha_cutoff);
  const float t = fminf(reach, chi2_clip);
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

// The indexed read of a block (kIndexed, see the header): thread tid's
// pairs base + tid + i * kPixels (i < kStage, tid + i * kPixels < G) into
// f[i], all their slots first, then the rows.
template <int kPixels, int kStage>
__device__ __forceinline__ void load_indexed(float (&f)[kStage][kRows],
                                             const float* __restrict__ table,
                                             const int* __restrict__ pair_slot,
                                             int base, int tid, int G) {
  int slot[kStage];
#pragma unroll
  for (int i = 0; i < kStage; ++i) {
    const int j = tid + i * kPixels;
    slot[i] = j < G ? pair_slot[base + j] : -1;
  }
#pragma unroll
  for (int i = 0; i < kStage; ++i) {
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
    float2 c = make_float2(0.0f, 0.0f);
    if (slot[i] >= 0) {
      const float4* row = reinterpret_cast<const float4*>(table) +
                          slot[i] * (kTableRow / 4);
      a = row[0];
      b = row[1];
      c = *reinterpret_cast<const float2*>(row + 2);
    }
    f[i][0] = a.x;
    f[i][1] = a.y;
    f[i][2] = a.z;
    f[i][3] = a.w;
    f[i][4] = b.x;
    f[i][5] = b.y;
    f[i][6] = b.z;
    f[i][7] = b.w;
    f[i][8] = c.x;
    f[i][9] = c.y;
  }
}

template <int kTile, int kMaxG, bool kLog, int kBody = kK1,
          bool kIndexed = false>
__global__ void __launch_bounds__(kTile * kTile) raster_fwd_kernel(
    const float* __restrict__ feat, int n_pairs, int stride,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    const int* __restrict__ order, float* __restrict__ out,
    float* __restrict__ state, unsigned long long* __restrict__ skipped,
    int tiles_x, int rows_mod, int G, float chi2_clip, float alpha_max,
    float alpha_cutoff, float t_min, CullMargins cm,
    const int* __restrict__ pair_slot = nullptr) {
  constexpr int kPixels = kTile * kTile;  // threads per CTA
  constexpr int kWarpsX = kTile / kWarpW;  // warp patches across the tile
  constexpr int kStage = (kMaxG + kPixels - 1) / kPixels;  // pairs a thread
                                                           // stages
  // What the body keeps of K1 (see the header).
  constexpr bool kReads = kBody != kEmpty && kBody != kNoInput;
  constexpr bool kWalks = kBody != kEmpty && kBody != kNoCompute;
  constexpr bool kCulls = kWalks && kBody != kNoInput;
  constexpr bool kRational = kBody == kNoTransc;
  constexpr bool kLogT = (kBody == kK1 && kLog) || kBody == kNoInput;
  static_assert(kTile % kWarpW == 0 && kTile % kWarpH == 0, "warp patches");
  static_assert(kMaxG % 32 == 0, "pair blocks are whole warps of pairs");
  static_assert(kBody == kK1 || !kLog, "the ablations take cumprod K1");
  static_assert(kBody == kK1 || !kIndexed, "the ablations read the list");
  __shared__ float4 sm[kReads ? kSlots * kMaxG : 1];

  const int tile = order[blockIdx.x];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int trow = rows_mod > 0 ? (tile / tiles_x) % rows_mod : tile / tiles_x;
  const int tx = (tile % tiles_x) * kTile + (warp % kWarpsX) * kWarpW;
  const int ty = trow * kTile + (warp / kWarpsX) * kWarpH;
  const int p = ((warp / kWarpsX) * kWarpH + lane / kWarpW) * kTile +
                (warp % kWarpsX) * kWarpW + lane % kWarpW;
  const float px = (float)(tx + lane % kWarpW);
  const float py = (float)(ty + lane / kWarpW);
  const float x0 = (float)tx, x1 = (float)(tx + kWarpW - 1);
  const float y0 = (float)ty;
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const int nblk = kBody != kEmpty && count > 0 ? (count + G - 1) / G : 0;

  float T = 1.0f;  // "log": T at the block's start, while in a block
  float S = 0.0f;  // "log": the block's running sum of log1pf(-alpha)
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  int blocks = 0;
  int reached = 0;  // (pair, warp) walked, uniform over the warp
  // Thread tid holds pairs tid + i * kPixels (< G) of the next block in
  // registers, loaded while the warps walk the current one.
  float f[kStage][kRows];
  if (kReads && nblk > 0 && start + G <= n_pairs) {
    if constexpr (kIndexed) {
      load_indexed<kPixels>(f, feat, pair_slot, start, tid, G);
    } else {
#pragma unroll
      for (int i = 0; i < kStage; ++i) {
        const int j = tid + i * kPixels;
        if (j < G) {
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            f[i][r] = feat[(size_t)r * stride + start + j];
        }
      }
    }
  }

  for (int k = 0; k < nblk; ++k) {
    // Saturation skip for continuation blocks (none in kNoCompute). The
    // barrier also keeps the previous block's shared pairs until every
    // warp has walked them.
    if (kBody == kNoCompute) {
      if (k > 0) __syncthreads();
    } else if (k > 0 && !__syncthreads_or(T > t_min)) {
      break;
    }
    const int base = start + k * G;
    if (base + G > n_pairs) break;  // uniform over the CTA: the list's
                                    // end (see the header)
    if (kBody == kK1 && state != nullptr) {
      float* s = state + (size_t)(base / G) * 5 * kPixels + p;
      s[0 * kPixels] = acc_r;
      s[1 * kPixels] = acc_g;
      s[2 * kPixels] = acc_b;
      s[3 * kPixels] = acc_d;
      s[4 * kPixels] = T;
    }
    if constexpr (kReads) {
#pragma unroll
      for (int i = 0; i < kStage; ++i) {
        const int j = tid + i * kPixels;
        if (j < G) {
          float m = 0.0f;
          const float t =
              kCulls ? reach_threshold<kRational>(f[i], chi2_clip,
                                                  alpha_cutoff, cm, &m)
                     : 0.0f;
          sm[kSlots * j + 0] =
              make_float4(f[i][0], f[i][1], f[i][2], f[i][3]);
          sm[kSlots * j + 1] =
              make_float4(f[i][4], f[i][5], f[i][6], f[i][7]);
          sm[kSlots * j + 2] = make_float4(f[i][8], f[i][9], t, m);
        }
      }
      __syncthreads();
      if (k + 1 < nblk && base + 2 * G <= n_pairs) {
        if constexpr (kIndexed) {
          load_indexed<kPixels>(f, feat, pair_slot, base + G, tid, G);
        } else {
#pragma unroll
          for (int i = 0; i < kStage; ++i) {
            const int j = tid + i * kPixels;
            if (j < G) {
#pragma unroll
              for (int r = 0; r < kRows; ++r)
                f[i][r] = feat[(size_t)r * stride + base + G + j];
            }
          }
        }
      }
    }

    if constexpr (kBody == kNoCompute) {
      float s = sm[kSlots * lane].x;
      for (int c = lane + 32; c < G; c += 32) s = s + sm[kSlots * c].x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s = s + __shfl_xor_sync(0xffffffffu, s, off);
      }
      T = T + s;
    }
    // kCumprod: the exclusive product within the current group of 8 pairs
    // and over the groups before it.
    [[maybe_unused]] float within = 1.0f, gpre = 1.0f;
    [[maybe_unused]] int group = 0;
    for (int w0 = 0; kWalks && w0 < G; w0 += 32) {
      unsigned mask = 0xffffffffu;
      if constexpr (kCulls) {
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
        mask = __ballot_sync(0xffffffffu, reach);
      }
      reached += __popc(mask);
      while (mask != 0u) {
        const int j = w0 + __ffs(mask) - 1;
        mask &= mask - 1u;
        float4 P, Q, R;
        if constexpr (kBody == kNoInput) {
          const float fj = (float)j * 1e-3f;
          P = make_float4(fj + 0.0f, fj + 1.0f, fj + 2.0f, fj + 3.0f);
          Q = make_float4(fj + 4.0f, fj + 5.0f, fj + 6.0f, fj + 7.0f);
          R = make_float4(fj + 8.0f, fj + 9.0f, 0.0f, 0.0f);
        } else {
          const float4* sj = sm + kSlots * j;
          P = sj[0];
          Q = sj[1];
          R = sj[2];
        }
        const float du = px - P.x;
        const float dv = py - P.y;
        const float q = P.z * du * du + 2.0f * P.w * du * dv +
                        Q.x * dv * dv;
        float g;
        if constexpr (kRational) {
          g = q <= chi2_clip ? 1.0f / (1.0f + 0.5f * q) : 0.0f;
        } else {
          // exp on every lane, then a select: a branch around it was slower
          const float e = expf(-0.5f * q);
          g = q <= chi2_clip ? e : 0.0f;
        }
        const float a_raw = Q.y * g;
        const float a = a_raw > alpha_max ? alpha_max : a_raw;
        const float alpha = a >= alpha_cutoff ? a : 0.0f;
        float Te = T;
        if constexpr (kLogT) {
          const float sl = log1pf(-alpha);
          S = S + sl;
          Te = expf(S - sl) * T;
        } else if constexpr (kRational) {
          const float sl = -alpha;
          S = S + sl;
          Te = (1.0f + (S - sl)) * T;
        } else if constexpr (kBody == kCumprod) {
          if ((j >> 3) != group) {  // the walk entered a later group
            gpre = gpre * within;
            within = 1.0f;
            group = j >> 3;
          }
          Te = (within * gpre) * T;
        }
        const float w = Te > t_min ? alpha * Te : 0.0f;
        acc_r = acc_r + w * Q.z;
        acc_g = acc_g + w * Q.w;
        acc_b = acc_b + w * R.x;
        acc_d = acc_d + w * R.y;
        if constexpr (kBody == kK1 && !kLog) {
          T = T * (1.0f - alpha);
        } else if constexpr (kBody == kNoMxu) {
          S = S + log1pf(-alpha);
        } else if constexpr (kBody == kCumprod) {
          within = within * (1.0f - alpha);
        }
      }
    }
    if constexpr (kLogT || kBody == kNoMxu) {
      T = T * expf(S);
      S = 0.0f;
    } else if constexpr (kRational) {
      T = T * (1.0f + S);
      S = 0.0f;
    } else if constexpr (kBody == kCumprod) {
      gpre = gpre * within;
      T = T * gpre;
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
  if (kWalks && skipped != nullptr && lane == 0 && blocks > 0) {
    atomicAdd(skipped, (unsigned long long)(blocks * G - reached));
  }
}

}  // namespace
