// Instruction-class ablations of the forward compositor (K1) for Hopper
// (sm_90a).
//
// Replace four of the TPU bodies that scripts/profile_kernel.py times
// through run_variant: _kernel_empty, _kernel_no_compute,
// _kernel_no_transc and _kernel_no_mxu. Each is K1 (raster_fwd.cu) with
// one class of work taken out, so that K1's time minus the variant's
// reads off that class's cost:
//   * kEmpty: writes its tile's output and nothing else: no feature read,
//     no block walk. The launch and per-CTA floor.
//   * kNoCompute: stages each block's 10 feature rows into shared memory
//     exactly as K1 does, then reduces row 0 (u) in a fixed order (each
//     lane adds u[lane], u[lane+32], ... in turn, then five xor shuffles;
//     every warp does this for itself) and adds it to T. No skip rule.
//     The cost of staging the rows.
//   * kNoTransc: K1 with exp(-q/2) replaced by 1/(1+q/2) and the per-pair
//     product T*(1-alpha) by T_in*(1 + exclusive running sum of -alpha).
//     The cost of expf on the special-function unit (a divide stays).
//   * kNoMxu: K1's alpha with w = alpha*T_in for every pair of the block
//     and T_out = T_in*exp(sum log1p(-alpha)). The dependent per-pair T
//     chain is gone (the TPU body removed its matrix-unit cumsum; K1 on
//     Hopper has no matrix product to remove).
// Their plain PyTorch versions are
// gsplat_tpu_torch/ops/raster_ablate.py::ablate_plain.
//
// Design. K1's skeleton: one CTA per 16x16 tile, one thread per pixel,
// walking the tile's cdiv(tile_count, G) blocks with T and the four sums
// in registers, the 10 x G feature rows of each block staged into shared
// memory by a coalesced copy, and (kNoTransc, kNoMxu) K1's block-granular
// skip by __syncthreads_or(T > T_min) before a continuation block. The TPU
// bodies gate on "first block or max T > T_min" and ignore the dead bit,
// which is K1's rule on a layout with no dead blocks (the profiler's).
// Every variant writes its tile's whole [8, 256] output as K1 does: rows
// 0-3 the sums (0 where nothing is summed), row 4 T, row 5 the blocks
// composited, rows 6-7 zero. One template body, instantiated four times
// and dispatched by one launcher.
//
// Arithmetic. Built with -fmad=false like K1, every expression in the
// plain version's order, so kernel and plain version round alike.
//
// Bound. kNoTransc and kNoMxu are bound by operations, as K1 is: 29 and 26
// f32 operations per composited (pair, pixel) (counted in
// gsplat_tpu_torch/profile_kernel.py), against 10 x G x 4 B per block.
// kNoCompute and kEmpty are bound by bytes: the staged rows plus the
// 8 KiB output per tile, and the output alone. The design does nothing
// about either yet: these kernels measure K1's costs, they do not cut
// them.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per CTA
constexpr int kRows = 10;               // u v a b c op r g b depth
constexpr int kMaxG = 256;

enum Variant { kEmpty = 0, kNoCompute = 1, kNoTransc = 2, kNoMxu = 3 };

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
    __shared__ float sm[kRows * kMaxG];
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
      const int base = start + k * G;
      if (base + G > n_pairs) break;  // uniform over the CTA
      for (int i = p; i < kRows * G; i += kPixels) {
        const int r = i / G;
        const int c = i - r * G;
        sm[i] = feat[(size_t)r * stride + base + c];
      }
      __syncthreads();

      if constexpr (V == kNoCompute) {
        const int lane = p & 31;
        float s = sm[lane];
        for (int c = lane + 32; c < G; c += 32) s = s + sm[c];
        for (int off = 16; off > 0; off >>= 1) {
          s = s + __shfl_xor_sync(0xffffffffu, s, off);
        }
        T = T + s;
      } else {
        const float* su = sm;
        const float* sv = sm + G;
        const float* sa = sm + 2 * G;
        const float* sb = sm + 3 * G;
        const float* sc = sm + 4 * G;
        const float* so = sm + 5 * G;
        const float* sr = sm + 6 * G;
        const float* sg = sm + 7 * G;
        const float* sbl = sm + 8 * G;
        const float* sd = sm + 9 * G;
        // kNoTransc: running sum of s = -alpha; kNoMxu: of log1p(-alpha).
        float run = 0.0f;
        for (int j = 0; j < G; ++j) {
          const float du = px - su[j];
          const float dv = py - sv[j];
          const float q = sa[j] * du * du + 2.0f * sb[j] * du * dv +
                          sc[j] * dv * dv;
          float g;
          if constexpr (V == kNoTransc) {
            g = q <= chi2_clip ? 1.0f / (1.0f + 0.5f * q) : 0.0f;
          } else {
            g = q <= chi2_clip ? expf(-0.5f * q) : 0.0f;
          }
          const float a_raw = so[j] * g;
          const float a = a_raw > alpha_max ? alpha_max : a_raw;
          const float alpha = a >= alpha_cutoff ? a : 0.0f;
          float w;
          if constexpr (V == kNoTransc) {
            const float s = -alpha;
            run = run + s;
            const float t_excl = (1.0f + (run - s)) * T;
            w = t_excl > t_min ? alpha * t_excl : 0.0f;
          } else {
            w = T > t_min ? alpha * T : 0.0f;
            run = run + log1pf(-alpha);
          }
          acc_r = acc_r + w * sr[j];
          acc_g = acc_g + w * sg[j];
          acc_b = acc_b + w * sbl[j];
          acc_d = acc_d + w * sd[j];
        }
        if constexpr (V == kNoTransc) {
          T = T * (1.0f + run);
        } else {
          T = T * expf(run);
        }
      }
      blocks += 1.0f;
    }
  }

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
void launch(const void* feat, int n_pairs, int stride, const void* tile_start,
            const void* tile_count, void* out, int num_tiles, int tiles_x,
            int G, float chi2_clip, float alpha_max, float alpha_cutoff,
            float t_min, cudaStream_t stream) {
  raster_ablate_kernel<V><<<num_tiles, kPixels, 0, stream>>>(
      (const float*)feat, n_pairs, stride, (const int*)tile_start,
      (const int*)tile_count, (float*)out, tiles_x, G, chi2_clip, alpha_max,
      alpha_cutoff, t_min);
}

}  // namespace

// Launches the variant (0 empty, 1 no-compute, 2 no-transc, 3 no-mxu) on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int raster_ablate(int variant, const void* feat, int n_pairs,
                             int stride, const void* tile_start,
                             const void* tile_count, void* out,
                             int num_tiles, int tiles_x, int G,
                             float chi2_clip, float alpha_max,
                             float alpha_cutoff, float t_min, void* stream) {
  if (G <= 0 || G > kMaxG || G % 32 != 0 || num_tiles < 0 || variant < 0 ||
      variant > kNoMxu) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_tiles == 0) return 0;
  auto* fn = launch<kEmpty>;
  if (variant == kNoCompute) fn = launch<kNoCompute>;
  if (variant == kNoTransc) fn = launch<kNoTransc>;
  if (variant == kNoMxu) fn = launch<kNoMxu>;
  fn(feat, n_pairs, stride, tile_start, tile_count, out, num_tiles, tiles_x,
     G, chi2_clip, alpha_max, alpha_cutoff, t_min, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
