// Forward tile compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel gsplat_tpu/ops/raster_pallas.py::_fwd_kernel
// (launched by _fwd_pallas). Same function: front-to-back alpha
// compositing of a tile-major, depth-ordered, block-aligned pair list,
// with the TPU kernel's block-granular saturation skip. Its plain PyTorch
// version is gsplat_tpu_torch/ops/raster_cuda.py::composite_pairs_plain.
//
// Design. The TPU kernel walks a sequential grid of (tile, block) steps
// and carries each tile's sums in its VMEM output block. CUDA blocks run
// in no order, so here one CTA owns one 16x16 tile, one thread per pixel,
// and walks the tile's cdiv(tile_count, G) blocks itself, with T and the
// four sums in registers:
//   * each block's 10 used feature rows (10 x G floats) are staged into
//     shared memory by a coalesced copy (the rows are feature-major);
//   * every thread then runs the G pairs in order; all threads read the
//     same pair at once, so shared-memory reads are broadcasts;
//   * before a continuation block, __syncthreads_or(T > T_min) decides
//     whether the tile goes on. T multiplies through every pair of a
//     composited block, so row 4 (and the alpha plane) keeps the TPU
//     kernel's block-granular meaning, and row 5 counts the blocks
//     composited (a later backward reads it as the active-block prefix);
//   * the [8, 256] output is written once, at the end;
//   * with a non-null `state` ([n_pairs / G, 5, 256] f32), each thread
//     writes its four sums (rows 0-3) and T (row 4) as they stand at the
//     start of every block it composites, at row base / G of the pair
//     list. Autograd asks for it: the backward (raster_bwd.cu) then runs
//     each composited block on its own. Serving passes null and writes
//     nothing; blocks not composited are left unwritten.
//
// Arithmetic. Built with -fmad=false, and every expression is evaluated
// in the plain version's order, so each (pair, pixel) alpha, T and
// T > T_min decision rounds as it does there. This is a choice for
// correctness first (kernel and plain version agree to 2e-5 abs); fused
// multiply-adds are a later speed step.
//
// Bound. Work grows with the ACTIVE pair-pixels (composited blocks x G x
// 256): about 24 f32 operations and one exp each, so the FLOP bound is
// active_blocks * G * 256 * 24 / 67 TFLOP/s. Bytes are the active feature
// blocks (10 x G x 4 B each) plus the 8 KiB output per tile, which is far
// less: the kernel is bound by operations (its exp and its dependent
// per-pair chain). The design does nothing about that yet beyond keeping
// every operand in registers or shared memory; tiles are also unbalanced
// (a CTA's time grows with its tile's active depth).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per CTA
constexpr int kRows = 10;               // u v a b c op r g b depth
constexpr int kMaxG = 256;

__global__ void __launch_bounds__(kPixels) raster_fwd_kernel(
    const float* __restrict__ feat, int n_pairs, int stride,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    float* __restrict__ out, float* __restrict__ state, int tiles_x, int G,
    float chi2_clip, float alpha_max, float alpha_cutoff, float t_min) {
  __shared__ float sm[kRows * kMaxG];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const int nblk = count > 0 ? (count + G - 1) / G : 0;
  const float px = (float)((tile % tiles_x) * kTile + p % kTile);
  const float py = (float)((tile / tiles_x) * kTile + p / kTile);

  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  float blocks = 0.0f;

  for (int k = 0; k < nblk; ++k) {
    // Saturation skip for continuation blocks. The barrier also keeps the
    // previous block's shared rows until every thread has used them.
    if (k > 0 && !__syncthreads_or(T > t_min)) break;
    const int base = start + k * G;
    if (base + G > n_pairs) break;  // uniform over the CTA; never on a
                                    // binning-made layout
    if (state != nullptr) {
      float* s = state + (size_t)(base / G) * 5 * kPixels + p;
      s[0 * kPixels] = acc_r;
      s[1 * kPixels] = acc_g;
      s[2 * kPixels] = acc_b;
      s[3 * kPixels] = acc_d;
      s[4 * kPixels] = T;
    }
    for (int i = p; i < kRows * G; i += kPixels) {
      const int r = i / G;
      const int c = i - r * G;
      sm[i] = feat[(size_t)r * stride + base + c];
    }
    __syncthreads();

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
    for (int j = 0; j < G; ++j) {
      const float du = px - su[j];
      const float dv = py - sv[j];
      const float q = sa[j] * du * du + 2.0f * sb[j] * du * dv +
                      sc[j] * dv * dv;
      const float g = q <= chi2_clip ? expf(-0.5f * q) : 0.0f;
      const float a_raw = so[j] * g;
      const float a = a_raw > alpha_max ? alpha_max : a_raw;
      const float alpha = a >= alpha_cutoff ? a : 0.0f;
      const float w = T > t_min ? alpha * T : 0.0f;
      acc_r = acc_r + w * sr[j];
      acc_g = acc_g + w * sg[j];
      acc_b = acc_b + w * sbl[j];
      acc_d = acc_d + w * sd[j];
      T = T * (1.0f - alpha);
    }
    blocks += 1.0f;
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

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `state` may be null (nothing written).
extern "C" int raster_fwd(const void* feat, int n_pairs, int stride,
                          const void* tile_start, const void* tile_count,
                          void* out, void* state, int num_tiles, int tiles_x,
                          int G, float chi2_clip, float alpha_max,
                          float alpha_cutoff, float t_min, void* stream) {
  if (G <= 0 || G > kMaxG || G % 32 != 0 || num_tiles < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_tiles == 0) return 0;
  raster_fwd_kernel<<<num_tiles, kPixels, 0, (cudaStream_t)stream>>>(
      (const float*)feat, n_pairs, stride, (const int*)tile_start,
      (const int*)tile_count, (float*)out, (float*)state, tiles_x, G,
      chi2_clip, alpha_max, alpha_cutoff, t_min);
  return (int)cudaGetLastError();
}
