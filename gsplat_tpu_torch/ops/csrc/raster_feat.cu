// Feature compositors for Hopper (sm_90a): F1 (forward) and F2 (backward)
// of Feature 3DGS (Zhou et al., CVPR 2024), beside K1 and K2.
//
// Each gaussian i carries a feature vector f_i of C floats (C a multiple
// of 32), composited with colour's own weights:
//     F_c(p) = sum_i w_i(p) f_i,c,   w_i = alpha_i T_i (0 where T_i <=
//     transmittance_min),
// the same alpha, cutoffs, block-granular saturation and transmittance as
// K1's frame (raster_fwd.cu). Their plain PyTorch versions are
// gsplat_tpu_torch/ops/raster_feat.py::composite_features_plain and
// composite_features_bwd_plain.
//
// Design.
//   * The features are read by gaussian, never gathered per pair: a pair's
//     row is fsem[depth_order[pair_slot[j]]], looked up inside the kernel,
//     and only for the pairs some warp of the tile reaches. No [C, pairs]
//     buffer exists on the path; at 128 channels it would take 18 GB at
//     36 M pair slots.
//   * K1 and K2 are not touched. F1 re-walks each tile with K1's own
//     arithmetic (-fmad=false, K1's order of operations, K1's per-warp
//     pair cull from raster_fwd_kernel.cuh) and walks exactly the blocks
//     K1 composited (K1's output row 5), so its weights are K1's bit for
//     bit. Folding C accumulators into K1 would take it from 40 registers
//     and 6 CTAs per SM to well over 100 and 2, for RGB frames too.
//   * A CTA owns one tile (16 x 16, one thread per pixel in K1's 8x4-pixel
//     warps) and one group of kCC = 32 channels: the grid is num_tiles x
//     C / 32. A thread keeps its pixel's 32 sums (F1) or 32 cotangents
//     (F2) in registers; the alpha walk is repeated once per group (about
//     26 operations against 64 per channel group and (pair, pixel)).
//   * Per block: each thread stages one pair's 10 rows and cull values in
//     shared memory, pair-major (K1's 48-byte layout); each warp makes its
//     reach masks (K1's cull) and ORs them into the block's; the CTA then
//     loads the 32-channel slice of each reached pair's feature row
//     (coalesced 16-byte loads, 128 B a pair) and the warps walk their
//     reached pairs. A pair whose weight is 0 at all 32 pixels of the warp
//     adds nothing and is skipped (acc + 0 f == acc for finite f).
//   * F1's sums are sequential over the pairs in list order, as the plain
//     version's running sum: F1 equals it bit for bit. The map is written
//     once, [C, H, W], pixels inside the image only.
//
// F2, the backward, walks each tile the same way from its start, carrying
// T and gP = sum_c gF_c(p) * (F prefix)_c(p) in registers (the feature
// prefix at a block's start is not saved: it would be C floats a pixel and
// block), and per (pair, pixel) works out
//     gdotf = gF(p) . f_j,  gP += gdotf w,  gS = gF(p) . F(p) - gP,
//     dalpha = [alive] (gdotf T_excl
//                       - gS / max(1 - alpha, 1 - alpha_max)),
// which is K2's dalpha with the feature channels as further colour
// channels (no final-transmittance term), gated and carried to the six
// geometry partials (u, v, conic, opacity) as K2 carries its own. Past
// saturation (T_excl <= transmittance_min) every later weight of the
// pixel is 0, so gS is 0 there but for rounding: [alive] keeps the exact
// zero, and once no lane of a warp is alive the warp walks no further
// pair of the tile (T only falls). Over a
// channel group gdotf and gS are partial sums; the partials are linear in
// dalpha, so the groups' partials add up to the whole.
//   * d(f_j) = sum_p w_j(p) gF(p) per pair, where some lane's weight is
//     not 0 (gF . f_j only matters there too; past saturation w is 0 and
//     only the alpha gradient is left): the warp reduces its 32
//     lanes' products by recursive halving (31 shuffles leave lane c with
//     channel c's sum) and adds it into a per-block shared buffer
//     [G][32] (shared atomics: warps of the tile meet there); at the
//     block's end the CTA adds each reached pair's row into d(fsem)
//     [N, C] with global float atomics, at the gaussian's own index.
//   * the six geometry partials: the same reduction (9 shuffles), a
//     shared [6][G] buffer, then global float atomics into K2's output
//     rows 0-5 (K2 wrote them first, on the same stream), which the
//     existing keyed reduction then sums per gaussian.
// So F2 is not deterministic: the order of its float atomics changes from
// run to run, at rounding level. K2 and the keyed reduction stay as they
// are.
//
// Shared memory (dynamic, by G): F1 180 G + 288 B (23.3 KiB at G = 128),
// F2 332 G + 288 B (42.8 KiB at G = 128, 85.3 KiB at 256; the launcher
// raises F2's limit once).
//
// Scope: tile 16, G a multiple of 32 up to 256, transmittance_math
// "cumprod", one view (no rows_mod), the whole list (no compact backward).
// The launchers return cudaErrorInvalidValue otherwise; raster_feat.py
// checks first and says why.

#include "raster_fwd_kernel.cuh"

namespace {

constexpr int kTileF = 16;
constexpr int kPixelsF = kTileF * kTileF;  // threads a CTA
constexpr int kWarpsF = kPixelsF / 32;
constexpr int kWarpsXF = kTileF / kWarpW;
constexpr int kCC = 32;  // channels a CTA
constexpr int kCC4 = kCC / 4;
constexpr int kMaxGF = 256;
constexpr int kGeo = 6;  // u v a b c op
constexpr unsigned kAll = 0xffffffffu;

// The shared-memory layout of one CTA for pair block G.
struct Smem {
  float4* sm;       // [3 G]: u v a b | c op r g | b depth t m
  float4* fs;       // [G][kCC4]: the reached pairs' channel slices
  float* dfs;       // [G][kCC] (F2): d f sums of the block
  float* gsum;      // [kGeo][G] (F2): geometry partial sums
  int* gid;         // [G]: the gaussian of each reached pair, else -1
  unsigned* wmask;  // [kWarpsF][kMaxGF / 32]: each warp's reach masks
  unsigned* need;   // [kMaxGF / 32]: their union
};

__host__ __device__ constexpr size_t smem_bytes(int G, bool bwd) {
  return (size_t)G * (48 + 16 * kCC4 + 4) +
         (bwd ? (size_t)G * (4 * kCC + 4 * kGeo) : 0) +
         (size_t)(kWarpsF + 1) * (kMaxGF / 32) * 4;
}

__device__ __forceinline__ Smem carve(char* base, int G, bool bwd) {
  Smem s;
  s.sm = (float4*)base;
  s.fs = s.sm + 3 * G;
  char* p = (char*)(s.fs + G * kCC4);
  s.dfs = (float*)p;
  if (bwd) p += (size_t)G * 4 * kCC;
  s.gsum = (float*)p;
  if (bwd) p += (size_t)G * 4 * kGeo;
  s.gid = (int*)p;
  p += (size_t)G * 4;
  s.wmask = (unsigned*)p;
  s.need = s.wmask + kWarpsF * (kMaxGF / 32);
  return s;
}

// A thread's pixel in K1's layout and its warp's patch.
struct Pixel {
  int gx, gy;          // image column and row
  float px, py;        // the same as floats
  float x0, x1, y0;    // the warp's patch
};

__device__ __forceinline__ Pixel pixel_of(int tile, int tiles_x, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int tx = (tile % tiles_x) * kTileF + (warp % kWarpsXF) * kWarpW;
  const int ty = (tile / tiles_x) * kTileF + (warp / kWarpsXF) * kWarpH;
  Pixel p;
  p.gx = tx + lane % kWarpW;
  p.gy = ty + lane / kWarpW;
  p.px = (float)p.gx;
  p.py = (float)p.gy;
  p.x0 = (float)tx;
  p.x1 = (float)(tx + kWarpW - 1);
  p.y0 = (float)ty;
  return p;
}

// Stage block `base`: every pair's rows and cull values (one pair a
// thread), each warp's reach masks and their union, then the channel
// slice [cg * kCC, (cg + 1) * kCC) of every reached pair's feature row
// with its gaussian. Ends with a barrier.
__device__ __forceinline__ void stage_block(
    const Smem& s, const float* __restrict__ feat, int stride, int base,
    int G, const int* __restrict__ pair_slot,
    const int* __restrict__ depth_order, const float4* __restrict__ fsem4,
    int C4, int cg, const Pixel& px, float chi2_clip, float alpha_cutoff,
    const CullMargins& cm, bool bwd) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid < G) {
    float f[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) f[r] = feat[(size_t)r * stride + base + tid];
    float m = 0.0f;
    const float t = reach_threshold<false>(f, chi2_clip, alpha_cutoff, cm, &m);
    s.sm[3 * tid + 0] = make_float4(f[0], f[1], f[2], f[3]);
    s.sm[3 * tid + 1] = make_float4(f[4], f[5], f[6], f[7]);
    s.sm[3 * tid + 2] = make_float4(f[8], f[9], t, m);
    s.gid[tid] = -1;
  }
  if (tid < kMaxGF / 32) s.need[tid] = 0u;
  if (bwd) {
    for (int i = tid; i < G * kCC; i += kPixelsF) s.dfs[i] = 0.0f;
    for (int i = tid; i < G * kGeo; i += kPixelsF) s.gsum[i] = 0.0f;
  }
  __syncthreads();
  // K1's cull: lane `lane` tests pair w0 + lane against the warp's patch.
  for (int w0 = 0; w0 < G; w0 += 32) {
    const float4* q4 = s.sm + 3 * (w0 + lane);
    const float4 A = q4[0], B = q4[1], Cc = q4[2];
    const float lo = px.x0 - A.x, hi = px.x1 - A.x;
    bool reach = false;
#pragma unroll
    for (int r = 0; r < kWarpH; ++r) {
      const float dv = (px.y0 + (float)r) - A.y;
      const float du = fminf(fmaxf(Cc.w * dv, lo), hi);
      const float q = A.z * du * du + 2.0f * A.w * du * dv + B.x * dv * dv;
      reach = reach || !(q > Cc.z);
    }
    const unsigned mask = __ballot_sync(kAll, reach);
    if (lane == 0) {
      s.wmask[warp * (kMaxGF / 32) + (w0 >> 5)] = mask;
      if (mask != 0u) atomicOr(&s.need[w0 >> 5], mask);
    }
  }
  __syncthreads();
  for (int i = tid; i < G * kCC4; i += kPixelsF) {
    const int j = i / kCC4, q = i - j * kCC4;
    if ((s.need[j >> 5] >> (j & 31)) & 1u) {
      const int slot = pair_slot[base + j];
      const int g = slot >= 0 ? depth_order[slot] : -1;
      s.fs[i] = g >= 0 ? fsem4[(size_t)g * C4 + cg * kCC4 + q]
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q == 0) s.gid[j] = g;
    }
  }
  __syncthreads();
}

// alpha of pair (P, Q) at pixel (px, py), in K1's order of operations,
// with the terms the backward reuses.
struct Alpha {
  float du, dv, g, a_raw, a, alpha;
};

__device__ __forceinline__ Alpha alpha_of(const float4& P, const float4& Q,
                                          float px, float py,
                                          float chi2_clip, float alpha_max,
                                          float alpha_cutoff) {
  Alpha r;
  r.du = px - P.x;
  r.dv = py - P.y;
  const float q = P.z * r.du * r.du + 2.0f * P.w * r.du * r.dv +
                  Q.x * r.dv * r.dv;
  const float e = expf(-0.5f * q);
  r.g = q <= chi2_clip ? e : 0.0f;
  r.a_raw = Q.y * r.g;
  r.a = r.a_raw > alpha_max ? alpha_max : r.a_raw;
  r.alpha = r.a >= alpha_cutoff ? r.a : 0.0f;
  return r;
}

// One step of recursive halving over the warp: lanes whose bit kStep is
// set keep the upper kHalf of v[0 .. 2 kHalf) and send the lower, the
// others the reverse; each adds what its partner sent. Template steps keep
// every index a constant, so v stays in registers.
template <int kHalf, int kStep, int kN>
__device__ __forceinline__ void halve(float (&v)[kN], int lane) {
  const bool up = lane & kStep;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float mine = up ? v[kHalf + i] : v[i];
    const float other = up ? v[i] : v[kHalf + i];
    v[i] = mine + __shfl_xor_sync(kAll, other, kStep);
  }
}

// The sum over the warp's lanes of v[i], for i = lane (16 + 8 + 4 + 2 + 1
// shuffles).
__device__ __forceinline__ float warp_sum_32(float (&v)[32], int lane) {
  halve<16, 16>(v, lane);
  halve<8, 8>(v, lane);
  halve<4, 4>(v, lane);
  halve<2, 2>(v, lane);
  halve<1, 1>(v, lane);
  return v[0];
}

// The sum over the warp of v[i] (8 values, the last two padding), for i =
// lane >> 2: three halving steps, then two plain ones (9 shuffles).
__device__ __forceinline__ float warp_sum_8(float (&v)[8], int lane) {
  halve<4, 16>(v, lane);
  halve<2, 8>(v, lane);
  halve<1, 4>(v, lane);
  const float s = v[0] + __shfl_xor_sync(kAll, v[0], 2);
  return s + __shfl_xor_sync(kAll, s, 1);
}

__global__ void __launch_bounds__(kPixelsF) feat_fwd_kernel(
    const float* __restrict__ feat, int stride,
    const int* __restrict__ pair_slot, const int* __restrict__ depth_order,
    const float* __restrict__ fsem, int C, const int* __restrict__ tile_start,
    const float* __restrict__ fwd, float* __restrict__ fmap, int tiles_x,
    int H, int W, int G, float chi2_clip, float alpha_max,
    float alpha_cutoff, float t_min, CullMargins cm) {
  extern __shared__ __align__(16) char smem_raw[];
  const Smem s = carve(smem_raw, G, false);
  const int tile = blockIdx.x, cg = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5;
  const Pixel px = pixel_of(tile, tiles_x, tid);
  const int nblk = (int)fwd[((size_t)tile * 8 + 5) * kPixelsF];
  const int start = tile_start[tile];
  const float4* fsem4 = (const float4*)fsem;

  float acc[kCC];
#pragma unroll
  for (int c = 0; c < kCC; ++c) acc[c] = 0.0f;
  float T = 1.0f;
  for (int k = 0; k < nblk; ++k) {
    const int base = start + k * G;
    __syncthreads();  // the previous block's shared pairs are walked
    stage_block(s, feat, stride, base, G, pair_slot, depth_order, fsem4,
                C / 4, cg, px, chi2_clip, alpha_cutoff, cm, false);
    for (int w0 = 0; w0 < G; w0 += 32) {
      unsigned mask = s.wmask[warp * (kMaxGF / 32) + (w0 >> 5)];
      while (mask != 0u) {
        const int j = w0 + __ffs(mask) - 1;
        mask &= mask - 1u;
        const Alpha a = alpha_of(s.sm[3 * j], s.sm[3 * j + 1], px.px, px.py,
                                 chi2_clip, alpha_max, alpha_cutoff);
        const float Te = T;
        const float w = Te > t_min ? a.alpha * Te : 0.0f;
        if (__any_sync(kAll, w != 0.0f)) {
          const float4* fj = s.fs + j * kCC4;
#pragma unroll
          for (int q = 0; q < kCC4; ++q) {
            const float4 v = fj[q];
            acc[4 * q + 0] = acc[4 * q + 0] + w * v.x;
            acc[4 * q + 1] = acc[4 * q + 1] + w * v.y;
            acc[4 * q + 2] = acc[4 * q + 2] + w * v.z;
            acc[4 * q + 3] = acc[4 * q + 3] + w * v.w;
          }
        }
        T = T * (1.0f - a.alpha);
      }
    }
  }
  if (px.gx < W && px.gy < H) {
    const size_t hw = (size_t)H * W;
    float* o = fmap + (size_t)cg * kCC * hw + (size_t)px.gy * W + px.gx;
#pragma unroll
    for (int c = 0; c < kCC; ++c) o[c * hw] = acc[c];
  }
}

__global__ void __launch_bounds__(kPixelsF) feat_bwd_kernel(
    const float* __restrict__ feat, int stride,
    const int* __restrict__ pair_slot, const int* __restrict__ depth_order,
    const float* __restrict__ fsem, int C, const int* __restrict__ tile_start,
    const float* __restrict__ fwd, const float* __restrict__ fmap,
    const float* __restrict__ gfmap, float* __restrict__ dgeo, int dstride,
    float* __restrict__ dfsem, int tiles_x, int H, int W, int G,
    float chi2_clip, float alpha_max, float alpha_cutoff,
    float one_minus_max, float t_min, CullMargins cm) {
  extern __shared__ __align__(16) char smem_raw[];
  const Smem s = carve(smem_raw, G, true);
  const int tile = blockIdx.x, cg = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Pixel px = pixel_of(tile, tiles_x, tid);
  const int nblk = (int)fwd[((size_t)tile * 8 + 5) * kPixelsF];
  const int start = tile_start[tile];
  const float4* fsem4 = (const float4*)fsem;

  // This pixel's cotangent of the group's channels, and gF . F.
  float gF[kCC];
  float gS_full = 0.0f;
  {
    const bool inside = px.gx < W && px.gy < H;
    const size_t hw = (size_t)H * W;
    const size_t o = (size_t)cg * kCC * hw + (size_t)px.gy * W + px.gx;
#pragma unroll
    for (int c = 0; c < kCC; ++c) {
      gF[c] = inside ? gfmap[o + c * hw] : 0.0f;
      gS_full = gS_full + gF[c] * (inside ? fmap[o + c * hw] : 0.0f);
    }
  }
  float T = 1.0f, gP = 0.0f;
  bool live = true;  // some lane of the warp is not saturated
  for (int k = 0; k < nblk; ++k) {
    const int base = start + k * G;
    __syncthreads();  // the previous block's sums are flushed
    stage_block(s, feat, stride, base, G, pair_slot, depth_order, fsem4,
                C / 4, cg, px, chi2_clip, alpha_cutoff, cm, true);
    for (int w0 = 0; w0 < G && live; w0 += 32) {
      unsigned mask = s.wmask[warp * (kMaxGF / 32) + (w0 >> 5)];
      while (mask != 0u) {
        const float Te = T;
        const bool alive = Te > t_min;
        if (!__any_sync(kAll, alive)) {  // nothing left to add
          live = false;
          break;
        }
        const int j = w0 + __ffs(mask) - 1;
        mask &= mask - 1u;
        const float4 P = s.sm[3 * j], Q = s.sm[3 * j + 1];
        const Alpha a = alpha_of(P, Q, px.px, px.py, chi2_clip, alpha_max,
                                 alpha_cutoff);
        const float w = alive ? a.alpha * Te : 0.0f;
        // gdotf matters only where w != 0: elsewhere alpha == 0 (the gate
        // is shut) or the pixel is saturated (w and [alive] are 0).
        const bool weighs = __any_sync(kAll, w != 0.0f);
        float gdotf = 0.0f;
        if (weighs) {
          const float4* fj = s.fs + j * kCC4;
#pragma unroll
          for (int q = 0; q < kCC4; ++q) {
            const float4 v = fj[q];
            gdotf = gdotf + gF[4 * q + 0] * v.x;
            gdotf = gdotf + gF[4 * q + 1] * v.y;
            gdotf = gdotf + gF[4 * q + 2] * v.z;
            gdotf = gdotf + gF[4 * q + 3] * v.w;
          }
        }
        gP = gP + gdotf * w;
        const float gS = gS_full - gP;
        const float om = 1.0f - a.alpha;
        const float one_minus = om < one_minus_max ? one_minus_max : om;
        const float dalpha = alive ? gdotf * Te - gS / one_minus : 0.0f;
        const bool gate = a.a_raw < alpha_max && a.a >= alpha_cutoff;
        const float ga = gate ? dalpha : 0.0f;
        const float dq = ga * Q.y * (-0.5f) * a.g;
        T = T * (1.0f - a.alpha);
        if (weighs) {  // d f: the pixels' w gF, summed over the warp
          float v[kCC];
#pragma unroll
          for (int c = 0; c < kCC; ++c) v[c] = w * gF[c];
          const float sc = warp_sum_32(v, lane);
          if (sc != 0.0f) atomicAdd(&s.dfs[j * kCC + lane], sc);
        }
        if (!__any_sync(kAll, ga != 0.0f)) continue;
        float u[8] = {dq * (2.0f * P.z * a.du + 2.0f * P.w * a.dv),
                      dq * (2.0f * Q.x * a.dv + 2.0f * P.w * a.du),
                      dq * a.du * a.du,
                      2.0f * dq * a.du * a.dv,
                      dq * a.dv * a.dv,
                      ga * a.g,
                      0.0f,
                      0.0f};
        const float sg = warp_sum_8(u, lane);
        const int row = lane >> 2;
        if ((lane & 3) == 0 && row < kGeo && sg != 0.0f) {
          atomicAdd(&s.gsum[row * G + j], sg);
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < G * kCC; i += kPixelsF) {
      const int j = i / kCC;
      const int g = s.gid[j];
      const float v = s.dfs[i];
      if (g >= 0 && v != 0.0f) {
        atomicAdd(&dfsem[(size_t)g * C + cg * kCC + (i - j * kCC)], v);
      }
    }
    for (int i = tid; i < G * kGeo; i += kPixelsF) {
      const int r = i / G, j = i - r * G;
      const float v = s.gsum[i];
      if (v != 0.0f) {
        atomicAdd(&dgeo[(size_t)r * dstride + base + j], r < 2 ? -v : v);
      }
    }
  }
}

bool bad_args(int C, int tile, int G, int num_tiles) {
  return tile != kTileF || G <= 0 || G > kMaxGF || G % 32 != 0 || C <= 0 ||
         C % kCC != 0 || num_tiles < 0;
}

}  // namespace

// F1 on `stream`: fmap [C, H, W] f32 (every pixel written) from the
// gathered pair rows `feat` ([>= 10, n_pairs] f32, row stride `stride`),
// pair_slot [n_pairs] and depth_order [N] int32, fsem [N, C] f32
// (contiguous), tile_start [num_tiles] int32 and K1's output `fwd`
// ([num_tiles, 8, 256] f32, row 5 the blocks composited). tile: 16; G: a
// multiple of 32 up to 256; C: a multiple of 32. Returns a cudaError_t.
extern "C" int feat_fwd(const void* feat, int stride, const void* pair_slot,
                        const void* depth_order, const void* fsem, int C,
                        const void* tile_start, const void* fwd, void* fmap,
                        int num_tiles, int tiles_x, int H, int W, int tile,
                        int G, float chi2_clip, float alpha_max,
                        float alpha_cutoff, float t_min, float margin_rel,
                        float margin_eps, float margin_abs, float kappa_min,
                        void* stream) {
  if (bad_args(C, tile, G, num_tiles)) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  const CullMargins cm = {margin_rel, margin_eps, margin_abs, kappa_min};
  const dim3 grid(num_tiles, C / kCC);
  feat_fwd_kernel<<<grid, kPixelsF, smem_bytes(G, false),
                    (cudaStream_t)stream>>>(
      (const float*)feat, stride, (const int*)pair_slot,
      (const int*)depth_order, (const float*)fsem, C,
      (const int*)tile_start, (const float*)fwd, (float*)fmap, tiles_x, H, W,
      G, chi2_clip, alpha_max, alpha_cutoff, t_min, cm);
  return (int)cudaGetLastError();
}

// F2 on `stream`: adds the feature channels' part of each composited
// pair's geometry gradient into rows 0-5 of `dgeo` ([>= 6, dstride] f32,
// K2's output, columns by pair slot) and d fsem into `dfsem` ([N, C] f32,
// zero-filled by the caller), for the cotangent gfmap [C, H, W] of F1's
// map fmap. Arguments otherwise as feat_fwd's. Returns a cudaError_t.
extern "C" int feat_bwd(const void* feat, int stride, const void* pair_slot,
                        const void* depth_order, const void* fsem, int C,
                        const void* tile_start, const void* fwd,
                        const void* fmap, const void* gfmap, void* dgeo,
                        int dstride, void* dfsem, int num_tiles, int tiles_x,
                        int H, int W, int tile, int G, float chi2_clip,
                        float alpha_max, float alpha_cutoff,
                        float one_minus_max, float t_min, float margin_rel,
                        float margin_eps, float margin_abs, float kappa_min,
                        void* stream) {
  if (bad_args(C, tile, G, num_tiles)) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  const size_t bytes = smem_bytes(G, true);
  cudaError_t e = cudaFuncSetAttribute(
      feat_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxGF, true));
  if (e != cudaSuccess) return (int)e;
  const CullMargins cm = {margin_rel, margin_eps, margin_abs, kappa_min};
  const dim3 grid(num_tiles, C / kCC);
  feat_bwd_kernel<<<grid, kPixelsF, bytes, (cudaStream_t)stream>>>(
      (const float*)feat, stride, (const int*)pair_slot,
      (const int*)depth_order, (const float*)fsem, C,
      (const int*)tile_start, (const float*)fwd, (const float*)fmap,
      (const float*)gfmap, (float*)dgeo, dstride, (float*)dfsem, tiles_x, H,
      W, G, chi2_clip, alpha_max, alpha_cutoff, one_minus_max, t_min, cm);
  return (int)cudaGetLastError();
}

// F1's and F2's registers, local bytes and resident CTAs per SM at pair
// block G, into out[0..5] (F1 registers, local bytes, CTAs; then F2's).
extern "C" int feat_resources(int G, int* out) {
  const void* kernels[2] = {(const void*)feat_fwd_kernel,
                            (const void*)feat_bwd_kernel};
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernels[i]);
    if (e != cudaSuccess) return (int)e;
    if (i == 1) {
      e = cudaFuncSetAttribute(feat_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kMaxGF, true));
      if (e != cudaSuccess) return (int)e;
    }
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernels[i], kPixelsF, smem_bytes(G, i == 1));
    if (e != cudaSuccess) return (int)e;
    out[3 * i + 0] = attr.numRegs;
    out[3 * i + 1] = (int)attr.localSizeBytes;
    out[3 * i + 2] = n;
  }
  return 0;
}
