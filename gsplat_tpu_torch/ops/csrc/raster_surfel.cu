// Surfel compositors for Hopper (sm_90a): S1 (forward) and S2 (backward) of
// 2D Gaussian Splatting (Huang et al., SIGGRAPH 2024, arXiv:2403.17888).
//
// The formulas are gsplat_tpu_torch/ops/raster_surfel.py's (its module
// docstring); its plain PyTorch versions are composite_surfels_plain and
// composite_surfels_bwd_plain, its cull's surfel_warp_reach. In short, per
// (pair, pixel): the ray-splat intersection s = (k x l)_{0,1} / (k x l)_2
// with k = x T_w - T_u, l = y T_w - T_v; rho = min(s.s, F |c - x|^2);
// alpha = min(op exp(-rho/2), alpha_max), zero below the cutoff or nearer
// than dist_near; w = alpha T while T > transmittance_min; five maps (rgb,
// sum w z, sum w, sum w n, the distortion) and M1, M2 and the last
// contributing index for S2.
//
// Design.
//   * A CTA owns one 16 x 16 tile, one thread per pixel in K1's 8x4-pixel
//     warps (raster_fwd.cu), and walks the tile's pairs in list order.
//     Each round stages 256 pairs, one a thread: the pair's row, read by
//     its surfel (tab[pair_slot[j]]: no per-pair buffer exists; a row is
//     20 floats, five 16-byte loads), and its two reach boxes.
//   * The per-warp cull: a pair's alpha reaches the cutoff only where
//     rho <= rho_max = 2 ln(op / cutoff) (widened), that is inside the
//     low-pass disc about c or inside the projection of the surfel's disc
//     of radius sqrt(rho_max), an ellipse whose bounding box comes from
//     the disc's dual conic (ops/surfel.py's footprint at that radius).
//     Both boxes are widened by a margin; a warp walks only the pairs
//     whose boxes meet its 8x4 patch (a ballot over 32 staged pairs, then
//     the set bits in order). Where the disc reaches near the camera
//     plane the box is not trusted and every warp walks the pair. A
//     skipped pair has alpha 0 at every pixel of the warp, so skipping it
//     changes no bit: w = 0, T (1 - 0) == T.
//   * A warp stops when every lane's T <= transmittance_min (every later
//     weight is 0); the CTA when every warp has.
//   * The distortion's sums take m - m0, with m0 the pixel's first
//     contributing pair's m (S2 finds the same pair first): the
//     distortion is unchanged by the shift, and where the pairs' m are
//     close (m ~ 1, their differences ~ 1e-2) the terms that cancel in
//     m^2 A + M2 - 2 m M1 and in A M2 - M1^2 stay small.
//   * S1's sums are sequential over the pairs in list order, as the plain
//     version's running sums: S1 equals it bit for bit (-fmad=false).
//   * S2 walks the tile from its start again, carrying T and the running
//     sum of w gw in registers (the forward's prefix is not saved: S2
//     recomputes it), up to the warp's last contributing pair (S1's row
//     11). Per reached pair a lane works out its 18 gradient terms, the
//     warp sums them by recursive halving (31 shuffles leave lane r with
//     term r's sum), and each warp writes its sums to its own slice of a
//     shared [8][18][32] buffer; after each 32 pairs the CTA adds the 8
//     warps' slices in warp order and writes the pairs' columns of
//     d [18, pairs]. No atomics: S2 is deterministic. The columns of the
//     pairs no warp reaches are written 0.
//
// Shared memory (static): S1 28,672 B; S2 47,104 B.
//
// Scope: tile 16, "cumprod" transmittance, one view; the launchers return
// cudaErrorInvalidValue otherwise (raster_surfel.py checks first).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads a CTA
constexpr int kWarps = kPix / 32;
constexpr int kWarpW = 8, kWarpH = 4;
constexpr int kStride = 20;  // floats a table row
constexpr int kRow4 = kStride / 4;
constexpr int kGrad = 18;  // d T_u, T_v, T_w (9), c (2), op, rgb (3), n (3)
constexpr int kOut = 12;   // S1's rows a pixel
constexpr int kBatch = kPix;  // pairs staged a round
constexpr int kSub = 32;      // pairs a ballot
constexpr unsigned kAll = 0xffffffffu;

// raster_surfel.py's _Consts, by reference.
struct Consts {
  float alpha_max, alpha_cutoff, one_minus_max, t_min;
  float F, near, kf, kd;
  float rho_rel, rho_abs, pix_abs, pix_rel, d_min;
  int pair_block;
};

struct Staged {
  float4 row[kBatch][kRow4];
  float4 ebox[kBatch];  // x0 x1 y0 y1 of the ellipse's box
  float4 lbox[kBatch];  // of the low-pass disc's
};

// The pairs [0, end) a tile walks: its count, cut to the whole pair
// blocks inside the list (raster_surfel.py::_blocks).
__device__ __forceinline__ int walk_end(int start, int count, int n_pairs,
                                        int G) {
  int fit = n_pairs - start;
  fit = fit > 0 ? (fit / G) * G : 0;
  return count < fit ? count : fit;
}

// Stage pair `j` of the tile (or an empty slot past `end`): its row and
// its reach boxes (surfel_warp_reach's arithmetic).
__device__ __forceinline__ void stage(Staged& s, int i, int j, int end,
                                     int start, const int* pair_slot,
                                     const float4* tab, const Consts& c) {
  float r[kStride];
#pragma unroll
  for (int q = 0; q < kStride; ++q) r[q] = 0.0f;
  if (j < end) {
    const int slot = pair_slot[start + j];
    if (slot >= 0) {
#pragma unroll
      for (int q = 0; q < kRow4; ++q) {
        const float4 v = tab[(size_t)slot * kRow4 + q];
        r[4 * q] = v.x;
        r[4 * q + 1] = v.y;
        r[4 * q + 2] = v.z;
        r[4 * q + 3] = v.w;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRow4; ++q)
    s.row[i][q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2],
                              r[4 * q + 3]);
  const float inf = __int_as_float(0x7f800000);
  float4 empty = make_float4(inf, -inf, inf, -inf);
  float4 lb = empty, eb = empty;
  const float op = r[11];
  if (op >= c.alpha_cutoff) {
    float rho = 2.0f * logf(op / c.alpha_cutoff);
    rho = rho * (1.0f + c.rho_rel) + c.rho_abs;
    float rl = sqrtf(rho / c.F);
    rl = rl + c.pix_abs + c.pix_rel * (fabsf(r[9]) + fabsf(r[10]) + rl);
    lb = make_float4(r[9] - rl, r[9] + rl, r[10] - rl, r[10] + rl);
    const float w0 = r[6], w1 = r[7], w2 = r[8];
    const float d = rho * (w0 * w0 + w1 * w1) - w2 * w2;
    const bool trust = d < -c.d_min * (w2 * w2);
    const float dd = trust ? d : -1.0f;
    const float cx = (rho * (r[0] * w0 + r[1] * w1) - r[2] * w2) / dd;
    const float cy = (rho * (r[3] * w0 + r[4] * w1) - r[5] * w2) / dd;
    float hx =
        cx * cx - (rho * (r[0] * r[0] + r[1] * r[1]) - r[2] * r[2]) / dd;
    float hy =
        cy * cy - (rho * (r[3] * r[3] + r[4] * r[4]) - r[5] * r[5]) / dd;
    hx = sqrtf(fmaxf(hx, 0.0f));
    hy = sqrtf(fmaxf(hy, 0.0f));
    hx = hx + c.pix_abs + c.pix_rel * (fabsf(cx) + hx);
    hy = hy + c.pix_abs + c.pix_rel * (fabsf(cy) + hy);
    eb = make_float4(cx - hx, cx + hx, cy - hy, cy + hy);
    const bool fin = isfinite(eb.x) && isfinite(eb.y) && isfinite(eb.z) &&
                     isfinite(eb.w);
    if (!(trust && fin)) eb = make_float4(-inf, inf, -inf, inf);
  }
  s.ebox[i] = eb;
  s.lbox[i] = lb;
}

__device__ __forceinline__ bool meets(float4 b, float X0, float Y0) {
  return b.x <= X0 + (kWarpW - 1) && b.y >= X0 && b.z <= Y0 + (kWarpH - 1) &&
         b.w >= Y0;
}

// One (pair, pixel): raster_surfel.py::_hit in its order of operations.
struct Hit {
  float alpha, a_raw, g, z, s0, s1, p2, dx, dy;
  float k0, k1, k2, l0, l1, l2;
  bool use3;
};

__device__ __forceinline__ Hit hit(const float* r, float x, float y,
                                   const Consts& c) {
  Hit h;
  h.k0 = x * r[6] - r[0];
  h.k1 = x * r[7] - r[1];
  h.k2 = x * r[8] - r[2];
  h.l0 = y * r[6] - r[3];
  h.l1 = y * r[7] - r[4];
  h.l2 = y * r[8] - r[5];
  const float p0 = h.k1 * h.l2 - h.k2 * h.l1;
  const float p1 = h.k2 * h.l0 - h.k0 * h.l2;
  const float p2 = h.k0 * h.l1 - h.k1 * h.l0;
  const bool ok = p2 != 0.0f;
  h.p2 = ok ? p2 : 1.0f;
  h.s0 = p0 / h.p2;
  h.s1 = p1 / h.p2;
  const float rho3 = h.s0 * h.s0 + h.s1 * h.s1;
  h.dx = r[9] - x;
  h.dy = r[10] - y;
  const float rho2 = c.F * (h.dx * h.dx + h.dy * h.dy);
  h.use3 = rho3 <= rho2;
  const float rho = h.use3 ? rho3 : rho2;
  const float z = h.use3 ? h.s0 * r[6] + h.s1 * r[7] + r[8] : r[8];
  h.g = expf(-0.5f * rho);
  h.a_raw = r[11] * h.g;
  const float a = fminf(h.a_raw, c.alpha_max);
  const bool keep = ok && (z >= c.near) && (a >= c.alpha_cutoff);
  h.alpha = keep ? a : 0.0f;
  h.z = keep ? z : 1.0f;
  return h;
}

__device__ __forceinline__ void load_row(float* r, const Staged& s, int j) {
#pragma unroll
  for (int q = 0; q < kRow4; ++q) {
    const float4 v = s.row[j][q];
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
}

__global__ void __launch_bounds__(kPix)
surfel_fwd_kernel(const float4* __restrict__ tab,
                  const int* __restrict__ pair_slot, int n_pairs,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_count,
                  float* __restrict__ out, int tiles_x, Consts c) {
  __shared__ Staged s;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  const int lx = (w % (kTile / kWarpW)) * kWarpW + (lane % kWarpW);
  const int ly = (w / (kTile / kWarpW)) * kWarpH + (lane / kWarpW);
  const float X0 = (float)((t % tiles_x) * kTile + lx - lane % kWarpW);
  const float Y0 = (float)((t / tiles_x) * kTile + ly - lane / kWarpW);
  const float x = (float)((t % tiles_x) * kTile + lx);
  const float y = (float)((t / tiles_x) * kTile + ly);
  const int start = tile_start[t];
  const int end = walk_end(start, tile_count[t], n_pairs, c.pair_block);

  float T = 1.0f;
  float C0 = 0.f, C1 = 0.f, C2 = 0.f, Z = 0.f, A = 0.f;
  float N0 = 0.f, N1 = 0.f, N2 = 0.f, D = 0.f, M1 = 0.f, M2 = 0.f;
  float last = 0.0f, m0 = 0.0f;
  bool done = false, has0 = false;
  for (int b0 = 0; b0 < end; b0 += kBatch) {
    stage(s, tid, b0 + tid, end, start, pair_slot, tab, c);
    if (__syncthreads_count(done ? 0 : 1) == 0) break;
    const int nb = min(kBatch, end - b0);
    for (int s0 = 0; s0 < nb && !done; s0 += kSub) {
      const int j = s0 + lane;
      const bool reach = j < nb && (meets(s.lbox[j], X0, Y0) ||
                                    meets(s.ebox[j], X0, Y0));
      unsigned mask = __ballot_sync(kAll, reach);
      while (mask) {
        const int jj = s0 + __ffs(mask) - 1;
        mask &= mask - 1;
        float r[kStride];
        load_row(r, s, jj);
        const Hit h = hit(r, x, y, c);
        if (h.alpha > 0.0f) {
          if (T > c.t_min) {
            const float wt = h.alpha * T;
            C0 = C0 + wt * r[12];
            C1 = C1 + wt * r[13];
            C2 = C2 + wt * r[14];
            N0 = N0 + wt * r[15];
            N1 = N1 + wt * r[16];
            N2 = N2 + wt * r[17];
            Z = Z + wt * h.z;
            const float mr = c.kf * (1.0f - c.near / h.z);
            if (!has0) {
              m0 = mr;
              has0 = true;
            }
            const float m = mr - m0;
            D = D + wt * (m * m * A + M2 - 2.0f * m * M1);
            A = A + wt;
            const float wm = wt * m;
            M1 = M1 + wm;
            M2 = M2 + wm * m;
            last = (float)(b0 + jj + 1);
          }
          T = T * (1.0f - h.alpha);
        }
      }
      done = __all_sync(kAll, T <= c.t_min);
    }
    __syncthreads();
  }
  float* o = out + (size_t)t * kOut * kPix + ly * kTile + lx;
  const float v[kOut] = {C0, C1, C2, Z, A, N0, N1, N2, D, M1, M2, last};
#pragma unroll
  for (int q = 0; q < kOut; ++q) o[q * kPix] = v[q];
}

// One step of the recursive halving: lanes with bit OFF set keep the
// upper half of v[0, 2 OFF), the others the lower, each adding its
// partner's (OFF shuffles).
template <int OFF>
__device__ __forceinline__ void halve_step(float (&v)[32], int lane) {
  const bool up = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = up ? v[i] : v[i + OFF];
    const float keep = up ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(kAll, send, OFF);
  }
}

// Recursive halving over the warp (31 shuffles): afterwards lane r holds
// the sum over the 32 lanes of v[r] (v[r] for r >= 18 is 0 on entry).
__device__ __forceinline__ float halve(float (&v)[32], int lane) {
  halve_step<16>(v, lane);
  halve_step<8>(v, lane);
  halve_step<4>(v, lane);
  halve_step<2>(v, lane);
  halve_step<1>(v, lane);
  return v[0];
}

__global__ void __launch_bounds__(kPix)
surfel_bwd_kernel(const float4* __restrict__ tab,
                  const int* __restrict__ pair_slot, int n_pairs,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_count,
                  const float* __restrict__ fwd,
                  const float* __restrict__ gout, float* __restrict__ d,
                  int tiles_x, Consts c) {
  __shared__ Staged s;
  __shared__ float part[kWarps][kGrad][kSub];
  __shared__ int warp_end[kWarps];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  const int lx = (w % (kTile / kWarpW)) * kWarpW + (lane % kWarpW);
  const int ly = (w / (kTile / kWarpW)) * kWarpH + (lane / kWarpW);
  const float X0 = (float)((t % tiles_x) * kTile + lx - lane % kWarpW);
  const float Y0 = (float)((t / tiles_x) * kTile + ly - lane / kWarpW);
  const float x = (float)((t % tiles_x) * kTile + lx);
  const float y = (float)((t / tiles_x) * kTile + ly);
  const int start = tile_start[t];
  const int end = walk_end(start, tile_count[t], n_pairs, c.pair_block);

  const size_t base = (size_t)t * kOut * kPix + ly * kTile + lx;
  float o[kOut], g[9];
#pragma unroll
  for (int q = 0; q < kOut; ++q) o[q] = fwd[base + q * kPix];
#pragma unroll
  for (int q = 0; q < 9; ++q) g[q] = gout[base + q * kPix];
  const float A = o[4], M1 = o[9], M2 = o[10];
  const float Stot = g[0] * o[0] + g[1] * o[1] + g[2] * o[2] + g[3] * o[3] +
                     g[4] * A + g[5] * o[5] + g[6] * o[6] + g[7] * o[7] +
                     2.0f * g[8] * (A * M2 - M1 * M1);
  // The warp walks to its last contributing pair.
  int mine = (int)o[11];
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    mine = max(mine, __shfl_xor_sync(kAll, mine, off));
  if (lane == 0) warp_end[w] = mine;
  __syncthreads();
  int cta_end = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) cta_end = max(cta_end, warp_end[q]);
  cta_end = min(cta_end, end);
  const int my_end = min(mine, end);

  float T = 1.0f, run = 0.0f, m0 = 0.0f;
  bool done = my_end == 0, has0 = false;
  for (int b0 = 0; b0 < cta_end; b0 += kBatch) {
    stage(s, tid, b0 + tid, cta_end, start, pair_slot, tab, c);
    __syncthreads();
    const int nb = min(kBatch, cta_end - b0);
    for (int s0 = 0; s0 < nb; s0 += kSub) {
#pragma unroll
      for (int q = 0; q < kGrad; ++q) part[w][q][lane] = 0.0f;
      __syncwarp();
      if (!done) {
        const int j = s0 + lane;
        const bool reach = j < nb && b0 + j < my_end &&
                           (meets(s.lbox[j], X0, Y0) ||
                            meets(s.ebox[j], X0, Y0));
        unsigned mask = __ballot_sync(kAll, reach);
        while (mask) {
          const int jj = s0 + __ffs(mask) - 1;
          mask &= mask - 1;
          float r[kStride];
          load_row(r, s, jj);
          const Hit h = hit(r, x, y, c);
          const bool on = h.alpha > 0.0f && T > c.t_min;
          float v[32];
#pragma unroll
          for (int q = 0; q < 32; ++q) v[q] = 0.0f;
          if (on) {
            const float Te = T;
            const float wt = h.alpha * Te;
            const float z = h.z;
            const float mr = c.kf * (1.0f - c.near / z);
            if (!has0) {
              m0 = mr;
              has0 = true;
            }
            const float m = mr - m0;
            const float gw = g[0] * r[12] + g[1] * r[13] + g[2] * r[14] +
                             g[3] * z + g[4] + g[5] * r[15] + g[6] * r[16] +
                             g[7] * r[17] +
                             g[8] * (m * m * A + M2 - 2.0f * m * M1);
            run = run + wt * gw;
            const float gS = Stot - run;
            const float om = fmaxf(1.0f - h.alpha, c.one_minus_max);
            const float dalpha = gw * Te - gS / om;
            const float ga = h.a_raw < c.alpha_max ? dalpha : 0.0f;
            const float op = r[11];
            const float d_op = ga * h.g;
            const float d_rho = ga * op * h.g * (-0.5f);
            const float dz = wt * g[3] + 2.0f * g[8] * wt * (m * A - M1) *
                                             c.kd / (z * z);
            float ds0 = 0.f, ds1 = 0.f, z3 = 0.f, dr2 = 0.f;
            if (h.use3) {
              ds0 = 2.0f * h.s0 * d_rho + dz * r[6];
              ds1 = 2.0f * h.s1 * d_rho + dz * r[7];
              z3 = dz;
            } else {
              dr2 = d_rho * (2.0f * c.F);
            }
            const float dp0 = ds0 / h.p2;
            const float dp1 = ds1 / h.p2;
            const float dp2 = -(ds0 * h.s0 + ds1 * h.s1) / h.p2;
            const float dk0 = h.l1 * dp2 - h.l2 * dp1;
            const float dk1 = h.l2 * dp0 - h.l0 * dp2;
            const float dk2 = h.l0 * dp1 - h.l1 * dp0;
            const float dl0 = dp1 * h.k2 - dp2 * h.k1;
            const float dl1 = dp2 * h.k0 - dp0 * h.k2;
            const float dl2 = dp0 * h.k1 - dp1 * h.k0;
            v[0] = -dk0;
            v[1] = -dk1;
            v[2] = -dk2;
            v[3] = -dl0;
            v[4] = -dl1;
            v[5] = -dl2;
            v[6] = x * dk0 + y * dl0 + z3 * h.s0;
            v[7] = x * dk1 + y * dl1 + z3 * h.s1;
            v[8] = x * dk2 + y * dl2 + dz;
            v[9] = dr2 * h.dx;
            v[10] = dr2 * h.dy;
            v[11] = d_op;
            v[12] = wt * g[0];
            v[13] = wt * g[1];
            v[14] = wt * g[2];
            v[15] = wt * g[5];
            v[16] = wt * g[6];
            v[17] = wt * g[7];
          }
          if (h.alpha > 0.0f) T = T * (1.0f - h.alpha);
          if (__any_sync(kAll, on)) {
            const float sum = halve(v, lane);
            if (lane < kGrad) part[w][lane][jj - s0] = sum;
          }
        }
        done = __all_sync(kAll, T <= c.t_min);
      }
      __syncthreads();
      for (int q = tid; q < kGrad * kSub; q += kPix) {
        const int row = q / kSub, col = q % kSub;
        const int j = b0 + s0 + col;
        if (s0 + col < nb) {
          float acc = 0.0f;
#pragma unroll
          for (int ww = 0; ww < kWarps; ++ww) acc += part[ww][row][col];
          d[(size_t)row * n_pairs + start + j] = acc;
        }
      }
      __syncthreads();
    }
  }
}

bool bad_args(int num_tiles, const Consts* c) {
  return num_tiles < 0 || c == nullptr || c->pair_block <= 0;
}

}  // namespace

// S1 on `stream`: out [num_tiles, 12, 256] f32 (every element written)
// from the depth-ordered table `tab` ([N, 20] f32), pair_slot [n_pairs],
// tile_start and tile_count [num_tiles] int32. Returns a cudaError_t.
extern "C" int surfel_fwd(const void* tab, const void* pair_slot,
                          int n_pairs, const void* tile_start,
                          const void* tile_count, void* out, int num_tiles,
                          int tiles_x, const void* consts, void* stream) {
  const Consts* c = (const Consts*)consts;
  if (bad_args(num_tiles, c)) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  surfel_fwd_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
      (const float4*)tab, (const int*)pair_slot, n_pairs,
      (const int*)tile_start, (const int*)tile_count, (float*)out, tiles_x,
      *c);
  return (int)cudaGetLastError();
}

// S2 on `stream`: the per-pair gradients into d [18, n_pairs] f32
// (zero-filled by the caller; the columns of the walked pairs written) for
// the cotangent gout [num_tiles, 12, 256] (rows 0-8 read) of S1's output
// fwd. Arguments otherwise as surfel_fwd's. Returns a cudaError_t.
extern "C" int surfel_bwd(const void* tab, const void* pair_slot,
                          int n_pairs, const void* tile_start,
                          const void* tile_count, const void* fwd,
                          const void* gout, void* d, int num_tiles,
                          int tiles_x, const void* consts, void* stream) {
  const Consts* c = (const Consts*)consts;
  if (bad_args(num_tiles, c)) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  surfel_bwd_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
      (const float4*)tab, (const int*)pair_slot, n_pairs,
      (const int*)tile_start, (const int*)tile_count, (const float*)fwd,
      (const float*)gout, (float*)d, tiles_x, *c);
  return (int)cudaGetLastError();
}

// S1's and S2's registers, local bytes and resident CTAs per SM, into
// out[0..5] (S1 registers, local bytes, CTAs; then S2's).
extern "C" int surfel_resources(int* out) {
  const void* kernels[2] = {(const void*)surfel_fwd_kernel,
                            (const void*)surfel_bwd_kernel};
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernels[i]);
    if (e != cudaSuccess) return (int)e;
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernels[i], kPix,
                                                      0);
    if (e != cudaSuccess) return (int)e;
    out[3 * i + 0] = attr.numRegs;
    out[3 * i + 1] = (int)attr.localSizeBytes;
    out[3 * i + 2] = n;
  }
  return 0;
}
