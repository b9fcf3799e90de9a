// The per-gaussian stages of a frame for Hopper (sm_90a), forward only:
// the packed covariance, the SH colour and the projection of every slot of
// the pool in one launch, P1 (ops/preprocess.py::preprocess_cuda).
//
// Replaces no Pallas kernel: the JAX package leaves these stages to XLA
// (gsplat_tpu/ops/gaussian.py, sh.py, projection.py). The port ran them as
// some 450 PyTorch launches a frame (ops/gaussian.py::build_cov3d_packed,
// ops/sh.py::evaluate_sh, ops/projection.py::project_gaussians), which
// stay its plain version and the path autograd records.
//
// Bound. About 400 operations a gaussian against 59 floats read (236 B)
// and the alive byte, and 61 B written (uv, depth, conic, opacity, the
// colour, radius, the two tile corners, valid): 298 B, 0.26 ms for
// 2,959,677 gaussians at 3.35 TB/s, where the operations take 0.02 ms at
// 67 TFLOP/s. Bytes bind. The design reads and writes each byte once:
//   * one thread a gaussian, 128 a block; the covariance, the view
//     direction and every intermediate stay in registers;
//   * each block stages its 128 rows of the [N, 3] leaves and of f_rest
//     (up to 5,760 contiguous bytes a warp) into shared memory with
//     16-byte loads, neighbouring threads on neighbouring addresses (the
//     wrapper requires those leaves and q_raw 16-byte aligned, so a full
//     block's rows start on a 16-byte boundary; the last block, with
//     fewer rows, stages word by word); a row
//     stride made odd (45, 25, 9, 3) keeps the reads of a row per thread
//     free of bank conflicts;
//   * the [N, 3] outputs (conic, colour) go back out through shared
//     memory the same way; the others are one coalesced word a thread;
//   * the pose and intrinsics are read from the device (the intrinsics by
//     value where the caller gives numbers), so the frame reads nothing
//     back to the host.
// Arithmetic. Every expression is the plain chain's, in its order, with
// the roundings PyTorch's CUDA kernels give: one rounding an operation
// (built with -fmad=false; PyTorch runs each operation as its own kernel),
// expf, logf, IEEE sqrtf and division, sigmoid as 1 / (1 + expf(-x)),
// clamps that pass a NaN through, a tensor over a Python number as the
// tensor times the number's float reciprocal, Python's double constants
// rounded to float. The three reductions add in the orders PyTorch's
// reduction kernels use at these shapes (found on the card): the
// quaternion's squared norm as (q0^2 + q2^2) + (q1^2 + q3^2); the
// view direction's as (x^2 + z^2) + y^2; the SH sum over K as four
// accumulators, term k into accumulator k % 4 in order, then
// ((a0 + a1) + a2) + a3. So P1 equals the plain chain bit for bit.
// The launcher returns the launch's cudaError_t; it neither synchronises
// nor allocates.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

#define F(x) ((float)(x))  // a Python double as PyTorch rounds it

// ops/sh.py's constants
constexpr double kC0 = 0.28209479177387814;
constexpr double kC1 = 0.4886025119029199;
constexpr double kC2_0 = 1.0925484305920792;
constexpr double kC2_1 = 0.31539156525252005;
constexpr double kC2_2 = 0.5462742152960396;
constexpr double kC3_0 = 0.5900435899266435;
constexpr double kC3_1 = 2.890611442640554;
constexpr double kC3_2 = 0.4570457994644658;
constexpr double kC3_3 = 0.3731763325901154;
constexpr double kC3_4 = 1.445305721320277;

// ops/preprocess.py's _Args, field for field.
struct Args {
  const float* pos;            // [N, 3]
  const float* scale_raw;      // [N, 3]
  const float* q_raw;          // [N, 4]
  const float* opacity_raw;    // [N]
  const float* f_dc;           // [N, 3]; colour variants only
  const float* f_rest;         // [N, 3 (K - 1)]
  const unsigned char* alive;  // [N] bool, or null
  const float* c2w;            // [4, 4], row-major
  const float* intr_ptr[4];    // fx, fy, cx, cy on the device, or null
  float* uv;                   // [N, 2]
  float* depth;                // [N]
  float* conic;                // [N, 3]
  float* opacity;              // [N]
  int* radius;                 // [N]
  int* tile_min;               // [N, 2]
  int* tile_max;               // [N, 2]
  unsigned char* valid;        // [N] bool
  float* rgb;                  // [N, 3]; colour variants only
  float intr[4];               // fx, fy, cx, cy where intr_ptr is null
  // The guard band, x: -pix_guard - cx and W + pix_guard - cx, folded in
  // double and rounded, where cx is a number; -pix_guard and W +
  // pix_guard, from which the kernel takes cx, where cx is on the device
  // (as PyTorch does with a tensor). y: the same with pix_guard_v, cy, H.
  float u_lo, u_hi, v_lo, v_hi;
  float near_plane, far_plane;
  float half_cutoff;           // alpha_cutoff * 0.5, in double, rounded
  float inv_cutoff;            // 1 / (float)alpha_cutoff, in float
  float chi2_clip, min_conic, aa_dilation;
  int n, height, width, tile;
  int aa_mode;                 // 0 none, 1 dilate, 2 mip
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);  // torch.clamp keeps NaN
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Rows [n0, n0 + rows) of a [N, W] float tensor into shared memory at row
// stride SW: 16-byte loads over a full block's contiguous slab (aligned:
// src is, and n0 * W * 4 is a multiple of 16).
template <int W, int SW>
__device__ __forceinline__ void stage_in(const float* __restrict__ src,
                                         int n0, int rows,
                                         float* __restrict__ dst) {
  const float* base = src + (long long)n0 * W;
  const int total = rows * W;
  if (rows == kThreads) {
    const float4* b4 = reinterpret_cast<const float4*>(base);
    for (int u = threadIdx.x; u < total / 4; u += kThreads) {
      const float4 v = __ldg(b4 + u);
      const int e = u * 4;
      dst[(e / W) * SW + e % W] = v.x;
      dst[((e + 1) / W) * SW + (e + 1) % W] = v.y;
      dst[((e + 2) / W) * SW + (e + 2) % W] = v.z;
      dst[((e + 3) / W) * SW + (e + 3) % W] = v.w;
    }
  } else {
    for (int e = threadIdx.x; e < total; e += kThreads) {
      dst[(e / W) * SW + e % W] = __ldg(base + e);
    }
  }
}

// Rows [n0, n0 + rows) of a [N, 3] output from shared memory (stride 3).
__device__ __forceinline__ void stage_out3(const float* __restrict__ src,
                                           int n0, int rows,
                                           float* __restrict__ dst) {
  float* base = dst + (long long)n0 * 3;
  const int total = rows * 3;
  if (rows == kThreads) {
    float4* b4 = reinterpret_cast<float4*>(base);
    for (int u = threadIdx.x; u < total / 4; u += kThreads) {
      b4[u] = make_float4(src[4 * u], src[4 * u + 1], src[4 * u + 2],
                          src[4 * u + 3]);
    }
  } else {
    for (int e = threadIdx.x; e < total; e += kThreads) base[e] = src[e];
  }
}

// The SH basis Y0..Y15 of a unit direction (ops/sh.py::sh_basis).
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* Y) {
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  Y[0] = F(kC0);
  Y[1] = F(-kC1) * y;
  Y[2] = F(kC1) * z;
  Y[3] = F(-kC1) * x;
  Y[4] = F(kC2_0) * xy;
  Y[5] = F(kC2_0) * yz;
  Y[6] = F(kC2_1) * (3.f * zz - 1.f);
  Y[7] = F(kC2_0) * xz;
  Y[8] = F(kC2_2) * (xx - yy);
  Y[9] = (F(kC3_0) * y) * (3.f * xx - yy);
  Y[10] = ((F(kC3_1) * x) * y) * z;
  Y[11] = (F(kC3_2) * y) * ((4.f * zz - xx) - yy);
  Y[12] = (F(kC3_3) * z) * ((2.f * zz - 3.f * xx) - 3.f * yy);
  Y[13] = (F(kC3_2) * x) * ((4.f * zz - xx) - yy);
  Y[14] = (F(kC3_4) * z) * (xx - yy);
  Y[15] = (F(kC3_0) * x) * (xx - 3.f * yy);
}

// p^T Sigma q for the packed covariance (ops/projection.py's quad).
__device__ __forceinline__ float quad(const float* S, const float* p,
                                      const float* q) {
  const float a = (S[0] * q[0] + S[1] * q[1]) + S[2] * q[2];
  const float b = (S[1] * q[0] + S[3] * q[1]) + S[4] * q[2];
  const float c = (S[2] * q[0] + S[4] * q[1]) + S[5] * q[2];
  return (p[0] * a + p[1] * b) + p[2] * c;
}

// K SH bases with colour (1, 4, 9, 16), or 0: no colour (pair_demand).
template <int K>
__global__ void __launch_bounds__(kThreads) preprocess_kernel(const Args a) {
  constexpr int kRest = K > 1 ? 3 * (K - 1) : 0;  // f_rest's width
  constexpr int kRestSW = kRest | 1;
  __shared__ float s_pos[kThreads * 3];
  __shared__ float s_scale[kThreads * 3];
  __shared__ float s_dc[K > 0 ? kThreads * 3 : 1];
  __shared__ float s_rest[K > 1 ? kThreads * kRestSW : 1];
  __shared__ float s_conic[kThreads * 3];
  __shared__ float s_rgb[K > 0 ? kThreads * 3 : 1];

  const int n0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, a.n - n0);
  stage_in<3, 3>(a.pos, n0, rows, s_pos);
  stage_in<3, 3>(a.scale_raw, n0, rows, s_scale);
  if constexpr (K > 0) stage_in<3, 3>(a.f_dc, n0, rows, s_dc);
  if constexpr (K > 1) stage_in<kRest, kRestSW>(a.f_rest, n0, rows, s_rest);
  __syncthreads();

  const int t = threadIdx.x;
  if (t < rows) {
    const int i = n0 + t;
    float R[9], T[3];  // c2w[:3, :3] and c2w[:3, 3]
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) R[3 * r + c] = __ldg(a.c2w + 4 * r + c);
      T[r] = __ldg(a.c2w + 4 * r + 3);
    }
    float in[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      in[k] = a.intr_ptr[k] != nullptr ? __ldg(a.intr_ptr[k]) : a.intr[k];
    }
    const float fx = in[0], fy = in[1], cx = in[2], cy = in[3];

    // --- covariance (ops/gaussian.py::build_cov3d_packed) ---
    const float4 q = __ldg(reinterpret_cast<const float4*>(a.q_raw) + i);
    const float qn = sqrtf((q.x * q.x + q.z * q.z) + (q.y * q.y + q.w * q.w));
    const float qd = qn + F(1e-9);
    const float x_ = q.x / qd, y_ = q.y / qd, z_ = q.z / qd, w_ = q.w / qd;
    const float xx_ = x_ * x_, yy_ = y_ * y_, zz_ = z_ * z_;
    const float xy_ = x_ * y_, xz_ = x_ * z_, yz_ = y_ * z_;
    const float xw_ = x_ * w_, yw_ = y_ * w_, zw_ = z_ * w_;
    const float r0[3] = {1.f - 2.f * (yy_ + zz_), 2.f * (xy_ - zw_),
                         2.f * (xz_ + yw_)};
    const float r1[3] = {2.f * (xy_ + zw_), 1.f - 2.f * (xx_ + zz_),
                         2.f * (yz_ - xw_)};
    const float r2[3] = {2.f * (xz_ - yw_), 2.f * (yz_ + xw_),
                         1.f - 2.f * (xx_ + yy_)};
    float s2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float s = clamp_min(expf(s_scale[3 * t + k]), F(1e-6));
      s2[k] = s * s;
    }
    // sig(a, b) = s0 a0 b0 + s1 a1 b1 + s2 a2 b2
#define SIG(A, B) \
  ((s2[0] * A[0] * B[0] + s2[1] * A[1] * B[1]) + s2[2] * A[2] * B[2])
    const float S[6] = {SIG(r0, r0), SIG(r0, r1), SIG(r0, r2),
                        SIG(r1, r1), SIG(r1, r2), SIG(r2, r2)};
#undef SIG

    // --- opacity pre-filter, camera transform, frustum ---
    float opacity = clampf(sigmoid(__ldg(a.opacity_raw + i)), 0.f, F(0.999));
    bool valid = opacity >= a.half_cutoff;
    if (a.alive != nullptr) valid = valid && a.alive[i] != 0;
    const float dx = s_pos[3 * t] - T[0];
    const float dy = s_pos[3 * t + 1] - T[1];
    const float dz = s_pos[3 * t + 2] - T[2];
    float x = (dx * R[0] + dy * R[3]) + dz * R[6];
    float y = (dx * R[1] + dy * R[4]) + dz * R[7];
    float z = (dx * R[2] + dy * R[5]) + dz * R[8];
    const float u_lo = a.intr_ptr[2] != nullptr ? a.u_lo - cx : a.u_lo;
    const float u_hi = a.intr_ptr[2] != nullptr ? a.u_hi - cx : a.u_hi;
    const float v_lo = a.intr_ptr[3] != nullptr ? a.v_lo - cy : a.v_lo;
    const float v_hi = a.intr_ptr[3] != nullptr ? a.v_hi - cy : a.v_hi;
    const float fx_x = fx * x, fy_y = fy * y;
    valid = valid && z > 0.f && z > a.near_plane && z < a.far_plane &&
            fx_x > z * u_lo && fx_x < z * u_hi && fy_y > z * v_lo &&
            fy_y < z * v_hi && isfinite(x) && isfinite(y) && isfinite(z);
    x = valid ? x : 0.f;
    y = valid ? y : 0.f;
    z = valid ? z : 1.f;
    const float u = fx * x / z + cx;
    const float v = fy * y / z + cy;

    // --- EWA ---
    const float invz = 1.f / clamp_min(z, F(1e-6));
    const float invz2 = invz * invz;
    const float zero = 0.f;
    const float ju[3] = {fx * invz, zero, -fx * x * invz2};
    const float jv[3] = {zero, fy * invz, -fy * y * invz2};
    float mu[3], mv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      mu[k] = (ju[0] * R[3 * k] + ju[1] * R[3 * k + 1]) + ju[2] * R[3 * k + 2];
      mv[k] = (jv[0] * R[3 * k] + jv[1] * R[3 * k + 1]) + jv[2] * R[3 * k + 2];
    }
    float sa = quad(S, mu, mu);
    float sc = quad(S, mv, mv);
    float sb = 0.5f * (quad(S, mu, mv) + quad(S, mv, mu));
    valid = valid && isfinite(sa) && isfinite(sb) && isfinite(sc);
    sa = valid ? sa : 1.f;
    sb = valid ? sb : 0.f;
    sc = valid ? sc : 1.f;
    if (a.aa_mode == 1) {
      sa = sa + a.aa_dilation;
      sc = sc + a.aa_dilation;
    } else if (a.aa_mode == 2) {
      const float det_before = clamp_min(sa * sc - sb * sb, F(1e-12));
      sa = sa + a.aa_dilation;
      sc = sc + a.aa_dilation;
      const float det_after = clamp_min(sa * sc - sb * sb, F(1e-12));
      opacity = opacity * sqrtf(det_before / det_after);
    }

    // --- eigenvalue clamp (clamp_eigvals_2x2) ---
    const float m = 0.5f * (sa + sc);
    const float d = 0.5f * (sa - sc);
    const float r = sqrtf((d * d + sb * sb) + F(1e-30));
    const float l1_raw = m - r, l2_raw = m + r;
    const float l1 = clampf(l1_raw, F(1e-6), F(1e4));
    const float l2 = clampf(l2_raw, F(1e-6), F(1e4));
    const bool unclamped = l1_raw >= F(1e-6) && l2_raw <= F(1e4);
    const float m_new = 0.5f * (l1 + l2);
    const float f = (l2 - l1) / (2.f * r);
    if (!unclamped) {
      sa = m_new + f * d;
      sc = m_new - f * d;
      sb = f * sb;
    }

    // --- cutoff-tied radius, tile box ---
    float k2 = clamp_max(
        2.f * logf(clamp_min(opacity, F(1e-12)) * a.inv_cutoff), a.chi2_clip);
    valid = valid && k2 > 0.f;
    k2 = clamp_min(k2, 0.f);
    const float radius_f = ceilf(sqrtf(k2 * clampf(l2, F(1e-12), F(1e4))));
    const float rx = ceilf(sqrtf(k2 * clampf(sa, F(1e-12), F(1e4))));
    const float ry = ceilf(sqrtf(k2 * clampf(sc, F(1e-12), F(1e4))));
    const float umin = floorf(u - rx), umax = floorf(u + rx);
    const float vmin = floorf(v - ry), vmax = floorf(v + ry);
    valid = valid && umax >= 0.f && umin < (float)a.width && vmax >= 0.f &&
            vmin < (float)a.height;
    const float wmax = (float)(a.width - 1), hmax = (float)(a.height - 1);
    const int umin_i = (int)clampf(valid ? umin : 0.f, 0.f, wmax);
    const int umax_i = (int)clampf(valid ? umax : 0.f, 0.f, wmax);
    const int vmin_i = (int)clampf(valid ? vmin : 0.f, 0.f, hmax);
    const int vmax_i = (int)clampf(valid ? vmax : 0.f, 0.f, hmax);

    // --- conic (inv2x2_packed) and its floors ---
    const float inv_det = 1.f / clamp_min(sa * sc - sb * sb, F(1e-12));
    s_conic[3 * t] = clamp_min(sc * inv_det, a.min_conic);
    s_conic[3 * t + 1] = -sb * inv_det;
    s_conic[3 * t + 2] = clamp_min(sa * inv_det, a.min_conic);

    reinterpret_cast<float2*>(a.uv)[i] = make_float2(u, v);
    a.depth[i] = z;
    a.opacity[i] = opacity;
    a.radius[i] = valid ? (int)radius_f : 0;
    reinterpret_cast<int2*>(a.tile_min)[i] =
        valid ? make_int2(umin_i / a.tile, vmin_i / a.tile) : make_int2(0, 0);
    reinterpret_cast<int2*>(a.tile_max)[i] =
        valid ? make_int2(umax_i / a.tile, vmax_i / a.tile)
              : make_int2(-1, -1);
    a.valid[i] = valid ? 1 : 0;

    // --- SH colour (ops/sh.py::evaluate_sh) ---
    if constexpr (K > 0) {
      const float sq = (dx * dx + dz * dz) + dy * dy;
      const float nd = sqrtf(clamp_min(sq, F(1e-24))) + F(1e-8);
      float Y[16];
      sh_basis(dx / nd, dy / nd, dz / nd, Y);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        acc[0] = acc[0] + Y[0] * s_dc[3 * t + c];
#pragma unroll
        for (int k = 1; k < K; ++k) {
          acc[k & 3] = acc[k & 3] +
                       Y[k] * s_rest[t * kRestSW + (k - 1) + c * (K - 1)];
        }
        s_rgb[3 * t + c] = sigmoid(((acc[0] + acc[1]) + acc[2]) + acc[3]);
      }
    }
  }
  __syncthreads();
  stage_out3(s_conic, n0, rows, a.conic);
  if constexpr (K > 0) stage_out3(s_rgb, n0, rows, a.rgb);
}

template <int K>
int launch(const Args& a, cudaStream_t stream) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  preprocess_kernel<K><<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// preprocess_args_bytes(): the argument pack's size, for the wrapper's
// check of its own layout.
extern "C" long long preprocess_args_bytes() { return (long long)sizeof(Args); }

// preprocess(args, sh_bases, stream) -> cudaError_t: P1 over args->n > 0
// slots; sh_bases 1, 4, 9 or 16 writes the colour, 0 does not.
extern "C" int preprocess(const void* args, int sh_bases, void* stream) {
  const Args* a = (const Args*)args;
  if (a == nullptr || a->n <= 0 || a->tile <= 0 || a->aa_mode < 0 ||
      a->aa_mode > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (sh_bases) {
    case 0: return launch<0>(*a, s);
    case 1: return launch<1>(*a, s);
    case 4: return launch<4>(*a, s);
    case 9: return launch<9>(*a, s);
    case 16: return launch<16>(*a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
