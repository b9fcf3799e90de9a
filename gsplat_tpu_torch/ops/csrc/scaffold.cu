// Scaffold-GS's decode for Hopper (sm_90a): D1, each visible anchor's k
// neural gaussians from three view-conditioned MLPs, and D2, its backward
// (ops/scaffold.py holds the plain version, decode_plain, and the
// equations).
//
// It replaces no TPU kernel: the JAX package has no anchors. It was added
// because an anchor pool makes every gaussian the compositor sees in the
// step, and autograd over the plain decode (three [A, 35] x [35, 32] and
// [A, 32] x [32, m] products, their activations and the post-processing,
// each a launch with its [A k] intermediates kept for the backward) sits on
// that path at 650 k anchors.
//
// What bounds it on this card: per visible anchor, D1 does 13,760 float32
// operations (the three MLPs) on 71 floats read and 10 slots x 14 floats
// written; D2 twice those products (the input and the weight gradients)
// plus a recomputed forward, on 14 gradient floats a slot read. Counted
// so, both sit near the ridge of 67 TFLOP/s and 3.35 TB/s. Measured (an
// H100 at 700 W, 650 k anchors, 228 k visible): D1 0.76 ms, D2 1.74 ms,
// both bound by shared memory: every product needs its weight delivered
// to its lane, and shared memory delivers 32 floats a cycle an SM against
// 128 fused multiply-adds, so a thread-an-anchor MLP runs at most at a
// quarter of the float32 rate (D1 also runs its invisible anchors' lanes
// beside the visible ones). What the design does:
//
//   * one thread an anchor: z = [f, d] (35), the hidden layer (32) and the
//     accumulators live in registers; every weight is read from shared
//     memory, where the CTA keeps all 7,086 of them (W1 transposed, so a
//     thread's 32 hidden units are 8 float4 broadcasts a row of W1^T), at
//     the same address in every lane (a broadcast);
//   * the slots are slot-major (slot t of anchor i is row t A + i), so a
//     warp's 32 neighbouring anchors write 32 neighbouring rows of each
//     field: D1's 140 floats an anchor leave as whole sectors. D1 runs
//     every anchor in order (an invisible anchor's slots are written zero,
//     keep false; the anchor cull, a plain stage, gave the visible mask);
//   * the products accumulate with fused multiply-adds (__fmaf_rn: the
//     library's -fmad=false does not reach them), in float32, no tensor
//     core: the configuration states float32;
//   * D2 recomputes the forward (it saves no hidden values: 96 floats an
//     anchor written and read again cost more than recomputing them from
//     the weights in shared memory); a persistent CTA walks a contiguous
//     range of anchors and queues the visible ones in shared memory (a
//     ballot a warp), so a tile is 128 visible anchors; per MLP each
//     leaves a row in shared memory (z, 1, relu(h), d h_pre, d out); the
//     CTA then sums the MLP's weight gradients, outer products of those
//     rows' columns, each thread owning fixed 4 x 4 tiles of them (16
//     products a row from 8 shared loads), into per-CTA partial sums in
//     shared memory; a second kernel adds the CTAs' partials in CTA order.
//     No float atomic: the gradients are the same in every run on a card.
//
// Masked slots (keep false: an invisible anchor, or tanh(.) <= 0) read no
// gradient: their outputs' gradients are taken as zero in every head.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kF = 32;          // feature
constexpr int kK = 10;          // offsets (slots) an anchor
constexpr int kH = 32;          // hidden units
constexpr int kIn = kF + 3;     // [f, d]
constexpr int kThreads = 128;
// Head M's outputs: opacity (0), scale and rotation (1), colour (2).
__host__ __device__ constexpr int out_of(int m) {
  return m == 0 ? kK : m == 1 ? 7 * kK : 3 * kK;
}
// Flat floats of each MLP (W1 [kH, kIn], b1, W2 [m, kH], b2): the
// wrapper's layout.
__host__ __device__ constexpr int numel_of(int m) {
  return kH * kIn + kH + out_of(m) * kH + out_of(m);
}
__host__ __device__ constexpr int flat_base(int m) {
  return m == 0 ? 0 : flat_base(m - 1) + numel_of(m - 1);
}
constexpr int kNumW = flat_base(3);  // 7,086
// Shared-memory layout of each MLP: W1^T [kIn][kH], b1, W2 [m][kH], b2
// padded to 4 floats, so every block starts on 16 bytes.
__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int smem_numel(int m) {
  return kIn * kH + kH + out_of(m) * kH + pad4(out_of(m));
}
__host__ __device__ constexpr int smem_base(int m) {
  return m == 0 ? 0 : smem_base(m - 1) + smem_numel(m - 1);
}
constexpr int kSmemW = smem_base(3);
constexpr int kB1 = kIn * kH;   // b1 within an MLP's block
constexpr int kW2 = kB1 + kH;   // W2 within an MLP's block
// D2's row a visible anchor: z, 1, relu(h), d h_pre, d out (at most 7 k),
// and the feature's and the scales' gradients summed over the heads.
constexpr int kRowZ = 0, kRowOne = kIn, kRowH = kIn + 1, kRowDh = kRowH + kH,
              kRowDo = kRowDh + kH, kRowDz = kRowDo + 7 * kK,
              kRowDl = kRowDz + kF;
constexpr int kRow = kRowDl + 6 + 1;  // odd: rows fall on other banks

static_assert(kH % 4 == 0 && kSmemW % 4 == 0, "float4 blocks");
static_assert(kNumW == 7086, "the published widths' 7,086 weights");
static_assert(kRow % 2 == 1, "odd row stride");

struct Args {
  const float* pos;        // [A, 3]
  const float* offset;     // [A, 3k]
  const float* feat;       // [A, F]
  const float* scale_raw;  // [A, 6]
  const float* w[3];       // the three flat MLPs
  const bool* visible;     // [A]
  const float* cam;        // [3]
  float* mu;               // [S, 3]   (S = A k)
  float* s;                // [S, 3]
  float* q;                // [S, 4]  (x, y, z, w)
  float* alpha;            // [S]
  float* color;            // [S, 3]
  bool* keep;              // [S]
  const float* g_mu;
  const float* g_s;
  const float* g_q;
  const float* g_alpha;
  const float* g_color;
  float* d_offset;         // [A, 3k]
  float* d_feat;           // [A, F]
  float* d_scale_raw;      // [A, 6]
  float* d_w;              // [7086]
  float* partials;         // [ctas, 7086]
  int anchors;
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The CTA's copy of the weights, W1 transposed.
__device__ void load_weights(const Args& a, float* sw) {
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float* w = a.w[m];
    float* dst = sw + smem_base(m);
    for (int e = threadIdx.x; e < numel_of(m); e += blockDim.x) {
      const float v = w[e];
      if (e < kB1) {
        dst[(e % kIn) * kH + e / kIn] = v;
      } else {
        dst[e] = v;  // b1, W2 and b2 keep their places
      }
    }
  }
}

// z = [f, (x - c) / |x - c|] of anchor i.
__device__ __forceinline__ void inputs(const Args& a, int i, float* z) {
#pragma unroll
  for (int k = 0; k < kF; ++k) z[k] = a.feat[(size_t)i * kF + k];
  const float dx = a.pos[i * 3] - a.cam[0];
  const float dy = a.pos[i * 3 + 1] - a.cam[1];
  const float dz = a.pos[i * 3 + 2] - a.cam[2];
  const float n = sqrtf(dx * dx + dy * dy + dz * dz);
  z[kF] = dx / n;
  z[kF + 1] = dy / n;
  z[kF + 2] = dz / n;
}

// h_pre = W1 z + b1 of one MLP (its shared block ``w``).
__device__ __forceinline__ void hidden(const float* w, const float* z,
                                       float* h) {
#pragma unroll
  for (int j = 0; j < kH; ++j) h[j] = 0.f;
#pragma unroll
  for (int k = 0; k < kIn; ++k) {
    const float zk = z[k];
    const float4* row = reinterpret_cast<const float4*>(w + k * kH);
#pragma unroll
    for (int j4 = 0; j4 < kH / 4; ++j4) {
      const float4 v = row[j4];
      h[4 * j4] = __fmaf_rn(v.x, zk, h[4 * j4]);
      h[4 * j4 + 1] = __fmaf_rn(v.y, zk, h[4 * j4 + 1]);
      h[4 * j4 + 2] = __fmaf_rn(v.z, zk, h[4 * j4 + 2]);
      h[4 * j4 + 3] = __fmaf_rn(v.w, zk, h[4 * j4 + 3]);
    }
  }
#pragma unroll
  for (int j = 0; j < kH; ++j) h[j] += w[kB1 + j];
}

// N outputs from row r0 of W2: out_r = (W2 relu(h))_r + b2_r.
template <int N>
__device__ __forceinline__ void outputs(const float* w, int m, int r0,
                                        const float* h, float* o) {
#pragma unroll
  for (int r = 0; r < N; ++r) o[r] = 0.f;
#pragma unroll
  for (int j4 = 0; j4 < kH / 4; ++j4) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const float4 v =
          reinterpret_cast<const float4*>(w + kW2 + (r0 + r) * kH)[j4];
      o[r] = __fmaf_rn(v.x, h[4 * j4], o[r]);
      o[r] = __fmaf_rn(v.y, h[4 * j4 + 1], o[r]);
      o[r] = __fmaf_rn(v.z, h[4 * j4 + 2], o[r]);
      o[r] = __fmaf_rn(v.w, h[4 * j4 + 3], o[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < N; ++r) o[r] += w[kW2 + out_of(m) * kH + r0 + r];
}

__device__ __forceinline__ void relu(float* h) {
#pragma unroll
  for (int j = 0; j < kH; ++j) h[j] = fmaxf(h[j], 0.f);
}

// D1's work on one visible anchor i of A; slot t of anchor i is S row
// t A + i (slot-major: a warp's 32 anchors write 32 neighbouring rows).
__device__ void decode_anchor(const Args& a, const float* sw, int i) {
  const int A = a.anchors;
  float z[kIn];
  inputs(a, i, z);
  float l[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) l[c] = expf(a.scale_raw[i * 6 + c]);
  float h[kH];
  // Opacity: tanh, and the mask.
  hidden(sw + smem_base(0), z, h);
  relu(h);
  float o[kK];
  outputs<kK>(sw + smem_base(0), 0, 0, h, o);
#pragma unroll
  for (int t = 0; t < kK; ++t) {
    const float al = tanhf(o[t]);
    a.alpha[t * A + i] = al;
    a.keep[t * A + i] = al > 0.f;
  }
  // Position, scale and rotation.
  hidden(sw + smem_base(1), z, h);
  relu(h);
#pragma unroll 1
  for (int t = 0; t < kK; ++t) {
    float o7[7];
    outputs<7>(sw + smem_base(1), 1, 7 * t, h, o7);
    const int s = t * A + i;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.mu[s * 3 + c] =
          a.pos[i * 3 + c] + a.offset[(size_t)i * 3 * kK + 3 * t + c] * l[c];
      a.s[s * 3 + c] = l[3 + c] * sigmoid(o7[c]);
    }
    const float n = sqrtf(o7[3] * o7[3] + o7[4] * o7[4] + o7[5] * o7[5] +
                          o7[6] * o7[6]);
    const float nn = fmaxf(n, 1e-12f);
    const float4 q = make_float4(o7[4] / nn, o7[5] / nn, o7[6] / nn,
                                 o7[3] / nn);  // (w, x, y, z) -> (x, y, z, w)
    reinterpret_cast<float4*>(a.q)[s] = q;
  }
  // Colour.
  hidden(sw + smem_base(2), z, h);
  relu(h);
#pragma unroll 1
  for (int t = 0; t < kK; ++t) {
    float o3[3];
    outputs<3>(sw + smem_base(2), 2, 3 * t, h, o3);
#pragma unroll
    for (int c = 0; c < 3; ++c) a.color[(t * A + i) * 3 + c] = sigmoid(o3[c]);
  }
}

__device__ void zero_slots(const Args& a, int i) {
  const int A = a.anchors;
  for (int t = 0; t < kK; ++t) {
    const int s = t * A + i;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.mu[s * 3 + c] = 0.f;
      a.s[s * 3 + c] = 0.f;
      a.color[s * 3 + c] = 0.f;
    }
    reinterpret_cast<float4*>(a.q)[s] = make_float4(0.f, 0.f, 0.f, 0.f);
    a.alpha[s] = 0.f;
    a.keep[s] = false;
  }
}

// D1: a thread an anchor, in anchor order.
__global__ void __launch_bounds__(kThreads) scaffold_d1_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  load_weights(a, sw);
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.anchors) return;
  if (a.visible[i]) {
    decode_anchor(a, sw, i);
  } else {
    zero_slots(a, i);
  }
}

// ---- D2 ---------------------------------------------------------------

// The backward of one MLP's head through its hidden layer, for the
// visible anchor of this thread: writes its row's relu(h), d h_pre and
// d out, and adds W1^T d h_pre (the feature's part) to the row's dz.
// ``dout_of(t, o, d, row)`` gives slot t's output gradients from its
// outputs.
template <int M, int PER, typename DoutOf>
__device__ __forceinline__ void head_bwd(const float* sw, float* row,
                                         DoutOf dout_of) {
  const float* w = sw + smem_base(M);
  float h[kH];
  hidden(w, row + kRowZ, h);
  relu(h);
  float dh[kH];
#pragma unroll
  for (int j = 0; j < kH; ++j) dh[j] = 0.f;
#pragma unroll 1
  for (int t = 0; t < out_of(M) / PER; ++t) {
    float o[PER], d[PER];
    outputs<PER>(w, M, PER * t, h, o);
    dout_of(t, o, d, row);
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      row[kRowDo + PER * t + r] = d[r];
      const float4* v =
          reinterpret_cast<const float4*>(w + kW2 + (PER * t + r) * kH);
#pragma unroll
      for (int j4 = 0; j4 < kH / 4; ++j4) {
        const float4 x = v[j4];
        dh[4 * j4] = __fmaf_rn(x.x, d[r], dh[4 * j4]);
        dh[4 * j4 + 1] = __fmaf_rn(x.y, d[r], dh[4 * j4 + 1]);
        dh[4 * j4 + 2] = __fmaf_rn(x.z, d[r], dh[4 * j4 + 2]);
        dh[4 * j4 + 3] = __fmaf_rn(x.w, d[r], dh[4 * j4 + 3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kH; ++j) {
    dh[j] = h[j] > 0.f ? dh[j] : 0.f;
    row[kRowH + j] = h[j];
    row[kRowDh + j] = dh[j];
  }
#pragma unroll 4
  for (int k = 0; k < kF; ++k) {
    const float4* v = reinterpret_cast<const float4*>(w + k * kH);
    float acc = 0.f;
#pragma unroll
    for (int j4 = 0; j4 < kH / 4; ++j4) {
      const float4 x = v[j4];
      acc = __fmaf_rn(x.x, dh[4 * j4], acc);
      acc = __fmaf_rn(x.y, dh[4 * j4 + 1], acc);
      acc = __fmaf_rn(x.z, dh[4 * j4 + 2], acc);
      acc = __fmaf_rn(x.w, dh[4 * j4 + 3], acc);
    }
    row[kRowDz + k] += acc;
  }
}

// The CTA's sums of MLP M's weight gradients over its ``n`` rows, added to
// its partials ``wacc`` (flat layout). W1 and b1 are the outer products
// d h_pre x [z, 1] (32 x 36 columns of a row), W2 and b2 d out x [1,
// relu(h)] (m x 33, read as 36); each thread owns fixed 4 x 4 tiles of
// them and sums a tile's 16 products a row from 8 loads.
template <int M>
__device__ void weight_grads(const float* rows, int n, float* wacc) {
  constexpr int m = out_of(M);
  constexpr int kL1 = kH / 4, kL2 = (m + 3) / 4, kR = (kIn + 1 + 3) / 4;
  constexpr int kB1e = kH * kIn, kW2e = kB1e + kH, kB2e = kW2e + m * kH;
  for (int tile = threadIdx.x; tile < (kL1 + kL2) * kR; tile += kThreads) {
    const bool first = tile < kL1 * kR;
    const int lb = first ? tile / kR : tile / kR - kL1;
    const int rb = tile % kR;
    const int L0 = (first ? kRowDh : kRowDo) + 4 * lb;
    const int R0 = (first ? kRowZ : kRowOne) + 4 * rb;
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    }
#pragma unroll 2
    for (int r = 0; r < n; ++r) {
      const float* row = rows + r * kRow;
      float lv[4], rv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        lv[q] = row[L0 + q];
        rv[q] = row[R0 + q];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = __fmaf_rn(lv[u], rv[v], acc[u][v]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int li = 4 * lb + u, ri = 4 * rb + v;
        int e = -1;
        if (first) {  // j = li, k = ri: W1[j][k], or b1[j] at k = kIn
          e = ri < kIn ? li * kIn + ri : (ri == kIn ? kB1e + li : -1);
        } else if (li < m) {  // i = li, c = ri: b2[i] at 0, W2[i][c - 1]
          e = ri == 0 ? kB2e + li : (ri <= kH ? kW2e + li * kH + ri - 1 : -1);
        }
        if (e >= 0) wacc[flat_base(M) + e] += acc[u][v];
      }
    }
  }
}

// Appends the visible anchors among the CTA's ``idx`` to ``queue`` after
// its ``qn`` entries, in thread order; returns the new length.
__device__ int append(bool vis, int idx, int* queue, int qn, int* warp_n) {
  const unsigned mask = __ballot_sync(0xffffffffu, vis);
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (lane == 0) warp_n[wid] = __popc(mask);
  __syncthreads();
  int off = qn, total = qn;
  for (int v = 0; v < kThreads / 32; ++v) {
    if (v < wid) off += warp_n[v];
    total += warp_n[v];
  }
  if (vis) queue[off + __popc(mask & ((1u << lane) - 1u))] = idx;
  __syncthreads();
  return total;
}

// Drops the first ``n`` of ``qn`` queued entries (qn - n < kThreads).
__device__ int pop(int* queue, int qn, int n) {
  const int rest = qn - n;
  __syncthreads();
  const int v = (int)threadIdx.x < rest ? queue[n + threadIdx.x] : 0;
  __syncthreads();
  if ((int)threadIdx.x < rest) queue[threadIdx.x] = v;
  __syncthreads();
  return rest;
}

// The output gradients of each head's slot t from its outputs ``o``: the
// opacity's tanh, the scale's sigmoid and the rotation's normalisation,
// the colour's sigmoid; zero where the slot is masked. The scales'
// gradient (d l[3:6]) is added to the row.
struct OpacityDout {
  const float* g_alpha;
  int A, i;
  unsigned keep;
  __device__ __forceinline__ void operator()(int t, const float* o,
                                             float* d, float*) const {
    const float al = tanhf(o[0]);
    const float g = (keep >> t) & 1u ? g_alpha[t * A + i] : 0.f;
    d[0] = g * (1.f - al * al);
  }
};

struct CovDout {
  const float* g_s;
  const float* g_q;
  int A, i;
  unsigned keep;
  float l3, l4, l5;
  __device__ __forceinline__ void operator()(int t, const float* o, float* d,
                                             float* row) const {
    const int s = t * A + i;
    if (!((keep >> t) & 1u)) {
#pragma unroll
      for (int r = 0; r < 7; ++r) d[r] = 0.f;
      return;
    }
    const float l[3] = {l3, l4, l5};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float sg = sigmoid(o[c]);
      const float g = g_s[s * 3 + c];
      row[kRowDl + 3 + c] += g * sg;
      d[c] = g * l[c] * (1.f - sg) * sg;
    }
    // q = r / max(|r|, 1e-12), r = (w, x, y, z) = o[3..6]; its gradient
    // arrives in (x, y, z, w).
    const float4 gq = reinterpret_cast<const float4*>(g_q)[s];
    const float gr[4] = {gq.w, gq.x, gq.y, gq.z};
    const float nr = sqrtf(o[3] * o[3] + o[4] * o[4] + o[5] * o[5] +
                           o[6] * o[6]);
    const float nn = fmaxf(nr, 1e-12f);
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) dot += (o[3 + c] / nn) * gr[c];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      d[3 + c] = nr > 1e-12f ? (gr[c] - (o[3 + c] / nn) * dot) / nn
                             : gr[c] / nn;
    }
  }
};

struct ColorDout {
  const float* g_color;
  int A, i;
  unsigned keep;
  __device__ __forceinline__ void operator()(int t, const float* o, float* d,
                                             float*) const {
    const bool kept = (keep >> t) & 1u;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float col = sigmoid(o[c]);
      d[c] = kept ? g_color[(t * A + i) * 3 + c] * (1.f - col) * col : 0.f;
    }
  }
};

// D2's work on the queued visible anchor i of this thread: its row, d
// offset, d anchor_feat and d scale_raw, with the three heads' weight sums
// over the CTA's ``n`` rows between them.
__device__ void backward_tile(const Args& a, const float* sw, float* rows,
                              float* wacc, int i, int n) {
  const int A = a.anchors;
  const bool mine = (int)threadIdx.x < n;
  float* row = rows + threadIdx.x * kRow;
  unsigned keep = 0u;
  if (mine) {
    float z[kIn];
    inputs(a, i, z);
#pragma unroll
    for (int k = 0; k < kIn; ++k) row[kRowZ + k] = z[k];
    row[kRowOne] = 1.f;
#pragma unroll
    for (int k = 0; k < kF + 6; ++k) row[kRowDz + k] = 0.f;
    // The mask, all ten slots' loads issued together.
#pragma unroll
    for (int t = 0; t < kK; ++t) {
      if (a.keep[t * A + i]) keep |= 1u << t;
    }
    // mu = x + O l[0:3]
    float l[3], dl[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 3; ++c) l[c] = expf(a.scale_raw[i * 6 + c]);
#pragma unroll 1
    for (int t = 0; t < kK; ++t) {
      const int s = t * A + i;
      const bool kept = (keep >> t) & 1u;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float g = kept ? a.g_mu[s * 3 + c] : 0.f;
        a.d_offset[(size_t)i * 3 * kK + 3 * t + c] = g * l[c];
        dl[c] += g * a.offset[(size_t)i * 3 * kK + 3 * t + c];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) row[kRowDl + c] = dl[c];
    head_bwd<0, 1>(sw, row, OpacityDout{a.g_alpha, A, i, keep});
  }
  __syncthreads();
  weight_grads<0>(rows, n, wacc);
  __syncthreads();
  if (mine) {
    head_bwd<1, 7>(sw, row,
                   CovDout{a.g_s, a.g_q, A, i, keep,
                           expf(a.scale_raw[i * 6 + 3]),
                           expf(a.scale_raw[i * 6 + 4]),
                           expf(a.scale_raw[i * 6 + 5])});
  }
  __syncthreads();
  weight_grads<1>(rows, n, wacc);
  __syncthreads();
  if (mine) {
    head_bwd<2, 3>(sw, row, ColorDout{a.g_color, A, i, keep});
#pragma unroll
    for (int k = 0; k < kF; ++k) {
      a.d_feat[(size_t)i * kF + k] = row[kRowDz + k];
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      a.d_scale_raw[i * 6 + c] = row[kRowDl + c] * expf(a.scale_raw[i * 6 + c]);
    }
  }
  __syncthreads();
  weight_grads<2>(rows, n, wacc);
}

// D2: a persistent CTA walks a contiguous range of anchors and queues the
// visible ones in shared memory (a ballot a warp); each full queue (or the
// last) is a tile, a thread a queued anchor. The anchors' gradient leaves
// come zeroed: an invisible anchor's stay zero.
__global__ void __launch_bounds__(kThreads)
    scaffold_d2_kernel(Args a, int per_cta) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* wacc = sw + kSmemW;
  float* rows = wacc + pad4(kNumW);
  __shared__ int queue[2 * kThreads];
  __shared__ int warp_n[kThreads / 32];
  load_weights(a, sw);
  for (int e = threadIdx.x; e < kNumW; e += kThreads) wacc[e] = 0.f;
  __syncthreads();
  const int lo = blockIdx.x * per_cta;
  const int hi = min(a.anchors, lo + per_cta);
  int qn = 0;
  for (int base = lo; base < hi; base += kThreads) {
    const int i = base + threadIdx.x;
    qn = append(i < hi && a.visible[i], i, queue, qn, warp_n);
    const bool last = base + kThreads >= hi;
    while (qn >= kThreads || (last && qn > 0)) {
      const int n = min(qn, kThreads);
      backward_tile(a, sw, rows, wacc,
                    (int)threadIdx.x < n ? queue[threadIdx.x] : 0, n);
      qn = pop(queue, qn, n);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kNumW; e += kThreads) {
    a.partials[(size_t)blockIdx.x * kNumW + e] = wacc[e];
  }
}

// d_w[e] = the CTAs' partials of element e, added in CTA order.
__global__ void scaffold_reduce_kernel(const float* partials, int ctas,
                                       float* d_w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kNumW) return;
  float acc = 0.f;
  for (int b = 0; b < ctas; ++b) acc += partials[(size_t)b * kNumW + e];
  d_w[e] = acc;
}

constexpr size_t kD1Smem = (size_t)kSmemW * sizeof(float);
constexpr size_t kD2Smem =
    (size_t)(kSmemW + pad4(kNumW) + kThreads * kRow) * sizeof(float);

int ctas_for(const void* kernel, size_t smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return (int)err;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  return 0;
}

int per_cta(int anchors, int ctas) {
  const int n = (anchors + ctas - 1) / ctas;
  return (n + kThreads - 1) / kThreads * kThreads;
}

}  // namespace

// scaffold_args_bytes(): Args' size, for the wrapper's check of its own
// layout.
extern "C" long long scaffold_args_bytes() { return (long long)sizeof(Args); }

// scaffold_decode(args, stream) -> cudaError_t: D1 over every anchor.
extern "C" int scaffold_decode(const void* args, void* stream) {
  const Args a = *static_cast<const Args*>(args);
  if (a.anchors <= 0) return 0;
  scaffold_d1_kernel<<<(a.anchors + kThreads - 1) / kThreads, kThreads,
                       kD1Smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// scaffold_decode_bwd_ctas(int* n) -> cudaError_t: D2's CTAs (every SM's
// resident CTAs on the current device): the rows of its partials.
extern "C" int scaffold_decode_bwd_ctas(int* n) {
  static int ctas = 0;
  if (ctas == 0) {
    const int err = ctas_for((const void*)scaffold_d2_kernel, kD2Smem, &ctas);
    if (err != 0) return err;
  }
  *n = ctas;
  return 0;
}

// scaffold_decode_bwd(args, ctas, stream) -> cudaError_t: D2 with
// ``ctas`` CTAs (scaffold_decode_bwd_ctas), then the partials' sum.
extern "C" int scaffold_decode_bwd(const void* args, int ctas, void* stream) {
  const Args a = *static_cast<const Args*>(args);
  if (a.anchors <= 0 || ctas <= 0) return (int)cudaErrorInvalidValue;
  int n = 0;
  int err = scaffold_decode_bwd_ctas(&n);
  if (err != 0) return err;
  scaffold_d2_kernel<<<ctas, kThreads, kD2Smem, (cudaStream_t)stream>>>(
      a, per_cta(a.anchors, ctas));
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  scaffold_reduce_kernel<<<(kNumW + 255) / 256, 256, 0,
                           (cudaStream_t)stream>>>(a.partials, ctas, a.d_w);
  return (int)cudaGetLastError();
}
