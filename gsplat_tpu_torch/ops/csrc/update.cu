// The training update for Hopper (sm_90a): the position clip, the dead-slot
// mask, the NaN guard and Adam over every leaf of the optimizer, in two
// launches (ops/update.py::adam_update).
//
// Replaces no Pallas kernel: the JAX package updates with optax under XLA
// (gsplat_tpu/train/trainer.py). The port's update was a chain of PyTorch
// operations a leaf: the clip's norm and scale, a torch.where for the dead
// slots, three clones of every parameter and moment for the guard,
// torch.optim.Adam's single-tensor step (about 17 elementwise kernels a
// leaf) and a torch.where a tensor to restore a non-finite step: about 170
// bytes moved a float and some 300 launches for nine leaves.
//
// Bound. Nothing here computes much; bytes bound it. The update needs one
// read of every gradient to decide the guard and the clip (4 B a float),
// then one pass that reads gradient, parameter and both moments (16 B) and
// writes the last three (12 B): 32 B a float, 5.3 ms for the 553.5 M
// floats of a 128-channel Feature 3DGS pool of 2,959,677 slots at
// 3.35 TB/s. The design makes exactly those two passes:
//   * update_check (U1): reads every gradient leaf once (the slot mask
//     only where an element is non-finite) and writes into
//     a small work buffer the step's non-finite flag (the loss, an alive
//     row's element of any leaf, every element of the slotless decoder,
//     or a NaN anywhere in the position gradient while some slot is
//     alive: the elements the masked, clipped gradients Adam would get
//     can be non-finite at) and the position gradient's sum of squares,
//     accumulated in double: per-block partials, then the last block to
//     finish (a completion counter, which it resets) sums them in a fixed
//     order, so a step is reproducible and no float atomic is used. That
//     block also works out each leaf's bias corrections in double from
//     its count plus one and its learning rate (read from the device
//     where the group's lr is a tensor, the position schedule's), as
//     PyTorch's Adam does on the host when its counts are there: float32
//     powers of 0.999 would be 2.5e-5 off at the second step;
//   * between the two, a gaussian-sharded step all-reduces the flag (max)
//     and the sum (sum) in place in that buffer;
//   * update_apply (U2): one grid-stride walk over every leaf, 16-byte
//     loads where a leaf's four tensors are 16-byte aligned (a scalar
//     tail), each element: the clip scale min(clip / (norm + 1e-6), 1) on
//     the position leaf, zero where the slot (element / floats a slot) is
//     dead, then Adam. A non-finite step (with the guard on) writes no
//     parameter, moment or count; the clipped, masked position gradient
//     is written back in place either way (the step's pos_grad). Block 0
//     advances each leaf's count: nothing in U2 reads a count (U1 read
//     them), so no block can see it move.
// The elementwise arithmetic is PyTorch's capturable single-tensor Adam,
// operation by operation, with the roundings its CUDA kernels give (found
// on the card): exp_avg.lerp_(g, 1 - b1) = fma(1 - b1, g - m, m);
// exp_avg_sq.mul_(b2).addcmul_(g, g, 1 - b2) = fma(1 - b2, g * g, v * b2);
// denom = sqrt(v) / (sqrt(bc2) * -step_size) + eps / -step_size, the two
// scalars rounded to float from double; param += exp_avg / denom. The
// clip's scale is reciprocal(norm + 1e-6) * clip (Python's float over a
// tensor). Built with -fmad=false, every other product and sum rounds on
// its own, as there, so the kernels equal
// ops/update.py::adam_update_plain on the card bit for bit. Each launcher
// returns the launch's cudaError_t; neither synchronises or allocates (the
// wrapper passes the work buffer).

#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 9;  // six leaves, f_sem and the decoder's two
constexpr int kCheckMaxBlocks = 1024;

struct Leaf {
  float* param;
  float* grad;
  float* exp_avg;
  float* exp_avg_sq;
  float* count;         // Adam's step count, [] f32
  const float* lr_ptr;  // the group's lr on the device, or null
  long long numel;
  double lr;            // the group's lr where lr_ptr is null
  double beta1;
  double beta2;
  double eps;
  int per_slot;         // floats a slot; 0: no slots (never masked)
  int vec;              // the four tensors take 16-byte loads
};

struct Table {
  Leaf leaf[kMaxLeaves];
  const unsigned char* alive;  // [slots] bool
  const float* loss;           // [] f32
  int n;                       // leaves
  int pos;                     // the clipped leaf, -1 for none
  float max_norm;
  int guard;                   // a non-finite step writes nothing
  int slots;
};

struct Work {
  float flag;   // 1: the step is non-finite
  float sumsq;  // the position gradient's sum of squares
  float pad0[2];
  float scal[kMaxLeaves][4];  // sqrt(bc2) * -step_size, eps / -step_size,
                              // the count + 1, unused
  unsigned int done;          // U1's finished blocks; the last resets it
  unsigned int pad1[3];
  int bits[kCheckMaxBlocks];
  double part[kCheckMaxBlocks];
};

// U1's flag bits, OR-ed over the grid.
constexpr int kBadAlive = 1;  // a non-finite element in an alive row
constexpr int kPosNaN = 2;    // a NaN in the position gradient

__device__ __forceinline__ bool alive_at(const Table& t, int per_slot,
                                         long long i) {
  return per_slot == 0 ||
         t.alive[(unsigned int)i / (unsigned int)per_slot] != 0;
}

// Whether elements i..i+3 lie in alive slots: one division, then the
// rows of the next three (at most three slot boundaries ahead).
__device__ __forceinline__ void alive4(const Table& t, int per_slot,
                                       long long i, bool live[4]) {
  if (per_slot == 0) {
    live[0] = live[1] = live[2] = live[3] = true;
    return;
  }
  const unsigned int ps = (unsigned int)per_slot;
  const unsigned int r0 = (unsigned int)i / ps;
  const unsigned int rem = (unsigned int)i - r0 * ps;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned int k = rem + j;
    live[j] = t.alive[r0 + (k >= ps) + (k >= 2 * ps) + (k >= 3 * ps)] != 0;
  }
}

// The slot mask is read only for a non-finite element (rare), so the walk
// is one read of the gradient.
__device__ __forceinline__ void check_one(const Table& t, int per_slot,
                                          bool is_pos, long long i, float x,
                                          double& sq, int& bits) {
  if (is_pos) sq += (double)x * (double)x;
  if (!isfinite(x)) {
    if (is_pos && x != x) bits |= kPosNaN;
    if (alive_at(t, per_slot, i)) bits |= kBadAlive;
  }
}

template <typename T>
__device__ __forceinline__ T block_sum(T v, T* shared) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) shared[warp] = v;
  __syncthreads();
  T s = 0;
  if (threadIdx.x == 0) {
    for (int k = 0; k < kThreads / 32; ++k) s += shared[k];
  }
  __syncthreads();
  return s;  // thread 0's is the block's
}

// The OR of the flag bits over the block, on every thread.
__device__ __forceinline__ int block_or(int bits) {
  return (__syncthreads_or(bits & kBadAlive) ? kBadAlive : 0) |
         (__syncthreads_or(bits & kPosNaN) ? kPosNaN : 0);
}

__global__ void __launch_bounds__(kThreads) check_kernel(const Table t,
                                                         Work* __restrict__ w) {
  __shared__ double s_sq[kThreads / 32];
  __shared__ bool s_last;
  double sq = 0.0;
  int bits = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
#pragma unroll
  for (int l = 0; l < kMaxLeaves; ++l) {
    if (l < t.n) {
      const Leaf& L = t.leaf[l];
      const bool is_pos = l == t.pos;
      const long long units = L.vec ? (L.numel + 3) >> 2 : L.numel;
      for (long long u = first; u < units; u += stride) {
        if (L.vec && (u << 2) + 4 <= L.numel) {
          const float4 g = __ldcs(reinterpret_cast<const float4*>(L.grad) + u);
          const long long i = u << 2;
          check_one(t, L.per_slot, is_pos, i, g.x, sq, bits);
          check_one(t, L.per_slot, is_pos, i + 1, g.y, sq, bits);
          check_one(t, L.per_slot, is_pos, i + 2, g.z, sq, bits);
          check_one(t, L.per_slot, is_pos, i + 3, g.w, sq, bits);
        } else {
          const long long i0 = L.vec ? u << 2 : u;
          const long long i1 = L.vec ? min(i0 + 4, L.numel) : i0 + 1;
          for (long long i = i0; i < i1; ++i) {
            check_one(t, L.per_slot, is_pos, i, L.grad[i], sq, bits);
          }
        }
      }
    }
  }
  const double bsq = block_sum(sq, s_sq);
  const int bbits = block_or(bits);
  if (threadIdx.x == 0) {
    w->part[blockIdx.x] = bsq;
    w->bits[blockIdx.x] = bbits;
    __threadfence();
    s_last = atomicAdd(&w->done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // The last block: every partial is written and visible (the fence
  // before each block's ticket); read them past L1, in a fixed order.
  __threadfence();
  double tsq = 0.0;
  int tbits = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    tsq += __ldcg(&w->part[b]);
    tbits |= __ldcg(&w->bits[b]);
  }
  const double total = block_sum(tsq, s_sq);
  const int all = block_or(tbits);
  // A NaN in the position gradient makes the clip's scale NaN, which the
  // mask then keeps in every alive row: is any slot alive?
  int some_alive = 0;
  if ((all & kPosNaN) != 0) {
    for (int i = threadIdx.x; i < t.slots; i += kThreads) {
      some_alive |= t.alive[i];
    }
    some_alive = __syncthreads_or(some_alive);
  }
  if (threadIdx.x != 0) return;
  const bool bad = !isfinite(*t.loss) || (all & kBadAlive) != 0 ||
                   some_alive != 0;
  w->flag = bad ? 1.f : 0.f;
  w->sumsq = (float)total;
#pragma unroll
  for (int l = 0; l < kMaxLeaves; ++l) {
    if (l < t.n) {
      const Leaf& L = t.leaf[l];
      const float count = __fadd_rn(*L.count, 1.f);
      const double c = (double)count;
      const double bc1 = __dsub_rn(1.0, pow(L.beta1, c));
      const double bc2 = __dsub_rn(1.0, pow(L.beta2, c));
      const double lr = L.lr_ptr != nullptr ? (double)*L.lr_ptr : L.lr;
      const double ssn = -__ddiv_rn(lr, bc1);
      w->scal[l][0] = __double2float_rn(__dmul_rn(__dsqrt_rn(bc2), ssn));
      w->scal[l][1] = __double2float_rn(__ddiv_rn(L.eps, ssn));
      w->scal[l][2] = count;
      w->scal[l][3] = 0.f;
    }
  }
  w->done = 0u;
}

// One element of U2: g in, the clipped and masked gradient out in g (the
// caller stores it for the position leaf); p, m, v updated unless skip.
struct Coef {
  float w1;  // lerp's weight, 1 - beta1
  float b2;  // beta2
  float w2;  // addcmul's value, 1 - beta2
  float d1;  // sqrt(bc2) * -step_size
  float e;   // eps / -step_size
};

__device__ __forceinline__ void apply_one(const Coef& k, bool live,
                                          bool is_pos, float scale,
                                          bool skip, float& g, float& p,
                                          float& m, float& v) {
  float x = is_pos ? __fmul_rn(g, scale) : g;
  if (!live) x = 0.f;
  g = x;
  if (skip) return;
  m = __fmaf_rn(k.w1, __fsub_rn(x, m), m);
  v = __fmaf_rn(k.w2, __fmul_rn(x, x), __fmul_rn(v, k.b2));
  const float den = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), k.d1), k.e);
  p = __fadd_rn(p, __fdiv_rn(m, den));
}

// At least one block a SM: ptxas then keeps U2 in 46 registers; with the
// thread count alone it capped it at 40 and spilled a leaf's constants.
__global__ void __launch_bounds__(kThreads, 1) apply_kernel(
    const Table t, const Work* __restrict__ w, int* __restrict__ skipped) {
  const bool skip = t.guard != 0 && w->flag != 0.f;
  // clamp(clip / (sqrt(sum) + 1e-6), max=1): a float over a tensor is
  // reciprocal(tensor) * float; a NaN stays NaN, as torch.clamp keeps it.
  const float s = __fmul_rn(
      __fdiv_rn(1.f, __fadd_rn(__fsqrt_rn(w->sumsq), 1e-6f)), t.max_norm);
  const float scale = s > 1.f ? 1.f : s;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
#pragma unroll
  for (int l = 0; l < kMaxLeaves; ++l) {
    if (l < t.n) {
      const Leaf& L = t.leaf[l];
      const bool is_pos = l == t.pos;
      // The float constants as PyTorch rounds Python's doubles for its
      // kernels (1 - beta1 is taken in double first).
      const Coef k = {__double2float_rn(__dsub_rn(1.0, L.beta1)),
                      __double2float_rn(L.beta2),
                      __double2float_rn(__dsub_rn(1.0, L.beta2)),
                      w->scal[l][0], w->scal[l][1]};
      const long long units = L.vec ? (L.numel + 3) >> 2 : L.numel;
      for (long long u = first; u < units; u += stride) {
        if (L.vec && (u << 2) + 4 <= L.numel) {
          const long long i = u << 2;
          float4 g = __ldcs(reinterpret_cast<const float4*>(L.grad) + u);
          float4 p = make_float4(0.f, 0.f, 0.f, 0.f), m = p, v = p;
          if (!skip) {
            p = __ldcs(reinterpret_cast<const float4*>(L.param) + u);
            m = __ldcs(reinterpret_cast<const float4*>(L.exp_avg) + u);
            v = __ldcs(reinterpret_cast<const float4*>(L.exp_avg_sq) + u);
          }
          bool live[4];
          alive4(t, L.per_slot, i, live);
          apply_one(k, live[0], is_pos, scale, skip, g.x, p.x, m.x, v.x);
          apply_one(k, live[1], is_pos, scale, skip, g.y, p.y, m.y, v.y);
          apply_one(k, live[2], is_pos, scale, skip, g.z, p.z, m.z, v.z);
          apply_one(k, live[3], is_pos, scale, skip, g.w, p.w, m.w, v.w);
          if (is_pos) __stcs(reinterpret_cast<float4*>(L.grad) + u, g);
          if (!skip) {
            __stcs(reinterpret_cast<float4*>(L.param) + u, p);
            __stcs(reinterpret_cast<float4*>(L.exp_avg) + u, m);
            __stcs(reinterpret_cast<float4*>(L.exp_avg_sq) + u, v);
          }
        } else {
          const long long i0 = L.vec ? u << 2 : u;
          const long long i1 = L.vec ? min(i0 + 4, L.numel) : i0 + 1;
          for (long long i = i0; i < i1; ++i) {
            float g = L.grad[i];
            float p = 0.f, m = 0.f, v = 0.f;
            if (!skip) {
              p = L.param[i];
              m = L.exp_avg[i];
              v = L.exp_avg_sq[i];
            }
            apply_one(k, alive_at(t, L.per_slot, i), is_pos, scale,
                      skip, g, p, m, v);
            if (is_pos) L.grad[i] = g;
            if (!skip) {
              L.param[i] = p;
              L.exp_avg[i] = m;
              L.exp_avg_sq[i] = v;
            }
          }
        }
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (skipped != nullptr) *skipped = skip ? 1 : 0;
    if (!skip) {
#pragma unroll
      for (int l = 0; l < kMaxLeaves; ++l) {
        if (l < t.n) *t.leaf[l].count = w->scal[l][2];
      }
    }
  }
}

// Blocks that fill the card: resident blocks per SM times SMs, found once
// per kernel and device.
template <typename K>
int grid_for(K kernel, int cap) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0) != cudaSuccess) {
    return -1;
  }
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  return blocks < cap ? blocks : cap;
}

int check_table(const Table* t) {
  if (t == nullptr || t->n < 1 || t->n > kMaxLeaves || t->pos < -1 ||
      t->pos >= t->n || t->loss == nullptr || t->slots < 0 ||
      (t->slots > 0 && t->alive == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < t->n; ++l) {
    const Leaf& L = t->leaf[l];
    if (L.numel < 0 || L.numel >= (1LL << 31) || L.per_slot < 0 ||
        (L.per_slot > 0 && t->alive == nullptr) || L.count == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
  }
  return 0;
}

}  // namespace

// update_work_bytes(): the work buffer's size; the caller allocates it
// zeroed once and keeps it (U1 leaves its counter at 0).
extern "C" long long update_work_bytes() { return (long long)sizeof(Work); }

// update_table_bytes(): the leaf table's size, for the wrapper's check of
// its own layout.
extern "C" long long update_table_bytes() { return (long long)sizeof(Table); }

// update_check(table, work, stream) -> cudaError_t: U1.
extern "C" int update_check(const void* table, void* work, void* stream) {
  const Table* t = (const Table*)table;
  const int err = check_table(t);
  if (err != 0) return err;
  static int grid = 0;  // one card a process
  if (grid == 0) grid = grid_for(check_kernel, kCheckMaxBlocks);
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  check_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(*t, (Work*)work);
  return (int)cudaGetLastError();
}

// update_apply(table, work, skipped, stream) -> cudaError_t: U2. skipped:
// [] int32, 1 where a non-finite step was skipped (may be null).
extern "C" int update_apply(const void* table, const void* work,
                            void* skipped, void* stream) {
  const Table* t = (const Table*)table;
  const int err = check_table(t);
  if (err != 0) return err;
  static int grid = 0;
  if (grid == 0) grid = grid_for(apply_kernel, 1 << 16);
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  apply_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      *t, (const Work*)work, (int*)skipped);
  return (int)cudaGetLastError();
}
