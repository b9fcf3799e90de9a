// Tile binning for Hopper (sm_90a): the pair emission, the stable sort by
// tile and the block-aligned scatter of ops/binning.py::bin_gaussians.
//
// Replaces no Pallas kernel: the JAX package bins with XLA operations
// (gsplat_tpu/ops/binning.py), and the port's plain PyTorch version
// (emit_pairs_plain, sort_pairs_plain, align_pairs_plain in
// ops/binning.py) did every step over all max_pairs slots with int64
// arrays: a searchsorted per slot and five gathers to expand, a
// scatter-add of a one per slot to count, an int64 sort of
// tile * (n + 1) + slot keys over all 64 bits, and an int64 decode and
// scatter to align, tens of GB a frame of 64 M slots. These kernels give
// the same integers bit for bit.
//
// Bound. Each step moves a few bytes per pair slot and computes almost
// nothing, so bytes bound them: at 3.35 TB/s a 64 M-slot frame needs
// about 8 B a slot to emit, 2 x 16 B to sort (two digit passes of an
// int32 key and an int32 payload, read and written) and 12 B to align,
// about 3.4 GB or 1 ms. The design keeps every pass over the slots int32
// and makes as few of them as the function allows:
//   * binning_emit: the pairs of each depth slot's tile rectangle, rows
//     then columns, at its post-drop exclusive offsets (the Kerbl et al.
//     duplicate-with-keys step). A gaussian near the camera covers
//     thousands of tiles and most cover a few, so threads are given pair
//     slots, not gaussians: a CTA owns a run of kEmitChunk consecutive
//     slots, two threads find the depth slots of its first and last real
//     pair with one binary search each over the offsets, and each thread
//     then finds the owner of each of its kEmitPer slots by a binary
//     search inside that short range, starting from the owner of its
//     previous slot. Neighbouring threads write neighbouring slots. Slots
//     past the kept demand get the sentinel tile num_tiles (and depth
//     slot n), which sorts after every real tile;
//   * binning_sort: CUB's stable LSD radix sort of the int32 tile keys
//     with the int32 depth slot as payload, over bits [0, end_bit) only,
//     end_bit = bit_length(num_tiles): 13 bits at 1080p, two 8-bit digit
//     passes instead of the eight of an int64 key. The emitted pairs are
//     in depth-slot order and a gaussian has at most one pair in a tile,
//     so a stable sort by tile alone gives the order of the unique int64
//     key tile * (n + 1) + slot: tile-major, front to back within a tile.
//     Ping-pong buffers (cub::DoubleBuffer): the temporary storage holds
//     only the sort's histograms and look-back state;
//   * binning_align: sorted pair p of tile t goes to padded_start[t] +
//     (p - real_start[t]) of the -1-filled pair_slot: real_start[t] is
//     where tile t's run starts in the sorted pairs (the wrapper finds it
//     with one binary search a tile) and padded_start the exclusive sum
//     of the runs' lengths rounded up to pair_block; no key decode.
// Each launcher returns the launch's cudaError_t; none synchronises or
// allocates (the wrapper passes every buffer, the sort's scratch
// included).

#include <cstddef>
#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int kEmitThreads = 256;
constexpr int kEmitPer = 4;  // pair slots a thread
constexpr int kEmitChunk = kEmitThreads * kEmitPer;
constexpr int kAlignThreads = 256;

// The largest g in [lo, hi] with offsets[g] <= p; offsets[lo] <= p.
__device__ __forceinline__ int owner(const long long* offsets, int lo,
                                     int hi, long long p) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo + 1) >> 1);
    if (offsets[mid] <= p) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// offsets [n + 1] (offsets[n] = kept demand <= max_pairs), tile_min
// [n, 2] (x, y) and n_u [n] int64, in depth order.
__global__ void __launch_bounds__(kEmitThreads) emit_kernel(
    const long long* __restrict__ offsets, int n,
    const long long* __restrict__ tile_min,
    const long long* __restrict__ n_u, int max_pairs, int tiles_x,
    int num_tiles, int* __restrict__ tile_id, int* __restrict__ slot) {
  __shared__ int range[2];
  const long long total = offsets[n];
  const long long base = (long long)blockIdx.x * kEmitChunk;
  if (threadIdx.x < 2 && base < total) {
    const long long last =
        (base + kEmitChunk < total ? base + kEmitChunk : total) - 1;
    range[threadIdx.x] =
        owner(offsets, 0, n - 1, threadIdx.x == 0 ? base : last);
  }
  __syncthreads();
  int g = base < total ? range[0] : 0;
  const int g_last = base < total ? range[1] : 0;
  for (int k = 0; k < kEmitPer; ++k) {
    const long long p = base + k * kEmitThreads + threadIdx.x;
    if (p >= max_pairs) break;
    int t = num_tiles;
    int s = n;
    if (p < total) {
      g = owner(offsets, g, g_last, p);  // slots rise with k
      const int local = (int)(p - offsets[g]);
      const int nu = (int)max(n_u[g], 1LL);
      const int tx = (int)tile_min[2 * (long long)g] + local % nu;
      const int ty = (int)tile_min[2 * (long long)g + 1] + local / nu;
      t = ty * tiles_x + tx;
      s = g;
    }
    tile_id[p] = t;
    slot[p] = s;
  }
}

__global__ void __launch_bounds__(kAlignThreads) align_kernel(
    const int* __restrict__ tile, const int* __restrict__ slot,
    int num_items, const long long* __restrict__ padded_start,
    const long long* __restrict__ real_start, int num_tiles,
    long long padded_pairs, int* __restrict__ pair_slot) {
  const long long p = (long long)blockIdx.x * kAlignThreads + threadIdx.x;
  if (p >= num_items) return;
  const int t = tile[p];
  if (t < 0 || t >= num_tiles) return;  // the sentinel: an unused slot
  const long long d = padded_start[t] + (p - real_start[t]);
  if (d >= 0 && d < padded_pairs) pair_slot[d] = slot[p];
}

}  // namespace

// binning_emit(offsets, n, tile_min, n_u, max_pairs, tiles_x, num_tiles,
//              tile_id, slot, stream): tile_id and slot [max_pairs] int32.
extern "C" int binning_emit(const void* offsets, int n, const void* tile_min,
                            const void* n_u, int max_pairs, int tiles_x,
                            int num_tiles, void* tile_id, void* slot,
                            void* stream) {
  if (n < 0 || max_pairs < 0 || tiles_x < 1 || num_tiles < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (max_pairs == 0) return 0;
  const int blocks = (int)(((long long)max_pairs + kEmitChunk - 1) /
                           kEmitChunk);
  emit_kernel<<<blocks, kEmitThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)offsets, n, (const long long*)tile_min,
      (const long long*)n_u, max_pairs, tiles_x, num_tiles, (int*)tile_id,
      (int*)slot);
  return (int)cudaGetLastError();
}

// binning_sort(temp, temp_bytes, keys, keys_alt, vals, vals_alt,
//              num_items, end_bit, selector, stream): with temp null, only
// writes the scratch bytes the sort needs into *temp_bytes (no launch);
// else sorts the int32 keys (non-negative, below 2^end_bit) with their
// int32 payload, stably, and writes into *selector which of the two
// buffer pairs holds the result (0: keys / vals, 1: keys_alt / vals_alt).
extern "C" int binning_sort(void* temp, size_t* temp_bytes, void* keys,
                            void* keys_alt, void* vals, void* vals_alt,
                            int num_items, int end_bit, int* selector,
                            void* stream) {
  if (num_items < 0 || end_bit < 1 || end_bit > 31) {
    return (int)cudaErrorInvalidValue;
  }
  cub::DoubleBuffer<unsigned int> k((unsigned int*)keys,
                                    (unsigned int*)keys_alt);
  cub::DoubleBuffer<int> v((int*)vals, (int*)vals_alt);
  cudaError_t err = cub::DeviceRadixSort::SortPairs(
      temp, *temp_bytes, k, v, num_items, 0, end_bit,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  if (temp != nullptr) {
    *selector = k.selector;
    err = cudaGetLastError();
  }
  return (int)err;
}

// binning_align(tile, slot, num_items, padded_start, real_start, num_tiles,
//               padded_pairs, pair_slot, stream): pair_slot [padded_pairs]
// int32, filled with -1 by the caller.
extern "C" int binning_align(const void* tile, const void* slot,
                             int num_items, const void* padded_start,
                             const void* real_start, int num_tiles,
                             long long padded_pairs, void* pair_slot,
                             void* stream) {
  if (num_items < 0 || num_tiles < 0 || padded_pairs < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_items == 0) return 0;
  const int blocks = (num_items + kAlignThreads - 1) / kAlignThreads;
  align_kernel<<<blocks, kAlignThreads, 0, (cudaStream_t)stream>>>(
      (const int*)tile, (const int*)slot, num_items,
      (const long long*)padded_start, (const long long*)real_start,
      num_tiles, padded_pairs, (int*)pair_slot);
  return (int)cudaGetLastError();
}
