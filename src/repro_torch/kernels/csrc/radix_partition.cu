// Per-block radix histograms for Hopper (sm_90a):
//   out[b, d] = #{ i in block b : ((uint32)keys[i] >> shift) & (n_bins-1) == d }
// The shift is LOGICAL: the key is read as uint32 before it is shifted, so a
// negative key (the -1 padding of the routed buffers) lands in the bin of
// its bit pattern, as in the reference's jax.lax.shift_right_logical.
//
// Replaces the TPU kernel block_histograms_pallas
// (src/repro/kernels/radix_partition/kernel.py:35, body _hist_kernel), which
// builds a (block x n_bins) one-hot of the digits in VMEM and reduces it
// with a matrix product on the MXU, so that no lane scatters into a shared
// histogram.
//
// What bounds it on this card: bytes. Each key is read once (4 bytes) and
// each block writes n_bins counts (4 bytes each): 4*N in, 4*(N/block)*n_bins
// out, one shift, one mask and one add per key. At the main path's route
// shape (N = 750,080 lineitem owners of one shard at SF1 on 8 shards, block
// 256, 8 bins) that is 3.1 MB, about 1 microsecond at 3.35 TB/s, so the
// launch itself (a few microseconds) dominates.
//
// Design: one warp counts one histogram block; a CUDA block of 8 warps
// walks histogram blocks with a grid-stride loop, so the route shape's
// 2,930 histogram blocks are 367 CUDA blocks, one wave. Keys come in as
// int4 loads, two a lane in flight, when the keys are 16-byte aligned and
// the block a multiple of 4; else as scalar loads.
//   * n_bins <= 32: counts in registers, no shared memory, no barrier.
//     Each lane keeps 4-bit counters, 8 bins to a word; a key adds
//     1 << 4 * (digit % 8) to word digit / 8. At most every 15 keys a lane
//     (every 8 with int4 loads), each word is split into four words of two
//     16-bit fields and summed over the warp by __reduce_add_sync (32 x 15
//     < 2^16), and lane d adds bin d's total to its count; lane d writes
//     bin d. A key costs a shift, a mask, a shift and an add, whatever the
//     bin count up to 8; one ballot a digit bit and key costs more (0.00243
//     ms of device time at the route shape against 0.00192 on an H100).
//   * n_bins 64-256: each warp keeps its own histogram of n_bins entries in
//     shared memory (only those n_bins are zeroed); lanes that hold the same
//     digit are combined with __match_any_sync before one INTEGER atomicAdd.
// Integer counts commute, so they are the same on every run.
//
// Diagnostic builds: -DBH_NO_WORK launches the same grid and writes zeros
// without reading a key (the launch floor of this grid); -DBH_LOAD_ONLY
// makes the register path read the keys and write their sums in place of
// counts (the floor of a kernel of this grid that reads them). Neither
// gives counts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBins = 256;
constexpr unsigned kFull = 0xffffffffu;

// The warp's total of bin 8w + (lane % 8), from each lane's word w of
// 4-bit counters (each at most 15).
__device__ __forceinline__ int word_total(unsigned c, int lane) {
  const unsigned lo = c & 0x0F0F0F0Fu, hi = (c >> 4) & 0x0F0F0F0Fu;
  // 16-bit fields: bins (0, 4), (2, 6), (1, 5), (3, 7) of the word
  const unsigned s0 = __reduce_add_sync(kFull, lo & 0x00FF00FFu);
  const unsigned s1 = __reduce_add_sync(kFull, (lo >> 8) & 0x00FF00FFu);
  const unsigned s2 = __reduce_add_sync(kFull, hi & 0x00FF00FFu);
  const unsigned s3 = __reduce_add_sync(kFull, (hi >> 8) & 0x00FF00FFu);
  const int d = lane & 7;
  const unsigned s = (d & 1) ? ((d & 2) ? s3 : s2) : ((d & 2) ? s1 : s0);
  return (int)((s >> ((d & 4) << 2)) & 0xFFFFu);
}

// A lane's 4-bit counters of 8 W bins, W words.
template <int W>
struct Nibbles {
  unsigned c[W];

  __device__ __forceinline__ Nibbles() {
#pragma unroll
    for (int w = 0; w < W; ++w) c[w] = 0;
  }

  __device__ __forceinline__ void add(int key, bool ok, int shift,
                                      unsigned mask) {
#ifdef BH_LOAD_ONLY
    c[0] += key;
#else
    const unsigned d = (static_cast<unsigned>(key) >> shift) & mask;
    const unsigned one = ok ? 1u << ((d & 7) << 2) : 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) c[w] += (d >> 3) == (unsigned)w ? one : 0u;
#endif
  }

  // The warp's total of bin ``lane`` (for lane < 8 W), the counters cleared.
  __device__ __forceinline__ int flush(int lane) {
    int total = 0;
#ifdef BH_LOAD_ONLY
    total = (int)c[0];
    c[0] = 0;
#else
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int t = word_total(c[w], lane);
      if ((lane >> 3) == w) total = t;
      c[w] = 0;
    }
#endif
    return total;
  }
};

template <int K, bool kVec>
__global__ void __launch_bounds__(kThreads)
hist_registers(const int* __restrict__ keys, int* __restrict__ out,
               long long n_blocks, int block, int shift) {
  const int lane = threadIdx.x & 31;
  const unsigned mask = (1u << K) - 1;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long hb = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       hb < n_blocks; hb += stride) {
    int count = 0;
#ifndef BH_NO_WORK
    Nibbles<(K <= 3 ? 1 : 1 << (K - 3))> n;
    const int* k = keys + hb * block;
    if (kVec) {
      const int4* k4 = reinterpret_cast<const int4*>(k);
      const int n4 = block >> 2;
      for (int base = 0; base < n4; base += 64) {
        const int i0 = base + lane, i1 = i0 + 32;
        const bool ok0 = i0 < n4, ok1 = i1 < n4;
        const int4 zero = make_int4(0, 0, 0, 0);
        const int4 v0 = ok0 ? __ldcs(k4 + i0) : zero;
        const int4 v1 = ok1 ? __ldcs(k4 + i1) : zero;
        n.add(v0.x, ok0, shift, mask);
        n.add(v0.y, ok0, shift, mask);
        n.add(v0.z, ok0, shift, mask);
        n.add(v0.w, ok0, shift, mask);
        n.add(v1.x, ok1, shift, mask);
        n.add(v1.y, ok1, shift, mask);
        n.add(v1.z, ok1, shift, mask);
        n.add(v1.w, ok1, shift, mask);
        count += n.flush(lane);
      }
    } else {
      int pending = 0;
      for (int base = 0; base < block; base += 32) {
        const int i = base + lane;
        n.add(i < block ? __ldcs(k + i) : 0, i < block, shift, mask);
        if (++pending == 15) {
          count += n.flush(lane);
          pending = 0;
        }
      }
      if (pending) count += n.flush(lane);
    }
#endif
    if (lane < (1 << K)) out[hb * (1 << K) + lane] = count;
  }
}

__device__ __forceinline__ void add_peers(int* hist, int key, bool ok,
                                          int lane, int shift,
                                          unsigned mask) {
  const int digit = ok ? (int)((static_cast<unsigned>(key) >> shift) & mask)
                       : -1;
  const unsigned peers = __match_any_sync(kFull, digit);
  if (ok && lane == __ffs(peers) - 1) atomicAdd(hist + digit, __popc(peers));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
hist_shared(const int* __restrict__ keys, int* __restrict__ out,
            long long n_blocks, int block, int n_bins, int shift) {
  __shared__ int hist[kWarps][kMaxBins];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* hw = hist[warp];
  const unsigned mask = (unsigned)(n_bins - 1);
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long hb = (long long)blockIdx.x * kWarps + warp; hb < n_blocks;
       hb += stride) {
    for (int d = lane; d < n_bins; d += 32) hw[d] = 0;
    __syncwarp();
#ifndef BH_NO_WORK
    const int* k = keys + hb * block;
    if (kVec) {
      const int4* k4 = reinterpret_cast<const int4*>(k);
      const int n4 = block >> 2;
      for (int base = 0; base < n4; base += 32) {
        const int i = base + lane;
        const bool ok = i < n4;
        const int4 v = ok ? __ldcs(k4 + i) : make_int4(0, 0, 0, 0);
        add_peers(hw, v.x, ok, lane, shift, mask);
        add_peers(hw, v.y, ok, lane, shift, mask);
        add_peers(hw, v.z, ok, lane, shift, mask);
        add_peers(hw, v.w, ok, lane, shift, mask);
      }
    } else {
      for (int base = 0; base < block; base += 32) {
        const int i = base + lane;
        add_peers(hw, i < block ? __ldcs(k + i) : 0, i < block, lane, shift,
                  mask);
      }
    }
    __syncwarp();
#endif
    for (int d = lane; d < n_bins; d += 32) out[hb * n_bins + d] = hw[d];
    __syncwarp();                       // read out before the next zeroing
  }
}

template <bool kVec>
cudaError_t launch(const int* keys, int* out, long long n_blocks, int block,
                   int n_bins, int shift, unsigned grid, cudaStream_t s) {
  using Counts = void (*)(const int*, int*, long long, int, int);
  static const Counts registers[] = {
      hist_registers<0, kVec>, hist_registers<1, kVec>,
      hist_registers<2, kVec>, hist_registers<3, kVec>,
      hist_registers<4, kVec>, hist_registers<5, kVec>};
  const int K = __builtin_ctz(n_bins);
  if (K < 6)
    registers[K]<<<grid, kThreads, 0, s>>>(keys, out, n_blocks, block,
                                           shift);
  else
    hist_shared<kVec><<<grid, kThreads, 0, s>>>(keys, out, n_blocks, block,
                                                n_bins, shift);
  return cudaGetLastError();
}

}  // namespace

// keys (n_blocks * block,) int32; out (n_blocks, n_bins) int32 is written.
// n_bins is a power of two in [1, 256], 0 <= shift < 32, block >= 1.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int block_histograms_launch(const int* keys, int* out,
                                       long long n_blocks, int block,
                                       int n_bins, int shift, void* stream) {
  if (n_blocks <= 0) return 0;
  if (block < 1 || n_bins < 1 || n_bins > kMaxBins ||
      (n_bins & (n_bins - 1)) || shift < 0 || shift > 31)
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  // one warp a histogram block, at most 8 CUDA blocks an SM at a time
  const long long want = (n_blocks + kWarps - 1) / kWarps;
  const unsigned grid = (unsigned)(want < 8LL * sms ? want : 8LL * sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec =
      block % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  return (int)(vec ? launch<true>(keys, out, n_blocks, block, n_bins, shift,
                                  grid, s)
                   : launch<false>(keys, out, n_blocks, block, n_bins, shift,
                                   grid, s));
}
