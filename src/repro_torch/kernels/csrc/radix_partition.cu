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
// Design. The one-hot product is not carried over: it spends n_bins
// multiply-adds per key where one integer add does. One CUDA block counts
// one histogram block. Each warp keeps a private histogram in shared memory
// and adds to it with INTEGER atomicAdd, which commutes, so the counts are
// the same on every run. Lanes of a warp that hold the same digit are
// combined first (__match_any_sync), so a warp issues one atomic per
// distinct digit and the few-bin routing case does not serialise 32 lanes
// on one address. The warps' histograms are added in warp order at the end.
// Any n_bins that is a power of two up to 256 and any block size work: the
// threads stride over the block in steps of the block's thread count.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBins = 256;

__global__ void __launch_bounds__(kThreads)
block_hist_kernel(const int* __restrict__ keys, int* __restrict__ out,
                  int block, int n_bins, int shift) {
  __shared__ int hist[kWarps][kMaxBins];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kWarps * kMaxBins; i += kThreads)
    (&hist[0][0])[i] = 0;
  __syncthreads();

  const int* k = keys + (long long)blockIdx.x * block;
  const unsigned mask = (unsigned)(n_bins - 1);
  // every lane runs the same number of steps, so the warp is converged at
  // each __match_any_sync; lanes past the block's end hold digit -1
  for (int base = 0; base < block; base += kThreads) {
    const int i = base + threadIdx.x;
    const int digit =
        i < block ? (int)(((unsigned)k[i] >> shift) & mask) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    if (digit >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&hist[warp][digit], __popc(peers));
  }
  __syncthreads();

  int* o = out + (long long)blockIdx.x * n_bins;
  for (int d = threadIdx.x; d < n_bins; d += kThreads) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += hist[w][d];
    o[d] = total;
  }
}

}  // namespace

// keys (n_blocks * block,) int32; out (n_blocks, n_bins) int32 is written.
// n_bins is a power of two in [1, 256], 0 <= shift < 32, block >= 1.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int block_histograms_launch(const int* keys, int* out,
                                       long long n_blocks, int block,
                                       int n_bins, int shift, void* stream) {
  if (n_blocks <= 0) return 0;
  block_hist_kernel<<<(unsigned)n_blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(keys, out, block,
                                                           n_bins, shift);
  return (int)cudaGetLastError();
}
