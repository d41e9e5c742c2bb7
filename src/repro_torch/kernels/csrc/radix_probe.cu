// Radix index probe for Hopper (sm_90a): for every probe key q
//   b     = uint32(q) * 2654435761 >> (32 - bits)        (the bucket)
//   p     = lower bound of q in sorted_keys over the bucket's run,
//           [bucket_starts[b], bucket_starts[b + 1])
//   found = p lies in that run and sorted_keys[p] == q
//   vals  = found ? sorted_vals[p] : 0.0
// over the index of analytics/join.py's build_radix_index: keys sorted by
// (bucket, key) with stable sorts, so p is a key's first occurrence.
//
// Replaces no Pallas kernel: the JAX reference probes the index with a
// fixed-trip binary search over every probe lane at once
// (src/repro/analytics/join.py, probe_radix_index, a lax.fori_loop of
// n.bit_length() steps), which the port ran as 24 whole-tensor steps of
// int64 elementwise work and gathers at 16M keys x 256M probes (about 37 GB
// of device traffic a step). kernels/radix_probe/ref.py keeps that route as
// the plain version; this kernel gives its bits.
//
// What bounds it on this card. Bytes: each probe key read once and vals and
// found written once, with the index read once, is 2.43 GB at 16M x 256M,
// 0.73 ms at 3.35 TB/s. Before that, the search's loads: a probe searches
// its own bucket's run (~15.6K keys at bits = 10), 14 dependent loads. The
// top levels of all runs are a few MB and stay in L2; the bottom ones fall
// anywhere in the 64 MB of sorted keys, past the 50 MB L2, so those come
// from device memory as random 32-byte sectors, and the last three or four
// levels fall in the sector the one before brought into L1.
//
// Design (timed on an H100 at 16M x 256M against variants of it).
//   * The top kStaged levels of every bucket's search tree (the keys the
//     search reads at depths 0 .. kStaged-1, for every path) are staged once
//     per block in shared memory: 31 keys a bucket at five levels, 124 KB at
//     bits = 10 (with four keys a thread, staging none was 19% slower and
//     four levels 10%). The grid is persistent, one block an SM (as many as
//     fit), so the staging is paid once an SM and not once a tile; fewer
//     levels are staged when the buckets are too many to fit (none past
//     2^15 buckets).
//   * The rest of the search reads through L1 (__ldg): around L1 (__ldcg)
//     it takes twice as long. One key a thread, 1,024 threads an SM: two or
//     four keys a thread side by side, their loads issued together, were 4%
//     and 11% slower (more sectors in flight than L1 keeps), 512 threads 13%.
//   * The search is a lower bound over (lo, len), bounded by the run's own
//     length and not by n. It keeps whether the key at the run's current
//     upper end (a position it has read, or the run's end) equals q; when
//     len reaches 0 that end is p, so found needs no further load of the
//     keys, and a hit reads its value once.
//   * Probe keys are read and vals and found written coalesced, the keys
//     and vals as streaming accesses (evict first) beside the sorted keys.
// Nothing is summed, so the outputs are the same bits on every run and
// equal to the plain version's, a -0.0 or NaN payload included.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kStaged = 5;                    // search levels in shared memory
constexpr int kSmemBudget = 200 * 1024;       // bytes of staged keys a block
constexpr unsigned kKnuth = 2654435761u;      // analytics/hashing._KNUTH

__device__ __forceinline__ int bucket_of(int key, int bits) {
  return bits == 0 ? 0 : (int)(((unsigned)key * kKnuth) >> (32 - bits));
}

// One step of the lower bound of q over [lo, lo + len), with k the key at
// lo + len / 2: go right past it when k < q, else shrink to its left half
// (the new upper end is that key, so eq takes whether it equals q).
__device__ __forceinline__ void step(int k, int q, int& lo, int& len,
                                     bool& eq) {
  const int half = len >> 1;
  if (k < q) {
    lo += half + 1;
    len -= half + 1;
  } else {
    len = half;
    eq = k == q;
  }
}

// grid: persistent, the probe keys taken in stride; dynamic shared memory:
// ((1 << levels) - 1) << bits int32.
__global__ void __launch_bounds__(kThreads)
radix_probe_kernel(const int* __restrict__ sorted_keys,
                   const float* __restrict__ sorted_vals,
                   const long long* __restrict__ bucket_starts,
                   const int* __restrict__ probe_keys,
                   float* __restrict__ vals, uint8_t* __restrict__ found,
                   long long n_probe, int bits, int levels) {
  extern __shared__ int tree[];               // [bucket][node - 1]
  const int nodes = (1 << levels) - 1;
  const long long n_buckets = 1ll << bits;

  // stage: node i (1-based, children 2i and 2i + 1 to the left and right)
  // at depth d holds the key the search reads there, found by replaying
  // the path its bits spell from the bucket's whole run; 0 where the range
  // is empty (no search reads it)
  for (long long e = threadIdx.x; e < n_buckets * nodes; e += kThreads) {
    const int b = (int)(e / nodes);
    const int node = (int)(e % nodes) + 1;
    int lo = (int)__ldg(bucket_starts + b);
    int len = (int)__ldg(bucket_starts + b + 1) - lo;
    for (int d = 31 - __clz(node) - 1; d >= 0; --d) {
      const int half = len >> 1;
      if ((node >> d) & 1) {
        lo += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
    tree[e] = len > 0 ? __ldg(sorted_keys + lo + (len >> 1)) : 0;
  }
  __syncthreads();

  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < n_probe; idx += (long long)gridDim.x * kThreads) {
    const int key = __ldcs(probe_keys + idx);
    const int b = bucket_of(key, bits);
    int lo = (int)__ldg(bucket_starts + b);
    int len = (int)__ldg(bucket_starts + b + 1) - lo;
    bool eq = false;
    // the staged levels: node follows the path, read from shared memory
    const int* staged = tree + b * nodes;
    for (int d = 0, node = 1; d < levels && len > 0; ++d) {
      const int k = staged[node - 1];
      node = 2 * node + (k < key);
      step(k, key, lo, len, eq);
    }
    // the rest from global memory, through L1: the last levels read the
    // sector an earlier one brought in
    while (len > 0)
      step(__ldg(sorted_keys + lo + (len >> 1)), key, lo, len, eq);
    __stcs(vals + idx, eq ? __ldg(sorted_vals + lo) : 0.f);
    found[idx] = eq ? 1 : 0;
  }
}

}  // namespace

// sorted_keys (n,) int32 and sorted_vals (n,) f32, sorted by (bucket,
// key); bucket_starts (2^bits + 1,) int64, each bucket's run start, the
// last n; probe_keys (n_probe,) int32; vals (n_probe,) f32 and found
// (n_probe,) bool (one byte each) are written. n < 2^31, 0 <= bits <= 30.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int radix_probe_launch(const int* sorted_keys,
                                  const float* sorted_vals,
                                  const long long* bucket_starts,
                                  const int* probe_keys, float* vals,
                                  uint8_t* found, long long n_probe, int bits,
                                  void* stream) {
  if (n_probe <= 0) return 0;
  if (bits < 0 || bits > 30) return (int)cudaErrorInvalidValue;
  int levels = kStaged;
  while (levels > 0 &&
         ((((1ll << levels) - 1) << bits) * (long long)sizeof(int) >
          kSmemBudget))
    --levels;
  const size_t smem = (((size_t)1 << levels) - 1) * sizeof(int) << bits;
  cudaError_t err = cudaFuncSetAttribute(
      radix_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, radix_probe_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n_probe + kThreads - 1) / kThreads;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > tiles) grid = tiles;
  radix_probe_kernel<<<(unsigned)grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      sorted_keys, sorted_vals, bucket_starts, probe_keys, vals, found,
      n_probe, bits, levels);
  return (int)cudaGetLastError();
}
