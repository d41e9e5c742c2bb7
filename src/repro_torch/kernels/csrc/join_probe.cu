// Partition-wise PK-FK join probe for Hopper (sm_90a):
//   vals[p, q]  = sum, in build order, of build_vals[p, b] where
//                 build_keys[p, b] == probe_keys[p, q]
//   found[p, q] = any such b
// Key -1 is the padding of both sides and matches -1 like any key.
//
// Replaces the TPU kernel join_probe_pallas
// (src/repro/kernels/join_probe/kernel.py:40, body _probe_kernel), which
// keeps a partition's whole build tile in VMEM and multiplies a (probe
// block x build) equality matrix with the build values on the MXU.
//
// What bounds it on this card: bytes. The inputs are read once and the
// outputs written once: at q3's lineitem x orders call at SF1 (P = 64, Bk =
// 46,976, Pk = 187,520) that is 132 MB, 0.039 ms at 3.35 TB/s. Besides, a
// hashed probe makes about 12M dependent reads of its table (one or two per
// probe slot), which the 50 MB L2 serves; the table itself (64 MB at that
// call, cleared once) adds 0.020 ms of writes to the bytes, the design's
// own floor. There is no tensor-core form: the payload is an f32 row
// position, exact only below 2^24, so a match is taken as a value, never
// through a product.
//
// Design. Build keys are unique apart from the -1 padding (PK-FK), so each
// partition gets an open-addressing hash table of power-of-two capacity at
// least 2 Bk (load at most 1/2), in three steps on one stream:
//   1. the table is cleared to all ones (cudaMemsetAsync), which reads as
//      the empty entry (key field -1);
//   2. the build launch, one thread per build slot, inserts every slot
//      whose key is not -1 as one 64-bit entry (key << 32 | value bits),
//      claimed with atomicCAS and linear probing from a mixing hash of the
//      key taken as uint32 (unsigned arithmetic throughout: no arithmetic
//      shift; see hash_slot). The entry carries the value, so a probe makes
//      one dependent read per step and not three. Each build block also writes
//      its chunk's padding summary: whether a slot holds -1, and the sum of
//      those slots' values as a fixed tree over the block;
//   3. the probe launch, four slots a thread with coalesced reads of the
//      keys and writes of vals and found, walks the table from the key's
//      hash until an empty entry (a miss: 0 and false) or its key (a hit:
//      0.f + value, which is the nested loop's and the plain version's bits
//      also for a payload of -0.0). A key of -1 takes the partition's
//      padding summary, the chunk partials added in chunk order by one warp.
// Unique keys make the table's answers independent of the order in which
// the inserts land, and nothing is added with a float atomic, so the
// outputs are the same bits on every run.
//
// Duplicate build keys. An insert that meets its own key already in the
// table sets a device flag, and the wrapper raises on it: build keys other
// than -1 must be unique, the reference's own contract
// (src/repro/kernels/join_probe/ref.py). This is the one place where the
// kernel refuses an input that the nested-loop design it replaces summed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                  // probe slots per thread
constexpr unsigned long long kEmpty = ~0ull;   // key field -1

// The table entry where a key's walk starts: the top cap_log2 bits of
// murmur3's 32-bit finalizer of the key (kernels/join_probe/ops.py, mix32).
// Not a multiply-shift: the partitions are cut by the top bits of
// uint32(key) * 0x9E3779B1 (analytics/hashing.partition_of), so within one
// partition every key would share the top bits of such a hash and fill a
// 1/P slice of the table in one long run.
__device__ __forceinline__ unsigned hash_slot(int key, int cap_log2) {
  unsigned h = (unsigned)key;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h >> (32 - cap_log2);
}

__device__ __forceinline__ int entry_key(unsigned long long e) {
  return (int)(unsigned)(e >> 32);
}

// grid (n_chunks, P): one thread per build slot of a chunk of kThreads.
__global__ void __launch_bounds__(kThreads)
join_build_kernel(const int* __restrict__ build_keys,
                  const float* __restrict__ build_vals,
                  unsigned long long* __restrict__ table,
                  float* __restrict__ pad_sum, int* __restrict__ pad_found,
                  int* __restrict__ duplicate, int Bk, int cap_log2) {
  __shared__ float warp_sum[kThreads / 32];
  const int p = blockIdx.y;
  const int b = blockIdx.x * kThreads + threadIdx.x;
  const long long at = (long long)p * Bk + b;
  const int key = b < Bk ? build_keys[at] : 0;
  const float val = b < Bk ? build_vals[at] : 0.f;
  const bool pad = b < Bk && key == -1;

  // the chunk's padding summary: a fixed tree over the block's threads
  float s = pad ? val : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  const int any_pad = __syncthreads_or(pad);
  if (threadIdx.x < 32) {
    float w = threadIdx.x < kThreads / 32 ? warp_sum[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = kThreads / 64; off > 0; off >>= 1)
      w = __fadd_rn(w, __shfl_xor_sync(0xffffffffu, w, off));
    if (threadIdx.x == 0) {
      const long long c = (long long)p * gridDim.x + blockIdx.x;
      pad_sum[c] = w;
      pad_found[c] = any_pad;
    }
  }

  if (b >= Bk || pad) return;
  unsigned long long* t = table + ((long long)p << cap_log2);
  const unsigned mask = (1u << cap_log2) - 1u;
  const unsigned long long e =
      ((unsigned long long)(unsigned)key << 32) | __float_as_uint(val);
  for (unsigned i = hash_slot(key, cap_log2);; i = (i + 1u) & mask) {
    const unsigned long long old = atomicCAS(t + i, kEmpty, e);
    if (old == kEmpty) return;
    if (entry_key(old) == key) {   // the same key twice: not PK-FK
      *duplicate = 1;
      return;
    }
  }
}

// grid (ceil(Pk / (kThreads * kPerThread)), P).
__global__ void __launch_bounds__(kThreads)
join_probe_kernel(const unsigned long long* __restrict__ table,
                  const float* __restrict__ pad_sum,
                  const int* __restrict__ pad_found,
                  const int* __restrict__ probe_keys, float* __restrict__ vals,
                  uint8_t* __restrict__ found, int Pk, int n_chunks,
                  int cap_log2) {
  __shared__ float s_pad_sum;
  __shared__ int s_pad_found;
  const int p = blockIdx.y;
  const long long base = (long long)blockIdx.x * kThreads * kPerThread;
  const int* pk = probe_keys + (long long)p * Pk;
  const unsigned long long* t = table + ((long long)p << cap_log2);
  const unsigned mask = (1u << cap_log2) - 1u;

  int key[kPerThread];
  unsigned pos[kPerThread];
  float val[kPerThread];
  bool hit[kPerThread], live[kPerThread];
  bool any_pad = false;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const long long idx = base + q * kThreads + threadIdx.x;
    key[q] = idx < Pk ? pk[idx] : 0;
    live[q] = idx < Pk && key[q] != -1;
    any_pad |= idx < Pk && key[q] == -1;
    pos[q] = hash_slot(key[q], cap_log2);
    val[q] = 0.f;
    hit[q] = false;
  }

  // the partition's padding summary, where a slot of the block needs it:
  // chunk partials added in chunk order (strided per lane, then a fixed
  // xor tree), so the same bits in every block
  if (__syncthreads_or(any_pad)) {
    if (threadIdx.x < 32) {
      const long long c0 = (long long)p * n_chunks;
      float s = 0.f;
      int f = 0;
      for (int c = threadIdx.x; c < n_chunks; c += 32) {
        s = __fadd_rn(s, pad_sum[c0 + c]);
        f |= pad_found[c0 + c];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
      f = __any_sync(0xffffffffu, f != 0);
      if (threadIdx.x == 0) {
        s_pad_sum = s;
        s_pad_found = f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      if (key[q] == -1) {
        val[q] = s_pad_sum;
        hit[q] = s_pad_found != 0;
      }
    }
  }

  // the walks of the thread's slots side by side, so their reads overlap
  bool any = false;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) any |= live[q];
  while (any) {
    any = false;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      if (!live[q]) continue;
      const unsigned long long e = t[pos[q]];
      const int k = entry_key(e);
      if (k == key[q]) {
        val[q] = __fadd_rn(0.f, __uint_as_float((unsigned)e));
        hit[q] = true;
        live[q] = false;
      } else if (k == -1) {
        live[q] = false;                       // an empty entry: a miss
      } else {
        pos[q] = (pos[q] + 1u) & mask;
        any = true;
      }
    }
  }

  float* pv = vals + (long long)p * Pk;
  uint8_t* pf = found + (long long)p * Pk;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const long long idx = base + q * kThreads + threadIdx.x;
    if (idx < Pk) {
      pv[idx] = val[q];
      pf[idx] = hit[q] ? 1 : 0;
    }
  }
}

}  // namespace

// build_keys/build_vals (P, Bk) int32/f32, probe_keys (P, Pk) int32; vals
// (P, Pk) f32 and found (P, Pk) bool (one byte each) are written. Scratch,
// allocated by the caller: table (P, 2^cap_log2) uint64 with 2^cap_log2 >=
// 2 Bk and 6 <= cap_log2 <= 31; pad_sum (P, n_chunks) f32 and pad_found
// (P, n_chunks) int32 with n_chunks = ceil(Bk / 256); duplicate, one int32,
// set to 1 when a partition holds a build key other than -1 twice.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int join_probe_launch(const int* build_keys, const float* build_vals,
                                 const int* probe_keys, float* vals,
                                 uint8_t* found, void* table, float* pad_sum,
                                 int* pad_found, int* duplicate, int P, int Bk,
                                 int Pk, int cap_log2, void* stream) {
  if (P <= 0 || Pk <= 0) return 0;
  if (Bk < 0 || cap_log2 < 6 || cap_log2 > 31 ||
      (long long)Bk * 2 > (1ll << cap_log2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* tab = static_cast<unsigned long long*>(table);
  cudaError_t err = cudaMemsetAsync(
      tab, 0xff, ((size_t)P << cap_log2) * sizeof(unsigned long long), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(duplicate, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (Bk + kThreads - 1) / kThreads;
  if (n_chunks > 0) {
    join_build_kernel<<<dim3(n_chunks, P), kThreads, 0, s>>>(
        build_keys, build_vals, tab, pad_sum, pad_found, duplicate, Bk,
        cap_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long per_block = (long long)kThreads * kPerThread;
  const unsigned gx = (unsigned)((Pk + per_block - 1) / per_block);
  join_probe_kernel<<<dim3(gx, P), kThreads, 0, s>>>(
      tab, pad_sum, pad_found, probe_keys, vals, found, Pk, n_chunks,
      cap_log2);
  return (int)cudaGetLastError();
}
