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
// What bounds it on this card: bytes. Build keys are unique apart from the
// -1 padding, so a hashed or sorted probe inside each partition does
// O(P * (Pk + Bk)) work, and the floor is reading the inputs and writing
// the outputs once (about 132 MB for q3's lineitem x orders at SF1). This
// nested-loop design does not reach that floor: it compares every probe
// slot with every build slot of its partition, P * Pk * Bk compares (5.6e11
// at that call), so its own floor is set by operations, orders of magnitude
// above the bytes. A hashed probe is the next design. There is no
// tensor-core form: the payload is an f32 row position, exact only below
// 2^24, so matches are taken with a select and an add, not a product in
// reduced precision.
//
// Design. One thread holds eight probe slots in registers; the block's
// threads stream the partition's build side through shared memory in
// tiles of 4096 (key, value) pairs (the SF1 build side, 46,976 slots, is
// larger than shared memory), and every thread compares its eight keys
// with each staged key, read as a broadcast. The compares are OR-ed first
// and the value is read and added only on a hit, which is rare because
// build keys are unique; the loop is bound by instruction issue, so this
// keeps it near one compare per key per probe. Each sum is taken in build
// order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 8;
constexpr int kTile = 4096;

__global__ void __launch_bounds__(kThreads)
join_probe_kernel(const int* __restrict__ build_keys,
                  const float* __restrict__ build_vals,
                  const int* __restrict__ probe_keys, float* __restrict__ vals,
                  uint8_t* __restrict__ found, int Bk, int Pk) {
  __shared__ int sk[kTile];
  __shared__ float sv[kTile];
  const int p = blockIdx.y;
  const long long base = (long long)blockIdx.x * kThreads * kPerThread;
  const int* bk = build_keys + (long long)p * Bk;
  const float* bv = build_vals + (long long)p * Bk;
  const int* pk = probe_keys + (long long)p * Pk;

  int key[kPerThread];
  float acc[kPerThread];
  bool hit[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const long long idx = base + q * kThreads + threadIdx.x;
    key[q] = idx < Pk ? pk[idx] : 0;
    acc[q] = 0.f;
    hit[q] = false;
  }
  for (int t0 = 0; t0 < Bk; t0 += kTile) {
    const int n = min(kTile, Bk - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < n; i += kThreads) {
      sk[i] = bk[t0 + i];
      sv[i] = bv[t0 + i];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int k = sk[j];
      bool any = false;
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) any |= key[q] == k;
      if (any) {  // rare: build keys are unique (padding -1 aside)
        const float v = sv[j];
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
          if (key[q] == k) {
            acc[q] += v;
            hit[q] = true;
          }
        }
      }
    }
  }
  float* pv = vals + (long long)p * Pk;
  uint8_t* pf = found + (long long)p * Pk;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const long long idx = base + q * kThreads + threadIdx.x;
    if (idx < Pk) {
      pv[idx] = acc[q];
      pf[idx] = hit[q] ? 1 : 0;
    }
  }
}

}  // namespace

// build_keys/build_vals (P, Bk) int32/f32, probe_keys (P, Pk) int32;
// vals (P, Pk) f32 and found (P, Pk) bool (one byte each) are written.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int join_probe_launch(const int* build_keys, const float* build_vals,
                                 const int* probe_keys, float* vals,
                                 uint8_t* found, int P, int Bk, int Pk,
                                 void* stream) {
  const long long per_block = (long long)kThreads * kPerThread;
  const unsigned gx = (unsigned)((Pk + per_block - 1) / per_block);
  join_probe_kernel<<<dim3(gx, P), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      build_keys, build_vals, probe_keys, vals, found, Bk, Pk);
  return (int)cudaGetLastError();
}
