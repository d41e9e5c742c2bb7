// First-order linear recurrence along time for Hopper (sm_90a), float32:
//   h[b, t, d] = a[b, t, d] * h[b, t-1, d] + b[b, t, d],   h[b, -1, d] = 0.
//
// Replaces the TPU kernel rglru_scan_pallas
// (src/repro/kernels/rglru_scan/kernel.py:52, body _scan_kernel :26): a grid
// of (batch * channel blocks, time chunks) that runs a doubling scan inside
// each (chunk, channel block) tile and carries h from chunk to chunk in VMEM
// scratch along the sequential time axis.
//
// What bounds it on this card: bytes. Each of a and b is read once and h is
// written once, two operations per element: at the RG-LRU prefill shape of
// recurrentgemma-2b ((2, 4096, 2560)) that is 3 x 83.9 MB, 0.075 ms at 3.35
// TB/s.
//
// Design: chunked over time, in three launches on the caller's stream.
//   1. summary: one thread per (batch, chunk of L steps, channel) runs the
//      chunk's recurrence from h = 0 and writes the chunk's product of a and
//      its end value;
//   2. carry:   one thread per (batch, channel) walks the chunks in order and
//      replaces each end value with the h that enters the chunk
//      (carry_{c+1} = prod_c * carry_c + end_c);
//   3. apply:   one thread per (batch, chunk, channel) runs the chunk's
//      recurrence again from its carry and writes h.
// A single thread per channel would give only B * D = 5,120 threads and a
// 4,096-step dependent chain; the chunks give B * (S / L) * D = 327,680
// threads with L = 64. Neighbouring threads own neighbouring channels, so
// every load and store of a warp is one 128-byte line. The price is a and b
// read twice (the second read mostly from device memory: 168 MB does not
// stay in the 50 MB L2), 5/3 of the bound's bytes. Within a chunk the order
// of operations is the plain loop's; the carry into a chunk is the plain
// loop's h up to rounding (a product of a's instead of the step-by-step
// chain), a few float32 ulps.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
scan_summary(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ prod, float* __restrict__ end, int S, int D,
             int L, int nc) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y, bb = blockIdx.z;
  if (d >= D) return;
  const int t0 = c * L, t1 = min(S, t0 + L);
  const long long base = ((long long)bb * S + t0) * D + d;
  float p = 1.f, h = 0.f;
#pragma unroll 8
  for (int t = 0; t < t1 - t0; ++t) {
    const float at = a[base + (long long)t * D];
    h = at * h + b[base + (long long)t * D];
    p *= at;
  }
  const long long o = ((long long)bb * nc + c) * D + d;
  prod[o] = p;
  end[o] = h;
}

__global__ void __launch_bounds__(kThreads)
scan_carry(const float* __restrict__ prod, float* __restrict__ end, int D,
           int nc) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int bb = blockIdx.y;
  if (d >= D) return;
  float h = 0.f;
  for (int c = 0; c < nc; ++c) {
    const long long o = ((long long)bb * nc + c) * D + d;
    const float e = end[o];
    end[o] = h;                         // the h that enters chunk c
    h = prod[o] * h + e;
  }
}

__global__ void __launch_bounds__(kThreads)
scan_apply(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ carry, float* __restrict__ out, int S,
           int D, int L, int nc) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y, bb = blockIdx.z;
  if (d >= D) return;
  const int t0 = c * L, t1 = min(S, t0 + L);
  const long long base = ((long long)bb * S + t0) * D + d;
  float h = carry[((long long)bb * nc + c) * D + d];
#pragma unroll 8
  for (int t = 0; t < t1 - t0; ++t) {
    const long long i = base + (long long)t * D;
    h = a[i] * h + b[i];
    out[i] = h;
  }
}

}  // namespace

// a, b, h: (B, S, D) contiguous float32; prod and carry: (B, ceil(S / L), D)
// float32 scratch. Returns the CUDA error code of the last failed launch
// (0 on success).
extern "C" int rglru_scan_launch(const float* a, const float* b, float* h,
                                 float* prod, float* carry, int B, int S,
                                 int D, int L, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  if (L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (S + L - 1) / L;
  const int dblocks = (D + kThreads - 1) / kThreads;
  scan_summary<<<dim3(dblocks, nc, B), kThreads, 0, s>>>(a, b, prod, carry,
                                                         S, D, L, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_carry<<<dim3(dblocks, B), kThreads, 0, s>>>(prod, carry, D, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_apply<<<dim3(dblocks, nc, B), kThreads, 0, s>>>(a, b, carry, h, S, D,
                                                       L, nc);
  return (int)cudaGetLastError();
}
