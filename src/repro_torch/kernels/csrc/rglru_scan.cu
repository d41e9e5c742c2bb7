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
// Design: a single-pass scan chained along time, in one launch (after one
// memset of the chain's words). A block owns one (batch, 32-channel tile,
// chunk of kWarps * R time steps); a row of the tile is one 128-byte line.
//   * Blocks draw their chunk from an atomic ticket, chunk-major: every
//     chain's chunk c comes before any chain's chunk c + 1, so a chunk's
//     predecessor has always started and the wait below cannot deadlock,
//     whatever order the hardware starts blocks in.
//   * Each warp stages its own run of R steps of a and b into shared memory
//     with cp.async (16 bytes a lane where the rows allow it, else 4) and
//     computes the run's product of a and its end value from h = 0, one
//     lane per channel.
//   * Warp 0 waits for the inclusive h its predecessor chunk published (one
//     64-bit word a channel: a flag and the value, so a single acquire load
//     sees both), folds the block's runs into it in warp order, publishes
//     the chunk's inclusive h, and leaves each run's entering h in shared
//     memory. Then every warp applies its run from shared memory and writes
//     h in 128-byte rows.
// a and b are read from device memory once and h is written once; the
// chains of the 160 tiles at the prefill shape run side by side, and later
// chunks stage and summarise while they wait (16 links a chain at R = 32).
//
// The order is fixed, so the bits are the same on every run. With runs of R
// steps numbered along time, run r's (P_r, E_r) is its product of a and its
// end value from 0, and the h entering run r + 1 is P_r * h_r + E_r from
// h_0 = 0; every multiply and add is rounded on its own (__fmul_rn,
// __fadd_rn), as the plain a * h + b in torch is. Chunk boundaries do not
// enter the formula: a chunk's published value is this fold at its end.
// Within the first run the kernel gives linear_scan_sequential's bits;
// tests/_scan_order.py is a torch model of the whole order and its bits.
//
// The diagnostic build -DRG_NO_WAIT skips the wait on the predecessor (its
// results are wrong): its time is the design's without the chain.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned long long kPublished = 1ull << 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void publish(unsigned long long* p, float h) {
  const unsigned long long w = kPublished | __float_as_uint(h);
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ float wait_published(
    const unsigned long long* p) {
  unsigned long long w;
  do {
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
                 : "=l"(w)
                 : "l"(p)
                 : "memory");
  } while (!(w & kPublished));
  return __uint_as_float(static_cast<uint32_t>(w));
}

// words: (B, nc, D) chain words, then the ticket; zeroed before the launch.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
scan_chained(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ h, unsigned long long* __restrict__ words,
             unsigned* __restrict__ ticket, int S, int D, int R, int n_tiles,
             int nc) {
  extern __shared__ float stage[];          // a then b: [kWarps][R][32] each
  __shared__ float s_p[kWarps][32], s_e[kWarps][32], s_h[kWarps][32];
  __shared__ unsigned s_ticket;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1u);
  __syncthreads();
  const int n_chains = gridDim.x / nc;
  const int chain = s_ticket % n_chains, c = s_ticket / n_chains;
  const int bb = chain / n_tiles, ch0 = (chain % n_tiles) * 32;
  const int ch = ch0 + lane;
  const int L = kWarps * R;
  const int r0 = c * L + warp * R;                 // the run's first step
  const int len = max(0, min(R, S - r0));          // its steps
  float* sa = stage + warp * R * 32;
  float* sb = sa + kWarps * R * 32;
  const long long row0 = ((long long)bb * S + r0) * D;

  if (kVec) {                  // 8 lanes a 128-byte row, 4 rows at a time
    for (int i = lane; i < len * 8; i += 32) {
      const int r = i >> 3, q = (i & 7) * 4;
      if (ch0 + q < D) {
        const long long g = row0 + (long long)r * D + ch0 + q;
        cp_async16(sa + r * 32 + q, a + g);
        cp_async16(sb + r * 32 + q, b + g);
      }
    }
  } else if (ch < D) {
    for (int r = 0; r < len; ++r) {
      const long long g = row0 + (long long)r * D + ch;
      cp_async4(sa + r * 32 + lane, a + g);
      cp_async4(sb + r * 32 + lane, b + g);
    }
  }
  cp_async_wait_all();
  __syncwarp();

  float p = 1.f, e = 0.f;                          // the run from h = 0
#pragma unroll 8
  for (int r = 0; r < len; ++r) {
    const float at = sa[r * 32 + lane];
    e = __fadd_rn(__fmul_rn(at, e), sb[r * 32 + lane]);
    p = __fmul_rn(p, at);
  }
  s_p[warp][lane] = p;
  s_e[warp][lane] = e;
  __syncthreads();

  if (warp == 0) {
    const int active = min(kWarps, (S - c * L + R - 1) / R);
    float hh = 0.f;
#ifndef RG_NO_WAIT
    if (c > 0 && ch < D)
      hh = wait_published(words + ((long long)bb * nc + c - 1) * D + ch);
#endif
    for (int w = 0; w < active; ++w) {
      s_h[w][lane] = hh;
      hh = __fadd_rn(__fmul_rn(s_p[w][lane], hh), s_e[w][lane]);
    }
    if (c + 1 < nc && ch < D)
      publish(words + ((long long)bb * nc + c) * D + ch, hh);
  }
  __syncthreads();

  if (ch < D && len > 0) {
    float hh = s_h[warp][lane];
    float* out = h + row0 + ch;
#pragma unroll 8
    for (int r = 0; r < len; ++r) {
      hh = __fadd_rn(__fmul_rn(sa[r * 32 + lane], hh), sb[r * 32 + lane]);
      out[(long long)r * D] = hh;
    }
  }
}

template <bool kVec>
cudaError_t launch(const float* a, const float* b, float* h,
                   unsigned long long* words, unsigned* ticket, int B, int S,
                   int D, int R, int n_tiles, int nc, cudaStream_t s) {
  const int smem = 2 * kWarps * R * 32 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      scan_chained<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * n_tiles * nc;
  scan_chained<kVec><<<(unsigned)blocks, kThreads, smem, s>>>(
      a, b, h, words, ticket, S, D, R, n_tiles, nc);
  return cudaGetLastError();
}

}  // namespace

// a, b, h: (B, S, D) contiguous float32. R = L is the run: the steps a warp
// covers before a carry enters; a chunk is kWarps * L steps, nc =
// ceil(S / (kWarps * L)). carry: B * nc * D + 1 zeroable 64-bit words (the
// chain's published values, then the ticket), zeroed here on the stream
// before the launch. prod is not used by this design (the C interface is
// the three-pass design's, so that both can be timed side by side).
// Returns the CUDA error code of the last failed call (0 on success).
extern "C" int rglru_scan_launch(const float* a, const float* b, float* h,
                                 float* prod, float* carry, int B, int S,
                                 int D, int L, void* stream) {
  (void)prod;
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  if (L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (S + kWarps * L - 1) / (kWarps * L);
  const int n_tiles = (D + 31) / 32;
  const long long n_words = (long long)B * nc * D;
  auto* words = reinterpret_cast<unsigned long long*>(carry);
  auto* ticket = reinterpret_cast<unsigned*>(words + n_words);
  cudaError_t err = cudaMemsetAsync(words, 0, (n_words + 1) * 8, s);
  if (err != cudaSuccess) return (int)err;
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  err = vec ? launch<true>(a, b, h, words, ticket, B, S, D, L, n_tiles, nc, s)
            : launch<false>(a, b, h, words, ticket, B, S, D, L, n_tiles, nc,
                            s);
  return (int)err;
}
