// Fused partition-local segment sums for Hopper (sm_90a):
//   out[p, b, c] = sum over t of [ids[p, t] == b] * vals[p, t, c]
// Ids outside [0, n_bins) contribute nothing.
//
// Replaces the TPU kernel hash_aggregate_multi_pallas
// (src/repro/kernels/hash_aggregate/kernel.py:54, body _agg_multi_kernel),
// which keeps a partition's (n_bins, C) table in VMEM across a sequential
// grid of row blocks and adds a one-hot x vals matrix product per block.
//
// What bounds it on this card: memory. Each row is read once (4 bytes of id
// and 4*C bytes of values) and does C adds; at the main path's shapes that
// is far below the card's arithmetic rate, so the floor is the bytes over
// 3.35 TB/s. The one-hot product would spend n_bins multiply-adds per row on
// zeros, so it is not carried over.
//
// Design. Blocks run in no order on Hopper and float atomics would make the
// sums depend on timing, so every sum here is taken in an order fixed by
// the data and the launch plan alone:
//   * pass 1, grid (row chunk, bin tile, partition): a block stages its
//     chunk's rows in shared memory, 1024 at a time, with cp.async (16
//     bytes where aligned) three batches deep, so two land while one is
//     summed. Every lane takes one row of a 32-row group (rows 32g..32g+31
//     of the chunk). The lanes whose rows fall in one bin are found with
//     __match_any_sync and their values summed by a fixed tree over their
//     ranks in lane order (rank r takes rank r + s at level s = 1, 2, 4,
//     ..., the peer s ranks up found by pointer doubling over shuffles).
//     The design it replaced added a warp's rows one after another, 2 of
//     32 lanes busy at C = 2.
//   * Small tables (all eight warps' copies within 32 KB, as q1's 128 bins
//     x 5 columns): each of 8 warps keeps its own table and takes the
//     groups g = w mod 8, adding each bin's group sum in group order; the
//     eight tables are added in warp order at the end. One barrier a batch.
//   * Wide tables: one table as wide as shared memory allows beside the
//     staging (q18 at SF1: all 23,552 bins x 2 columns, 184 KB, so the rows
//     are read once), and 16 warps. Each group sum marks its bin in two
//     bitmaps, "seen" and "seen twice" (integer atomics: the marks do not
//     depend on timing). A sum whose bin no other group of the batch holds
//     is added at once, all such sums in parallel: q18's rows come in
//     random order over 23,552 bins, so nearly all are. The others are
//     left in place of their rows, and warp w adds those of the bins b
//     with (b - b0) mod 16 == w, group after group. Either way a bin's
//     entry takes its group sums in group order, one thread at a time.
//   * pass 2 adds the chunks' partial tables of each (p, b, c) in chunk
//     order. With one chunk, pass 1 writes the result directly.
// A row whose id is out of range, or whose values are all +-0, takes part
// in no sum: the tables start at +0 and no sum from +0 reaches -0, so such
// a row changes no bit (padding and masked rows are such rows).
// tests/_agg_order.py is a torch model of this order; the kernel gives its
// bits (tests/test_torch_cuda.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                // warps (and tables) of a block
constexpr int kThreads = kWarps * 32;    // with private tables
constexpr int kOwnedWarps = 16;          // warps of a block with one table
constexpr int kOwnedThreads = kOwnedWarps * 32;
constexpr int kStage = 1024;   // rows staged per batch
constexpr int kStages = 3;     // batches in flight or in use
constexpr int kGroups = kStage / 32;
constexpr int kMaxC = 8;       // columns one launch takes

// floats of the table(s), rounded up so the staging stays 16-byte aligned
__host__ __device__ inline int table_floats(int tile_bins, int C,
                                            bool private_tables) {
  return ((private_tables ? kWarps : 1) * tile_bins * C + 3) / 4 * 4;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two bitmaps over a tile's bins, "seen" and "seen twice", of
// bitmap_words(tile_bins) ints each. A bin is marked with integer atomics,
// so the marks do not depend on the order the threads come in.
__host__ __device__ inline int bitmap_words(int tile_bins) {
  return (tile_bins + 31) / 32;
}

__device__ __forceinline__ void mark(int* seen, int* twice, int bin) {
  const int bit = 1 << (bin & 31);
  if (atomicOr(&seen[bin >> 5], bit) & bit) atomicOr(&twice[bin >> 5], bit);
}

// Sum the values x of the lanes that share a bin (bin -1: no part) by a
// fixed tree over their ranks in lane order; afterwards the lowest lane of
// each bin holds its sum in x. Returns whether this lane is that lane.
__device__ __forceinline__ bool group_tree(int bin, float (&x)[kMaxC], int C,
                                           int lane) {
  const unsigned peers = __match_any_sync(0xffffffffu, bin);
  const int rank = __popc(peers & ((1u << lane) - 1u));
#ifndef HA_NO_TREE
  const unsigned top = __reduce_max_sync(
      0xffffffffu, bin >= 0 ? (unsigned)__popc(peers) : 0u);
  const unsigned above = peers & ~((2u << lane) - 1u);
  int up = above ? __ffs(above) - 1 : 32;   // the lane of rank + s, or 32
  for (unsigned s = 1; s < top; s <<= 1) {
    const bool take = bin >= 0 && (rank & (2 * s - 1)) == 0 && up < 32;
    const int src = take ? up : lane;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) {
        const float y = __shfl_sync(0xffffffffu, x[c], src);
        if (take) x[c] += y;
      }
    const int next = __shfl_sync(0xffffffffu, up, up < 32 ? up : lane);
    up = up < 32 ? next : 32;               // now rank + 2s
  }
#endif
  return bin >= 0 && rank == 0;
}

template <bool kPrivate>
__global__ void __launch_bounds__(kPrivate ? kThreads : kOwnedThreads)
agg_partial_kernel(const int* __restrict__ ids, const float* __restrict__ vals,
                   float* __restrict__ partial, long long T, int C, int n_bins,
                   int tile_bins, long long rows_per_chunk, int n_chunks) {
  constexpr int kW = kPrivate ? kWarps : kOwnedWarps;   // warps a block
  constexpr int kNT = kW * 32;
  constexpr int NG = kGroups / kW;                      // groups a warp
  extern __shared__ float4 smem4[];
  const int chunk = blockIdx.x, tile = blockIdx.y, p = blockIdx.z;
  const int b0 = tile * tile_bins;
  const int nb = min(tile_bins, n_bins - b0);
  const int tw = tile_bins * C;                        // floats of one table
  const int n_tables = kPrivate ? kWarps : 1;
  float* table = reinterpret_cast<float*>(smem4);
  int* sid = reinterpret_cast<int*>(table + table_floats(tile_bins, C,
                                                         kPrivate));
  float* sval = reinterpret_cast<float*>(sid + kStages * kStage);
  int* seen = reinterpret_cast<int*>(sval + kStages * kStage * C);
  int* twice = seen + bitmap_words(tile_bins);
  const long long r0 = (long long)chunk * rows_per_chunk;
  const long long r1 = min(r0 + rows_per_chunk, T);
  const int* pid = ids + (long long)p * T + r0;
  const float* pval = vals + ((long long)p * T + r0) * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = table + (kPrivate ? warp * tw : 0);
  // 16-byte copies where both sources are 16-byte aligned (every batch
  // starts kStage rows on, a multiple of 4)
  const bool wide = ((reinterpret_cast<uintptr_t>(pid) |
                      reinterpret_cast<uintptr_t>(pval)) & 15) == 0;

  for (int i = threadIdx.x; i < n_tables * tw; i += kNT) table[i] = 0.f;
  if (!kPrivate)
    for (int i = threadIdx.x; i < 2 * bitmap_words(tile_bins); i += kNT)
      seen[i] = 0;

  const int n_batches = (int)((r1 - r0 + kStage - 1) / kStage);
  auto stage = [&](int k) {
    const long long s = (long long)k * kStage;
    const int n = (int)min((long long)kStage, r1 - r0 - s);
    int* did = sid + (k % kStages) * kStage;
    float* dval = sval + (size_t)(k % kStages) * kStage * C;
    const int n4 = wide ? n / 4 : 0, nv4 = wide ? n * C / 4 : 0;
    for (int i = threadIdx.x; i < n4; i += kNT)
      cp_async16(did + 4 * i, pid + s + 4 * i);
    for (int i = 4 * n4 + threadIdx.x; i < n; i += kNT)
      cp_async4(did + i, pid + s + i);
    for (int i = threadIdx.x; i < nv4; i += kNT)
      cp_async16(dval + 4 * i, pval + s * C + 4 * i);
    for (int i = 4 * nv4 + threadIdx.x; i < n * C; i += kNT)
      cp_async4(dval + i, pval + s * C + i);
    cp_async_commit();
  };
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_batches) stage(k);
    else cp_async_commit();      // empty groups keep the count uniform
  }
  for (int k = 0; k < n_batches; ++k) {
    cp_async_wait<kStages - 2>();
    // batch k has landed, the tables are zeroed, and every warp is done
    // with batch k - 1, whose buffer batch k + kStages - 1 now takes
    __syncthreads();
    if (k + kStages - 1 < n_batches) stage(k + kStages - 1);
    else cp_async_commit();
    int* bid = sid + (k % kStages) * kStage;
    float* bval = sval + (size_t)(k % kStages) * kStage * C;
    const int n = (int)min((long long)kStage, r1 - r0 - (long long)k * kStage);
    // 1. warp w sums the groups g = w + kW u of the batch, one at a time
    int bin[NG];
    float x[NG][kMaxC];
    bool lead[NG];
#pragma unroll
    for (int u = 0; u < NG; ++u) {
      const int j = (warp + kW * u) * 32 + lane;
      bin[u] = -1;
      lead[u] = false;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) x[u][c] = 0.f;
      if (j < n) {
        const int off = bid[j] - b0;
        if (off >= 0 && off < nb) {
          bool nonzero = false;
#pragma unroll
          for (int c = 0; c < kMaxC; ++c)
            if (c < C) {
              x[u][c] = bval[j * C + c];
              nonzero |= x[u][c] != 0.f;
            }
          if (nonzero) bin[u] = off;
        }
      }
#ifdef HA_NO_SUM
      continue;
#endif
      if (__ballot_sync(0xffffffffu, bin[u] >= 0) == 0) continue;
      lead[u] = group_tree(bin[u], x[u], C, lane);
      if (kPrivate) {
        // with private tables the warp adds its groups' sums in group order
        if (lead[u]) {
#pragma unroll
          for (int c = 0; c < kMaxC; ++c)
            if (c < C) mine[bin[u] * C + c] += x[u][c];
        }
        __syncwarp();      // the entries are written before the next group
      }
    }
    if (!kPrivate) {
      // 2. which bins more than one group of the batch holds: every sum
      //    marks its bin
#pragma unroll
      for (int u = 0; u < NG; ++u)
        if (lead[u]) mark(seen, twice, bin[u]);
      __syncthreads();
      // 3. a sum whose bin no other group of the batch holds is added now
      //    (no other thread touches that entry in this batch); the others
      //    are left in place of their rows (every other row's id is -1)
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        const int j = (warp + kW * u) * 32 + lane;
        const bool dup =
            lead[u] && (twice[bin[u] >> 5] >> (bin[u] & 31)) & 1;
        if (lead[u] && !dup) {
#pragma unroll
          for (int c = 0; c < kMaxC; ++c)
            if (c < C) table[bin[u] * C + c] += x[u][c];
        }
        if (j < n) {
          bid[j] = dup ? bin[u] : -1;
          if (dup) {
#pragma unroll
            for (int c = 0; c < kMaxC; ++c)
              if (c < C) bval[j * C + c] = x[u][c];
          }
        }
      }
      __syncthreads();
      // unmark this batch's bins for the next (no one reads the marks now)
#pragma unroll
      for (int u = 0; u < NG; ++u)
        if (lead[u]) {
          seen[bin[u] >> 5] = 0;
          twice[bin[u] >> 5] = 0;
        }
      // 4. warp w adds the rest for the bins b with b mod kW == w, group
      //    after group (a group's sums have distinct bins), the ids read
      //    at once and the groups with none of its bins passed over
      int rec[kGroups];
      unsigned has = 0;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int j = g * 32 + lane;
        rec[g] = j < n ? bid[j] : -1;
        if (rec[g] >= 0 && rec[g] % kW == warp) has |= 1u << g;
      }
      has = __reduce_or_sync(0xffffffffu, has);
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if (!((has >> g) & 1u)) continue;
        if (rec[g] >= 0 && rec[g] % kW == warp) {
          const int j = g * 32 + lane;
#pragma unroll
          for (int c = 0; c < kMaxC; ++c)
            if (c < C) table[rec[g] * C + c] += bval[j * C + c];
        }
        __syncwarp();
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* dst = partial + (((long long)p * n_chunks + chunk) * n_bins + b0) * C;
  for (int i = threadIdx.x; i < nb * C; i += kNT) {
    float s = table[i];
    if (kPrivate)
      for (int w = 1; w < kWarps; ++w) s += table[w * tw + i];
    dst[i] = s;
  }
}

__global__ void agg_reduce_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, long long total,
                                  long long per_p, int n_chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long p = i / per_p, e = i - p * per_p;
  const float* src = partial + p * n_chunks * per_p + e;
  float acc = src[0];
  for (int k = 1; k < n_chunks; ++k) acc += src[k * per_p];
  out[i] = acc;
}

// dynamic shared memory of pass 1: the table(s) and the staged batches
size_t smem_bytes(int tile_bins, int C, int private_tables) {
  return ((size_t)table_floats(tile_bins, C, private_tables) +
          (size_t)kStages * kStage * (1 + C) +
          (private_tables ? 0 : 2 * (size_t)bitmap_words(tile_bins))) *
         sizeof(float);
}

template <bool kPrivate>
cudaError_t launch_partial(const int* ids, const float* vals, float* dst,
                           int P, long long T, int C, int n_bins,
                           int tile_bins, int n_chunks,
                           long long rows_per_chunk, cudaStream_t s) {
  const size_t smem = smem_bytes(tile_bins, C, kPrivate);
  cudaError_t e = cudaFuncSetAttribute(
      agg_partial_kernel<kPrivate>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int n_tiles = (n_bins + tile_bins - 1) / tile_bins;
  agg_partial_kernel<kPrivate>
      <<<dim3(n_chunks, n_tiles, P), kPrivate ? kThreads : kOwnedThreads,
         smem, s>>>(
          ids, vals, dst, T, C, n_bins, tile_bins, rows_per_chunk, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// ids (P, T) int32, vals (P, T, C) f32 with 1 <= C <= 8, out (P, n_bins, C)
// f32; partial is scratch of (P, n_chunks, n_bins, C) f32 when n_chunks > 1
// (else unused). private_tables != 0 gives each warp its own table (the
// caller checks that 8 tables fit). Returns the CUDA error code of the
// launches (0 on success), or -1 for a C the kernel does not take.
extern "C" int hash_aggregate_multi_launch(
    const int* ids, const float* vals, float* out, float* partial, int P,
    long long T, int C, int n_bins, int tile_bins, int n_chunks,
    long long rows_per_chunk, int private_tables, void* stream) {
  if (C < 1 || C > kMaxC) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = n_chunks == 1 ? out : partial;
  cudaError_t e =
      private_tables
          ? launch_partial<true>(ids, vals, dst, P, T, C, n_bins, tile_bins,
                                 n_chunks, rows_per_chunk, s)
          : launch_partial<false>(ids, vals, dst, P, T, C, n_bins, tile_bins,
                                  n_chunks, rows_per_chunk, s);
  if (e != cudaSuccess || n_chunks == 1) return (int)e;
  const long long per_p = (long long)n_bins * C, total = per_p * P;
  const int threads = 256;
  agg_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                      s>>>(partial, out, total, per_p, n_chunks);
  return (int)cudaGetLastError();
}
