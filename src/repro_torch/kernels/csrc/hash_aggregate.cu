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
// sums depend on timing, so every sum here is taken in a fixed order:
//   * pass 1, grid (row chunk, bin tile, partition): a block stages its
//     chunk's rows in shared memory, 1024 at a time, and adds them into a
//     (bin tile x C) table in shared memory. Each warp owns the bins whose
//     offset in the tile is its warp index modulo 8, so no two warps write
//     one bin. A stable counting sort of every staged batch by owner (ballot
//     ranks within 32-row groups, a warp scan over the groups) hands each
//     warp its own rows in row order; it adds them one after another, lane
//     c adding column c and holding the current bin's sum in a register.
//     No atomics: each bin's partial is the sum of the chunk's rows in row
//     order, the same bits on every run.
//   * pass 2 adds the chunks' partial tables of each (p, b, c) in chunk
//     order. With one chunk, pass 1 writes the result directly.
// A table larger than the tile budget (q18 at SF1: 23,552 bins x 2 columns)
// is cut into bin tiles; each tile's blocks read the chunk's rows again.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 1024;  // rows staged in shared memory per step
constexpr int kGroups = kStage / 32;
constexpr int kGroupsPerWarp = kGroups / kWarps;
static_assert(kGroups == 32, "the owner scan puts one group on each lane");

__global__ void __launch_bounds__(kThreads)
agg_partial_kernel(const int* __restrict__ ids, const float* __restrict__ vals,
                   float* __restrict__ partial, long long T, int C, int n_bins,
                   int tile_bins, long long rows_per_chunk, int n_chunks) {
  extern __shared__ float smem[];
  const int chunk = blockIdx.x, tile = blockIdx.y, p = blockIdx.z;
  const int b0 = tile * tile_bins;
  const int nb = min(tile_bins, n_bins - b0);
  float* table = smem;                                   // nb * C
  int* sid = reinterpret_cast<int*>(smem + (size_t)tile_bins * C);
  float* sval = reinterpret_cast<float*>(sid + kStage);  // kStage * C
  const long long r0 = (long long)chunk * rows_per_chunk;
  const long long r1 = min(r0 + rows_per_chunk, T);
  const int* pid = ids + (long long)p * T;
  const float* pval = vals + (long long)p * T * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < nb * C; i += kThreads) table[i] = 0.f;
  // per staged 32-row group: rows owned by each warp, then their offsets
  __shared__ int cnt[kGroups][kWarps];
  __shared__ int start[kWarps + 1];
  __shared__ short order[kStage];  // staged rows grouped by owner, in row order
  for (long long s = r0; s < r1; s += kStage) {
    const int n = (int)min((long long)kStage, r1 - s);
    __syncthreads();  // the previous stage is consumed (and the table zeroed)
    for (int i = threadIdx.x; i < n; i += kThreads) sid[i] = pid[s + i];
    for (int i = threadIdx.x; i < n * C; i += kThreads)
      sval[i] = pval[s * C + i];
    __syncthreads();
    // 1. the owner warp of every staged row (-1: another tile's bin, or a
    //    row whose values are all +-0, which changes no sum: the table
    //    starts at +0 and x + 0 == x for every x but -0, which a sum from
    //    +0 never reaches; padding and masked rows are such rows), and its
    //    rank among its 32-row group's rows of that owner
    int own[kGroupsPerWarp], rank[kGroupsPerWarp];
#pragma unroll
    for (int k = 0; k < kGroupsPerWarp; ++k) {
      const int g = warp + k * kWarps;
      const int j = g * 32 + lane;
      int o = -1;
      if (j < n) {
        const int off = sid[j] - b0;
        if (off >= 0 && off < nb) {
          bool nonzero = false;
          for (int c = 0; c < C; ++c) nonzero |= sval[j * C + c] != 0.f;
          if (nonzero) o = off % kWarps;
        }
      }
      own[k] = o;
      rank[k] = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const unsigned mask = __ballot_sync(0xffffffffu, o == w);
        if (lane == w) cnt[g][w] = __popc(mask);
        if (o == w) rank[k] = __popc(mask & ((1u << lane) - 1u));
      }
    }
    __syncthreads();
    // 2. exclusive scan over the groups of each owner's counts (warp w
    //    scans owner w, lane g holding group g), then the owners' starts
    {
      const int v = cnt[lane][warp];
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += t;
      }
      cnt[lane][warp] = incl - v;
      if (lane == 31) start[warp + 1] = incl;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      start[0] = 0;
      for (int w = 0; w < kWarps; ++w) start[w + 1] += start[w];
    }
    __syncthreads();
    // 3. a stable counting sort of the staged rows by owner
#pragma unroll
    for (int k = 0; k < kGroupsPerWarp; ++k) {
      const int g = warp + k * kWarps;
      if (own[k] >= 0)
        order[start[own[k]] + cnt[g][own[k]] + rank[k]] = (short)(g * 32 + lane);
    }
    __syncthreads();
    // 4. each warp adds its own rows one after another in row order, lane c
    //    adding column c. Row indices and bins come 32 at a time into
    //    registers, and the current bin's table entry stays in a register
    //    while consecutive rows hit that bin: the same adds in the same
    //    order as table[b] += v, without a shared-memory round trip per row.
    const int e = start[warp + 1];
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      int cur = -1;
      float acc = 0.f;
      for (int i0 = start[warp]; i0 < e; i0 += 32) {
        const int m = min(32, e - i0);
        const int my_row = lane < m ? order[i0 + lane] : 0;
        const int my_b = sid[my_row] - b0;
        for (int k = 0; k < m; ++k) {
          const int row = __shfl_sync(0xffffffffu, my_row, k);
          const int b = __shfl_sync(0xffffffffu, my_b, k);
          if (c < C) {
            if (b != cur) {
              if (cur >= 0) table[cur * C + c] = acc;
              cur = b;
              acc = table[b * C + c];
            }
            acc += sval[row * C + c];
          }
        }
      }
      if (c < C && cur >= 0) table[cur * C + c] = acc;
    }
  }
  __syncthreads();
  float* dst = partial + (((long long)p * n_chunks + chunk) * n_bins + b0) * C;
  for (int i = threadIdx.x; i < nb * C; i += kThreads) dst[i] = table[i];
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

// dynamic shared memory of pass 1: the table tile and one staged batch
size_t smem_bytes(int tile_bins, int C) {
  return ((size_t)tile_bins * C + kStage + (size_t)kStage * C) * sizeof(float);
}

}  // namespace

// ids (P, T) int32, vals (P, T, C) f32, out (P, n_bins, C) f32; partial is
// scratch of (P, n_chunks, n_bins, C) f32 when n_chunks > 1 (else unused).
// Returns the CUDA error code of the launches (0 on success).
extern "C" int hash_aggregate_multi_launch(
    const int* ids, const float* vals, float* out, float* partial, int P,
    long long T, int C, int n_bins, int tile_bins, int n_chunks,
    long long rows_per_chunk, void* stream) {
  const size_t smem = smem_bytes(tile_bins, C);
  cudaError_t e = cudaFuncSetAttribute(
      agg_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (n_bins + tile_bins - 1) / tile_bins;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = n_chunks == 1 ? out : partial;
  agg_partial_kernel<<<dim3(n_chunks, n_tiles, P), kThreads, smem, s>>>(
      ids, vals, dst, T, C, n_bins, tile_bins, rows_per_chunk, n_chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks == 1) return (int)e;
  const long long per_p = (long long)n_bins * C, total = per_p * P;
  const int threads = 256;
  agg_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                      s>>>(partial, out, total, per_p, n_chunks);
  return (int)cudaGetLastError();
}
