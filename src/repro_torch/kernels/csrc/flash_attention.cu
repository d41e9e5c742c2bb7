// Causal / sliding-window grouped-query attention forward for Hopper
// (sm_90a), float32 throughout:
//   o[b, i, h, :] = sum_j p_ij v[b, j, h / G, :],
//   p_ij = softmax_j(scale * q[b, i, h, :] . k[b, j, h / G, :]) over the keys
//   j with j <= q_offset + i (causal) and j > q_offset + i - window (window),
// and o = 0 for a query row that sees no key.
//
// Replaces the TPU kernel flash_attention_fwd
// (src/repro/kernels/flash_attention/kernel.py:89, body _fa_kernel :29): a
// grid of (batch * heads, q blocks, kv blocks) that carries the running max,
// denominator and accumulator in VMEM scratch across the kv-block axis and
// skips kv blocks the mask hides with pl.when.
//
// What bounds it on this card: operations. The prefill of recurrentgemma-2b
// (q (2, 4096, 10, 256), one KV head, window 2048) has 1.26e8 visible
// (query, key) pairs, each 4 * 256 float32 operations (a multiply-add of the
// score and one of the mix): 1.29e11, 1.92 ms at 67 TFLOP/s outside the
// tensor cores, against 0.055 ms for the 185 MB it reads and writes. The
// reference sums f32 x f32 products in f32, so the tensor cores' TF32 (ten
// bits of mantissa) is not an option: every product here is an IEEE fp32
// FMA on the CUDA cores, and the FMA pipe's issue slots are the budget.
//
// Design. One block owns one (batch, query head, 64-row query tile) and
// walks the 64-row K/V tiles of that head's KV head (h / G) that the mask
// leaves visible: the loop starts at the first tile inside the window and
// stops at the last tile at or before the diagonal (the TPU kernel's block
// skipping written as loop bounds); blocks are issued heaviest first. The
// Q tile (scaled on load, as the reference scales q before the dot), one K
// tile, one V tile and the probabilities sit in shared memory (211 KB at
// D = 256, one block per SM). What the design does about each limit:
//   * Loads overlap the products. A ninth, producer warp copies the tiles
//     with Hopper's bulk copies (cp.async.bulk, one per 4*D-byte row) that
//     complete on mbarriers; it refills the K buffer with tile t+1 as soon
//     as every consumer is past its scores of tile t (during their softmax
//     and P.V of t), and the V buffer during their scores of t+1. No thread
//     that computes waits on a load it could have issued earlier.
//   * No block-wide barrier in the loop. Each consumer warp owns 8 query
//     rows: it loads and scales its own Q rows, writes and reads its own
//     rows of P, and writes its own output, so warps meet only at the
//     mbarriers ("K/V tile full", "K/V buffer free"). A warp in its softmax
//     no longer holds the other seven, and warps drift into one another's
//     phases, which fills the FMA pipe's gaps.
//   * Issue slots. Thread (ty, tx) = (tid / 16, tid % 16) owns query rows
//     4ty..4ty+3: a 4 x 4 register tile of scores (keys tx + 16j, float4
//     reads along D: 8 LDS.128 per 64 FFMA) and 4 rows x D/16 output
//     columns 4tx + 64n (4 LDS.128 of V and 1 of P per 64 FFMA). Both
//     products load the next step's fragments (Q and K at d + 4, P at the
//     next 4 keys) before the current step's FMAs, so with two warps a
//     scheduler the shared-memory latency hides behind 64 FMAs (3.88 to
//     3.63 ms at the prefill shape on an H100 80GB HBM3 at 700 W,
//     scripts/tune_flash_attention.py). Rows and
//     columns of the Q and K tiles are padded by 4 floats so a quarter-
//     warp's float4 reads fall in distinct banks.
//   * The G query heads of one KV head each read the KV head's tiles: at
//     64 rows a block (the Q tile is 64 KB at D = 256 in fp32, so a block
//     cannot hold more rows), any packing of (position, head) pairs into
//     the rows reads the same number of tiles. With the reads overlapped
//     they are background traffic (~4.2 GB from L2 per prefill call, under
//     1.5 TB/s at the predicted time), not a stall: a build that read each
//     tile once for two query heads timed 3.64-3.66 ms against this one's
//     3.61-3.63 in one call (scripts/tune_flash_attention.py, H100 80GB
//     HBM3 at 700 W). A cluster that multicasts one tile to two SMs would
//     halve the traffic.
// Head dims. D is 64, 128, 192 or 256, a multiple of 64: each of a thread's
// NC = D / 64 output float4 columns is 64 floats from the last, and a row
// is one 4*D-byte bulk copy (a multiple of 16 bytes). D = 192 is MLA's
// (deepseek-v3: 128 rope-free + 64 rotary dims of q and k, v zero-padded
// from 128 by the caller): NC = 3, 163 KB of shared memory, the rows of Q
// and K padded by 4 floats to 196, as at the other widths. Its P.V
// mixes v's 64 zero columns too, a third of that product's FMAs: a separate
// v width would skip them.
// The online softmax is the reference's, step for step: masked scores are
// -1e30, their probabilities 0, the denominator floored at 1e-37, so a row
// with no visible key gives 0. Rows past Skv in a ragged last tile are not
// copied: their scores are masked, and their V rows hold zeros (or an
// earlier tile's finite values), so 0 * v adds nothing.
//
// Diagnostic builds (scripts/tune_flash_attention.py) time the parts: with
// FA_NO_LOADS the producer copies nothing (tiles keep stale data), with
// FA_NO_SOFTMAX the probabilities are the raw scores. Both give wrong
// outputs; the committed build defines neither.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int NW = 8;            // consumer warps (8 query rows each)
constexpr int NCT = NW * 32;     // consumer threads
constexpr int NT = NCT + 32;     // and one producer warp
constexpr float kNegInf = -1e30f;

template <int D>
struct Smem {
  static constexpr int QS = D + 4;          // padded row stride of Q and K
  static constexpr int PS = BK + 4;         // padded row stride of P
  static constexpr size_t floats =
      (size_t)BQ * QS + BK * QS + BK * D + BQ * PS;
  // the four mbarriers follow the tiles
  static constexpr size_t bytes = sizeof(float) * floats + 4 * 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// arrive once and add ``bytes`` to the transfer count the phase waits for
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// one bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Sq,
              int Skv, int Hq, int Hkv, int q_offset, int causal, int window,
              float scale) {
  constexpr int QS = Smem<D>::QS, PS = Smem<D>::PS;
  constexpr int D4 = D / 4;
  constexpr int NC = D / 64;                // float4 output columns a thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * QS;
  float* sP = sV + BK * D;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sP + BQ * PS);
  uint64_t* full_k = bar;       // tile t of K has landed (phase t)
  uint64_t* full_v = bar + 1;
  uint64_t* free_k = bar + 2;   // every consumer is done with K tile t
  uint64_t* free_v = bar + 3;

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = qt * BQ;
  const int rows = min(BQ, Sq - q0);

  // the K/V tiles the mask leaves visible to some row of this query tile
  const int qpos_lo = q_offset + q0, qpos_hi = q_offset + q0 + rows - 1;
  int kt_lo = 0, kt_hi = (Skv + BK - 1) / BK - 1;
  if (causal) kt_hi = min(kt_hi, qpos_hi / BK);
  if (window >= 0) {
    const int kmin = qpos_lo - window + 1;    // first visible key
    if (kmin > 0) kt_lo = kmin / BK;
  }
  const int n_tiles = max(0, kt_hi - kt_lo + 1);

  if (tid == 0) {
    mbar_init(full_k, 1);
    mbar_init(full_v, 1);
    mbar_init(free_k, NCT);
    mbar_init(free_v, NCT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // a ragged last tile leaves V rows uncopied: give them finite values
  const int tail = n_tiles > 0 ? Skv - kt_hi * BK : BK;
  if (tail < BK && tid < NCT) {
    for (int i = tail * D4 + tid; i < BK * D4; i += NCT)
      reinterpret_cast<float4*>(sV)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    // order these writes before the bulk copies' writes to the same rows
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NW) {
    // the producer: tile t of K into the K buffer once every consumer is
    // past tile t-1's scores, and of V once every consumer is past tile
    // t-1's P.V; one bulk copy per row, rows spread over the lanes
    const long long stride = (long long)Hkv * D;
    const float* kb = k + ((long long)b * Skv * Hkv + hk) * D;
    const float* vb = v + ((long long)b * Skv * Hkv + hk) * D;
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = (kt_lo + t) * BK;
      const int n = min(BK, Skv - k0);
      const uint32_t bytes = (uint32_t)(n * D * sizeof(float));
      if (t > 0) mbar_wait(free_k, (t - 1) & 1);
#ifdef FA_NO_LOADS
      if (lane == 0) mbar_arrive(full_k);
#else
      if (lane == 0) mbar_expect(full_k, bytes);
      __syncwarp();
      for (int r = lane; r < n; r += 32)
        bulk_load(sK + r * QS, kb + (k0 + r) * stride, D * sizeof(float),
                  full_k);
#endif
      if (t > 0) mbar_wait(free_v, (t - 1) & 1);
#ifdef FA_NO_LOADS
      if (lane == 0) mbar_arrive(full_v);
#else
      if (lane == 0) mbar_expect(full_v, bytes);
      __syncwarp();
      for (int r = lane; r < n; r += 32)
        bulk_load(sV + r * D, vb + (k0 + r) * stride, D * sizeof(float),
                  full_v);
#endif
    }
    return;
  }

  // the consumers: warp w owns query rows 8w..8w+7 (ty = 2w, 2w+1)
  const int ty = tid >> 4, tx = tid & 15;
  for (int i = lane; i < 8 * D4; i += 32) {
    const int r = 8 * warp + i / D4, c4 = i % D4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows)
      x = reinterpret_cast<const float4*>(
          q + (((long long)b * Sq + q0 + r) * Hq + h) * D)[c4];
    x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    *reinterpret_cast<float4*>(sQ + r * QS + 4 * c4) = x;
  }
  __syncwarp();

  float m[4], l[4];
  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = (kt_lo + t) * BK;
    mbar_wait(full_k, t & 1);

    // scores of rows 4ty+i against keys tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    float4 qa[4], kb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qa[i] = *reinterpret_cast<const float4*>(sQ + (4 * ty + i) * QS);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kb[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * QS);
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const int dn = d + 4 < D ? d + 4 : d;
      float4 qn[4], kn[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qn[i] = *reinterpret_cast<const float4*>(sQ + (4 * ty + i) * QS + dn);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kn[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * QS + dn);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qn[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = kn[j];
    }
    mbar_arrive(free_k);

    // online softmax, row by row (a row lives on 16 lanes of one warp)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + 4 * ty + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Skv && (!causal || kpos <= qpos) &&
                (window < 0 || kpos > qpos - window);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#ifdef FA_NO_SOFTMAX
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(4 * ty + i) * PS + tx + 16 * j] = s[i][j];
      (void)mx;
#else
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(4 * ty + i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        acc[i][n].x *= corr; acc[i][n].y *= corr;
        acc[i][n].z *= corr; acc[i][n].w *= corr;
      }
#endif
    }
    __syncwarp();                 // this warp's rows of P are written
    mbar_wait(full_v, t & 1);

    // acc += P V over this tile's keys
    float4 pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[i] = *reinterpret_cast<const float4*>(sP + (4 * ty + i) * PS);
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      const int cn = c + 4 < BK ? c + 4 : c;
      float4 pn[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pn[i] = *reinterpret_cast<const float4*>(sP + (4 * ty + i) * PS + cn);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const float4 vb = *reinterpret_cast<const float4*>(
              sV + (c + cc) * D + 64 * n + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y
                            : cc == 2 ? pa[i].z : pa[i].w;
            acc[i][n].x = fmaf(p, vb.x, acc[i][n].x);
            acc[i][n].y = fmaf(p, vb.y, acc[i][n].y);
            acc[i][n].z = fmaf(p, vb.z, acc[i][n].z);
            acc[i][n].w = fmaf(p, vb.w, acc[i][n].w);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = pn[i];
    }
    __syncwarp();                 // this warp's rows of P are read
    mbar_arrive(free_v);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
    const float den = fmaxf(l[i], 1e-37f);
    float* out = o + (((long long)b * Sq + q0 + r) * Hq + h) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const float4 a = acc[i][n];
      *reinterpret_cast<float4*>(out + 64 * n + 4 * tx) =
          make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int Sq, int Skv, int Hq, int Hkv, int q_offset, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hq, (Sq + BQ - 1) / BQ, B);
  fa_fwd_kernel<D><<<grid, NT, smem, stream>>>(q, k, v, o, Sq, Skv, Hq, Hkv,
                                               q_offset, causal, window,
                                               scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), o (B, Sq, Hq, D): contiguous
// float32 with 16-byte aligned bases. D is 64, 128, 192 or 256;
// Hq % Hkv == 0; q_offset >= 0; window < 0 means no window. Returns the
// CUDA error code of the launch (0 on success), or -1 for a D the kernel is
// not built for.
extern "C" int flash_attention_fwd_launch(const float* q, const float* k,
                                          const float* v, float* o, int B,
                                          int Sq, int Skv, int Hq, int Hkv,
                                          int D, int q_offset, int causal,
                                          int window, float scale,
                                          void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, q_offset, causal,
                        window, scale, s);
    case 128:
      return launch<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, q_offset, causal,
                         window, scale, s);
    case 192:
      return launch<192>(q, k, v, o, B, Sq, Skv, Hq, Hkv, q_offset, causal,
                         window, scale, s);
    case 256:
      return launch<256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, q_offset, causal,
                         window, scale, s);
    default:
      return -1;
  }
}
