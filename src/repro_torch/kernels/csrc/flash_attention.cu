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
// FMA on the CUDA cores.
//
// Design. One block of 256 threads owns one (batch, query head, 64-row query
// tile) and walks the 64-row K/V tiles of that head's KV head (h / G) that
// the mask leaves visible: the loop starts at the first tile inside the
// window and stops at the last tile at or before the diagonal, which is the
// TPU kernel's block skipping written as loop bounds. The query tile (scaled
// on load, as the reference scales q before the dot), the K tile, the V tile
// and the tile of probabilities sit in shared memory (211 KB at D = 256, one
// block per SM). Thread (ty, tx) = (tid / 16, tid % 16) owns query rows
// 4ty..4ty+3: it computes their scores against keys tx + 16j (a 4 x 4
// register tile, float4 reads along D), keeps their running max and
// denominator (reduced across the 16 lanes of the row with shuffles) and
// accumulates their output in registers over columns 4tx + 64n (D / 16
// columns per row). Rows and columns of the Q and K tiles are padded by 4
// floats so a quarter-warp's float4 reads fall in distinct banks. The online
// softmax is the reference's, step for step: masked scores are -1e30, their
// probabilities 0, the denominator floored at 1e-37, so a row with no
// visible key gives 0. Blocks are issued heaviest first (the last query
// tiles see the most keys).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int NT = 256;          // threads per block
constexpr float kNegInf = -1e30f;

template <int D>
struct Smem {
  static constexpr int QS = D + 4;          // padded row stride of Q and K
  static constexpr int PS = BK + 4;         // padded row stride of P
  static constexpr size_t bytes =
      sizeof(float) * (size_t)(BQ * QS + BK * QS + BK * D + BQ * PS);
};

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

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * BQ;
  const int rows = min(BQ, Sq - q0);

  for (int i = tid; i < BQ * D4; i += NT) {
    const int r = i / D4, c4 = i - r * D4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows)
      x = reinterpret_cast<const float4*>(
          q + (((long long)b * Sq + q0 + r) * Hq + h) * D)[c4];
    x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    *reinterpret_cast<float4*>(sQ + r * QS + 4 * c4) = x;
  }

  // the K/V tiles the mask leaves visible to some row of this query tile
  const int qpos_lo = q_offset + q0, qpos_hi = q_offset + q0 + rows - 1;
  int kt_lo = 0, kt_hi = (Skv + BK - 1) / BK - 1;
  if (causal) kt_hi = min(kt_hi, qpos_hi / BK);
  if (window >= 0) {
    const int kmin = qpos_lo - window + 1;    // first visible key
    if (kmin > 0) kt_lo = kmin / BK;
  }

  float m[4], l[4];
  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();              // the last tile's K, V and P are consumed
    for (int i = tid; i < BK * D4; i += NT) {
      const int r = i / D4, c4 = i - r * D4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < Skv) {
        const long long off = (((long long)b * Skv + k0 + r) * Hkv + hk) * D;
        kx = reinterpret_cast<const float4*>(k + off)[c4];
        vx = reinterpret_cast<const float4*>(v + off)[c4];
      }
      *reinterpret_cast<float4*>(sK + r * QS + 4 * c4) = kx;
      *reinterpret_cast<float4*>(sV + r * D + 4 * c4) = vx;
    }
    __syncthreads();

    // scores of rows 4ty+i against keys tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(sQ + (4 * ty + i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

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
    }
    __syncthreads();

    // acc += P V over this tile's keys
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(sP + (4 * ty + i) * PS + c);
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
    }
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
// float32. D is 64, 128 or 256; Hq % Hkv == 0; q_offset >= 0; window < 0
// means no window. Returns the CUDA error code of the launch (0 on
// success), or -1 for a D the kernel is not built for.
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
    case 256:
      return launch<256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, q_offset, causal,
                         window, scale, s);
    default:
      return -1;
  }
}
