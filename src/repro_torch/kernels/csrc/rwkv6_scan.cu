// WKV6 recurrence of RWKV6 "Finch" for Hopper (sm_90a), float32. Per
// (batch b, head h), with the state S (N x N, key row i, value column j)
// starting at zero:
//   y[b, t, h, j] = sum_i r_t[i] (S[i, j] + u[h, i] k_t[i] v_t[j])
//   S[i, j]      <- w_t[i] S[i, j] + k_t[i] v_t[j]
// and the final S is returned beside y.
//
// Replaces the TPU kernel wkv6_pallas (src/repro/kernels/rwkv6_scan/
// kernel.py:61, body _wkv_kernel :23): a grid of (batch * heads, time
// blocks of 256) over heads-major copies of r, k, v, w, with S resident in
// VMEM scratch along the sequential time axis and one (1, N) x (N, N)
// product per step.
//
// What bounds it on this card: bytes. r, k, v and w are read once and y is
// written once: at the rwkv6-7b prefill shape (B, S, H, N) = (2, 4096, 64,
// 64) that is 5 x 134 MB, 0.200 ms at 3.35 TB/s. Its arithmetic, about
// 5 N^2 flops per (b, h, t), is 1.07e10 flops, 0.16 ms at the 67 TFLOP/s
// float32 rate of the CUDA cores.
//
// Design. Time is a chain of 4096 dependent steps, and there are only
// B * H = 128 (b, h) pairs, fewer than the 132 SMs. But the value columns
// are independent: S[:, j] evolves from k, w and v_j alone, and y_j reads
// only S[:, j]. So a block owns one (b, h, tile of JT value columns), and a
// thread owns G = 16 key rows of one column (G = 8 at N = 16), in
// registers, beside its G entries of u. At (2, 4096, 64, 64) that is 256
// blocks of 128 threads. r, k and w of a chunk of 32 steps (all N key
// rows) and v (the block's columns) are staged in shared memory with
// coalesced loads, with two __syncthreads per chunk, not per step; each
// step then reads r, k, w as float4 broadcasts (a group's row segment is
// padded by 4 floats, so the N / G groups of a warp hit distinct banks).
// y of a chunk is gathered in shared memory and written as whole rows of
// the tile.
//
// Arithmetic. The kernel takes the operations of the plain version
// (kernels/rwkv6_scan/ref.py, wkv6_ref) in its order, each rounded on its
// own (the _rn intrinsics keep the compiler from fusing a multiply and an
// add): kv = k_i v_j, t = S_ij + u_i kv, p_i = r_i t, S_ij = w_i S_ij + kv,
// and y_j the pairwise tree over i of the p_i: first inside the thread
// over its G contiguous rows, then across the N / G threads of the column
// (neighbouring lanes) with xor shuffles, a + b being b + a in IEEE
// arithmetic. So the kernel gives the plain version's bits, and the same
// bits on every run: at full width rwkv6-7b magnified one rounding of y to
// 2.4e-4 in its logits (measured on an H100 with a kernel of another
// order), and no other order could be held to them. The price is 7
// operations per element and step where 3 would compute the function (the
// TPU kernel's r.S + (sum_i r_i u_i k_i) v with fused multiply-adds). r, k,
// v and w are read in place through their (batch, time, head) strides; the
// head dim must be contiguous.
#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;          // time steps per staged chunk
constexpr int kPad = 4;         // floats after each group's row segment

template <int N>
struct Tile {
  static constexpr int G = N >= 32 ? 16 : N / 2;     // key rows per thread
  static constexpr int NG = N / G;                   // threads per column
  static constexpr int JT = (128 / NG) < N ? 128 / NG : N;  // columns/block
  static constexpr int THREADS = JT * NG;
  static constexpr int ROW = NG * (G + kPad);        // staged floats per step
  static_assert(G % 4 == 0 && THREADS % 32 == 0 && N % JT == 0, "tile");
};

// One element (i, j) of one step: returns r_i (S_ij + u_i k_i v_j) and
// advances S_ij to w_i S_ij + k_i v_j, each operation rounded on its own.
__device__ __forceinline__ float element(float r, float k, float w, float u,
                                         float v, float& s) {
  const float kv = __fmul_rn(k, v);
  const float p = __fmul_rn(r, __fadd_rn(s, __fmul_rn(u, kv)));
  s = __fadd_rn(__fmul_rn(w, s), kv);
  return p;
}

// The pairwise tree over a thread's G rows, level by level: p[m] + p[m +
// s] into p[m] for s = 1, 2, 4, ...; returns the root.
template <int G, int S = 1>
__device__ __forceinline__ float tree(float (&p)[G]) {
  if constexpr (S < G) {
#pragma unroll
    for (int m = 0; m < G; m += 2 * S) p[m] = __fadd_rn(p[m], p[m + S]);
    return tree<G, 2 * S>(p);
  } else {
    return p[0];
  }
}

template <int N>
__global__ void __launch_bounds__(Tile<N>::THREADS)
wkv6_fwd(const float* __restrict__ r, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, float* __restrict__ y,
         float* __restrict__ s_out, int S, int H, long long sb,
         long long ss, long long sh) {
  using T = Tile<N>;
  constexpr int G = T::G, NG = T::NG, JT = T::JT, THREADS = T::THREADS;
  constexpr int ROW = T::ROW;
  __shared__ __align__(16) float sr[kT * ROW];
  __shared__ __align__(16) float sk[kT * ROW];
  __shared__ __align__(16) float sw[kT * ROW];
  __shared__ float sv[kT * JT], sy[kT * JT];

  const int tid = threadIdx.x;
  const int g = tid % NG, jl = tid / NG;
  const int j0 = blockIdx.x * JT, h = blockIdx.y, b = blockIdx.z;
  const long long base = (long long)b * sb + (long long)h * sh;

  float st[G], uu[G];           // S[g * G + m, j0 + jl] and u[g * G + m]
#pragma unroll
  for (int m = 0; m < G; ++m) {
    st[m] = 0.f;
    uu[m] = u[h * N + g * G + m];
  }

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int nt = min(kT, S - t0);
    __syncthreads();            // the previous chunk is read and written out
    for (int e = tid; e < nt * N; e += THREADS) {
      const int tt = e / N, i = e % N;
      const long long off = base + (long long)(t0 + tt) * ss + i;
      const int p = tt * ROW + (i / G) * (G + kPad) + i % G;
      sr[p] = r[off];
      sk[p] = k[off];
      sw[p] = w[off];
    }
    for (int e = tid; e < nt * JT; e += THREADS) {
      const int tt = e / JT, jj = e % JT;
      sv[e] = v[base + (long long)(t0 + tt) * ss + j0 + jj];
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = sv[tt * JT + jl];
      const int seg = tt * ROW + g * (G + kPad);
      const float4* r4 = reinterpret_cast<const float4*>(sr + seg);
      const float4* k4 = reinterpret_cast<const float4*>(sk + seg);
      const float4* w4 = reinterpret_cast<const float4*>(sw + seg);
      float pr[G];
#pragma unroll
      for (int q = 0; q < G / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q];
        pr[4 * q + 0] = element(rq.x, kq.x, wq.x, uu[4 * q + 0], vj,
                                st[4 * q + 0]);
        pr[4 * q + 1] = element(rq.y, kq.y, wq.y, uu[4 * q + 1], vj,
                                st[4 * q + 1]);
        pr[4 * q + 2] = element(rq.z, kq.z, wq.z, uu[4 * q + 2], vj,
                                st[4 * q + 2]);
        pr[4 * q + 3] = element(rq.w, kq.w, wq.w, uu[4 * q + 3], vj,
                                st[4 * q + 3]);
      }
      float part = tree(pr);
#pragma unroll
      for (int off = 1; off < NG; off <<= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
      if (g == 0) sy[tt * JT + jl] = part;
    }
    __syncthreads();
    for (int e = tid; e < nt * JT; e += THREADS) {
      const int tt = e / JT, jj = e % JT;
      y[(((long long)b * S + t0 + tt) * H + h) * N + j0 + jj] = sy[e];
    }
  }
  float* so = s_out + ((long long)b * H + h) * N * N + j0 + jl;
#pragma unroll
  for (int m = 0; m < G; ++m) so[(long long)(g * G + m) * N] = st[m];
}

template <int N>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, float* y, float* s_out,
                   int B, int S, int H, long long sb, long long ss,
                   long long sh, cudaStream_t stream) {
  using T = Tile<N>;
  wkv6_fwd<N><<<dim3(N / T::JT, H, B), T::THREADS, 0, stream>>>(
      r, k, v, w, u, y, s_out, S, H, sb, ss, sh);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w: (B, S, H, N) float32 with element strides (sb, ss, sh, 1),
// the same for all four; u: (H, N); y: (B, S, H, N) and s_out: (B, H, N,
// N) contiguous float32. N is 16, 32 or 64. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int wkv6_fwd_launch(const float* r, const float* k,
                               const float* v, const float* w,
                               const float* u, float* y, float* s_out,
                               int B, int S, int H, int N, long long sb,
                               long long ss, long long sh, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return (int)launch<16>(r, k, v, w, u, y, s_out, B, S, H, sb, ss,
                                    sh, s);
    case 32: return (int)launch<32>(r, k, v, w, u, y, s_out, B, S, H, sb, ss,
                                    sh, s);
    case 64: return (int)launch<64>(r, k, v, w, u, y, s_out, B, S, H, sb, ss,
                                    sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
