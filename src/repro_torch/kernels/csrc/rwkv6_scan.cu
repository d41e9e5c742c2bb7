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
// What bounds it on this card. Bytes: r, k, v and w are read once and y is
// written once: at the rwkv6-7b prefill shape (B, S, H, N) = (2, 4096, 64,
// 64) that is 5 x 134 MB, 0.200 ms at 3.35 TB/s. But the order of
// operations is fixed (below): 6 separately rounded float32 operations per
// element (i, j) and step plus one add of the sum tree, 1.5e10 lane
// instructions at that shape, about 0.45-0.51 ms of FP32 issue at 132 SMs x
// 128 lanes x 1.98 GHz. That issue floor, not the bytes, is what the design
// works against.
//
// Design. Time is a chain of 4096 dependent steps and there are only B * H
// = 128 (b, h) pairs, fewer than the 132 SMs; but the value columns are
// independent: S[:, j] evolves from k, w and v_j alone, and y_j reads only
// S[:, j]. So a block owns one (b, h, tile of JT value columns), and a
// thread owns C value columns x G key rows of S in registers, beside its G
// entries of u: each r, k and w value it reads from shared memory feeds C
// elements. At N = 64 (and 32) C = G = 4, at N = 16 C = 2, G = 4; at (2,
// 4096, 64, 64) that is 256 blocks of 128 threads (16 lanes a column
// group), 96 registers a thread. scripts/tune_wkv6_tiles.py times the
// other tiles.
// - Staging. r, k and w of a chunk of 32 steps (all N key rows) and v (the
//   block's columns) are copied into shared memory with cp.async, 16 bytes
//   a copy where every base pointer and stride is a multiple of 16 bytes
//   and 4 bytes otherwise, into two buffers: chunk c + 1 is in flight
//   while chunk c is computed, with one __syncthreads per chunk. A row
//   group's segment of a step is padded by 4 floats where G > 4, so the
//   row groups of a quarter warp read distinct banks; each step reads r,
//   k, w as float4.
// - The sum over i. The plain version's tree runs first inside the thread
//   over its G contiguous rows, for each of its C columns, then across the
//   N / G lanes that hold the neighbouring row groups, by xor shuffles. The
//   first log2(C) of those levels are transposed: at each, a lane keeps
//   half of its columns, sends the other half and adds what its partner
//   sends for the kept half, so C columns cost C - 1 shuffles, not C per
//   level. To make that uniform, slot s of lane g holds the column s ^
//   bitrev(g mod C), and after the last level lane g holds column
//   bitrev(g mod C) of its group; the lanes g < C write y from registers.
//   (tests/test_torch_kernel_orders.py models this order in torch and
//   holds it to the plain version's bits.)
// - Batches. A warp issues in order, so a step's chain of dependent
//   shuffles and the store of its y would stall the next step's element
//   math; on the card that cost more than the math. The cross-lane levels
//   therefore run for NB = 8 steps at once, after their element math: the
//   8 steps' shuffles of a level are independent and overlap.
// Arithmetic. The kernel takes the operations of the plain version
// (kernels/rwkv6_scan/ref.py, wkv6_ref) in its order, each rounded on its
// own (the _rn intrinsics keep the compiler from fusing a multiply and an
// add): kv = k_i v_j, t = S_ij + u_i kv, p_i = r_i t, S_ij = w_i S_ij + kv,
// and y_j the pairwise tree over i of the p_i, a + b being b + a in IEEE
// arithmetic. So the kernel gives the plain version's bits, and the same
// bits on every run: at full width rwkv6-7b magnified one rounding of y to
// 2.4e-4 in its logits (measured on an H100 with a kernel of another
// order), and no other order could be held to them. The price is 7
// operations per element and step where 3 would compute the function (the
// TPU kernel's r.S + (sum_i r_i u_i k_i) v with fused multiply-adds). r, k,
// v and w are read in place through their (batch, time, head) strides; the
// head dim must be contiguous.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;          // time steps per staged chunk

template <int N_, int G_, int C_, int JT_, int NB_>
struct Cfg {
  static constexpr int N = N_, G = G_, C = C_, JT = JT_;
  static constexpr int NB = NB_;                   // steps a batch
  static constexpr int NG = N / G;                 // lanes per column group
  static constexpr int THREADS = JT / C * NG;
  // floats per row group and step: segments of 4 floats start on the 8
  // bank quads of a quarter warp's 8 row groups; longer ones are padded by
  // 4 floats so that they do too
  static constexpr int SEG = G == 4 ? 4 : G + 4;
  static constexpr int ROW = NG * SEG;             // staged floats per step
  static constexpr int STAGE = 3 * kT * ROW + kT * JT;   // floats a buffer
  static constexpr int SMEM = 2 * STAGE * (int)sizeof(float);
  static_assert(G % 4 == 0 && N % G == 0, "rows a thread: float4 loads");
  static_assert((C & (C - 1)) == 0 && NG >= C && 32 % NG == 0,
                "a column group's lanes lie in one warp");
  static_assert(THREADS % 32 == 0 && N % JT == 0 && JT % 4 == 0 &&
                JT % C == 0 && kT % NB == 0, "tile");
};

template <int N> struct Tile;
template <> struct Tile<64> : Cfg<64, 4, 4, 32, 8> {};
template <> struct Tile<32> : Cfg<32, 4, 4, 32, 8> {};
template <> struct Tile<16> : Cfg<16, 4, 2, 16, 8> {};

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

// The log2(C) low bits of x in reverse order.
template <int C>
__device__ __forceinline__ int bitrev(int x) {
  int r = 0;
#pragma unroll
  for (int b = 1; b < C; b <<= 1) {
    r = (r << 1) | (x & 1);
    x >>= 1;
  }
  return r;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy steps [t0, t0 + nt) of r, k, w (all N rows, into their padded row
// group segments) and v (the block's JT columns) into one buffer, VEC
// floats a copy.
template <class T, int VEC>
__device__ __forceinline__ void stage(float* buf, const float* r,
                                      const float* k, const float* w,
                                      const float* v, long long base,
                                      long long ss, int t0, int nt, int j0) {
  constexpr int N = T::N, G = T::G, JT = T::JT;
  float* sr = buf;
  float* sk = buf + kT * T::ROW;
  float* sw = buf + 2 * kT * T::ROW;
  float* sv = buf + 3 * kT * T::ROW;
  for (int e = threadIdx.x; e < nt * (N / VEC); e += T::THREADS) {
    const int tt = e / (N / VEC), i = e % (N / VEC) * VEC;
    const long long off = base + (long long)(t0 + tt) * ss + i;
    const int d = tt * T::ROW + i / G * T::SEG + i % G;
    if constexpr (VEC == 4) {
      cp_async16(sr + d, r + off);
      cp_async16(sk + d, k + off);
      cp_async16(sw + d, w + off);
    } else {
      cp_async4(sr + d, r + off);
      cp_async4(sk + d, k + off);
      cp_async4(sw + d, w + off);
    }
  }
  for (int e = threadIdx.x; e < nt * (JT / VEC); e += T::THREADS) {
    const int tt = e / (JT / VEC), jj = e % (JT / VEC) * VEC;
    const long long off = base + (long long)(t0 + tt) * ss + j0 + jj;
    if constexpr (VEC == 4) {
      cp_async16(sv + tt * JT + jj, v + off);
    } else {
      cp_async4(sv + tt * JT + jj, v + off);
    }
  }
}

// One step's operands of a thread: r, k, w of its G rows and v of its C
// columns (slot s holding column s ^ flip of its group).
template <class T>
struct Operands {
  float r[T::G], k[T::G], w[T::G], v[T::C];
};

template <class T>
__device__ __forceinline__ void load_step(const float* buf, int tt, int g,
                                          int cg, int flip, Operands<T>& o) {
  const int seg = tt * T::ROW + g * T::SEG;
#pragma unroll
  for (int q = 0; q < T::G / 4; ++q) {
    const float4 rq = reinterpret_cast<const float4*>(buf + seg)[q];
    const float4 kq =
        reinterpret_cast<const float4*>(buf + kT * T::ROW + seg)[q];
    const float4 wq =
        reinterpret_cast<const float4*>(buf + 2 * kT * T::ROW + seg)[q];
    o.r[4 * q] = rq.x; o.r[4 * q + 1] = rq.y;
    o.r[4 * q + 2] = rq.z; o.r[4 * q + 3] = rq.w;
    o.k[4 * q] = kq.x; o.k[4 * q + 1] = kq.y;
    o.k[4 * q + 2] = kq.z; o.k[4 * q + 3] = kq.w;
    o.w[4 * q] = wq.x; o.w[4 * q + 1] = wq.y;
    o.w[4 * q + 2] = wq.z; o.w[4 * q + 3] = wq.w;
  }
  const float* sv = buf + 3 * kT * T::ROW + tt * T::JT + cg * T::C;
#pragma unroll
  for (int s = 0; s < T::C; ++s) o.v[s] = sv[s ^ flip];
}

// NB steps of a thread from shared memory at step tt of the buffer (global
// step t): each step's elements and in-thread trees, then the tree's
// levels across the NG lanes of a column group for all NB steps together,
// so that their shuffles overlap: the first log2(C) levels transposed
// (keep slots [0, half), add the partner's slots [half, 2 half)), the
// rest plain. Lane g < C then writes column bitrev(g mod C) of its group.
template <class T, int NB>
__device__ __forceinline__ void run_steps(const float* buf, int tt, int g,
                                          int cg, int flip,
                                          const float (&uu)[T::G],
                                          float (&st)[T::C][T::G],
                                          float* yb, long long y_step,
                                          int t) {
  constexpr int G = T::G, C = T::C, NG = T::NG;
  float acc[NB][C];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    Operands<T> o;
    load_step<T>(buf, tt + i, g, cg, flip, o);
#pragma unroll
    for (int s = 0; s < C; ++s) {
      float p[G];
#pragma unroll
      for (int m = 0; m < G; ++m)
        p[m] = element(o.r[m], o.k[m], o.w[m], uu[m], o.v[s], st[s][m]);
      acc[i][s] = tree(p);
    }
  }
  float recv[NB][C];
#pragma unroll
  for (int half = C / 2, off = 1; half >= 1; half /= 2, off *= 2) {
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int s = 0; s < half; ++s)
        recv[i][s] = __shfl_xor_sync(0xffffffffu, acc[i][s + half], off);
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int s = 0; s < half; ++s)
        acc[i][s] = __fadd_rn(acc[i][s], recv[i][s]);
  }
#pragma unroll
  for (int off = C; off < NG; off <<= 1) {
#pragma unroll
    for (int i = 0; i < NB; ++i)
      recv[i][0] = __shfl_xor_sync(0xffffffffu, acc[i][0], off);
#pragma unroll
    for (int i = 0; i < NB; ++i) acc[i][0] = __fadd_rn(acc[i][0], recv[i][0]);
  }
  if (g < C) {
#pragma unroll
    for (int i = 0; i < NB; ++i) yb[(long long)(t + i) * y_step] = acc[i][0];
  }
}

template <int N, int VEC>
__global__ void __launch_bounds__(Tile<N>::THREADS)
wkv6_fwd(const float* __restrict__ r, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, float* __restrict__ y,
         float* __restrict__ s_out, int S, int H, long long sb,
         long long ss, long long sh) {
  using T = Tile<N>;
  constexpr int G = T::G, C = T::C, NG = T::NG, JT = T::JT, NB = T::NB;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int g = tid % NG, cg = tid / NG;
  const int flip = bitrev<C>(g % C);      // slot s holds column s ^ flip
  const int j0 = blockIdx.x * JT, h = blockIdx.y, b = blockIdx.z;
  const long long base = (long long)b * sb + (long long)h * sh;

  float st[C][G], uu[G];        // S[g G + m, j0 + cg C + (s ^ flip)], u
#pragma unroll
  for (int m = 0; m < G; ++m) {
    uu[m] = u[h * N + g * G + m];
#pragma unroll
    for (int s = 0; s < C; ++s) st[s][m] = 0.f;
  }
  float* yb = y + ((long long)b * S * H + h) * N + j0 + cg * C + flip;
  const long long y_step = (long long)H * N;

  stage<T, VEC>(smem, r, k, w, v, base, ss, 0, min(kT, S), j0);
  cp_async_commit();
  for (int c = 0, t0 = 0; t0 < S; ++c, t0 += kT) {
    const int nt = min(kT, S - t0);
    cp_async_wait_all();
    __syncthreads();            // chunk c landed; chunk c - 1 is consumed
    if (t0 + kT < S)
      stage<T, VEC>(smem + ((c + 1) & 1) * T::STAGE, r, k, w, v, base, ss,
                    t0 + kT, min(kT, S - t0 - kT), j0);
    cp_async_commit();
    const float* buf = smem + (c & 1) * T::STAGE;
    int tt = 0;
#pragma unroll 1
    for (; tt + NB <= nt; tt += NB)
      run_steps<T, NB>(buf, tt, g, cg, flip, uu, st, yb, y_step, t0 + tt);
#pragma unroll 1
    for (; tt < nt; ++tt)       // a last chunk's ragged end
      run_steps<T, 1>(buf, tt, g, cg, flip, uu, st, yb, y_step, t0 + tt);
  }
  float* so = s_out + ((long long)b * H + h) * N * N + j0 + cg * C;
#pragma unroll
  for (int s = 0; s < C; ++s) {
#pragma unroll
    for (int m = 0; m < G; ++m)
      so[(long long)(g * G + m) * N + (s ^ flip)] = st[s][m];
  }
}

template <int N>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, float* y, float* s_out,
                   int B, int S, int H, long long sb, long long ss,
                   long long sh, cudaStream_t stream) {
  using T = Tile<N>;
  const bool vec =
      ((uintptr_t)r | (uintptr_t)k | (uintptr_t)v | (uintptr_t)w) % 16 == 0 &&
      sb % 4 == 0 && ss % 4 == 0 && sh % 4 == 0;
  auto kernel = vec ? wkv6_fwd<N, 4> : wkv6_fwd<N, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(N / T::JT, H, B), T::THREADS, T::SMEM, stream>>>(
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
