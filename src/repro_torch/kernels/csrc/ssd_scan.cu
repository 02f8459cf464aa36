// Mamba2 SSD chunked scan, forward, for sm_90a: bfloat16 on the tensor
// cores, float32 on the CUDA cores.
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/ssd_scan.py:74 `ssd_scan` (pallas_call at :85), and
// computes what the reference's model runs in its place,
// models/ssm.py:ssd_chunked: per (batch, head), chunk by chunk,
//     y       = ((C B^T) o L) (dt x) + (C o e^{cum}) State^T
//     State  <- e^{cum_last} State + (B o e^{cum_last - cum})^T (dt x)
// with the state carried in float32 in chunk order from an optional
// initial state, and the final state emitted.  The kernel forms dt x and
// dt A itself and reads B / C of group h / (H / G) in place.  Rounding
// follows ssd_chunked, which rounds to the input type T at five places:
// the masked scores, the decayed B, the decayed C, the state where it
// meets C and the inter-chunk product; dt x stays float32, y is float32,
// the final state T.
//
// What bounds it on an H100: bytes.  Per (b, h) and chunk the causal work
// is c(c+1)(N+P) + 4cPN operations: 15 GFLOP a launch at the training
// shape (8 x 1024 tokens, 32 heads, P 64, N 128), 0.015 ms at the bf16
// tensor-core peak; the bytes (x, dt, B, C in; y in float32 and the final
// state out, 110 MB) take 0.033 ms at 3.35 TB/s.
//
// bfloat16: `ssd_mma_bf16_kernel`, warp-level tensor-core MMAs
//   (mma.sync.m16n8k16, bf16 in, f32 accumulate).  One 256-thread block
//   owns one (batch, head) and walks its chunks in order: the state is the
//   sequential dependency, carried in float32 in the registers of the
//   eight warps (each holds 16-column blocks of State^T, all P rows), and
//   a bf16 copy of it -- the reference's rounding where it meets C -- sits
//   in shared memory for the y product.  B, C, x and dt of a chunk are
//   staged in bf16 shared memory through cp.async (rows padded by 16
//   bytes, so ldmatrix reads no bank twice); with two ring slots the next
//   chunk is fetched while this one computes.  Each warp owns 16 rows of
//   the chunk (warps w and w + 4, which share a scheduler, take rows from
//   both ends of the causal triangle) and computes, all on the tensor
//   cores, y_inter = rnd(C o e^cum) rnd(State)^T, then the scores C B^T
//   16 columns at a time, masked, decayed and rounded in registers, and
//   their product with dt x; then its columns of State^T += (B o
//   e^{last - cum})^T (dt x).  dt x is float32 in the reference, which
//   bf16 cannot hold: dt is folded into the other operand (the rounded
//   scores, the rounded decayed B), and that float32 product is split
//   into bf16 parts, MMAs against the exact bf16 x: hi + lo for y (~2^-17
//   of each term left), hi + mid + lo for the state, which is carried to
//   the output and rounded there.  The block count is the (b, h) count:
//   at 8 x 32 (256 blocks) one slot and two blocks a SM, below the SM
//   count two slots.
// float32: `ssd_simt_kernel`, FMAs on the CUDA cores (no TF32): one block
//   per (P-tile of 32 columns, head, batch), the chunk staged as float32.
//
// Measured (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3 at 700 W): 0.171
// ms at the training shape, 5.2x its bound (the float32-FMA design before
// it: 1.546 ms), 0.049 ms at one 384-token prefill of 32 heads and 0.042
// ms at zamba2's 80 heads of N 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>

namespace simt {

constexpr int kThreads = 256;
constexpr int kPT = 32;      // P columns per block
constexpr int kMaxC = 128;   // chunk rows (score tile side)
constexpr int kMaxN = 128;   // state size

// the kernel below is written for any T; only float is instantiated
template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
// round a float32 value to T and back (a no-op for float)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// 8 consecutive values at p (16-byte aligned), as floats
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

size_t smem_bytes(int c, int N) {
  return sizeof(float) *
         (2 * (size_t)N * c + (size_t)c * c + (size_t)c * kPT +
          (size_t)N * kPT + 3 * (size_t)c);
}

// x (b, S, H, P) T; dt (b, S, H) f32; A (H,) f32; B / C (b, S, G, N) T;
// init (b, H, P, N) T or null; y (b, S, H, P) f32; fin (b, H, P, N) T.
// grid (P / kPT, H, b), kThreads threads, smem_bytes(c, N) dynamic.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_simt_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ B,
                const T* __restrict__ C, const T* __restrict__ init,
                float* __restrict__ y, T* __restrict__ fin, int S, int H,
                int G, int N, int P, int c) {
  extern __shared__ __align__(16) float smem[];
  float* Bt = smem;               // [N][c]  B^T of the chunk
  float* Ct = Bt + N * c;         // [N][c]  C^T of the chunk
  float* St = Ct + N * c;         // [c][c]  masked scores, St[j][i]
  float* xdt = St + c * c;        // [c][kPT] dt x
  float* stT = xdt + c * kPT;     // [N][kPT] state^T, float32
  float* cum = stT + N * kPT;     // [c] inclusive cumsum of dt A
  float* dte = cum + c;           // [c] e^{cum_last - cum}
  float* ind = dte + c;           // [c] e^{cum}

  const int p0 = blockIdx.x * kPT, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const float Ah = A[h];

  for (int idx = tid; idx < N * kPT; idx += kThreads) {
    const int p = idx / N, n = idx % N;
    stT[n * kPT + p] =
        init ? to_f<T>(init[(((size_t)bi * H + h) * P + p0 + p) * N + n])
             : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += c) {
    // ---- load the chunk, 16 bytes a load: B^T, C^T (8 state entries a
    // thread, neighbouring threads on neighbouring rows, so the transposed
    // stores hit distinct banks), dt x (8 columns a thread), dt A
#pragma unroll 4
    for (int idx = tid; idx < c * (N / 8); idx += kThreads) {
      const int t = idx % c, n0 = (idx / c) * 8;
      const size_t row = (((size_t)bi * S + t0 + t) * G + g) * N + n0;
      float bv[8], cv[8];
      load8(B + row, bv);
      load8(C + row, cv);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        Bt[(n0 + r) * c + t] = bv[r];
        Ct[(n0 + r) * c + t] = cv[r];
      }
    }
    for (int idx = tid; idx < c * (kPT / 8); idx += kThreads) {
      const int t = idx / (kPT / 8), p8 = (idx % (kPT / 8)) * 8;
      const size_t row = ((size_t)bi * S + t0 + t) * H + h;
      float xv[8];
      load8(x + row * P + p0 + p8, xv);
      const float d = dt[row];
#pragma unroll
      for (int r = 0; r < 8; ++r) xdt[t * kPT + p8 + r] = xv[r] * d;
    }
    if (tid < c) cum[tid] = dt[((size_t)bi * S + t0 + tid) * H + h] * Ah;
    __syncthreads();

    // ---- inclusive cumsum of dt A over the chunk (warp 0)
    if (tid < 32) {
      const int per = (c + 31) / 32, lo = tid * per;
      const int hi = min(c, lo + per);
      float run = 0.f;
      for (int t = lo; t < hi; ++t) {
        run += cum[t];
        cum[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float excl = incl - run;
      for (int t = lo; t < hi; ++t) cum[t] += excl;
    }
    __syncthreads();
    const float last = cum[c - 1];
    if (tid < c) {
      dte[tid] = expf(last - cum[tid]);
      ind[tid] = expf(cum[tid]);
    }

    // ---- masked scores: St[j][i] = T((C_i . B_j) e^{cum_i - cum_j}), i >= j
    {
      const int ti = tid % 16, tj = tid / 16;
      const int i0 = ti * 8, j0 = tj * 8;
      if (i0 < c && j0 < c && tj <= ti) {
        float acc[8][8];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[8], bv[8];
          load8(Ct + n * c + i0, cv);
          load8(Bt + n * c + j0, bv);
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < 8; ++b)
              acc[a][b] = fmaf(cv[a], bv[b], acc[a][b]);
        }
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int j = j0 + b;
          float out[8];
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            const int i = i0 + a;
            out[a] = i >= j ? round_to<T>(acc[a][b] * expf(cum[i] - cum[j]))
                            : 0.f;
          }
          float4* dst = reinterpret_cast<float4*>(St + j * c + i0);
          dst[0] = make_float4(out[0], out[1], out[2], out[3]);
          dst[1] = make_float4(out[4], out[5], out[6], out[7]);
        }
      }
    }
    __syncthreads();

    // ---- decayed B and C, rounded to T, in place
    for (int idx = tid; idx < N * c; idx += kThreads) {
      const int t = idx % c;
      Bt[idx] = round_to<T>(Bt[idx] * dte[t]);
      Ct[idx] = round_to<T>(Ct[idx] * ind[t]);
    }
    __syncthreads();

    // ---- y rows i0..i0+7 of column p: intra + T(inter)
    for (int w = tid; w < (c / 8) * kPT; w += kThreads) {
      const int p = w % kPT, i0 = (w / kPT) * 8;
      float yi[8], ye[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) yi[a] = ye[a] = 0.f;
      for (int j = 0; j < i0 + 8; ++j) {
        float s[8];
        load8(St + j * c + i0, s);
        const float xv = xdt[j * kPT + p];
#pragma unroll
        for (int a = 0; a < 8; ++a) yi[a] = fmaf(s[a], xv, yi[a]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[8];
        load8(Ct + n * c + i0, cv);
        const float sv = round_to<T>(stT[n * kPT + p]);
#pragma unroll
        for (int a = 0; a < 8; ++a) ye[a] = fmaf(cv[a], sv, ye[a]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
        y[(((size_t)bi * S + t0 + i0 + a) * H + h) * P + p0 + p] =
            yi[a] + round_to<T>(ye[a]);
    }
    __syncthreads();

    // ---- state rows n0..n0+7 of column p
    const float decay = expf(last);
    for (int w = tid; w < (N / 8) * kPT; w += kThreads) {
      const int p = w % kPT, n0 = (w / kPT) * 8;
      float acc[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] = 0.f;
      for (int t = 0; t < c; ++t) {
        const float xv = xdt[t * kPT + p];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          acc[r] = fmaf(Bt[(n0 + r) * c + t], xv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float& s = stT[(n0 + r) * kPT + p];
        s = s * decay + acc[r];
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < N * kPT; idx += kThreads) {
    const int p = idx / N, n = idx % N;
    fin[(((size_t)bi * H + h) * P + p0 + p) * N + n] =
        from_f<T>(stT[n * kPT + p]);
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* init, void* y, void* fin, int b, int S,
           int H, int G, int N, int P, int c, cudaStream_t stream) {
  // opt in once, for the largest chunk and state (before any CUDA graph
  // capture: the first launch of each type runs eagerly)
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxC, kMaxN));
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const size_t smem = smem_bytes(c, N);
  dim3 grid(P / kPT, H, b);
  ssd_simt_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const T*>(init),
      static_cast<float*>(y), static_cast<T*>(fin), S, H, G, N, P, c);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxC = 128;        // chunk rows
constexpr int kMaxP = 64;         // head width P

// row stride (elements) of a bf16 tile in shared memory: 16 bytes of
// padding put the 8 rows one ldmatrix reads on distinct banks
__host__ __device__ constexpr int padded(int n) { return n + 8; }

// one ring slot: C and B [c][N + 8], x [c][P + 8] (bf16), dt [c] (f32)
__host__ __device__ inline size_t slot_bytes(int c, int N, int P) {
  return (size_t)c * (2 * padded(N) + padded(P)) * 2 + (size_t)c * 4;
}
// the state where it meets C, bf16 [P][N + 8]
__host__ __device__ inline size_t state_bytes(int N, int P) {
  return (size_t)P * padded(N) * 2;
}
inline size_t smem_bytes(int c, int N, int P, int stages) {
  return stages * slot_bytes(c, N, P) + state_bytes(N, P) +
         3 * (size_t)c * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
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

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) @ b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 and packed, the first in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// two float32 values as bf16 hi + lo pairs (hi + lo holds ~16 of their 24
// bits; what is left is ~2^-17 of each value)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack2(a, b);
  const float2 h = unpack2(hi);
  lo = pack2(a - h.x, b - h.y);
}
// as bf16 hi + mid + lo: all 24 bits
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack2(a, b);
  const float2 h = unpack2(hi);
  split2(a - h.x, b - h.y, mid, lo);
}
// a packed pair of bf16 values times s, rounded back to bf16 (the
// reference's decayed C)
__device__ __forceinline__ uint32_t scale2(uint32_t u, float s) {
  const float2 v = unpack2(u);
  return pack2(v.x * s, v.y * s);
}

// Fragment layout of an m16n8 accumulator: lane owns rows lane / 4
// (elements 0, 1) and lane / 4 + 8 (elements 2, 3), columns 2 (lane % 4)
// and + 1.
//
// x (b, S, H, P), B / C (b, S, G, N), init / fin (b, H, P, N) bf16; dt (b,
// S, H), A (H,), y (b, S, H, P) f32.  grid (H, b), kThreads threads,
// smem_bytes(c, N, P, STAGES) dynamic.  c, P multiples of 16 (c <= 128,
// P <= 64), N one of 16, 32, 64, 128.
template <int N, int STAGES>
__global__ void __launch_bounds__(kThreads, STAGES == 1 ? 2 : 1)
    ssd_mma_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const __nv_bfloat16* __restrict__ B,
                        const __nv_bfloat16* __restrict__ C,
                        const __nv_bfloat16* __restrict__ init,
                        float* __restrict__ y, __nv_bfloat16* __restrict__ fin,
                        int S, int H, int G, int P, int c) {
  constexpr int LN = padded(N);   // row stride of B, C and the state
  constexpr int KN = N / 16;      // k16 steps over the state
  constexpr int NB = N / 16;      // 16-column blocks of State^T
  constexpr int UNITS = NB >= 2 ? NB / 2 : 1;   // (p16, n16) tiles a warp
  static_assert(N % 16 == 0 && N <= 128 && kWarps % NB == 0, "state size");
  const int LP = padded(P);
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t slot = slot_bytes(c, N, P);
  unsigned char* st_smem = smem + STAGES * slot;
  const uint32_t sS = smem_u32(st_smem);
  float* cum = reinterpret_cast<float*>(st_smem + state_bytes(N, P));
  float* ind = cum + c;           // e^{cum}
  float* dte = ind + c;           // e^{cum_last - cum}

  const int h = blockIdx.x, bi = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r = lane / 4, q = lane % 4;
  const float Ah = A[h];
  const int n_chunks = S / c, npt = P / 16, nrt = c / 16;

  // chunk k's C, B, x and dt into ring slot k % STAGES: one commit group
  auto fetch_chunk = [&](int k) {
    const uint32_t base = smem_u32(smem + (k % STAGES) * slot);
    const size_t t0 = (size_t)bi * S + (size_t)k * c;
    for (int i = tid; i < c * (N / 8); i += kThreads) {
      const int t = i / (N / 8), col = (i % (N / 8)) * 8;
      const size_t src = ((t0 + t) * G + g) * N + col;
      cp_async16(base + (t * LN + col) * 2, C + src);
      cp_async16(base + ((c + t) * LN + col) * 2, B + src);
    }
    for (int i = tid; i < c * (P / 8); i += kThreads) {
      const int t = i / (P / 8), col = (i % (P / 8)) * 8;
      cp_async16(base + (2 * c * LN + t * LP + col) * 2,
                 x + ((t0 + t) * H + h) * P + col);
    }
    if (tid < c)
      cp_async4(base + (2 * c * LN + c * LP) * 2 + tid * 4,
                dt + (t0 + tid) * H + h);
    cp_async_commit();
  };
  fetch_chunk(0);

  // this warp's tiles of State^T (float32): rows p of p16 block pt(u),
  // columns n of the 16-column block nb, as two m16n8 accumulators
  const int nb = warp % NB;
  auto unit_pt = [&](int u) { return warp / NB + u * (kWarps / NB); };
  float st[UNITS][2][4];
#pragma unroll
  for (int u = 0; u < UNITS; ++u)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * unit_pt(u) + r + 8 * (e / 2);
        const int n = 16 * nb + 8 * j + 2 * q + (e % 2);
        st[u][j][e] = init && unit_pt(u) < npt
                          ? __bfloat162float(
                                init[(((size_t)bi * H + h) * P + p) * N + n])
                          : 0.f;
      }
  // the state where it meets C: State rounded to bf16, [p][n]
  auto store_state = [&]() {
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      if (unit_pt(u) >= npt) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = 16 * unit_pt(u) + r + 8 * hf;
          const int n = 16 * nb + 8 * j + 2 * q;
          const uint32_t hi = pack2(st[u][j][2 * hf], st[u][j][2 * hf + 1]);
          *reinterpret_cast<uint32_t*>(st_smem + (p * LN + n) * 2) = hi;
        }
    }
  };
  store_state();

  // this warp's 16 rows of the chunk: warps w and w + 4 share a scheduler
  // and take row tiles from both ends of the causal triangle
  const int rt = warp < 4 ? warp : nrt + 3 - warp;
  const bool has_rows = warp < 4 ? warp < nrt : rt >= 4;
  const int i0 = 16 * rt;

  for (int k = 0; k < n_chunks; ++k) {
    cp_async_wait<0>();
    // chunk k and the state are visible to every warp, and every warp is
    // done with chunk k - 1, whose slot the next copy refills
    __syncthreads();
    if (STAGES == 2 && k + 1 < n_chunks) fetch_chunk(k + 1);
    unsigned char* sl = smem + (k % STAGES) * slot;
    const uint32_t sC = smem_u32(sl);
    const uint32_t sB = sC + c * LN * 2;
    const uint32_t sX = sB + c * LN * 2;
    const float* dts = reinterpret_cast<const float*>(
        sl + (size_t)(2 * c * LN + c * LP) * 2);
    const size_t t0 = (size_t)bi * S + (size_t)k * c;

    // inclusive cumsum of dt A over the chunk, and the decays (warp 0)
    if (warp == 0) {
      const int per = (c + 31) / 32, lo = lane * per;
      const int hi = min(c, lo + per);
      float run = 0.f;
      for (int t = lo; t < hi; ++t) {
        run += dts[t] * Ah;
        cum[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const float excl = incl - run;
      for (int t = lo; t < hi; ++t) cum[t] += excl;
      __syncwarp();
      const float last = cum[c - 1];
      for (int t = lane; t < c; t += 32) {
        ind[t] = expf(cum[t]);
        dte[t] = expf(last - cum[t]);
      }
    }
    __syncthreads();

    // ---- y for this warp's rows
    if (has_rows) {
      float yacc[kMaxP / 8][4];
#pragma unroll
      for (int n = 0; n < kMaxP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[n][e] = 0.f;
      // C's A fragment of k-step kk: matrices (rows +0/+8) x (cols +0/+8)
      auto c_frag = [&](int kk, uint32_t* a) {
        ldsm_x4(sC + ((i0 + (lane % 8) + 8 * ((lane / 8) % 2)) * LN +
                      16 * kk + 8 * (lane / 16)) * 2, a);
      };
      // y_inter = rnd(C o e^cum) rnd(State)^T, rounded once more
      const float ia = ind[i0 + r], ib = ind[i0 + r + 8];
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        uint32_t a[4];
        c_frag(kk, a);
        a[0] = scale2(a[0], ia);
        a[1] = scale2(a[1], ib);
        a[2] = scale2(a[2], ia);
        a[3] = scale2(a[3], ib);
#pragma unroll
        for (int pp = 0; pp < kMaxP / 16; ++pp) {
          if (pp >= npt) break;
          uint32_t b[4];
          ldsm_x4(sS + ((16 * pp + (lane % 8) + 8 * (lane / 16)) * LN +
                        16 * kk + 8 * ((lane / 8) % 2)) * 2, b);
          mma_16816(yacc[2 * pp], a, b[0], b[1]);
          mma_16816(yacc[2 * pp + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < kMaxP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[n][e] = round_bf(yacc[n][e]);

      // the masked score, decayed and rounded: rnd((C_i . B_j) L_ij)
      auto masked = [&](float s, int i, int j) {
        return i >= j ? round_bf(s * expf(cum[i] - cum[j])) : 0.f;
      };
      // y_intra: the scores 16 columns j at a time, then their product
      // with dt x (dt folded into the scores, split hi + lo)
      for (int jb = 0; jb <= rt; ++jb) {
        float s[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          uint32_t a[4], b[4];
          c_frag(kk, a);
          ldsm_x4(sB + ((16 * jb + (lane % 8) + 8 * (lane / 16)) * LN +
                        16 * kk + 8 * ((lane / 8) % 2)) * 2, b);
          mma_16816(s[0], a, b[0], b[1]);
          mma_16816(s[1], a, b[2], b[3]);
        }
        // score tiles t = 0, 1 (columns +0 / +8) make the A fragment of
        // k-step jb: register 2 t + hf holds row r + 8 hf
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = i0 + r + 8 * hf;
            const int j = 16 * jb + 8 * t + 2 * q;
            split2(masked(s[t][2 * hf], i, j) * dts[j],
                   masked(s[t][2 * hf + 1], i, j + 1) * dts[j + 1],
                   ahi[2 * t + hf], alo[2 * t + hf]);
          }
#pragma unroll
        for (int np = 0; np < kMaxP / 16; ++np) {
          if (np >= npt) break;
          uint32_t b[4];
          ldsm_x4_trans(sX + ((16 * jb + (lane % 8) + 8 * ((lane / 8) % 2)) *
                                  LP + 16 * np + 8 * (lane / 16)) * 2, b);
          mma_16816(yacc[2 * np], ahi, b[0], b[1]);
          mma_16816(yacc[2 * np], alo, b[0], b[1]);
          mma_16816(yacc[2 * np + 1], ahi, b[2], b[3]);
          mma_16816(yacc[2 * np + 1], alo, b[2], b[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < kMaxP / 8; ++n) {
        if (n >= P / 8) break;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const size_t row = (t0 + i0 + r + 8 * hf) * H + h;
          *reinterpret_cast<float2*>(y + row * P + 8 * n + 2 * q) =
              make_float2(yacc[n][2 * hf], yacc[n][2 * hf + 1]);
        }
      }
    }

    // ---- State^T <- e^{last} State^T + x^T (rnd(B o dte) dt), this
    // warp's 16 columns n: B as the col operand (ldmatrix.trans of B [t][n]),
    // decayed, rounded, times dt, split hi + mid + lo (the state is carried
    // to the output, so all 24 bits: a state off by 2^-17 would tip the
    // final bf16 rounding of many more entries than float32 sums do); x^T
    // as the row operand (ldmatrix.trans of x [t][p]), exact in bf16
    const float decay = expf(cum[c - 1]);
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[u][j][e] *= decay;
    for (int kt = 0; kt < nrt; ++kt) {
      uint32_t b[4], bhi[4], bmid[4], blo[4];
      ldsm_x4_trans(sB + ((16 * kt + (lane % 8) + 8 * ((lane / 8) % 2)) * LN +
                          16 * nb + 8 * (lane / 16)) * 2, b);
      // register m holds t = 16 kt + 2 q (+ 8 for m odd) and t + 1
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int t = 16 * kt + 2 * q + 8 * (m % 2);
        const float2 v = unpack2(b[m]);
        split3(round_bf(v.x * dte[t]) * dts[t],
               round_bf(v.y * dte[t + 1]) * dts[t + 1], bhi[m], bmid[m],
               blo[m]);
      }
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        if (unit_pt(u) >= npt) break;
        uint32_t a[4];
        ldsm_x4_trans(sX + ((16 * kt + (lane % 8) + 8 * (lane / 16)) * LP +
                            16 * unit_pt(u) + 8 * ((lane / 8) % 2)) * 2, a);
        mma_16816(st[u][0], a, bhi[0], bhi[1]);
        mma_16816(st[u][0], a, bmid[0], bmid[1]);
        mma_16816(st[u][0], a, blo[0], blo[1]);
        mma_16816(st[u][1], a, bhi[2], bhi[3]);
        mma_16816(st[u][1], a, bmid[2], bmid[3]);
        mma_16816(st[u][1], a, blo[2], blo[3]);
      }
    }
    // every warp is done reading the state's bf16 copy and the slot
    __syncthreads();
    store_state();
    if (STAGES == 1 && k + 1 < n_chunks) fetch_chunk(k + 1);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    if (unit_pt(u) >= npt) break;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = 16 * unit_pt(u) + r + 8 * hf;
        const int n = 16 * nb + 8 * j + 2 * q;
        *reinterpret_cast<uint32_t*>(
            fin + (((size_t)bi * H + h) * P + p) * N + n) =
            pack2(st[u][j][2 * hf], st[u][j][2 * hf + 1]);
      }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int N, int STAGES>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* init, void* y, void* fin, int b, int S,
           int H, int G, int P, int c, cudaStream_t stream) {
  // opt in once, for the largest chunk and head width (before any CUDA
  // graph capture: the first launch of each instantiation runs eagerly)
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_mma_bf16_kernel<N, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxC, N, kMaxP, STAGES));
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  ssd_mma_bf16_kernel<N, STAGES>
      <<<dim3(H, b), kThreads, smem_bytes(c, N, P, STAGES), stream>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const float*>(dt), static_cast<const float*>(A),
          static_cast<const __nv_bfloat16*>(B),
          static_cast<const __nv_bfloat16*>(C),
          static_cast<const __nv_bfloat16*>(init), static_cast<float*>(y),
          static_cast<__nv_bfloat16*>(fin), S, H, G, P, c);
  return (int)cudaGetLastError();
}

// two ring slots while the (b, h) blocks fit one a SM, else one slot and
// two blocks a SM (measured: PERF.md section 7)
template <int N>
int launch_stages(const void* x, const void* dt, const void* A,
                  const void* B, const void* C, const void* init, void* y,
                  void* fin, int b, int S, int H, int G, int P, int c,
                  cudaStream_t s) {
  if ((long long)b * H <= sm_count())
    return launch<N, 2>(x, dt, A, B, C, init, y, fin, b, S, H, G, P, c, s);
  return launch<N, 1>(x, dt, A, B, C, init, y, fin, b, S, H, G, P, c, s);
}

}  // namespace tc

// dtype: 0 float32, 1 bfloat16 (x, B, C, init, fin).  float32 runs on the
// CUDA cores (P % 32 == 0, c <= 128 and c % 8 == 0, N <= 128 and N % 8 ==
// 0), bfloat16 on the tensor cores (c and P multiples of 16, c <= 128, P <=
// 64, N one of 16, 32, 64, 128); both need S % c == 0 and H % G == 0.
// Returns a cudaError_t code (cudaErrorInvalidValue for a shape the
// kernel of that dtype does not take).
extern "C" int ssd_scan_fwd(int dtype, const void* x, const void* dt,
                            const void* A, const void* B, const void* C,
                            const void* init, void* y, void* fin, int b,
                            int S, int H, int G, int N, int P, int c,
                            void* stream) {
  if (c <= 0 || S % c || N <= 0 || P <= 0 || G <= 0 || H % G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (P % simt::kPT || c > simt::kMaxC || c % 8 || N > simt::kMaxN ||
        N % 8)
      return (int)cudaErrorInvalidValue;
    if (b == 0 || S == 0 || H == 0) return 0;
    return simt::launch<float>(x, dt, A, B, C, init, y, fin, b, S, H, G, N,
                               P, c, s);
  }
  if (dtype != 1 || c % 16 || c > tc::kMaxC || P % 16 || P > tc::kMaxP)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || S == 0 || H == 0) return 0;
  switch (N) {
    case 16:
      return tc::launch_stages<16>(x, dt, A, B, C, init, y, fin, b,
                                   S, H, G, P, c, s);
    case 32:
      return tc::launch_stages<32>(x, dt, A, B, C, init, y, fin, b,
                                   S, H, G, P, c, s);
    case 64:
      return tc::launch_stages<64>(x, dt, A, B, C, init, y, fin, b,
                                   S, H, G, P, c, s);
    case 128:
      return tc::launch_stages<128>(x, dt, A, B, C, init, y, fin, b,
                                    S, H, G, P, c, s);
  }
  return (int)cudaErrorInvalidValue;
}
