// Mamba2 SSD chunked scan, forward, for sm_90a.
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
// follows ssd_chunked: the masked scores, the decayed B and C and the
// state where it meets C are rounded to the input type T, as is the
// inter-chunk product; y is float32, the final state T.
//
// Design.  The TPU kernel walks a grid (b*h, chunk) in order with the
// state in VMEM scratch.  Here one 256-thread block owns a (P-tile of 32
// columns, head, batch) triple and loops over the chunks itself: columns
// of P are independent (y[:, p] and state row p read only x[:, p]), so
// splitting P spreads the work (b*H*P/32 blocks: 512 at 8 x 32 heads, 64
// at one sequence) at the price of loading B / C and computing the (c x c)
// score tile once per P-tile.  Per chunk everything lives in dynamic
// shared memory as float32 (c = N = 128: B^T and C^T 64 KB each, the score
// tile 64 KB, x dt and the state 16 KB each; 226 KB, one block per SM);
// global loads move 16 bytes a thread.  Products are float32 FMAs on the
// CUDA cores from 8 x 8 register tiles.
//
// Bound.  Per (b, h) and chunk the causal work is c(c+1)(N+P) + 4cPN
// operations: 15 GFLOP a launch at the training shape (8 x 1024 tokens, 32
// heads, P 64, N 128), 0.015 ms at the bf16 tensor-core peak; the bytes
// (x, dt, B, C in; y in float32 and the final state out, 110 MB) take
// 0.033 ms at 3.35 TB/s, so the bytes bound it.  This kernel does its
// products as float32 FMAs on the CUDA cores with one block per SM and
// computes the scores once per P-tile: ~1.5 ms at that shape on an H100
// 80GB HBM3 at 700 W (chip_smoke.py; PERF.md has the current reading).
// Tensor-core products (mma.sync / wgmma) are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kPT = 32;      // P columns per block
constexpr int kMaxC = 128;   // chunk rows (score tile side)
constexpr int kMaxN = 128;   // state size

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
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
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
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
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
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
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxC, kMaxN));
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const size_t smem = smem_bytes(c, N);
  dim3 grid(P / kPT, H, b);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const T*>(init),
      static_cast<float*>(y), static_cast<T*>(fin), S, H, G, N, P, c);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C, init, fin).  Shapes as the kernel
// above; the caller checks P % 16 == 0, c <= 128 and c % 8 == 0, S % c ==
// 0, N <= 128 and N % 8 == 0, H % G == 0.  Returns a cudaError_t code
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int ssd_scan_fwd(int dtype, const void* x, const void* dt,
                            const void* A, const void* B, const void* C,
                            const void* init, void* y, void* fin, int b,
                            int S, int H, int G, int N, int P, int c,
                            void* stream) {
  if (P % kPT || c > kMaxC || c % 8 || c <= 0 || S % c || N > kMaxN ||
      N % 8 || N <= 0 || G <= 0 || H % G)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || S == 0 || H == 0 || P == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, B, C, init, y, fin, b, S, H, G, N, P, c,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, B, C, init, y, fin, b, S, H, G,
                                 N, P, c, s);
  return (int)cudaErrorInvalidValue;
}
