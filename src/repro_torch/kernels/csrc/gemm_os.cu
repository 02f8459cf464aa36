// Output-stationary GEMM for sm_90a.
//
// Replaces the reference's Pallas TPU kernel src/repro/kernels/gemm_os.py:61
// `gemm_os` (pallas_call at :71, body `_gemm_kernel` at :28):
//     out (M, N) = x (M, K) @ w (K, N)
// with a float32 accumulator that stays resident while K streams through,
// cast to the input type once at the end -- the paper's output-stationary
// dataflow: every output element is written exactly once.
//
// Design.  The TPU kernel walks a grid (M/bm, N/bn, K/bk) with K innermost
// and sequential, the (bm, bn) accumulator in VMEM scratch.  Here one
// thread block owns one (BM x BN) output tile and loops over K itself (the
// sequential grid axis becomes that loop); the blocks run in parallel on
// the 132 SMs.  Each thread keeps an 8 x 8 sub-tile of the accumulator in
// registers for the whole K loop: rows {4 ty .. 4 ty + 3} and the same four
// rows BM/2 further, columns likewise (so a warp's shared-memory reads of w
// fall on distinct banks).  K arrives in bk-deep slabs: the (BM x bk) slab
// of x and the (bk x BN) slab of w are copied into shared memory with
// 16-byte cp.async copies, double-buffered (slab t+1 in flight while slab t
// is consumed) when two slabs fit in the 227 KB a block may hold, one at a
// time otherwise.  Rows of both slabs are padded by 16 bytes.  The products
// are float32 FMAs on the CUDA cores; each thread reads x's rows 8 bytes
// at a time (2 float32 or 4 bf16 k-steps), which keeps it within the 128
// registers that let two 256-thread blocks share a SM.
// Tiles: BM, BN in {64, 128} (BM/8 x BN/8 threads); a 256 x 256 float32
// accumulator (256 KB) would not fit the SM's 64K-register file.
//
// Bound.  2MNK operations against (MK + KN + MN) elements moved: at the
// zamba2-2.7b MLP shapes (4096 tokens, 2560 x 10240 and back, bf16) that is
// 215 GFLOP, 0.22 ms at the bf16 tensor-core peak of 989 TFLOP/s, while the
// 159 MB move in 0.05 ms at 3.35 TB/s: operations bound it.  This first
// design runs on the float32 CUDA cores (67 TFLOP/s, >= 3.2 ms at that
// shape), so it cannot come near the bound; moving the products to
// tensor cores (mma.sync / wgmma fed by TMA) is the redesign's work.
// PERF.md has the times on the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTM = 8, kTN = 8;         // outputs per thread (registers)
constexpr int kPadBytes = 16;           // row padding of the shared slabs
constexpr size_t kMaxSmem = 232448;     // dynamic shared memory a block

// 4 consecutive values at p, as floats (16-byte or 8-byte aligned)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
// 8 bytes of consecutive values at p (8-byte aligned), as floats: 2
// float32 or 4 bf16
__device__ __forceinline__ void load8b(const float* p, float* v) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void load8b(const __nv_bfloat16* p, float* v) {
  load4(p, v);
}

// 4 floats to 4 consecutive outputs of type T (round to nearest even)
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int BM, int BN>
size_t smem_bytes(int bk, int stages) {
  constexpr int pad = kPadBytes / sizeof(T);
  return (size_t)stages *
         ((size_t)BM * (bk + pad) + (size_t)bk * (BN + pad)) * sizeof(T);
}

// x (M, K), w (K, N), out (M, N), all row-major T; grid (N/BN, M/BM),
// BM/8 x BN/8 threads, smem_bytes<T, BM, BN>(bk, stages) dynamic; at
// most 128 registers a thread, so two 256-thread blocks share a SM.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__((BM / kTM) * (BN / kTN), 2)
gemm_os_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int N, int K, int bk, int stages) {
  constexpr int TX = BN / kTN, NT = (BM / kTM) * TX;
  constexpr int E = 16 / sizeof(T);             // elements a 16-byte copy
  constexpr int KA = 8 / sizeof(T);             // k-steps an 8-byte x read
  constexpr int PAD = kPadBytes / sizeof(T);
  constexpr int ldb = BN + PAD;                 // w slab row stride
  const int lda = bk + PAD;                     // x slab row stride
  const int stage = BM * lda + bk * ldb;        // elements a slab pair
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T* xb = x + (size_t)m0 * K;
  const T* wb = w + n0;
  const int n_k = K / bk;

  // slab t of x and w into buffer s: neighbouring threads copy
  // neighbouring 16-byte chunks of a row
  auto load_slab = [&](int t, int s) {
    T* As = smem + (size_t)s * stage;
    T* Bs = As + BM * lda;
    const int k0 = t * bk;
    const int a_cpr = bk / E;
    for (int c = tid; c < BM * a_cpr; c += NT) {
      const int r = c / a_cpr, col = (c - r * a_cpr) * E;
      cp_async16(As + r * lda + col, xb + (size_t)r * K + k0 + col);
    }
    constexpr int b_cpr = BN / E;
    for (int c = tid; c < bk * b_cpr; c += NT) {
      const int r = c / b_cpr, col = (c - r * b_cpr) * E;
      cp_async16(Bs + r * ldb + col, wb + (size_t)(k0 + r) * N + col);
    }
    cp_async_commit();
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  load_slab(0, 0);
  for (int t = 0; t < n_k; ++t) {
    const int s = stages == 2 ? (t & 1) : 0;
    if (stages == 2 && t + 1 < n_k) {
      load_slab(t + 1, s ^ 1);       // its buffer was read in step t - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* As = smem + (size_t)s * stage;
    const T* Bs = As + BM * lda;
#pragma unroll 1
    for (int k = 0; k < bk; k += KA) {
      float a[kTM][KA];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int row = (i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3);
        load8b(As + row * lda + k, a[i]);
      }
#pragma unroll
      for (int kk = 0; kk < KA; ++kk) {
        float b[kTN];
        const T* brow = Bs + (k + kk) * ldb + tx * 4;
        load4(brow, b);
        load4(brow + BN / 2, b + 4);
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
    __syncthreads();                 // the next copy overwrites the slab
    if (stages == 1 && t + 1 < n_k) load_slab(t + 1, 0);
  }

  // the accumulator leaves the registers once, cast to T
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + (i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3);
    T* o = out + (size_t)row * N + n0 + tx * 4;
    store4(o, acc[i]);
    store4(o + BN / 2, acc[i] + 4);
  }
}

template <typename T, int BM, int BN>
int launch(const void* x, const void* w, void* out, int M, int N, int K,
           int bk, int stages, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, BM, BN>(bk, stages);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_os_kernel<T, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / BN, M / BM);
  gemm_os_kernel<T, BM, BN><<<grid, (BM / kTM) * (BN / kTN), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), N, K, bk, stages);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, int M, int N, int K,
             int bm, int bn, int bk, int stages, cudaStream_t s) {
  if (bm == 64 && bn == 64)
    return launch<T, 64, 64>(x, w, out, M, N, K, bk, stages, s);
  if (bm == 64 && bn == 128)
    return launch<T, 64, 128>(x, w, out, M, N, K, bk, stages, s);
  if (bm == 128 && bn == 64)
    return launch<T, 128, 64>(x, w, out, M, N, K, bk, stages, s);
  if (bm == 128 && bn == 128)
    return launch<T, 128, 128>(x, w, out, M, N, K, bk, stages, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w and out share it).  bm, bn in {64,
// 128} dividing M and N; bk a multiple of 16 dividing K; stages 1 or 2.
// x, w, out 16-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int gemm_os(int dtype, const void* x, const void* w, void* out,
                       int M, int N, int K, int bm, int bn, int bk,
                       int stages, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      bk % 16 || M % bm ||
      N % bn || K % bk || (stages != 1 && stages != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, w, out, M, N, K, bm, bn, bk, stages, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, out, M, N, K, bm, bn, bk, stages,
                                   s);
  return (int)cudaErrorInvalidValue;
}
