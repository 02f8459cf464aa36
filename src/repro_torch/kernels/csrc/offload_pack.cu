// Stash / spill codec kernels for Hopper (sm_90a): blockwise pack with
// three quantisers and the shared unpack.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/offload_pack.py:
//   * fp8_pack    (`_pack_kernel`, pl.pallas_call at :63): per row block
//     absmax, scale = max(absmax/448, 1e-12), q = float8_e4m3fn(x/scale);
//   * int8_pack   (`_int8_pack_kernel`, pl.pallas_call at :110):
//     scale = max(absmax/127, 1e-30), q = clip(round_half_even(x/scale),
//     +-127);
//   * blocksparse_pack (`_blocksparse_pack_kernel`, pl.pallas_call at :143):
//     the int8 pack, with entries |x| < absmax/32 set to exact zeros;
//   * fp8_unpack = int8_unpack = blocksparse_unpack (`_unpack_kernel`,
//     pl.pallas_call at :86): (q * scale) cast to the output dtype, for
//     int8 and float8_e4m3fn payloads.
// All must be bit-exact against their plain versions: the division stays
// IEEE x/scale (no fast math), int8 rounding is rintf (half to even, like
// jnp.round), the fp8 cast is cvt.rn.satfinite (round to nearest even; the
// codec keeps |x/scale| <= 448 up to one ulp, which rounds to 448 as the
// reference's cast does) and the bf16 cast is round-to-nearest-even.
//
// What bounds them on an H100: bytes.  A pack reads the tensor once for the
// absmax and once to quantise (2 or 4 bytes an element each time) and writes
// one byte an element; an unpack reads one byte and writes 2 or 4.  A few
// operations per element, so the floor is the bytes moved / 3.35 TB/s.
//
// Design: a row block can be one whole stashed activation (8192 x 576 on
// the training path), so a pack spreads every row block over many thread
// blocks.  Pass 1 reduces per-thread-block partial absmaxes through warp
// shuffles and shared memory and folds them into the row block's absmax
// with atomicMax on the bits of the non-negative float (a max is exact in
// any order, so the result does not depend on the schedule).  Pass 2 has
// every thread block derive the one scale from that absmax and quantise its
// slice.  The unpack is a grid-stride elementwise loop.  Not yet done
// (later work): 16-byte vector loads, fusing the two passes.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kElemsPerBlock = 16384;   // pack slice per thread block
constexpr int kMaxSlices = 1024;              // thread blocks per row block

enum Quant { kInt8 = 0, kFp8 = 1, kBlocksparse = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// scale from a row block's absmax, as the reference's kernels compute it
template <int Q>
__device__ __forceinline__ float scale_of(float absmax) {
  return Q == kFp8 ? fmaxf(absmax / 448.0f, 1e-12f)
                   : fmaxf(absmax / 127.0f, 1e-30f);
}

template <int Q>
struct Payload { using type = int8_t; };
template <>
struct Payload<kFp8> { using type = uint8_t; };   // float8_e4m3fn bits

template <int Q>
__device__ __forceinline__ typename Payload<Q>::type quantise(
    float v, float s, float absmax) {
  if constexpr (Q == kFp8) {
    return (uint8_t)__nv_cvt_float_to_fp8(v / s, __NV_SATFINITE, __NV_E4M3);
  } else {
    const float r = fminf(fmaxf(rintf(v / s), -127.f), 127.f);
    if constexpr (Q == kBlocksparse) {
      if (!(fabsf(v) >= absmax / 32.0f)) return (int8_t)0;
    }
    return (int8_t)r;
  }
}

// slice [lo, hi) of row block blockIdx.y handled by thread block blockIdx.x
__device__ __forceinline__ void slice_of(long long block_elems,
                                         long long& lo, long long& hi) {
  const long long per = (block_elems + gridDim.x - 1) / gridDim.x;
  lo = (long long)blockIdx.x * per;
  hi = lo + per < block_elems ? lo + per : block_elems;
}

// pass 1: absmax of each row block, folded over its thread blocks
template <typename T>
__global__ void __launch_bounds__(kThreads)
    absmax_kernel(const T* __restrict__ x, unsigned int* __restrict__ amax,
                  long long block_elems) {
  const T* xb = x + (size_t)blockIdx.y * block_elems;
  long long lo, hi;
  slice_of(block_elems, lo, hi);
  __shared__ float warp_max[kThreads / 32];
  float m = 0.f;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
    m = fmaxf(m, fabsf(to_float(xb[i])));
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    // non-negative floats order as their bit patterns
    if (threadIdx.x == 0) atomicMax(amax + blockIdx.y, __float_as_uint(m));
  }
}

// pass 2: every thread block quantises its slice with the row block's scale
template <typename T, int Q>
__global__ void __launch_bounds__(kThreads)
    quantise_kernel(const T* __restrict__ x,
                    typename Payload<Q>::type* __restrict__ q,
                    const unsigned int* __restrict__ amax,
                    float* __restrict__ scales, long long block_elems) {
  const size_t base = (size_t)blockIdx.y * block_elems;
  const float absmax = __uint_as_float(amax[blockIdx.y]);
  const float s = scale_of<Q>(absmax);
  if (blockIdx.x == 0 && threadIdx.x == 0) scales[blockIdx.y] = s;
  long long lo, hi;
  slice_of(block_elems, lo, hi);
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
    q[base + i] = quantise<Q>(to_float(x[base + i]), s, absmax);
}

template <typename Tin, typename T>
__global__ void __launch_bounds__(kThreads)
    unpack_kernel(const Tin* __restrict__ q, const float* __restrict__ scales,
                  T* __restrict__ out, long long n, long long block_elems) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    out[i] = from_float<T>(to_float(q[i]) * scales[i / block_elems]);
}

template <typename T, int Q>
void launch_pack(const void* x, void* q, void* scales, void* amax, int nb,
                 long long block_elems, cudaStream_t s) {
  long long slices = (block_elems + kElemsPerBlock - 1) / kElemsPerBlock;
  if (slices > kMaxSlices) slices = kMaxSlices;
  const dim3 grid((unsigned)slices, (unsigned)nb);
  absmax_kernel<T><<<grid, kThreads, 0, s>>>(
      (const T*)x, (unsigned int*)amax, block_elems);
  quantise_kernel<T, Q><<<grid, kThreads, 0, s>>>(
      (const T*)x, (typename Payload<Q>::type*)q, (const unsigned int*)amax,
      (float*)scales, block_elems);
}

template <int Q>
int pack(int dtype, const void* x, void* q, void* scales, void* amax,
         long long rows, long long cols, long long block_rows, void* stream) {
  const int nb = (int)(rows / block_rows);
  const long long block_elems = block_rows * cols;
  cudaStream_t s = (cudaStream_t)stream;
  if (nb > 65535) return (int)cudaErrorInvalidValue;     // grid.y limit
  cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(unsigned int) * nb, s);
  if (e != cudaSuccess) return (int)e;
  if (dtype == 0)
    launch_pack<float, Q>(x, q, scales, amax, nb, block_elems, s);
  else if (dtype == 1)
    launch_pack<__nv_bfloat16, Q>(x, q, scales, amax, nb, block_elems, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename Tin>
void launch_unpack(int dtype, const void* q, const void* scales, void* out,
                   long long n, long long block_elems, cudaStream_t s) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (dtype == 0)
    unpack_kernel<Tin, float><<<(int)blocks, kThreads, 0, s>>>(
        (const Tin*)q, (const float*)scales, (float*)out, n, block_elems);
  else
    unpack_kernel<Tin, __nv_bfloat16><<<(int)blocks, kThreads, 0, s>>>(
        (const Tin*)q, (const float*)scales, (__nv_bfloat16*)out, n,
        block_elems);
}

}  // namespace

// Packs.  dtype: 0 float32, 1 bfloat16 (of x).  x: (rows, cols) row-major;
// rows % block_rows == 0; q: int8 or fp8 bytes (rows, cols); scales: f32
// (rows / block_rows); amax: scratch of rows / block_rows 32-bit words.
extern "C" int int8_pack(int dtype, const void* x, void* q, void* scales,
                         void* amax, long long rows, long long cols,
                         long long block_rows, void* stream) {
  return pack<kInt8>(dtype, x, q, scales, amax, rows, cols, block_rows,
                     stream);
}

extern "C" int fp8_pack(int dtype, const void* x, void* q, void* scales,
                        void* amax, long long rows, long long cols,
                        long long block_rows, void* stream) {
  return pack<kFp8>(dtype, x, q, scales, amax, rows, cols, block_rows,
                    stream);
}

extern "C" int blocksparse_pack(int dtype, const void* x, void* q,
                                void* scales, void* amax, long long rows,
                                long long cols, long long block_rows,
                                void* stream) {
  return pack<kBlocksparse>(dtype, x, q, scales, amax, rows, cols,
                            block_rows, stream);
}

// The shared unpack.  payload: 0 int8, 1 float8_e4m3fn; dtype: 0 float32,
// 1 bfloat16 (of out).
extern "C" int unpack(int payload, int dtype, const void* q,
                      const void* scales, void* out, long long rows,
                      long long cols, long long block_rows, void* stream) {
  const long long n = rows * cols;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (payload == 0)
    launch_unpack<int8_t>(dtype, q, scales, out, n, block_rows * cols, s);
  else if (payload == 1)
    launch_unpack<__nv_fp8_e4m3>(dtype, q, scales, out, n, block_rows * cols,
                                 s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
