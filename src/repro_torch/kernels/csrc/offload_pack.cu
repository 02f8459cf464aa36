// int8 spill codec for Hopper (sm_90a): blockwise pack and the shared unpack.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/offload_pack.py:
//   * int8_pack   (`_int8_pack_kernel`, pl.pallas_call at :110): per row
//     block absmax, scale = max(absmax/127, 1e-30),
//     q = clip(round_half_even(x/scale), +-127);
//   * int8_unpack = fp8_unpack (`_unpack_kernel`, pl.pallas_call at :86):
//     (q * scale) cast to the output dtype.
// Both must be bit-exact against their plain versions: the division stays
// IEEE x/scale (no fast math), rounding is rintf (half to even, like
// jnp.round) and the bf16 cast is round-to-nearest-even.
//
// What bounds them on an H100: bytes.  A pack reads the tensor once for the
// absmax and once to quantise (2 or 4 bytes an element each time) and writes
// one byte an element; an unpack reads one byte and writes 2 or 4.  One or
// two flops per element, so the floor is the bytes moved / 3.35 TB/s.
//
// Simple design: the pack runs one thread block per row block (on the
// serving path a row block is a whole page leaf, e.g. 1440 x 64 at full
// width: one block strides over all of it), reduces the absmax through warp
// shuffles and shared memory, writes the scale once, then sweeps again to
// quantise; the second sweep mostly hits L1/L2.  The unpack is a grid-stride
// elementwise loop.  Not yet done (later work): 16-byte vector loads and
// splitting one large row block over several thread blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPackThreads = 1024;
constexpr int kUnpackThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kPackThreads)
    int8_pack_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scales, long long block_elems) {
  const T* xb = x + (size_t)blockIdx.x * block_elems;
  int8_t* qb = q + (size_t)blockIdx.x * block_elems;
  __shared__ float warp_max[kPackThreads / 32];
  __shared__ float block_scale;

  float m = 0.f;
  for (long long i = threadIdx.x; i < block_elems; i += kPackThreads)
    m = fmaxf(m, fabsf(to_float(xb[i])));
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kPackThreads / 32 ? warp_max[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) {
      const float s = fmaxf(m / 127.0f, 1e-30f);
      block_scale = s;
      scales[blockIdx.x] = s;
    }
  }
  __syncthreads();
  const float s = block_scale;
  for (long long i = threadIdx.x; i < block_elems; i += kPackThreads) {
    const float v = fminf(fmaxf(rintf(to_float(xb[i]) / s), -127.f), 127.f);
    qb[i] = (int8_t)v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kUnpackThreads)
    int8_unpack_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ scales, T* __restrict__ out,
                       long long n, long long block_elems) {
  const long long stride = (long long)gridDim.x * kUnpackThreads;
  for (long long i = (long long)blockIdx.x * kUnpackThreads + threadIdx.x;
       i < n; i += stride)
    out[i] = from_float<T>((float)q[i] * scales[i / block_elems]);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (of x).  x: (rows, cols) row-major;
// rows % block_rows == 0; q: int8 (rows, cols); scales: f32 (rows/block_rows).
extern "C" int int8_pack(int dtype, const void* x, void* q, void* scales,
                         long long rows, long long cols, long long block_rows,
                         void* stream) {
  const int nb = (int)(rows / block_rows);
  const long long block_elems = block_rows * cols;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    int8_pack_kernel<float><<<nb, kPackThreads, 0, s>>>(
        (const float*)x, (int8_t*)q, (float*)scales, block_elems);
  else if (dtype == 1)
    int8_pack_kernel<__nv_bfloat16><<<nb, kPackThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (int8_t*)q, (float*)scales, block_elems);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16 (of out).
extern "C" int int8_unpack(int dtype, const void* q, const void* scales,
                           void* out, long long rows, long long cols,
                           long long block_rows, void* stream) {
  const long long n = rows * cols;
  long long blocks = (n + kUnpackThreads - 1) / kUnpackThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    int8_unpack_kernel<float><<<(int)blocks, kUnpackThreads, 0, s>>>(
        (const int8_t*)q, (const float*)scales, (float*)out, n,
        block_rows * cols);
  else if (dtype == 1)
    int8_unpack_kernel<__nv_bfloat16><<<(int)blocks, kUnpackThreads, 0, s>>>(
        (const int8_t*)q, (const float*)scales, (__nv_bfloat16*)out, n,
        block_rows * cols);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
