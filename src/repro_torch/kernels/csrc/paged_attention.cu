// Paged-attention decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (`_paged_kernel`, launched by `paged_decode_attention` through
// pl.pallas_call at :189): one-token decode attention straight over the KV
// page pool through a block table, dead pages skipped, online softmax, tanh
// softcap, GQA (G query heads per kv head), and page ids >= P read the int8
// side pool, dequantised in the load as float(q)*scale cast to the pool
// dtype.
//
// What bounds it on an H100: bytes.  Per step it reads each live K/V page of
// each session once (2 * page * hd elements per kv head) and does ~4 flops
// per element read -- far below the ~295 flop/byte where the tensor cores
// would become the limit -- so the floor is (bytes read) / 3.35 TB/s.
//
// Simple design: one thread block per (session, kv head).  The page loop
// runs inside the block (it replaces the TPU's sequential grid axis and its
// VMEM m/l/acc scratch); the block reads its own page ids from the block
// table (it replaces scalar prefetch).  Each live page's (page, hd) K and V
// tiles are staged in shared memory as float, the G x page scores and the
// softmax statistics live in shared memory, and each thread keeps a few of
// the G x hd output accumulators in registers.  A dead page costs neither a
// load nor a flop, so the bytes read scale with the rows a session holds.
// Not yet done (later work): cp.async/TMA double buffering of the next page,
// more than one block per session for long caches (split-K), vector loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite: a fully masked row stays finite
constexpr int kThreads = 128;
constexpr int kMaxAcc = 8;         // G * hd <= kMaxAcc * kThreads

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

// Round to T's precision and back: the reference's casts to the pool dtype.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int8_t* __restrict__ kq,
    const int8_t* __restrict__ vq, const float* __restrict__ ks,
    const float* __restrict__ vs, const int32_t* __restrict__ page_map,
    T* __restrict__ out, int K, int G, int hd, int page, int pp, int P, int C,
    int cache_index, int window, float scale, float softcap) {
  const int b = blockIdx.x / K;
  const int kh = blockIdx.x % K;
  const int tid = threadIdx.x;
  const int hdp = hd + 1;  // padded K rows: the score loop reads them by row
  const int H = K * G;

  extern __shared__ float smem[];
  float* q_s = smem;                // G * hd
  float* k_s = q_s + G * hd;        // page * hdp
  float* v_s = k_s + page * hdp;    // page * hd
  float* p_s = v_s + page * hd;     // G * page   scores, then probabilities
  float* m_s = p_s + G * page;      // G          running max
  float* l_s = m_s + G;             // G          running denominator
  float* c_s = l_s + G;             // G          this page's correction

  const size_t q_off = ((size_t)b * H + (size_t)kh * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) q_s[i] = to_float(q[q_off + i]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) acc[a] = 0.f;
  __syncthreads();

  for (int j = 0; j < pp; ++j) {
    const int base = j * page;
    // page visibility (block-uniform): any row <= cache_index and, with a
    // sliding window, any row inside the band
    bool live = base <= cache_index;
    if (window > 0) live = live && (base + page - 1) > cache_index - window;
    if (!live) continue;
    const int pid = page_map[(size_t)b * pp + j];
    if (C > 0 && pid >= P) {
      // fused codec decode: int8 side-pool frame, one scale per frame
      const int ci = min(max(pid - P, 0), C - 1);
      const float sk = ks[ci], sv = vs[ci];
      for (int i = tid; i < page * hd; i += kThreads) {
        const int r = i / hd, d = i - r * hd;
        const size_t off = (((size_t)ci * page + r) * K + kh) * hd + d;
        k_s[r * hdp + d] = round_to<T>((float)kq[off] * sk);
        v_s[r * hd + d] = round_to<T>((float)vq[off] * sv);
      }
    } else {
      const int rp = min(max(pid, 0), P - 1);
      for (int i = tid; i < page * hd; i += kThreads) {
        const int r = i / hd, d = i - r * hd;
        const size_t off = (((size_t)rp * page + r) * K + kh) * hd + d;
        k_s[r * hdp + d] = to_float(k_pool[off]);
        v_s[r * hd + d] = to_float(v_pool[off]);
      }
    }
    __syncthreads();

    for (int i = tid; i < G * page; i += kThreads) {
      const int g = i / page, r = i - g * page;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += q_s[g * hd + d] * k_s[r * hdp + d];
      s *= scale;
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      const int pos = base + r;
      bool valid = pos <= cache_index;
      if (window > 0) valid = valid && pos > cache_index - window;
      p_s[i] = valid ? s : kNegInf;
    }
    __syncthreads();

    for (int g = tid; g < G; g += kThreads) {
      float mx = m_s[g];
      for (int r = 0; r < page; ++r) mx = fmaxf(mx, p_s[g * page + r]);
      float sum = 0.f;
      for (int r = 0; r < page; ++r) {
        const float p = expf(p_s[g * page + r] - mx);
        p_s[g * page + r] = p;
        sum += p;
      }
      const float corr = expf(m_s[g] - mx);
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = mx;
      c_s[g] = corr;
    }
    __syncthreads();

    // PV: p is cast to the pool dtype before the product, as the reference
#pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) {
      const int i = tid + a * kThreads;
      if (i < G * hd) {
        const int g = i / hd, d = i - g * hd;
        float pv = 0.f;
        for (int r = 0; r < page; ++r)
          pv += round_to<T>(p_s[g * page + r]) * v_s[r * hd + d];
        acc[a] = acc[a] * c_s[g] + pv;
      }
    }
    __syncthreads();  // the next page overwrites the tiles
  }

#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    const int i = tid + a * kThreads;
    if (i < G * hd) {
      const float l = fmaxf(l_s[i / hd], 1e-30f);
      out[q_off + i] = from_float<T>(acc[a] / l);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* kq, const void* vq, const void* ks, const void* vs,
           const void* page_map, void* out, int B, int K, int G, int hd,
           int page, int pp, int P, int C, int cache_index, int window,
           float scale, float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)G * hd + (size_t)page * (hd + 1) +
                                       (size_t)page * hd + (size_t)G * page +
                                       3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_decode_kernel<T><<<B * K, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, (const int8_t*)kq,
      (const int8_t*)vq, (const float*)ks, (const float*)vs,
      (const int32_t*)page_map, (T*)out, K, G, hd, page, pp, P, C,
      cache_index, window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, pools and out share it).  C == 0: no
// side pool (kq/vq/ks/vs unused).  Returns cudaGetLastError() after launch.
extern "C" int paged_decode_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* kq, const void* vq, const void* ks, const void* vs,
    const void* page_map, void* out, int B, int K, int G, int hd, int page,
    int pp, int P, int C, int cache_index, int window, float scale,
    float softcap, void* stream) {
  if (G * hd > kMaxAcc * kThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, kq, vq, ks, vs, page_map, out, B,
                         K, G, hd, page, pp, P, C, cache_index, window, scale,
                         softcap, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, kq, vq, ks, vs, page_map,
                                 out, B, K, G, hd, page, pp, P, C, cache_index,
                                 window, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
