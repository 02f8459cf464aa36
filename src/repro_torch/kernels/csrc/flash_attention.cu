// Flash attention forward for Hopper (sm_90a): causal / sliding-window GQA
// with an online softmax.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (pl.pallas_call at
// src/repro/kernels/flash_attention.py:109, `flash_attention_fwd`).  It
// computes what that kernel computes: s = (q k^T) * scale in f32, masked
// with the finite -1e30 (k_pos < T; causal q_pos >= k_pos; window
// q_pos - k_pos < window), running max m, denominator l and accumulator
// acc in f32, p = exp(s - m_new) summed into l unrounded and rounded to
// v's dtype before the PV product, l clamped at 1e-30, output cast to q's
// dtype.  Query head h reads kv head h / G (GQA, no K/V repeat).
//
// What bounds it on an H100: operations.  At the training shape (B 8, H 9,
// K 3, S = T = 1024, d 64, causal) it does 4 d B H S(S+1)/2 = 9.7 GFLOP
// against 25 MB of traffic; the tensor-core floor is 0.0098 ms.
//
// Design (simple first, not yet fast): the TPU grid walks kv blocks in
// order on one core and carries m/l/acc in VMEM scratch between grid steps;
// CUDA thread blocks cannot carry state, so one thread block of 128 threads
// owns one (b, h, 64-row query tile) and loops over the 64-row kv tiles
// that intersect its causal / window band (the Pallas `block_live` test:
// tiles outside the band are skipped whole, so the work is the banded
// count).  Q, K, V and P tiles sit in shared memory as f32; each thread owns
// a 4 x 8 block of the score tile and a 4 x d/8 block of the accumulator,
// with 16-byte shared-memory loads in both products; m, l and acc stay in
// registers.  Products are f32 FMAs on the CUDA cores (no mma / wgmma, no
// TMA): a later PR moves them to the tensor cores.  Ragged S and T are
// masked in the kernel (no padding copies); inputs may be strided
// (B, S, H, d) views seen as (B, H, S, d), last dimension contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int BQ = 64;          // query rows per thread block
constexpr int BK = 64;          // kv rows per tile
constexpr float kNegInf = -1e30f;

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

// x rounded to T's precision, kept as f32 (p's cast to v's dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int H, K, S, T, causal, window;
  float scale;
};

template <int D>
constexpr int smem_floats() {
  // Q, K, V tiles with rows padded to D + 4 (16-byte aligned rows, and the
  // 8 rows one quarter-warp reads land on distinct banks), P padded too
  return BQ * (D + 4) + 2 * BK * (D + 4) + BQ * (BK + 4);
}

template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int n_rows) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int pos = row0 + r;
    dst[r * (D + 4) + d] =
        pos < n_rows ? to_float(src[(long long)pos * row_stride + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  static_assert(D % 32 == 0 && BQ == BK, "tile shapes");
  constexpr int LD = D + 4;
  constexpr int LP = BK + 4;
  constexpr int DV = D / 32;      // float4 chunks of the accumulator row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int q0 = qt * BQ;
  const T* q = (const T*)a.q + b * a.q_sb + h * a.q_sh;
  const T* k = (const T*)a.k + b * a.k_sb + kh * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + kh * a.v_sh;
  T* o = (T*)a.o + b * a.o_sb + h * a.o_sh;

  const int tr = threadIdx.x / 8;   // rows tr*4 .. tr*4+3
  const int tc = threadIdx.x % 8;   // score cols tc + 8j; acc chunks tc + 8jj

  load_tile<T, D>(Qs, q, a.q_ss, q0, a.S);

  float m[4], l[4], acc[4][DV * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DV * 4; ++j) acc[i][j] = 0.f;
  }

  // kv tiles intersecting the band of rows [q0, q_last]
  const int n_kv = (a.T + BK - 1) / BK;
  const int q_last = min(q0 + BQ, a.S) - 1;
  int kt_end = n_kv, kt_begin = 0;
  if (a.causal) {
    kt_end = min(n_kv, q_last / BK + 1);
    if (a.window > 0) kt_begin = max(0, q0 - a.window + 1) / BK;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();               // previous tile's K/V/P reads are done
    load_tile<T, D>(Ks, k, a.k_ss, k0, a.T);
    load_tile<T, D>(Vs, v, a.v_ss, k0, a.T);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(tr * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&Ks[(tc + 8 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + tr * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k_pos = k0 + tc + 8 * j;
        bool ok = k_pos < a.T;
        if (a.causal) {
          ok = ok && q_pos >= k_pos;
          if (a.window > 0) ok = ok && (q_pos - k_pos) < a.window;
        }
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // a row's 64 scores live on 8 neighbouring lanes
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(tr * 4 + i) * LP + tc + 8 * j] = round_to<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DV * 4; ++j) acc[i][j] *= corr;
    }
    __syncthreads();               // P tile complete

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(tr * 4 + i) * LP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < DV; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(c + cc) * LD + 4 * (tc + 8 * jj)]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y
                            : cc == 2 ? pv[i].z : pv[i].w;
            acc[i][4 * jj + 0] = fmaf(p, vv.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(p, vv.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(p, vv.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(p, vv.w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + tr * 4 + i;
    if (q_pos >= a.S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* row = o + (long long)q_pos * a.o_ss;
#pragma unroll
    for (int jj = 0; jj < DV; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        row[4 * (tc + 8 * jj) + e] = from_float<T>(acc[i][4 * jj + e] / li);
  }
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  // above 48 KB of dynamic shared memory needs the opt-in, once per
  // instantiation (so never inside a CUDA-graph capture after a warm-up)
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const Args& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(a, B, s);
    case 64: return launch<T, 64>(a, B, s);
    case 128: return launch<T, 128>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike); D: head dim (32,
// 64 or 128).  q/o: (B, H, S, D), k/v: (B, K, T, D) with element strides
// strides[0..11] = q (b, h, s), k (b, h, t), v (b, h, t), o (b, h, s); the
// last dimension is contiguous.  H % K == 0.
extern "C" int flash_attention_fwd(int dtype, int D, const void* q,
                                   const void* k, const void* v, void* o,
                                   const long long* strides, int B, int H,
                                   int K, int S, int T, int causal,
                                   int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H % K != 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.q_sb = strides[0]; a.q_sh = strides[1]; a.q_ss = strides[2];
  a.k_sb = strides[3]; a.k_sh = strides[4]; a.k_ss = strides[5];
  a.v_sb = strides[6]; a.v_sh = strides[7]; a.v_ss = strides[8];
  a.o_sb = strides[9]; a.o_sh = strides[10]; a.o_ss = strides[11];
  a.H = H; a.K = K; a.S = S; a.T = T;
  a.causal = causal; a.window = window; a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_d<float>(a, B, D, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(a, B, D, s);
  return (int)cudaErrorInvalidValue;
}
