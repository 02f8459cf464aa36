// Flash attention forward for Hopper (sm_90a): causal / sliding-window GQA
// with an online softmax; bfloat16 on the tensor cores, float32 on the CUDA
// cores.
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
// Both kernels: the TPU grid walks kv blocks in order on one core and
// carries m/l/acc in VMEM scratch between grid steps; CUDA thread blocks
// cannot carry state, so one thread block of 128 threads owns one (b, h,
// query tile) and loops over the 64-row kv tiles that intersect its
// causal / window band (the Pallas `block_live` test: tiles outside the
// band are skipped whole, so the work is the banded count); m, l and acc
// stay in registers.  Ragged S and T are masked in the kernel (no padding
// copies); inputs may be strided (B, S, H, d) views seen as (B, H, S, d),
// last dimension contiguous; the output is written through its strides.
//
// bfloat16: `flash_mma_bf16_kernel`, warp-level tensor-core MMAs (FA2
//   style).  Each of the 4 warps owns 16 query rows.  Q is copied to
//   shared memory once and held in registers as mma A fragments
//   (ldmatrix); K and V tiles arrive through a two-slot cp.async ring in
//   bf16 shared memory, one barrier a tile (rows padded by 16 bytes, so
//   the 8 rows an ldmatrix reads fall on distinct banks at every head
//   dim, 80 included; rows past T are zero-filled by the copy).  S = Q K^T
//   is mma.m16n8k16 (bf16 in, f32 out) with K read as the col operand by a
//   plain ldmatrix; the mask comes from each fragment's (row, col), and
//   only on tiles that cut a warp's band (a warp whose rows see none of a
//   tile skips it); row max and sum reduce over the 4 lanes of a quad; p
//   is rounded to bf16 in registers, two m16n8 score tiles making one
//   m16k16 A fragment, and P V is mma.m16n8k16 with V read by
//   ldmatrix.trans; K and V fragments are read one step ahead of their
//   MMAs.  Registers are capped at 128 up to head dim 80 so that four
//   blocks share a SM (measured best of 1 / 2 row fragments a warp, 4 / 8
//   warps, 2 / 3 ring slots: PERF.md).  Any head dim that is a multiple
//   of 16 up to 128 is one instantiation: D/16 k-steps for Q K^T, D/8
//   n-tiles for P V (5 and 10 at 80).
// float32: `flash_simt_f32_kernel`, FMAs on the CUDA cores (no TF32, which
//   keeps about 3 decimal digits against a 2e-5 limit), 64-row query
//   tiles.  Q, K, V and P tiles sit in shared memory as f32; each thread
//   owns a 4 x 8 block of the score tile and 4 rows x D/16 float2 chunks
//   of the accumulator.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int BQ = 64;          // query rows per thread block
constexpr int BK = 64;          // kv rows per tile
constexpr float kNegInf = -1e30f;

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

// kv tiles [begin, end) intersecting the band of the block's query rows
// [q0, q0 + BQ) (the Pallas block_live test)
__device__ __forceinline__ void kv_band(const Args& a, int q0, int& begin,
                                        int& end) {
  const int n_kv = (a.T + BK - 1) / BK;
  const int q_last = min(q0 + BQ, a.S) - 1;
  begin = 0;
  end = n_kv;
  if (a.causal) {
    end = min(n_kv, q_last / BK + 1);
    if (a.window > 0) begin = max(0, q0 - a.window + 1) / BK;
  }
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
namespace simt {

template <int D>
constexpr int smem_floats() {
  // Q, K, V tiles with rows padded to D + 4 (16-byte aligned rows, and the
  // 8 rows one quarter-warp reads land on distinct banks), P padded too
  return BQ * (D + 4) + 2 * BK * (D + 4) + BQ * (BK + 4);
}

template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int row0,
                                          int n_rows) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int pos = row0 + r;
    dst[r * (D + 4) + d] =
        pos < n_rows ? src[(long long)pos * row_stride + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_simt_f32_kernel(Args a) {
  static_assert(D % 16 == 0 && BQ == BK, "tile shapes");
  constexpr int LD = D + 4;
  constexpr int LP = BK + 4;
  constexpr int DV = D / 16;      // float2 chunks of an accumulator row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int q0 = qt * BQ;
  const float* q = (const float*)a.q + b * a.q_sb + h * a.q_sh;
  const float* k = (const float*)a.k + b * a.k_sb + kh * a.k_sh;
  const float* v = (const float*)a.v + b * a.v_sb + kh * a.v_sh;
  float* o = (float*)a.o + b * a.o_sb + h * a.o_sh;

  const int tr = threadIdx.x / 8;   // rows tr*4 .. tr*4+3
  const int tc = threadIdx.x % 8;   // score cols tc + 8j; acc chunks tc + 8jj

  load_tile<D>(Qs, q, a.q_ss, q0, a.S);

  float m[4], l[4], acc[4][DV * 2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DV * 2; ++j) acc[i][j] = 0.f;
  }

  int kt_begin, kt_end;
  kv_band(a, q0, kt_begin, kt_end);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();               // previous tile's K/V/P reads are done
    load_tile<D>(Ks, k, a.k_ss, k0, a.T);
    load_tile<D>(Vs, v, a.v_ss, k0, a.T);
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
        Ps[(tr * 4 + i) * LP + tc + 8 * j] = p;   // v is f32: no rounding
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DV * 2; ++j) acc[i][j] *= corr;
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
          const float2 vv = *reinterpret_cast<const float2*>(
              &Vs[(c + cc) * LD + 2 * (tc + 8 * jj)]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y
                            : cc == 2 ? pv[i].z : pv[i].w;
            acc[i][2 * jj + 0] = fmaf(p, vv.x, acc[i][2 * jj + 0]);
            acc[i][2 * jj + 1] = fmaf(p, vv.y, acc[i][2 * jj + 1]);
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
    float* row = o + (long long)q_pos * a.o_ss;
#pragma unroll
    for (int jj = 0; jj < DV; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        row[2 * (tc + 8 * jj) + e] = acc[i][2 * jj + e] / li;
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  // above 48 KB of dynamic shared memory needs the opt-in, once per
  // instantiation (so never inside a CUDA-graph capture after a warm-up)
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_simt_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  flash_simt_f32_kernel<D><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
namespace mma {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory; zeros when !valid (nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + 64) of an (n_rows x D) bf16 matrix (row stride
// `stride` elements) into a 64 x (D + 8) shared tile; rows past n_rows
// become zeros
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int n_rows) {
  constexpr int CPR = D / 8;      // 16-byte chunks a row
  for (int c = threadIdx.x; c < BK * CPR; c += kThreads) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool ok = row0 + r < n_rows;
    const __nv_bfloat16* g =
        ok ? src + (long long)(row0 + r) * stride + col : src;
    cp_async16(dst + (r * (D + 8) + col) * 2, g, ok);
  }
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

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two probabilities rounded to bf16 (the reference's p.astype(v.dtype))
// and packed, the lower column in the low half
__device__ __forceinline__ uint32_t pack_p(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Each of the 4 warps owns 16 query rows.  Fragment layout of an m16n8
// tile (mma's accumulator): lane owns rows lane/4 (elements 0, 1) and
// lane/4 + 8 (elements 2, 3), columns 2 (lane % 4) and + 1.  Registers
// are capped for MIN_BLOCKS resident blocks a SM.
template <int D, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
    flash_mma_bf16_kernel(Args a) {
  static_assert(D % 16 == 0 && D <= 128 && BQ == 64 && BK == 64,
                "tile shapes");
  constexpr int LD = D + 8;       // shared row stride (elements)
  constexpr int KS = D / 16;      // k16 steps of Q K^T
  constexpr int NT = D / 8;       // n8 tiles of the output
  constexpr int TILE = BK * LD * 2;           // bytes of one Q, K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = smem_u32(smem_raw);
  const uint32_t sKV = sQ + TILE;             // K, V of slot 0, then slot 1

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.K);
  const int q0 = qt * BQ;
  const __nv_bfloat16* q =
      (const __nv_bfloat16*)a.q + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* k =
      (const __nv_bfloat16*)a.k + b * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* v =
      (const __nv_bfloat16*)a.v + b * a.v_sb + kvh * a.v_sh;
  __nv_bfloat16* o = (__nv_bfloat16*)a.o + b * a.o_sb + h * a.o_sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wq0 = q0 + warp * 16, wq1 = wq0 + 15;   // this warp's rows

  int kt_begin, kt_end;
  kv_band(a, q0, kt_begin, kt_end);
  // tile kt's K and V go to ring slot (kt - kt_begin) % 2
  auto load_kv = [&](int kt) {
    const uint32_t slot = sKV + ((kt - kt_begin) % 2) * 2 * TILE;
    load_tile<D>(slot, k, a.k_ss, kt * BK, a.T);
    load_tile<D>(slot + TILE, v, a.v_ss, kt * BK, a.T);
  };
  load_tile<D>(sQ, q, a.q_ss, q0, a.S);
  if (kt_begin < kt_end) load_kv(kt_begin);
  cp_async_commit();

  uint32_t qf[KS][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // scores in log2 units: exp(x) = exp2(x log2 e), masked at -1e30 as is
  const float sl2 = a.scale * kLog2e;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    cp_async_wait<0>();
    // one barrier a tile: tile kt is visible to every warp, and every warp
    // is done with tile kt - 1, whose slot the next copy refills while
    // this tile is computed
    __syncthreads();
    if (kt + 1 < kt_end) load_kv(kt + 1);
    cp_async_commit();
    const uint32_t sK = sKV + ((kt - kt_begin) % 2) * 2 * TILE;
    const uint32_t sV = sK + TILE;
    if (kt == kt_begin) {
      // Q's A fragments, once: matrices (rows +0/+8) x (cols +0/+8)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int r = warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2);
        const int c = 16 * kk + 8 * (lane / 16);
        ldsm_x4(sQ + (r * LD + c) * 2, qf[kk]);
      }
    }
    const int k0 = kt * BK;
    // a warp whose rows see none of this tile skips it: masked scores
    // would leave m, l and acc as they are (or be wiped by the visible
    // key every causal row has on its diagonal); a tile wholly inside
    // every row's band needs no mask
    const bool live =
        !a.causal ||
        (k0 <= wq1 && (a.window == 0 || k0 + BK - 1 > wq0 - a.window));
    const bool whole = k0 + BK <= a.T &&
        (!a.causal || (k0 + BK - 1 <= wq0 &&
                       (a.window == 0 || wq1 - k0 < a.window)));
    if (!live) continue;

    // S (16 x 64 a warp) = Q K^T: eight n8 tiles, two per ldmatrix, each
    // K fragment read one step ahead of the MMAs that use it
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    auto k_frag = [&](int i, uint32_t* bf) {   // i = 4 kk + jp
      const int r = 16 * (i % 4) + (lane % 8) + 8 * (lane / 16);
      const int c = 16 * (i / 4) + 8 * ((lane / 8) % 2);
      ldsm_x4(sK + (r * LD + c) * 2, bf);
    };
    uint32_t kb[2][4];
    k_frag(0, kb[0]);
#pragma unroll
    for (int i = 0; i < 4 * KS; ++i) {
      if (i + 1 < 4 * KS) k_frag(i + 1, kb[(i + 1) % 2]);
      const uint32_t* bf = kb[i % 2];
      mma_16816(s[2 * (i % 4)], qf[i / 4], bf[0], bf[1]);
      mma_16816(s[2 * (i % 4) + 1], qf[i / 4], bf[2], bf[3]);
    }

    // mask, online softmax over the quad that shares each row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = wq0 + lane / 4 + 8 * r;
      // scale; mask at -1e30 as the reference only where the tile cuts
      // the warp's band (a row that has seen only masked keys gets p =
      // exp2(0) = 1, wiped by its first visible key)
      if (whole) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) s[j][e] *= sl2;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const int kp = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
            bool vis = kp < a.T;
            if (a.causal) {
              vis = vis && qp >= kp;
              if (a.window > 0) vis = vis && (qp - kp) < a.window;
            }
            s[j][e] = vis ? s[j][e] * sl2 : kNegInf;
          }
      }
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) mx = fmaxf(mx, s[j][e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = fast_exp2(s[j][e] - m_new);
          sum += s[j][e];             // l sums p unrounded
        }
      const float corr = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] = l[r] * corr + sum;       // this lane's columns; quad-summed last
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    // O += P V: score tiles 2kk, 2kk+1 form the A fragment of kv k-step
    // kk; V fragments read one step ahead
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_p(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_p(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_p(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_p(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    auto v_frag = [&](int i, uint32_t* bf) {   // i = (NT / 2) kk + np
      const int r = 16 * (i / (NT / 2)) + (lane % 8) + 8 * ((lane / 8) % 2);
      const int c = 16 * (i % (NT / 2)) + 8 * (lane / 16);
      ldsm_x4_trans(sV + (r * LD + c) * 2, bf);
    };
    uint32_t vb[2][4];
    v_frag(0, vb[0]);
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i) {
      if (i + 1 < 2 * NT) v_frag(i + 1, vb[(i + 1) % 2]);
      const uint32_t* bf = vb[i % 2];
      const int kk = i / (NT / 2), np = i % (NT / 2);
      mma_16816(acc[2 * np], pa[kk], bf[0], bf[1]);
      mma_16816(acc[2 * np + 1], pa[kk], bf[2], bf[3]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr = fmaxf(lr, 1e-30f);
    const int qp = wq0 + lane / 4 + 8 * r;
    if (qp >= a.S) continue;
    __nv_bfloat16* row = o + (long long)qp * a.o_ss + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * r] / lr, acc[n][2 * r + 1] / lr);
  }
}

// four blocks a SM (at most 128 registers a thread) up to head dim 80;
// at 128 the accumulator and Q's fragments alone take 96, so two
template <int D>
constexpr int min_blocks() { return D <= 80 ? 4 : 2; }

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(BQ + 4 * BK) * (D + 8) * 2;   // Q, then K, V twice
}

template <int D>
int launch(const Args& a, int B, cudaStream_t s) {
  auto kernel = flash_mma_bf16_kernel<D, min_blocks<D>()>;
  static bool opted_in = false;     // once per instantiation, as above
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<D>());
    // the whole unified L1 / shared memory as shared, so that as many
    // blocks as the registers allow are resident on a SM
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  kernel<<<grid, kThreads, smem_bytes<D>(), s>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, flash_mma_bf16_kernel<D, min_blocks<D>()>, kThreads,
          smem_bytes<D>()) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace mma

// the head dims instantiated (the configs' 32, 64, 80 and 128); every
// multiple of 16 up to 128 is one more case here
template <int D>
int launch_d(int dtype, const Args& a, int B, cudaStream_t s) {
  if (dtype == 0) return simt::launch<D>(a, B, s);
  if (dtype == 1) return mma::launch<D>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores) -- q, k, v and
// out alike; D: head dim (32, 64, 80 or 128).  q/o: (B, H, S, D), k/v:
// (B, K, T, D) with element strides strides[0..11] = q (b, h, s), k (b, h,
// t), v (b, h, t), o (b, h, s); the last dimension is contiguous; for
// bfloat16 every row starts on 16 bytes.  H % K == 0.
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
  switch (D) {
    case 32: return launch_d<32>(dtype, a, B, s);
    case 64: return launch_d<64>(dtype, a, B, s);
    case 80: return launch_d<80>(dtype, a, B, s);
    case 128: return launch_d<128>(dtype, a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// thread blocks of the bfloat16 kernel resident on one SM at head dim D
// (after a first launch has set its attributes), or -1
extern "C" int flash_attention_blocks_per_sm(int D) {
  switch (D) {
    case 32: return mma::blocks_per_sm<32>();
    case 64: return mma::blocks_per_sm<64>();
    case 80: return mma::blocks_per_sm<80>();
    case 128: return mma::blocks_per_sm<128>();
    default: return -1;
  }
}
