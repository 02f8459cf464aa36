// Paged-attention decode for Hopper (sm_90a), the pages split over blocks.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (`_paged_kernel`, launched by `paged_decode_attention` through
// pl.pallas_call at :189): one-token decode attention straight over the KV
// page pool through a block table, dead pages skipped, online softmax, tanh
// softcap, GQA (G query heads per kv head), and page ids >= P read the int8
// side pool, dequantised in the load as float(q)*scale cast to the pool
// dtype; p is cast to the pool dtype before the PV product.
//
// What bounds it on an H100: bytes.  Per step it reads each live K/V page of
// each session once (2 * page * hd elements per kv head) and does ~4 flops
// per element read -- far below the ~295 flop/byte where the tensor cores
// would become the limit -- so the floor is (bytes read) / 3.35 TB/s.  What
// held the first design back was latency: one block per (session, kv head)
// walked its pages one after another (~3.5 us a page on an H100).
//
// Design (flash-decoding): the grid covers (split, kv head, session); each
// split is a contiguous range of the page map's columns.  The split count
// comes from the page-map width, the batch and the SM count (the wrapper's
// `split_plan`), never from cache_index, so one pool and batch always
// launch the same grid.  A split whose pages are all dead writes an empty
// partial (m = -1e30, the kernel's finite -inf, l = 0).  Inside a block
// each of the 4 warps takes every 4th live page of the split and keeps
// its own running max, denominator and accumulator; a page's K and V tiles
// arrive by cp.async, 16 bytes a thread, into the warp's two-slot ring,
// the next page while this one is scored.  The block merges its warps in
// shared memory and writes its partial (m, l, accumulator) to a scratch
// the wrapper allocates; the last block of a (session, kv head) to finish
// (an atomic counter, which it resets) merges the splits into `out`,
// scaling each by e^(m_split - m).  When every split shares one maximum,
// as in chip_smoke.py's rounding probe, those factors are e^0 = 1 and the
// merge adds the partials exactly, so the probe stays exact.
//
// bfloat16, G <= 16, page 16 or 32, hd <= 128: `paged_mma_bf16_kernel`,
//   the scores and PV on the tensor cores (mma.sync.m16n8k16, bf16 in,
//   f32 accumulate; the G query heads padded to 16 rows): Q's A fragments
//   stay in registers, K is the col operand (ldmatrix of the padded K
//   tile), p is rounded to bf16 as it is packed into the A fragment of PV
//   and V is read by ldmatrix.trans.  A side-pool page arrives as int8
//   codes in a staging buffer and is dequantised into the bf16 tiles.
//   The row max and sum reduce over the 4 lanes of a quad.
// float32, and the bfloat16 shapes above it does not take:
//   `paged_simt_kernel` on the CUDA cores.  The lanes split the G x hd
//   query / output values (two adjacent values a lane, 64 a step); each
//   lane sums its part of every (query head, row) score and one
//   transposing butterfly of 31 shuffles leaves lane i with score i; the
//   softmax max and sum of a query head reduce over the page's lanes.
//
// Measured (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3 at 700 W):
// 0.0085 ms at smollm's decode shape (B 8, H 9, K 3, hd 64, 192 rows
// visible; one block a (session, kv head) walking its pages took 0.043),
// 31x its bound; 0.0287 ms at zamba2's (B 6, H = K = 32, hd 80, 448 rows;
// 0.104 before), 3.7x its bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite: a fully masked row stays finite
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 16;         // value pairs a lane: G * hd <= 64 kSlots
constexpr size_t kMaxSmem = 226 * 1024;   // dynamic, below 227 KB: room
                                           // for the static `last`

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

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// values d, d + 1 of row `row` of a staged page tile: a raw page holds T,
// a side-pool page int8 codes dequantised as round_to<T>(q * scale)
template <typename T>
__device__ __forceinline__ float2 kv_pair(const unsigned char* tile,
                                          bool comp, int row, int d, int hd,
                                          float scale) {
  if (comp) {
    const char2 c8 = *reinterpret_cast<const char2*>(tile + row * hd + d);
    const float lo = (float)c8.x * scale, hi = (float)c8.y * scale;
    return make_float2(round_to<T>(lo), round_to<T>(hi));
  }
  return load2(reinterpret_cast<const T*>(tile) + row * hd + d);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
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

// can the token at cache_index see any row of logical page j
__device__ __forceinline__ bool page_live(int j, int page, int idx,
                                          int window) {
  const int base = j * page;
  bool live = base <= idx;
  if (window > 0) live = live && (base + page - 1) > idx - window;
  return live;
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int8_t* kq;
  const int8_t* vq;
  const float* ks;
  const float* vs;
  const int32_t* page_map;
  void* out;
  float* part;   // (B, K, n_split, G, 2) m and l, then (B, K, n_split, G hd)
  int* counters; // (B, K) finished splits, 0 between calls
  int B, K, G, hd, pp, P, C, n_split, per_split, depth, cache_index, window;
  float scale, softcap;
};

// the split partial of a block that saw nothing
__device__ __forceinline__ void empty_partial(float* ml, float* acc, int G,
                                              int GH) {
  for (int i = threadIdx.x; i < G; i += kThreads) {
    ml[2 * i] = kNegInf;
    ml[2 * i + 1] = 0.f;
  }
  for (int i = threadIdx.x; i < GH; i += kThreads) acc[i] = 0.f;
}

// After a block has written its partial: the last block of its (session,
// kv head) to finish merges every split into out (b, kh G + g, d), each
// scaled by e^(m_split - m), and resets the counter for the next call.
template <typename T>
__device__ void finish_splits(const Args& a, int b, int kh) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  int* counter = a.counters + (size_t)b * a.K + kh;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == a.n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int G = a.G, GH = G * a.hd;
  const size_t base = ((size_t)b * a.K + kh) * a.n_split;
  const float* ml = a.part + base * G * 2;
  const float* acc = a.part + (size_t)a.B * a.K * a.n_split * G * 2 +
                     base * GH;
  T* o = static_cast<T*>(a.out) + ((size_t)b * a.K + kh) * GH;
  for (int i = threadIdx.x; i < GH; i += kThreads) {
    const int g = i / a.hd;
    float m = kNegInf;
    for (int s = 0; s < a.n_split; ++s)
      m = fmaxf(m, __ldcg(ml + (s * G + g) * 2));
    float l = 0.f, num = 0.f;
    for (int s = 0; s < a.n_split; ++s) {
      const float w = expf(__ldcg(ml + (s * G + g) * 2) - m);
      l += __ldcg(ml + (s * G + g) * 2 + 1) * w;
      num += __ldcg(acc + (size_t)s * GH + i) * w;
    }
    o[i] = from_float<T>(num / fmaxf(l, 1e-30f));
  }
  if (threadIdx.x == 0) *counter = 0;
}

// one K or V page tile in T, and a block's shared memory around its rings
__host__ __device__ inline size_t tile_bytes(int page, int hd, int esize) {
  return (size_t)page * hd * esize;
}
__host__ __device__ inline size_t ring_bytes(int page, int hd, int esize,
                                             int depth, int G) {
  const size_t rings = (size_t)kWarps * depth * 2 * tile_bytes(page, hd,
                                                               esize);
  const size_t red = (size_t)kWarps * G * hd * 4;
  return rings > red ? rings : red;
}
inline size_t smem_bytes(int page, int hd, int esize, int depth, int G) {
  return ring_bytes(page, hd, esize, depth, G) +
         4 * ((size_t)G * hd + (size_t)kWarps * ((size_t)G * page + 3 * G));
}

// ---------------------------------------------------------------------------
// float32 (and bfloat16 shapes the tensor-core kernel lacks) on the CUDA
// cores.  One block: one (split, kv head, session).  grid (n_split, K, B).
template <typename T, int PAGE>
__global__ void __launch_bounds__(kThreads) paged_simt_kernel(Args a) {
  constexpr int GP = 32 / PAGE;      // query heads in one pass of 32 lanes
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.G, hd = a.hd, GH = G * hd;
  const size_t pidx = ((size_t)b * a.K + kh) * a.n_split + split;
  float* part_ml = a.part + pidx * G * 2;
  float* part_acc =
      a.part + (size_t)a.B * a.K * a.n_split * G * 2 + pidx * GH;

  // the split's live pages [j0, j1) (liveness is an interval of j)
  const int s0 = split * a.per_split;
  const int s1 = min(a.pp, s0 + a.per_split);
  int j0 = s1, j1 = s0;
  for (int j = s0; j < s1; ++j)
    if (page_live(j, PAGE, a.cache_index, a.window)) {
      j0 = min(j0, j);
      j1 = j + 1;
    }
  if (j0 >= j1) {   // nothing visible: an empty partial
    empty_partial(part_ml, part_acc, G, GH);
    finish_splits<T>(a, b, kh);
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tile = tile_bytes(PAGE, hd, sizeof(T));
  unsigned char* ring = smem + (size_t)warp * a.depth * 2 * tile;
  float* q_s = reinterpret_cast<float*>(
      smem + ring_bytes(PAGE, hd, sizeof(T), a.depth, G));
  float* stat = q_s + GH;           // per warp: p [G PAGE], m, l, corr [G]
  auto wm = [&](int w, int g) { return stat[w * (G * PAGE + 3 * G) +
                                            G * PAGE + g]; };
  auto wl = [&](int w, int g) { return stat[w * (G * PAGE + 3 * G) +
                                            G * PAGE + G + g]; };
  float* p_s = stat + warp * (G * PAGE + 3 * G);
  float* m_s = p_s + G * PAGE;
  float* l_s = m_s + G;
  float* c_s = l_s + G;
  float* red = reinterpret_cast<float*>(smem);   // after the pages: the rings

  const T* q = static_cast<const T*>(a.q) + ((size_t)b * a.K + kh) * GH;
  for (int i = tid; i < GH; i += kThreads) q_s[i] = to_float(q[i]);
  for (int g = lane; g < G; g += 32) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  // this lane's values: flat f = 2 lane + 64 s of the G x hd block, as
  // (g << 16) | d, or -1 past its end
  int gd[kSlots];
  float acc[kSlots][2];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int f = 2 * lane + 64 * s;
    gd[s] = f < GH ? ((f / hd) << 16) | (f % hd) : -1;
    acc[s][0] = acc[s][1] = 0.f;
  }
  __syncthreads();

  const int n_live = j1 - j0;
  const int mine = n_live > warp ? (n_live - warp + kWarps - 1) / kWarps : 0;
  // page n of this warp (logical page j0 + warp + 4 n) into ring slot
  // n % depth: one commit group, empty past the warp's last page
  auto fetch_page = [&](int n) {
    if (n < mine) {
      const int j = j0 + warp + kWarps * n;
      const int pid = a.page_map[(size_t)b * a.pp + j];
      const bool comp = a.C > 0 && pid >= a.P;
      const int rowb = comp ? hd : hd * (int)sizeof(T);
      const size_t stride = (size_t)a.K * rowb;
      const unsigned char *ksrc, *vsrc;
      if (comp) {
        const int ci = min(max(pid - a.P, 0), a.C - 1);
        const size_t off = ((size_t)ci * PAGE * a.K + kh) * hd;
        ksrc = reinterpret_cast<const unsigned char*>(a.kq + off);
        vsrc = reinterpret_cast<const unsigned char*>(a.vq + off);
      } else {
        const int rp = min(max(pid, 0), a.P - 1);
        const size_t off = ((size_t)rp * PAGE * a.K + kh) * hd;
        ksrc = reinterpret_cast<const unsigned char*>(
            static_cast<const T*>(a.k_pool) + off);
        vsrc = reinterpret_cast<const unsigned char*>(
            static_cast<const T*>(a.v_pool) + off);
      }
      unsigned char* dst = ring + (n % a.depth) * 2 * tile;
      const int cpr = rowb / 16;
      for (int i = lane; i < PAGE * cpr; i += 32) {
        const int r = i / cpr, ch = 16 * (i % cpr);
        cp_async16(smem_u32(dst + r * rowb + ch), ksrc + r * stride + ch);
        cp_async16(smem_u32(dst + tile + r * rowb + ch),
                   vsrc + r * stride + ch);
      }
    }
    cp_async_commit();
  };

  if (a.depth == 2) fetch_page(0);
  for (int n = 0; n < mine; ++n) {
    // depth 2: page n + 1 goes to the other slot while page n is scored
    if (a.depth == 2) {
      fetch_page(n + 1);
      cp_async_wait<1>();
    } else {
      fetch_page(n);
      cp_async_wait<0>();
    }
    __syncwarp();
    const int j = j0 + warp + kWarps * n;
    const int pid = a.page_map[(size_t)b * a.pp + j];
    const bool comp = a.C > 0 && pid >= a.P;
    float sk = 0.f, sv = 0.f;   // the side-pool frame's scales
    if (comp) {
      const int ci = min(max(pid - a.P, 0), a.C - 1);
      sk = a.ks[ci]; sv = a.vs[ci];
    }
    const unsigned char* kt = ring + (n % a.depth) * 2 * tile;
    const unsigned char* vt = kt + tile;

    for (int ps = 0; ps * GP < G; ++ps) {
      // this lane's part of the score of (query head ps GP + e, row r) in
      // v[e PAGE + r]; the butterfly then leaves lane i with score i
      float v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = 0.f;
      // slots rolled, rows and heads unrolled: v stays in registers and
      // the eight instantiations compile in seconds
#pragma unroll 1
      for (int s = 0; s < kSlots; ++s) {
        const int f = 2 * lane + 64 * s;
        if (f >= GH) break;
        const int gs = f / hd, ds = f - gs * hd;
        const int gg = gs - ps * GP;
        if (gg < 0 || gg >= GP) continue;
        const float2 qv = *reinterpret_cast<const float2*>(q_s + gs * hd +
                                                          ds);
#pragma unroll
        for (int r = 0; r < PAGE; ++r) {
          const float2 kv = kv_pair<T>(kt, comp, r, ds, hd, sk);
          const float d = qv.x * kv.x + qv.y * kv.y;
#pragma unroll
          for (int e = 0; e < GP; ++e) v[e * PAGE + r] += gg == e ? d : 0.f;
        }
      }
#pragma unroll
      for (int w = 16; w >= 1; w /= 2) {
        const bool up = lane & w;
#pragma unroll
        for (int i = 0; i < w; ++i) {
          const float send = up ? v[i] : v[i + w];
          const float keep = up ? v[i + w] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, w);
        }
      }
      const int g = ps * GP + lane / PAGE, r = lane % PAGE;
      const bool valid = g < G;
      float s = v[0] * a.scale;
      if (a.softcap > 0.f) s = tanhf(s / a.softcap) * a.softcap;
      const int pos = j * PAGE + r;
      bool vis = pos <= a.cache_index;
      if (a.window > 0) vis = vis && pos > a.cache_index - a.window;
      s = vis ? s : kNegInf;
      // max and sum over the PAGE lanes (rows) of query head g
      const float m_old = valid ? m_s[g] : kNegInf;
      float mx = s;
#pragma unroll
      for (int o = PAGE / 2; o >= 1; o /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(s - m_new);
      float sum = p;   // l sums p unrounded
#pragma unroll
      for (int o = PAGE / 2; o >= 1; o /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (valid) {
        p_s[g * PAGE + r] = round_to<T>(p);   // p cast to T before PV
        if (r == 0) {
          const float corr = expf(m_old - m_new);
          m_s[g] = m_new;
          l_s[g] = l_s[g] * corr + sum;
          c_s[g] = corr;
        }
      }
    }
    __syncwarp();

    // PV over the page's rows, then acc = acc * corr + pv
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (gd[s] < 0) break;
      const int gs = gd[s] >> 16, ds = gd[s] & 0xffff;
      float pv0 = 0.f, pv1 = 0.f;
#pragma unroll 1
      for (int r = 0; r < PAGE; ++r) {
        const float pr = p_s[gs * PAGE + r];
        const float2 vv = kv_pair<T>(vt, comp, r, ds, hd, sv);
        pv0 += pr * vv.x;
        pv1 += pr * vv.y;
      }
      const float corr = c_s[gs];
      acc[s][0] = acc[s][0] * corr + pv0;
      acc[s][1] = acc[s][1] * corr + pv1;
    }
    __syncwarp();   // the slot, p and corr are free for the next page
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the warps: each scaled by e^(m_warp - m_block)
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (gd[s] < 0) break;
    const int gs = gd[s] >> 16;
    float mb = kNegInf;
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, wm(w, gs));
    const float f = expf(m_s[gs] - mb);
    const int i = 2 * lane + 64 * s;
    red[warp * GH + i] = acc[s][0] * f;
    red[warp * GH + i + 1] = acc[s][1] * f;
  }
  __syncthreads();
  for (int i = tid; i < GH; i += kThreads) {
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w) o += red[w * GH + i];
    part_acc[i] = o;
  }
  for (int g = tid; g < G; g += kThreads) {
    float mb = kNegInf;
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, wm(w, g));
    float lb = 0.f;
    for (int w = 0; w < kWarps; ++w) lb += wl(w, g) * expf(wm(w, g) - mb);
    part_ml[2 * g] = mb;
    part_ml[2 * g + 1] = lb;
  }
  finish_splits<T>(a, b, kh);
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
namespace tc {

constexpr int kMaxHd = 128;
constexpr int kRows = 16;          // the G query heads, padded to one m16

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
// two probabilities rounded to bf16 (the reference's p.to(v.dtype)) and
// packed, the lower column in the low half
__device__ __forceinline__ uint32_t pack_p(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// two dequantised side-pool values q * scale rounded to bf16 (the
// reference's cast to the pool dtype) and packed
__device__ __forceinline__ uint32_t pack_dq(float x0, float x1) {
  const __nv_bfloat162 d = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&d);
}

// row stride (elements) of a bf16 page tile: 16 bytes of padding put the
// 8 rows one ldmatrix reads on distinct banks
__host__ __device__ inline int tile_ld(int hd) { return hd + 8; }
__host__ __device__ inline size_t tile_bytes(int page, int hd) {
  return (size_t)page * tile_ld(hd) * 2;
}
// a warp's K / V tiles for two pages, then one int8 staging buffer
__host__ __device__ inline size_t warp_bytes(int page, int hd) {
  return 4 * tile_bytes(page, hd) + 2 * (size_t)page * hd;
}
// after the pages, each warp's m, l [16] and accumulator [16][hd]
__host__ __device__ inline size_t ring_bytes(int page, int hd) {
  const size_t rings = kWarps * warp_bytes(page, hd);
  const size_t merge = (size_t)kWarps * kRows * (2 + hd) * 4;
  return rings > merge ? rings : merge;
}
inline size_t smem_bytes(int page, int hd) {
  return ring_bytes(page, hd) + (size_t)kRows * tile_ld(hd) * 2;
}

// Fragment layout of an m16n8 accumulator: lane owns rows (query heads)
// lane / 4 (elements 0, 1) and lane / 4 + 8 (elements 2, 3), columns 2
// (lane % 4) and + 1.  One block: one (split, kv head, session).  grid
// (n_split, K, B).
template <int PAGE>
__global__ void __launch_bounds__(kThreads) paged_mma_bf16_kernel(Args a) {
  static_assert(PAGE % 16 == 0 && PAGE <= 32, "page rows");
  constexpr int NT = PAGE / 8;       // n8 tiles of a page's scores
  constexpr int MAX_KS = kMaxHd / 16, MAX_NP = kMaxHd / 16;
  using bf16 = __nv_bfloat16;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r = lane / 4, q = lane % 4;
  const int G = a.G, hd = a.hd, GH = G * hd, LD = tile_ld(hd);
  const int KS = hd / 16;            // k16 steps of Q K^T, n16 pairs of PV
  const size_t pidx = ((size_t)b * a.K + kh) * a.n_split + split;
  float* part_ml = a.part + pidx * G * 2;
  float* part_acc =
      a.part + (size_t)a.B * a.K * a.n_split * G * 2 + pidx * GH;

  const int s0 = split * a.per_split;
  const int s1 = min(a.pp, s0 + a.per_split);
  int j0 = s1, j1 = s0;
  for (int j = s0; j < s1; ++j)
    if (page_live(j, PAGE, a.cache_index, a.window)) {
      j0 = min(j0, j);
      j1 = j + 1;
    }
  if (j0 >= j1) {   // nothing visible: an empty partial
    empty_partial(part_ml, part_acc, G, GH);
    finish_splits<bf16>(a, b, kh);
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tileb = tile_bytes(PAGE, hd);
  unsigned char* wring = smem + warp * warp_bytes(PAGE, hd);
  unsigned char* stage = wring + 4 * tileb;   // int8 K codes, then V codes
  bf16* q_s = reinterpret_cast<bf16*>(smem + ring_bytes(PAGE, hd));
  const bf16* qg = static_cast<const bf16*>(a.q) + ((size_t)b * a.K + kh) *
                                                      GH;
  for (int i = tid; i < kRows * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    q_s[g * LD + d] = g < G ? qg[i] : __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  // Q's A fragments, once: matrices (rows +0/+8) x (cols +0/+8)
  uint32_t qf[MAX_KS][4];
#pragma unroll
  for (int kk = 0; kk < MAX_KS; ++kk) {
    if (kk >= KS) break;
    ldsm_x4(smem_u32(q_s) + (((lane % 8) + 8 * ((lane / 8) % 2)) * LD +
                             16 * kk + 8 * (lane / 16)) * 2, qf[kk]);
  }
  float acc[2 * MAX_NP][4];
#pragma unroll
  for (int n = 0; n < 2 * MAX_NP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int n_live = j1 - j0;
  const int mine = n_live > warp ? (n_live - warp + kWarps - 1) / kWarps : 0;
  auto page_id = [&](int n) {
    return a.page_map[(size_t)b * a.pp + j0 + warp + kWarps * n];
  };
  // page n of this warp: raw bf16 rows into ring slot n % 2 (padded), or
  // a side-pool page's int8 codes into the staging buffer; one group
  auto fetch_page = [&](int n) {
    if (n < mine) {
      const int pid = page_id(n);
      if (a.C > 0 && pid >= a.P) {
        const int ci = min(max(pid - a.P, 0), a.C - 1);
        const size_t off = ((size_t)ci * PAGE * a.K + kh) * hd;
        const int cpr = hd / 16;
        for (int i = lane; i < PAGE * cpr; i += 32) {
          const int row = i / cpr, ch = 16 * (i % cpr);
          const size_t src = off + (size_t)row * a.K * hd + ch;
          cp_async16(smem_u32(stage + row * hd + ch), a.kq + src);
          cp_async16(smem_u32(stage + (PAGE + row) * hd + ch), a.vq + src);
        }
      } else {
        const int rp = min(max(pid, 0), a.P - 1);
        const size_t off = ((size_t)rp * PAGE * a.K + kh) * hd;
        const bf16* kp = static_cast<const bf16*>(a.k_pool) + off;
        const bf16* vp = static_cast<const bf16*>(a.v_pool) + off;
        unsigned char* dst = wring + 2 * (n % 2) * tileb;
        const int cpr = hd / 8;
        for (int i = lane; i < PAGE * cpr; i += 32) {
          const int row = i / cpr, col = 8 * (i % cpr);
          const size_t src = (size_t)row * a.K * hd + col;
          cp_async16(smem_u32(dst + (row * LD + col) * 2), kp + src);
          cp_async16(smem_u32(dst + tileb + (row * LD + col) * 2), vp + src);
        }
      }
    }
    cp_async_commit();
  };

  fetch_page(0);
  for (int n = 0; n < mine; ++n) {
    cp_async_wait<0>();
    __syncwarp();
    const int j = j0 + warp + kWarps * n;
    const int pid = page_id(n);
    unsigned char* kt = wring + 2 * (n % 2) * tileb;
    unsigned char* vt = kt + tileb;
    if (a.C > 0 && pid >= a.P) {
      // dequantise the side-pool frame into the bf16 tiles: 16 codes a
      // lane a step, each round_to<bf16>(q * scale) as the reference
      const int ci = min(max(pid - a.P, 0), a.C - 1);
      const float sk = a.ks[ci], sv = a.vs[ci];
      const int cpr = hd / 16;
      for (int i = lane; i < 2 * PAGE * cpr; i += 32) {
        const int row = i / cpr, ch = 16 * (i % cpr);
        const bool is_v = row >= PAGE;
        const float sc = is_v ? sv : sk;
        const int8_t* c8 = reinterpret_cast<const int8_t*>(stage) +
                           row * hd + ch;
        uint32_t w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          w[e] = pack_dq((float)c8[2 * e] * sc, (float)c8[2 * e + 1] * sc);
        uint4* dst = reinterpret_cast<uint4*>(
            (is_v ? vt : kt) + ((row % PAGE) * LD + ch) * 2);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncwarp();
    }
    // the next page goes to the other slot while this one is scored
    fetch_page(n + 1);

    // S (16 query rows x PAGE) = Q K^T: K read as the col operand
    float s[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MAX_KS; ++kk) {
      if (kk >= KS) break;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(smem_u32(kt) + ((16 * np + (lane % 8) + 8 * (lane / 16)) *
                                    LD + 16 * kk + 8 * ((lane / 8) % 2)) * 2,
                bf);
        mma_16816(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_16816(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }
    // scale, softcap, mask; online softmax over the quad sharing a row
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
          const int pos = j * PAGE + 8 * t + 2 * q + (e & 1);
          float v = s[t][e] * a.scale;
          if (a.softcap > 0.f) v = tanhf(v / a.softcap) * a.softcap;
          bool vis = pos <= a.cache_index;
          if (a.window > 0) vis = vis && pos > a.cache_index - a.window;
          s[t][e] = vis ? v : kNegInf;
          mx = fmaxf(mx, s[t][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      const float corr = expf(m[hf] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
          s[t][e] = expf(s[t][e] - m_new);
          sum += s[t][e];             // l sums p unrounded
        }
      m[hf] = m_new;
      l[hf] = l[hf] * corr + sum;     // this lane's columns; quad-summed last
#pragma unroll
      for (int n8 = 0; n8 < 2 * MAX_NP; ++n8) {
        acc[n8][2 * hf] *= corr;
        acc[n8][2 * hf + 1] *= corr;
      }
    }
    // O += P V: score tiles 2 kk, 2 kk + 1 form the A fragment of row
    // k-step kk; V read by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < PAGE / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_p(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_p(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_p(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_p(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int np = 0; np < MAX_NP; ++np) {
        if (np >= KS) break;
        uint32_t bf[4];
        ldsm_x4_trans(smem_u32(vt) + ((16 * kk + (lane % 8) +
                                       8 * ((lane / 8) % 2)) * LD +
                                      16 * np + 8 * (lane / 16)) * 2, bf);
        mma_16816(acc[2 * np], pa, bf[0], bf[1]);
        mma_16816(acc[2 * np + 1], pa, bf[2], bf[3]);
      }
    }
    __syncwarp();   // the slot is free for page n + 2
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
  }
  __syncthreads();

  // merge the warps: each scaled by e^(m_warp - m_block)
  float* mw = reinterpret_cast<float*>(smem);       // [warp][16]
  float* lw = mw + kWarps * kRows;                  // [warp][16]
  float* aw = lw + kWarps * kRows;                  // [warp][16][hd]
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int g = r + 8 * hf;
    if (q == 0) {
      mw[warp * kRows + g] = m[hf];
      lw[warp * kRows + g] = l[hf];
    }
#pragma unroll
    for (int n8 = 0; n8 < 2 * MAX_NP; ++n8) {
      if (n8 >= 2 * KS) break;
      float* row = aw + (warp * kRows + g) * hd + 8 * n8 + 2 * q;
      row[0] = acc[n8][2 * hf];
      row[1] = acc[n8][2 * hf + 1];
    }
  }
  __syncthreads();
  for (int i = tid; i < GH; i += kThreads) {
    const int g = i / hd;
    float mb = kNegInf;
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, mw[w * kRows + g]);
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w)
      o += aw[(w * kRows + g) * hd + i - g * hd] *
           expf(mw[w * kRows + g] - mb);
    part_acc[i] = o;
  }
  for (int g = tid; g < G; g += kThreads) {
    float mb = kNegInf;
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, mw[w * kRows + g]);
    float lb = 0.f;
    for (int w = 0; w < kWarps; ++w)
      lb += lw[w * kRows + g] * expf(mw[w * kRows + g] - mb);
    part_ml[2 * g] = mb;
    part_ml[2 * g + 1] = lb;
  }
  finish_splits<bf16>(a, b, kh);
}

}  // namespace tc

// raise a kernel's dynamic shared memory limit to what this launch needs
// (once per size above the last; before any CUDA graph capture, the first
// launch of a shape runs eagerly)
bool opt_in(const void* fn, size_t smem, size_t& done) {
  if (smem <= done) return true;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return false;
  done = smem;
  return true;
}

template <typename T, int PAGE>
int launch_simt(Args a, cudaStream_t stream) {
  a.depth = 2;
  size_t smem = smem_bytes(PAGE, a.hd, sizeof(T), a.depth, a.G);
  if (smem > kMaxSmem) {
    a.depth = 1;
    smem = smem_bytes(PAGE, a.hd, sizeof(T), a.depth, a.G);
  }
  static size_t opted_in = 48 * 1024;
  if (smem > kMaxSmem ||
      !opt_in((const void*)paged_simt_kernel<T, PAGE>, smem, opted_in))
    return (int)cudaErrorInvalidValue;
  paged_simt_kernel<T, PAGE>
      <<<dim3(a.n_split, a.K, a.B), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int PAGE>
int launch_mma(const Args& a, cudaStream_t stream) {
  const size_t smem = tc::smem_bytes(PAGE, a.hd);
  static size_t opted_in = 48 * 1024;
  if (smem > kMaxSmem ||
      !opt_in((const void*)tc::paged_mma_bf16_kernel<PAGE>, smem, opted_in))
    return (int)cudaErrorInvalidValue;
  tc::paged_mma_bf16_kernel<PAGE>
      <<<dim3(a.n_split, a.K, a.B), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_page(const Args& a, int page, cudaStream_t s) {
  switch (page) {
    case 4: return launch_simt<T, 4>(a, s);
    case 8: return launch_simt<T, 8>(a, s);
    case 16: return launch_simt<T, 16>(a, s);
    case 32: return launch_simt<T, 32>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, pools and out share it).  C == 0: no
// side pool (kq/vq/ks/vs unused).  part: B * K * n_split * G * (hd + 2)
// floats of scratch; counters: B * K ints, 0 on entry and on return;
// pages [s per_split, (s + 1) per_split) of the page map form split s.
// Takes page 4, 8, 16 or 32, hd a multiple of 16, G hd <= 1024; bfloat16
// with G <= 16, page 16 or 32 and hd <= 128 runs on the tensor cores.
// Returns cudaGetLastError() after the launch.
extern "C" int paged_decode_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* kq, const void* vq, const void* ks, const void* vs,
    const void* page_map, void* out, void* part, void* counters, int B,
    int K, int G, int hd, int page, int pp, int P, int C, int n_split,
    int per_split, int cache_index, int window, float scale, float softcap,
    void* stream) {
  if (G * hd > 64 * kSlots || hd % 16 || hd <= 0 || G <= 0 ||
      n_split < 1 || per_split < 1 || (long long)n_split * per_split < pp)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || K == 0) return 0;
  Args a{q, k_pool, v_pool, static_cast<const int8_t*>(kq),
         static_cast<const int8_t*>(vq), static_cast<const float*>(ks),
         static_cast<const float*>(vs),
         static_cast<const int32_t*>(page_map), out,
         static_cast<float*>(part), static_cast<int*>(counters), B, K, G,
         hd, pp, P, C, n_split, per_split, 2, cache_index, window, scale,
         softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_page<float>(a, page, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (G <= tc::kRows && hd <= tc::kMaxHd && (page == 16 || page == 32))
    return page == 16 ? launch_mma<16>(a, s) : launch_mma<32>(a, s);
  return launch_page<__nv_bfloat16>(a, page, s);
}
