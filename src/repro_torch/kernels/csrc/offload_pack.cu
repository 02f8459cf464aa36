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
// What bounds them on an H100: bytes.  A pack reads 2 or 4 bytes an element
// and writes one; an unpack reads one byte and writes 2 or 4.  A few
// operations per element, so the floor is the bytes moved / 3.35 TB/s.  At
// a spilled page (a few hundred KB) the floor is a fraction of a
// microsecond and launches and latency set the time.
//
// The int8 pack and the shared unpack work on *leaves*: up to kMaxLeaves
// tensors in one launch, each described by value in the kernel's
// parameters (no pointer table copied to the card).  A leaf's elements, in
// logical order, are runs of `run_len` contiguous elements, one run every
// `src_stride` (`dst_stride` on the other side), so a page is read from, or
// written into, a pool frame in place: a pool leaf (n_groups, frames, page,
// K, hd) holds page `pid` as n_groups runs of page*K*hd elements.  A leaf is
// cut into row blocks of `block_elems` elements, one scale each (a page
// leaf is one row block).  Work goes in chunks of 16 elements: a chunk that
// lies inside one run, at 16-byte aligned addresses, moves as 16-byte
// accesses (16 codes in one store); any other chunk (the ragged tail of a
// row block, a row block that starts off alignment) element by element.
//
// int8 pack, a row block that fits on chip in one thread-block cluster
// (every page leaf of the main paths, up to 16 x 512 x 4 chunks): one
// launch, x read once.  A cluster of up to 16 blocks takes one row block;
// each block loads its slice into registers (16-byte loads, up to 4 chunks
// a thread), reduces a partial absmax with warp shuffles and publishes it
// in shared memory; after the cluster barrier every block reads the
// cluster's partials through distributed shared memory, derives the one
// scale (the same quotient in every block) and quantises its slice from
// its registers (no round trip through shared memory).  No memset, no
// atomic.  A cluster runs inside one GPC, whose share of the L2 bandwidth
// and instruction rate bounds a large row block: a zamba2 page runs faster
// through the two-pass form over every SM, at one more launch on a
// host-bound serving loop (PERF.md has the times, from chip_ab.sh codec).
// A larger row block (8192 x 576, one stashed activation): two launches,
// pass 1 writes one partial absmax a slice, pass 2 folds its row block's
// partials into the scale and quantises, re-reading x while it is in the
// 50 MB L2.  Nothing needs zeroing: every partial is written each call.
//
// A code is clip(rint(x / s), +-127) of the IEEE quotient.  x * (1/s)
// rounded lies within 2^-15 of it, so it is used wherever it is not within
// 2^-12 of a half integer (a chunk holding such a value divides), and the
// rounding to an integer is the add of 1.5 x 2^23 (half to even, as rintf),
// whose low byte is the code: no conversion instruction (an SM runs
// conversions at a fraction of its rate of adds).
//
// The shared unpack: one chunk of 16 codes a thread (one 16-byte load),
// the row block's scale found once a chunk with 32-bit index math (per
// element only in a chunk that straddles two row blocks), fp8 decoded two
// at a time (exact into half, then float), 16-byte stores.
//
// fp8_pack and blocksparse_pack keep the first design: pass 1 folds
// per-thread-block partial absmaxes into the row block's absmax with
// atomicMax on the bits of the non-negative float (a max is exact in any
// order), pass 2 has every thread block derive the scale and quantise.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr long long kElemsPerBlock = 16384;   // pack slice per thread block
constexpr int kMaxSlices = 1024;              // thread blocks per row block

enum Quant { kInt8 = 0, kFp8 = 1, kBlocksparse = 2 };

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

// ---------------------------------------------------------------------------
// fp8 and blocksparse packs (first design: two passes over x)

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

// ---------------------------------------------------------------------------
// leaves: the int8 pack and the shared unpack

constexpr unsigned kVec = 16;      // elements a chunk: 16 codes, 16 bytes
constexpr int kMaxLeaves = 16;
constexpr int kClusterThreads = 512;  // a cluster block
constexpr int kRegChunks = 4;         // chunks a cluster thread holds, at most
constexpr int kPassThreads = 256;     // a two-pass block
constexpr int kUnpackThreads = 64;    // an unpack block (small: a page
                                      // leaf spreads over more SMs)
constexpr unsigned kBatch = 2;        // chunks a thread in a two-pass slice

// one leaf as the wrapper passes it (ctypes: 3 pointers, 5 int64)
struct LeafArg {
  const void* src;
  void* dst;
  float* scales;
  long long src_stride, dst_stride, numel, run_len, block_elems;
};

// n / d for every n < 2^31 as a multiply and a shift: m = ceil(2^(31+l)
// / d) with l = ceil(log2 d) fits 32 bits, and n * m / 2^(31+l) exceeds
// n / d by less than 1/d
struct Div {
  unsigned m, shift;
};

Div make_div(unsigned d) {
  unsigned l = 0;
  while ((1ull << l) < d) ++l;
  const unsigned long long p = 1ull << (31 + l);
  return {(unsigned)((p + d - 1) / d), 31 + l};
}

__device__ __forceinline__ unsigned fdiv(unsigned n, const Div& v) {
  return (unsigned)(((unsigned long long)n * v.m) >> v.shift);
}

// one leaf as a kernel reads it (element counts below 2^31)
struct Leaf {
  const void* src;     // pack: x; unpack: codes
  void* dst;           // pack: codes; unpack: out
  float* scales;       // one a row block: the pack writes, the unpack reads
  long long src_stride, dst_stride;   // elements from one run to the next
  unsigned numel, run_len, block_elems;
  unsigned first;      // row blocks of the leaves before this one
  Div run_div, block_div;             // / run_len, / block_elems
};

struct Leaves {
  Leaf l[kMaxLeaves];
};

// element e of a leaf side laid out as runs of run_len every stride
template <typename T>
__device__ __forceinline__ T* elem(T* base, long long stride,
                                   unsigned run_len, unsigned e) {
  const unsigned run = e / run_len;
  return base + run * stride + (e - run * run_len);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// where the chunk of n (<= 16) elements from leaf element e0 lies: its
// first element's offset on each side, and whether it is whole and inside
// one run (then it moves as 16-byte accesses wherever its address is
// 16-byte aligned)
struct Spot {
  long long src, dst;
  bool whole;
};

__device__ __forceinline__ Spot locate(const Leaf& L, unsigned e0,
                                       unsigned n) {
  const unsigned run = fdiv(e0, L.run_div), off = e0 - run * L.run_len;
  return {run * L.src_stride + off, run * L.dst_stride + off,
          n == kVec && off + kVec <= L.run_len};
}

// the pack's chunk at e0 (n valid elements; the rest zero, which no absmax
// sees) into registers: sizeof(T) 16-byte words
template <typename T>
__device__ __forceinline__ void load_chunk(const Leaf& L, unsigned e0,
                                           unsigned n, uint4* w) {
  const T* x = (const T*)L.src;
  const Spot at = locate(L, e0, n);
  const T* p = x + at.src;
  if (at.whole && aligned16(p)) {
#pragma unroll
    for (int k = 0; k < (int)sizeof(T); ++k) w[k] = __ldg((const uint4*)p + k);
  } else {
    T* t = (T*)w;
#pragma unroll
    for (unsigned j = 0; j < kVec; ++j)
      t[j] = j < n ? *elem(x, L.src_stride, L.run_len, e0 + j)
                   : from_float<T>(0.f);
  }
}

template <typename T>
__device__ __forceinline__ float chunk_absmax(const uint4* r) {
  if constexpr (sizeof(T) == 2) {        // bf16: a max is exact in bf16
    const __nv_bfloat162* h = (const __nv_bfloat162*)r;
    __nv_bfloat162 m = __habs2(h[0]);
#pragma unroll
    for (int k = 1; k < (int)kVec / 2; ++k) m = __hmax2(m, __habs2(h[k]));
    return fmaxf(__low2float(m), __high2float(m));
  } else {
    const T* t = (const T*)r;
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < (int)kVec; ++j) m = fmaxf(m, fabsf(to_float(t[j])));
    return m;
  }
}

// 1.5 x 2^23: for |r| < 2^22, r + kRound is r rounded to an integer, half
// to even (the add's own rounding), held in the float's low mantissa bits:
// its low byte is that integer's int8 code
constexpr float kRound = 12582912.0f;

// clip(r, +-127) rounded half to even, as the low byte of the result's bits
// (clipping first rounds the same as rounding first: the bounds are
// integers)
__device__ __forceinline__ float round_code(float r) {
  return fminf(fmaxf(r, -127.f), 127.f) + kRound;
}

// quantise a chunk (its words in registers) with scale s and store its n
// codes at e0 of dst.  A code is clip(rint(v / s), +-127) with v / s the
// IEEE quotient.  |v / s| <= 127 and a few ulps, so v * inv (inv = 1/s
// rounded) lies within 2^-15 of that quotient and rounds to the same
// integer unless it lies within 2^-12 of a half integer: a chunk with such
// a value takes the quotient itself
template <typename T>
__device__ __forceinline__ void store_codes(const Leaf& L, unsigned e0,
                                            unsigned n, const uint4* r,
                                            float s) {
  const T* x = (const T*)r;
  const float inv = 1.0f / s;
  float t[kVec];
  bool near_half = false;
#pragma unroll
  for (int j = 0; j < (int)kVec; ++j) {
    const float v = to_float(x[j]) * inv;
    t[j] = round_code(v);
    near_half |= fabsf(fminf(fmaxf(v, -127.f), 127.f) - (t[j] - kRound)) >
                 0.5f - 0x1p-12f;
  }
  if (near_half) {
#pragma unroll
    for (int j = 0; j < (int)kVec; ++j) t[j] = round_code(to_float(x[j]) / s);
  }
  uint32_t c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    c[k] = __byte_perm(__byte_perm(__float_as_uint(t[4 * k]),
                                   __float_as_uint(t[4 * k + 1]), 0x40),
                       __byte_perm(__float_as_uint(t[4 * k + 2]),
                                   __float_as_uint(t[4 * k + 3]), 0x40),
                       0x5410);
  int8_t* q = (int8_t*)L.dst;
  const Spot at = locate(L, e0, n);
  int8_t* p = q + at.dst;
  if (at.whole && aligned16(p)) {
    *(uint4*)p = make_uint4(c[0], c[1], c[2], c[3]);
  } else {                               // ragged: code by code
    const unsigned m = n;
#pragma unroll
    for (unsigned j = 0; j < kVec; ++j)
      if (j < m)
        *elem(q, L.dst_stride, L.run_len, e0 + j) =
            (int8_t)(c[j / 4] >> (8 * (j % 4)));
  }
}

// max over the block of N threads; the result is valid in warp 0
template <int N>
__device__ __forceinline__ float block_max(float m, float* warp_max) {
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = threadIdx.x < N / 32 ? warp_max[threadIdx.x] : 0.f;
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// int8 pack, a row block a cluster: grid (row blocks x cluster, leaves).
// A block holds its slice in registers, up to kRegChunks chunks a thread
template <typename T>
__global__ void __launch_bounds__(kClusterThreads)
    int8_pack_cluster_kernel(__grid_constant__ const Leaves a) {
  __shared__ float warp_max[kClusterThreads / 32];
  __shared__ float partial, absmax;
  cg::cluster_group cluster = cg::this_cluster();
  const Leaf& L = a.l[blockIdx.y];
  const unsigned cs = cluster.num_blocks(), rank = cluster.block_rank();
  const unsigned rb = blockIdx.x / cs;
  if (rb >= L.numel / L.block_elems) return;     // the whole cluster
  const unsigned chunks = (L.block_elems + kVec - 1) / kVec;
  const unsigned per = (chunks + cs - 1) / cs;
  const unsigned c0 = min(rank * per, chunks), c1 = min(c0 + per, chunks);
  const unsigned base = rb * L.block_elems;
  uint4 w[kRegChunks][sizeof(T)];
#pragma unroll
  for (int i = 0; i < kRegChunks; ++i) {
    const unsigned c = c0 + threadIdx.x + i * kClusterThreads;
    if (c < c1)
      load_chunk<T>(L, base + c * kVec, min(kVec, L.block_elems - c * kVec),
                    w[i]);
  }
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kRegChunks; ++i) {
    const unsigned c = c0 + threadIdx.x + i * kClusterThreads;
    if (c < c1) m = fmaxf(m, chunk_absmax<T>(w[i]));
  }
  m = block_max<kClusterThreads>(m, warp_max);
  if (threadIdx.x == 0) partial = m;
  cluster.sync();                  // every block's partial is published
  if (threadIdx.x < 32) {
    float v = threadIdx.x < cs
                  ? *cluster.map_shared_rank(&partial, threadIdx.x) : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (threadIdx.x == 0) absmax = v;
  }
  // this block reads no other block's shared memory after here
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  const float s = scale_of<kInt8>(absmax);
  if (rank == 0 && threadIdx.x == 0) L.scales[rb] = s;
#pragma unroll
  for (int i = 0; i < kRegChunks; ++i) {
    const unsigned c = c0 + threadIdx.x + i * kClusterThreads;
    if (c < c1)
      store_codes<T>(L, base + c * kVec, min(kVec, L.block_elems - c * kVec),
                     w[i], s);
  }
  // stay until the others have read this block's partial
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// int8 pack, larger row blocks, pass 1: the partial absmax of each slice
// (kPassThreads x kBatch chunks) into partials[(first + rb) * slices + sl]
template <typename T>
__global__ void __launch_bounds__(kPassThreads)
    int8_absmax_kernel(__grid_constant__ const Leaves a,
                       float* __restrict__ partials, unsigned slices) {
  __shared__ float warp_max[kPassThreads / 32];
  const Leaf& L = a.l[blockIdx.y];
  const unsigned rb = blockIdx.x / slices, sl = blockIdx.x % slices;
  if (rb >= L.numel / L.block_elems) return;
  const unsigned chunks = (L.block_elems + kVec - 1) / kVec;
  const unsigned base = rb * L.block_elems;
  uint4 w[kBatch][sizeof(T)];
  float m = 0.f;
#pragma unroll
  for (unsigned b = 0; b < kBatch; ++b) {
    const unsigned c = (sl * kBatch + b) * kPassThreads + threadIdx.x;
    if (c < chunks)
      load_chunk<T>(L, base + c * kVec,
                    min(kVec, L.block_elems - c * kVec), w[b]);
  }
#pragma unroll
  for (unsigned b = 0; b < kBatch; ++b) {
    const unsigned c = (sl * kBatch + b) * kPassThreads + threadIdx.x;
    if (c < chunks) m = fmaxf(m, chunk_absmax<T>(w[b]));
  }
  m = block_max<kPassThreads>(m, warp_max);
  if (threadIdx.x == 0) partials[(size_t)(L.first + rb) * slices + sl] = m;
}

// pass 2: the row block's scale from its partials, then quantise the slice
template <typename T>
__global__ void __launch_bounds__(kPassThreads)
    int8_quantise_kernel(__grid_constant__ const Leaves a,
                         const float* __restrict__ partials,
                         unsigned slices) {
  __shared__ float warp_max[kPassThreads / 32];
  __shared__ float absmax;
  const Leaf& L = a.l[blockIdx.y];
  const unsigned rb = blockIdx.x / slices, sl = blockIdx.x % slices;
  if (rb >= L.numel / L.block_elems) return;
  const unsigned chunks = (L.block_elems + kVec - 1) / kVec;
  const unsigned base = rb * L.block_elems;
  uint4 w[kBatch][sizeof(T)];
#pragma unroll
  for (unsigned b = 0; b < kBatch; ++b) {
    const unsigned c = (sl * kBatch + b) * kPassThreads + threadIdx.x;
    if (c < chunks)
      load_chunk<T>(L, base + c * kVec,
                    min(kVec, L.block_elems - c * kVec), w[b]);
  }
  float m = 0.f;
  const float* pr = partials + (size_t)(L.first + rb) * slices;
  for (unsigned i = threadIdx.x; i < slices; i += kPassThreads)
    m = fmaxf(m, pr[i]);
  m = block_max<kPassThreads>(m, warp_max);
  if (threadIdx.x == 0) absmax = m;
  __syncthreads();
  const float s = scale_of<kInt8>(absmax);
  if (sl == 0 && threadIdx.x == 0) L.scales[rb] = s;
#pragma unroll
  for (unsigned b = 0; b < kBatch; ++b) {
    const unsigned c = (sl * kBatch + b) * kPassThreads + threadIdx.x;
    if (c < chunks)
      store_codes<T>(L, base + c * kVec, min(kVec, L.block_elems - c * kVec),
                     w[b], s);
  }
}

// 16 payload bytes to floats: int8 one by one, fp8 two at a time (exact
// into half, then float)
template <typename P>
__device__ __forceinline__ void decode16(const uint4& w, float* v);
template <>
__device__ __forceinline__ void decode16<int8_t>(const uint4& w, float* v) {
  const int8_t* b = (const int8_t*)&w;
#pragma unroll
  for (int j = 0; j < (int)kVec; ++j) v[j] = (float)b[j];
}
template <>
__device__ __forceinline__ void decode16<__nv_fp8_e4m3>(const uint4& w,
                                                        float* v) {
  const __nv_fp8x2_storage_t* p = (const __nv_fp8x2_storage_t*)&w;
#pragma unroll
  for (int j = 0; j < (int)kVec / 2; ++j) {
    const float2 f =
        __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(p[j], __NV_E4M3)));
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// 16 floats to 16 output elements as sizeof(T) 16-byte stores at p
template <typename T>
__device__ __forceinline__ void store16(T* p, const float* v);
template <>
__device__ __forceinline__ void store16<float>(float* p, const float* v) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    ((float4*)p)[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                                  v[4 * k + 3]);
}
template <>
__device__ __forceinline__ void store16<__nv_bfloat16>(__nv_bfloat16* p,
                                                       const float* v) {
  uint32_t u[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    u[j] = *(const uint32_t*)&h;
  }
  ((uint4*)p)[0] = make_uint4(u[0], u[1], u[2], u[3]);
  ((uint4*)p)[1] = make_uint4(u[4], u[5], u[6], u[7]);
}

// the shared unpack: grid (chunk blocks, leaves), a chunk of 16 a thread
template <typename P, typename T>
__global__ void __launch_bounds__(kUnpackThreads)
    unpack_kernel(__grid_constant__ const Leaves a) {
  const Leaf& L = a.l[blockIdx.y];
  const unsigned chunks = (L.numel + kVec - 1) / kVec;
  for (unsigned c = blockIdx.x * kUnpackThreads + threadIdx.x; c < chunks;
       c += gridDim.x * kUnpackThreads) {
    const unsigned e0 = c * kVec, n = min(kVec, L.numel - e0);
    const Spot at = locate(L, e0, n);
    const uint8_t* q = (const uint8_t*)L.src;
    const uint8_t* pq = q + at.src;
    uint4 w;
    if (at.whole && aligned16(pq)) {
      w = __ldg((const uint4*)pq);
    } else {
      uint32_t b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (unsigned j = 0; j < kVec; ++j)
        if (j < n)
          b[j / 4] |= (uint32_t)*elem(q, L.src_stride, L.run_len, e0 + j)
                      << (8 * (j % 4));
      w = make_uint4(b[0], b[1], b[2], b[3]);
    }
    float v[kVec];
    decode16<P>(w, v);
    const unsigned b0 = fdiv(e0, L.block_div);
    if (fdiv(e0 + n - 1, L.block_div) == b0) {    // one row block's scale
      const float s = __ldg(L.scales + b0);
#pragma unroll
      for (int j = 0; j < (int)kVec; ++j) v[j] *= s;
    } else {                                      // straddles row blocks
#pragma unroll
      for (unsigned j = 0; j < kVec; ++j)
        if (j < n) v[j] *= __ldg(L.scales + fdiv(e0 + j, L.block_div));
    }
    T* out = (T*)L.dst;
    T* po = out + at.dst;
    if (at.whole && aligned16(po)) {
      store16<T>(po, v);
    } else {
#pragma unroll
      for (unsigned j = 0; j < kVec; ++j)
        if (j < n)
          *elem(out, L.dst_stride, L.run_len, e0 + j) = from_float<T>(v[j]);
    }
  }
}

// checks the wrapper's leaves and fills the kernel's; returns the largest
// row-block count and row block (elements) over the leaves, or 0 on a leaf
// the kernels cannot take
unsigned long long to_leaves(int n, const LeafArg* in, Leaves& a,
                             unsigned& max_rb, unsigned& max_block) {
  if (n < 1 || n > kMaxLeaves) return 0;
  unsigned first = 0;
  max_rb = max_block = 0;
  for (int i = 0; i < n; ++i) {
    const LeafArg& g = in[i];
    if (g.numel < 1 || g.numel >= (1ll << 31) || g.run_len < 1 ||
        g.block_elems < 1 || g.numel % g.run_len || g.numel % g.block_elems)
      return 0;
    Leaf& L = a.l[i];
    L.src = g.src;
    L.dst = g.dst;
    L.scales = g.scales;
    L.src_stride = g.src_stride;
    L.dst_stride = g.dst_stride;
    L.numel = (unsigned)g.numel;
    L.run_len = (unsigned)g.run_len;
    L.block_elems = (unsigned)g.block_elems;
    L.first = first;
    L.run_div = make_div(L.run_len);
    L.block_div = make_div(L.block_elems);
    const unsigned rbs = L.numel / L.block_elems;
    first += rbs;
    max_rb = rbs > max_rb ? rbs : max_rb;
    max_block = L.block_elems > max_block ? L.block_elems : max_block;
  }
  return first;
}

template <typename T>
int launch_int8_pack(const Leaves& a, int n, unsigned max_rb,
                     unsigned max_block, int cluster, unsigned slices,
                     float* partials, cudaStream_t s) {
  cudaError_t e;
  if (cluster > 0) {
    const unsigned chunks = (max_block + kVec - 1) / kVec;
    if ((chunks + cluster - 1) / cluster > kClusterThreads * kRegChunks)
      return (int)cudaErrorInvalidValue;   // the slice outgrows registers
    auto kern = int8_pack_cluster_kernel<T>;
    static bool non_portable = false;    // per instantiation, set once
    if (cluster > 8 && !non_portable) {
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return (int)e;
      non_portable = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(max_rb * (unsigned)cluster, (unsigned)n);
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kern, a);
    if (e != cudaSuccess) return (int)e;
  } else {
    if (slices < 1 || partials == nullptr) return (int)cudaErrorInvalidValue;
    const dim3 grid(max_rb * slices, (unsigned)n);
    int8_absmax_kernel<T><<<grid, kPassThreads, 0, s>>>(a, partials, slices);
    int8_quantise_kernel<T><<<grid, kPassThreads, 0, s>>>(a, partials,
                                                           slices);
  }
  return (int)cudaGetLastError();
}

template <typename P>
int launch_unpack(int dtype, const Leaves& a, int n, unsigned max_numel,
                  cudaStream_t s) {
  unsigned blocks =
      (max_numel + kVec * kUnpackThreads - 1) / (kVec * kUnpackThreads);
  if (blocks > 65535) blocks = 65535;
  const dim3 grid(blocks, (unsigned)n);
  if (dtype == 0)
    unpack_kernel<P, float><<<grid, kUnpackThreads, 0, s>>>(a);
  else if (dtype == 1)
    unpack_kernel<P, __nv_bfloat16><<<grid, kUnpackThreads, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// Packs (fp8, blocksparse).  dtype: 0 float32, 1 bfloat16 (of x).  x:
// (rows, cols) row-major; rows % block_rows == 0; q: fp8 or int8 bytes
// (rows, cols); scales: f32 (rows / block_rows); amax: scratch of
// rows / block_rows 32-bit words.
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

// The int8 pack over n leaves (src x, dst codes, scales written).  dtype:
// 0 float32, 1 bfloat16 (of x).  cluster > 0: a row block a cluster of
// that many blocks; cluster 0: two passes of `slices` blocks a row block,
// with partials a scratch of (row blocks over all leaves) x slices floats.
extern "C" int int8_pack_leaves(int dtype, int n, const void* leaves,
                                int cluster, int slices, void* partials,
                                void* stream) {
  Leaves a = {};
  unsigned max_rb, max_block;
  if (!to_leaves(n, (const LeafArg*)leaves, a, max_rb, max_block) ||
      cluster < 0 || cluster > 16 || slices < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_int8_pack<float>(a, n, max_rb, max_block, cluster,
                                   (unsigned)slices, (float*)partials, s);
  if (dtype == 1)
    return launch_int8_pack<__nv_bfloat16>(a, n, max_rb, max_block, cluster,
                                           (unsigned)slices,
                                           (float*)partials, s);
  return (int)cudaErrorInvalidValue;
}

// The shared unpack over n leaves (src codes, dst out, scales read).
// payload: 0 int8, 1 float8_e4m3fn; dtype: 0 float32, 1 bfloat16 (of out).
extern "C" int unpack_leaves(int payload, int dtype, int n,
                             const void* leaves, void* stream) {
  Leaves a = {};
  unsigned max_rb, max_block;
  if (!to_leaves(n, (const LeafArg*)leaves, a, max_rb, max_block))
    return (int)cudaErrorInvalidValue;
  unsigned max_numel = 0;
  for (int i = 0; i < n; ++i)
    max_numel = a.l[i].numel > max_numel ? a.l[i].numel : max_numel;
  cudaStream_t s = (cudaStream_t)stream;
  if (payload == 0) return launch_unpack<int8_t>(dtype, a, n, max_numel, s);
  if (payload == 1)
    return launch_unpack<__nv_fp8_e4m3>(dtype, a, n, max_numel, s);
  return (int)cudaErrorInvalidValue;
}
