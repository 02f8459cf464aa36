// Output-stationary GEMM for sm_90a: a tensor-core path for bfloat16 and a
// CUDA-core path for float32.
//
// Replaces the reference's Pallas TPU kernel src/repro/kernels/gemm_os.py:61
// `gemm_os` (pallas_call at :71, body `_gemm_kernel` at :28):
//     out (M, N) = x (M, K) @ w (K, N)
// with a float32 accumulator that stays resident while K streams through,
// cast to the input type once at the end -- the paper's output-stationary
// dataflow: every output element is written exactly once.
//
// The TPU kernel walks a grid (M/bm, N/bn, K/bk) with K innermost and
// sequential, the (bm, bn) accumulator in VMEM scratch.  Here one thread
// block owns one (BM x BN) output tile and loops over K itself (the
// sequential grid axis becomes that loop); the blocks run in parallel on
// the 132 SMs.
//
// Bound.  2MNK operations against (MK + KN + MN) elements moved: at the
// zamba2-2.7b MLP shapes (4096 tokens, 2560 x 10240 and back, bf16) that is
// 215 GFLOP, 0.22 ms at the bf16 tensor-core peak of 989 TFLOP/s, while the
// 159 MB move in 0.05 ms at 3.35 TB/s: operations bound it.
//
// bfloat16: `gemm_wgmma_bf16_kernel`, warpgroup MMAs fed by TMA.
//   A block is one producer warpgroup and BM/64 consumer warpgroups.  K
//   arrives in a ring of `stages` bk-deep stages in shared memory; each
//   stage holds bk/64 sub-slabs, and each sub-slab one (BM x 64) box of x
//   and BN/64 (64 x 64) boxes of w, every box one TMA copy in the 128-byte
//   swizzle that wgmma reads.  A stage has a full mbarrier (the producer's
//   expected bytes; TMA completes it) and an empty one (one arrival per
//   consumer warp).  One thread of the producer keeps the copies in flight;
//   each consumer warpgroup waits for a stage, issues bk/16
//   wgmma.m64nBNk16 (bf16 in, f32 accumulate) on its 64 rows, and keeps
//   them in flight while it waits for the previous stage's, whose slot it
//   then releases.  x is K-major (the usual A operand); w is
//   (K, N) row-major, so B is N-major: its boxes run along N and wgmma
//   reads them in its transposed-B mode -- w is never copied transposed.
//   The f32 accumulator (BN/2 registers a thread) stays in registers over
//   the whole K loop and is cast to bf16 and stored once.  The producer
//   gives registers up (setmaxnreg) so that two consumers can hold
//   128 accumulators each at BN = 256.  Tiles: BM in {64, 128}, BN in {64,
//   128, 256}, bk a multiple of 64 (one swizzled 128-byte row of x).
// float32: `gemm_simt_f32_kernel`, FMAs on the CUDA cores.  Each thread
//   keeps an 8 x 8 sub-tile of the accumulator in registers for the whole
//   K loop: rows {4 ty .. 4 ty + 3} and the same four rows BM/2 further,
//   columns likewise (so a warp's shared-memory reads of w fall on distinct
//   banks).  K arrives in bk-deep slabs copied with 16-byte cp.async,
//   double-buffered when two slabs fit in the 227 KB a block may hold, one
//   at a time otherwise; rows padded by 16 bytes.  No TF32: it keeps about
//   3 decimal digits, and float32 callers are held to 1e-5 of the output.
//   Tiles: BM, BN in {64, 128} (BM/8 x BN/8 threads).
// PERF.md has the times on the card.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr size_t kMaxSmem = 232448;     // dynamic shared memory a block

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
namespace simt {

constexpr int kTM = 8, kTN = 8;         // outputs per thread (registers)
constexpr int kPadBytes = 16;           // row padding of the shared slabs

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load2(const float* p, float* v) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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

template <int BM, int BN>
size_t smem_bytes(int bk, int stages) {
  constexpr int pad = kPadBytes / sizeof(float);
  return (size_t)stages *
         ((size_t)BM * (bk + pad) + (size_t)bk * (BN + pad)) * sizeof(float);
}

// x (M, K), w (K, N), out (M, N), all row-major float32; grid (N/BN,
// M/BM), BM/8 x BN/8 threads, smem_bytes<BM, BN>(bk, stages) dynamic; at
// most 128 registers a thread, so two 256-thread blocks share a SM.
template <int BM, int BN>
__global__ void __launch_bounds__((BM / kTM) * (BN / kTN), 2)
gemm_simt_f32_kernel(const float* __restrict__ x,
                     const float* __restrict__ w, float* __restrict__ out,
                     int N, int K, int bk, int stages) {
  constexpr int TX = BN / kTN, NT = (BM / kTM) * TX;
  constexpr int E = 4;                          // floats a 16-byte copy
  constexpr int KA = 2;                         // k-steps an 8-byte x read
  constexpr int PAD = kPadBytes / sizeof(float);
  constexpr int ldb = BN + PAD;                 // w slab row stride
  const int lda = bk + PAD;                     // x slab row stride
  const int stage = BM * lda + bk * ldb;        // floats a slab pair
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float* xb = x + (size_t)m0 * K;
  const float* wb = w + n0;
  const int n_k = K / bk;

  // slab t of x and w into buffer s: neighbouring threads copy
  // neighbouring 16-byte chunks of a row
  auto load_slab = [&](int t, int s) {
    float* As = smem + (size_t)s * stage;
    float* Bs = As + BM * lda;
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
    const float* As = smem + (size_t)s * stage;
    const float* Bs = As + BM * lda;
#pragma unroll 1
    for (int k = 0; k < bk; k += KA) {
      float a[kTM][KA];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int row = (i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3);
        load2(As + row * lda + k, a[i]);
      }
#pragma unroll
      for (int kk = 0; kk < KA; ++kk) {
        float b[kTN];
        const float* brow = Bs + (k + kk) * ldb + tx * 4;
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

  // the accumulator leaves the registers once
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + (i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3);
    float* o = out + (size_t)row * N + n0 + tx * 4;
    store4(o, acc[i]);
    store4(o + BN / 2, acc[i] + 4);
  }
}

template <int BM, int BN>
int launch(const void* x, const void* w, void* out, int M, int N, int K,
           int bk, int stages, cudaStream_t stream) {
  const size_t smem = smem_bytes<BM, BN>(bk, stages);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // the opt-in above 48 KB, once per instantiation (never inside a
  // CUDA-graph capture after a first eager call)
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_simt_f32_kernel<BM, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid(N / BN, M / BM);
  gemm_simt_f32_kernel<BM, BN><<<grid, (BM / kTM) * (BN / kTN), smem,
                                 stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), N, K, bk, stages);
  return (int)cudaGetLastError();
}

int dispatch(const void* x, const void* w, void* out, int M, int N, int K,
             int bm, int bn, int bk, int stages, cudaStream_t s) {
  if (stages != 1 && stages != 2) return (int)cudaErrorInvalidValue;
  if (bm == 64 && bn == 64)
    return launch<64, 64>(x, w, out, M, N, K, bk, stages, s);
  if (bm == 64 && bn == 128)
    return launch<64, 128>(x, w, out, M, N, K, bk, stages, s);
  if (bm == 128 && bn == 64)
    return launch<128, 64>(x, w, out, M, N, K, bk, stages, s);
  if (bm == 128 && bn == 128)
    return launch<128, 128>(x, w, out, M, N, K, bk, stages, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
namespace tc {

constexpr int kBox = 64;                // elements along a box's 128-byte row
constexpr int kBoxBytesW = kBox * kBox * 2;   // one (64 x 64) box of w
constexpr int kMaxStages = 8;
constexpr int kTransB = 1;              // w is N-major: transposed-B mode

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// spin until the barrier's phase with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one 2-D box of the tensor map to shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all >> 4)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (64 x n, f32, n/2 registers a thread) += A (64 x 16, K-major,
// descriptor da) @ B (16 x n, N-major, descriptor db), bf16 operands
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 64) wgmma_n64(d, da, db);
  else if constexpr (BN == 128) wgmma_n128(d, da, db);
  else wgmma_n256(d, da, db);
}

__host__ __device__ constexpr uint32_t sub_bytes(int bm, int bn) {
  return (uint32_t)(bm + bn) * kBox * 2;   // w boxes, then the x box
}

// Shared memory: 1 KB of barriers (full[s] at +8 s, empty[s] at +8
// (kMaxStages + s)), then `stages` stages of bk/64 sub-slabs, each the
// BN/64 boxes of w (64 k-rows of 128 bytes) followed by the (BM x 64) box
// of x; every box starts on 1024 bytes, as the swizzle needs.
// x (M, K) and w (K, N) come as tensor maps, out (M, N) row-major bf16;
// grid (N/BN, M/BM), 128 (BM/64 + 1) threads.
template <int BM, int BN>
__global__ void __launch_bounds__(128 * (BM / 64 + 1), 1)
gemm_wgmma_bf16_kernel(__grid_constant__ const CUtensorMap tx,
                       __grid_constant__ const CUtensorMap tw,
                       __nv_bfloat16* __restrict__ out, int N, int K, int bk,
                       int stages) {
  constexpr int NC = BM / 64;               // consumer warpgroups
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base, empty0 = base + 8 * kMaxStages;
  const uint32_t tiles = base + 1024;
  const int subs = bk / kBox;
  const uint32_t stage_bytes = subs * sub_bytes(BM, BN);
  const int n_k = K / bk;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wg = threadIdx.x / 128;         // 0 producer, 1..NC consumers

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    if constexpr (NC == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    }
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % stages;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((kt / stages) & 1) ^ 1);
        mbar_expect_tx(full, stage_bytes);
        const uint32_t st = tiles + s * stage_bytes;
        for (int j = 0; j < subs; ++j) {
          const int k = kt * bk + j * kBox;
          const uint32_t sb = st + j * sub_bytes(BM, BN);
#pragma unroll
          for (int c = 0; c < BN / kBox; ++c)
            tma_load(sb + c * kBoxBytesW, &tw, n0 + c * kBox, k, full);
          tma_load(sb + BN * kBox * 2, &tx, k, m0, full);
        }
      }
    }
  } else {
    // consumers: warpgroup wg - 1 owns rows 64 (wg - 1) .. + 63 of the tile
    if constexpr (NC == 2) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    }
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const uint32_t a_off = BN * kBox * 2 + (wg - 1) * 64 * kBox * 2;
    const int lane = threadIdx.x % 32;
    for (int ks = 0; ks < n_k; ++ks) {
      const int s = ks % stages;
      mbar_wait(full0 + 8 * s, (ks / stages) & 1);
      const uint32_t st = tiles + s * stage_bytes;
      wgmma_fence();
      for (int j = 0; j < subs; ++j) {
        const uint32_t sb = st + j * sub_bytes(BM, BN);
#pragma unroll
        for (int kk = 0; kk < kBox / 16; ++kk) {
          // x: K-major rows of 128 bytes, 8-row groups 1024 bytes apart,
          // a k16 step 32 bytes along the row; w: N-major, 64-wide n
          // boxes kBoxBytesW apart, 8-deep k groups 1024 bytes apart, a
          // k16 step 16 rows (2048 bytes) down
          wgmma_tile<BN>(acc, desc(sb + a_off + kk * 32, 16, 1024),
                         desc(sb + kk * 2048, kBoxBytesW, 1024));
        }
      }
      wgmma_commit();
      if (stages > 1) {
        // this stage's products stay in flight while the next stage's
        // are issued; the previous stage's are done and its slot is free
        wgmma_wait<1>();
        if (ks > 0 && lane == 0)
          mbar_arrive(empty0 + 8 * ((ks + stages - 1) % stages));
      } else {
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }
    }
    wgmma_wait<0>();
    // the accumulator leaves the registers once, cast to bf16: d[4j + e]
    // holds row r (+8 for e >= 2), column 8j + 2 (lane % 4) + (e & 1)
    const int warp = (threadIdx.x % 128) / 32;
    const int row = m0 + (wg - 1) * 64 + warp * 16 + lane / 4;
    __nv_bfloat16* o = out + (size_t)row * N + n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(o + (size_t)8 * N + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

size_t smem_bytes(int bm, int bn, int bk, int stages) {
  return 2048 + (size_t)stages * (bk / kBox) * sub_bytes(bm, bn);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is
// looked up in the libcuda the runtime already loaded, so nothing links
// against it
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib)
      fn = reinterpret_cast<EncodeTiled>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a (rows x cols) row-major bf16 matrix as boxes of (box_rows x 64)
bool encode(CUtensorMap* map, const void* p, int rows, int cols,
            int box_rows) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBox, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN>
int launch(const void* x, const void* w, void* out, int M, int N, int K,
           int bk, int stages, cudaStream_t stream) {
  const size_t smem = smem_bytes(BM, BN, bk, stages);
  if (stages < 1 || stages > kMaxStages || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;     // once per instantiation, as above
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_wgmma_bf16_kernel<BM, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  CUtensorMap tx, tw;
  if (!encode(&tx, x, M, K, BM) || !encode(&tw, w, K, N, kBox))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, M / BM);
  gemm_wgmma_bf16_kernel<BM, BN><<<grid, 128 * (BM / 64 + 1), smem,
                                   stream>>>(
      tx, tw, static_cast<__nv_bfloat16*>(out), N, K, bk, stages);
  return (int)cudaGetLastError();
}

int dispatch(const void* x, const void* w, void* out, int M, int N, int K,
             int bm, int bn, int bk, int stages, cudaStream_t s) {
  if (bk % kBox) return (int)cudaErrorInvalidValue;
#define GEMM_TC_TILE(BM_, BN_)                                         \
  if (bm == BM_ && bn == BN_)                                          \
    return launch<BM_, BN_>(x, w, out, M, N, K, bk, stages, s);
  GEMM_TC_TILE(64, 64) GEMM_TC_TILE(64, 128) GEMM_TC_TILE(64, 256)
  GEMM_TC_TILE(128, 64) GEMM_TC_TILE(128, 128) GEMM_TC_TILE(128, 256)
#undef GEMM_TC_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// dtype: 0 float32 (CUDA cores: bm, bn in {64, 128}, bk a multiple of 16,
// stages 1 or 2), 1 bfloat16 (tensor cores: bm in {64, 128}, bn in {64,
// 128, 256}, bk a multiple of 64, stages 1 .. 8); x, w and out share it.
// The blocks divide M, N and K; x, w, out 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
extern "C" int gemm_os(int dtype, const void* x, const void* w, void* out,
                       int M, int N, int K, int bm, int bn, int bk,
                       int stages, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      bk % 16 || M % bm || N % bn || K % bk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return simt::dispatch(x, w, out, M, N, K, bm, bn, bk, stages, s);
  if (dtype == 1)
    return tc::dispatch(x, w, out, M, N, K, bm, bn, bk, stages, s);
  return (int)cudaErrorInvalidValue;
}
