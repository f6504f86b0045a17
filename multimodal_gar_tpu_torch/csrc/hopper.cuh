// Hopper (sm_90a) building blocks of the redesigned bf16 kernels
// (csrc/stem_conv.cu: mgar_stem_conv_bf16, csrc/gather_wgmma.cuh, kernels
// C and D in csrc/subm_conv.cu and csrc/sparse_wgrad.cu): mbarriers,
// tensor (TMA) copies into shared memory, the cp.async arrive on an
// mbarrier, the async-proxy fence, the warpgroup matrix multiply
// (wgmma.mma_async, bf16 in, float32 accumulators), thread-block cluster
// barriers and distributed shared-memory stores, and the host's tensor
// map encoder reached through the runtime (no -lcuda on the nvcc line).
//
// Shared-memory operands of wgmma, as the kernels lay them out (each
// checked on the card against a plain product):
//  - K-major without swizzle ("interleave"; the sparse core's A): core
//    matrices of 8 rows (along M) of 16 bytes (8 values along K), 128
//    contiguous bytes; the descriptor's leading byte offset (LBO) is the
//    distance between core matrices neighbouring along K, its stride byte
//    offset (SBO) that between those neighbouring along M.
//  - N-major with the 32-, 64- or 128-byte swizzle (every B: rows along K
//    of N values, the row's width the swizzle's), as TMA writes it with
//    the same swizzle: SBO is the distance between groups of 8 K rows, the
//    swizzle atom; LBO (between atoms along N) is unused at N <= 64.
//    Rows written by cp.async take the swizzle by hand: the 16-byte piece
//    j of row p of W bytes lands at piece j ^ ((p W / 128) & (W / 16 - 1)),
//    the address bits TMA swizzles.
//  - M-major A (wgmma's transposed A, kernel D's dOut rows): as an N-major
//    B with M in place of N, 64 values a row, the 128-byte swizzle.
//
// The accumulators of m64nNk16 (f32): warp w of the warpgroup holds rows
// 16 w .. 16 w + 15; with g = lane / 4 and t = lane % 4, d[4 j + i] is
// row 16 w + g + 8 (i / 2), column 8 j + 2 t + (i % 2). An A operand from
// registers has mma.sync's m16n8k16 A fragment per warp (mma_bf16.cuh).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mgar {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the block's other threads and
// to the async proxy; the caller follows it with __syncthreads().
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival that also expects `bytes` of bulk or tensor copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival once every cp.async this thread issued before it has landed
// (counted in the barrier's arrival count: .noinc).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(bar))
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed. A wait
// past about 2^34 cycles (seconds) can only be a fault: it traps, so that
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// Orders this thread's (and what it has observed of other threads')
// generic-proxy writes to shared memory, cp.async included, before its
// later async-proxy reads (wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- tensor copies (TMA) -----------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Descriptor of a canonical operand at `smem`; lbo and sbo in bytes as the
// note above says; `layout` 0 without swizzle (16-byte aligned), 1, 2, 3
// for the 128-, 64- and 32-byte swizzles (aligned to 8 rows of the swizzle
// width).
__device__ __forceinline__ uint64_t gmma_desc(const void* smem, unsigned lbo,
                                              unsigned sbo,
                                              unsigned layout = 0) {
  const uint64_t a = smem_u32(smem);
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma's fence, commit and wait.
template <int N>
__device__ __forceinline__ void pin_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MGAR_D8(o)                                                       \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),       \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d (64 x N, float32) += A (64 x 16) * B (16 x N), both from shared memory;
// A K-major, B N-major (TRANS_B 1).
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<16, 1>(float (&d)[8], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 1;\n"
      "}\n"
      : MGAR_D8(0)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<32, 1>(float (&d)[16], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 1;\n"
      "}\n"
      : MGAR_D8(0), MGAR_D8(8)
      : "l"(da), "l"(db), "r"(1));
}

#define MGAR_N64_REGS                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

template <>
__device__ __forceinline__ void wgmma_ss<64, 1>(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MGAR_N64_REGS
      ", %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : MGAR_D8(0), MGAR_D8(8), MGAR_D8(16), MGAR_D8(24)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, float32) += A (64 x 16, registers: a[4] per thread in the
// m16n8k16 A fragment of its warp's 16 rows) * B (16 x 64, shared memory,
// N-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const unsigned (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MGAR_N64_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : MGAR_D8(0), MGAR_D8(8), MGAR_D8(16), MGAR_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x N, float32) = A (64 x 16) * B (16 x N) + (scale_d ? d : 0), both
// from shared memory: A K-major (TRANS_A 0) or M-major (TRANS_A 1, laid
// out as an N-major B is), B N-major. scale_d 0 starts a fresh sum.
template <int N, int TRANS_A>
__device__ __forceinline__ void wgmma_ss_bn(float (&d)[N / 2], uint64_t da,
                                            uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma widths");
  if constexpr (N == 16) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, 1;\n"
        "}\n"
        : MGAR_D8(0)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p, 1, 1, %19, 1;\n"
        "}\n"
        : MGAR_D8(0), MGAR_D8(8)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MGAR_N64_REGS
        ", %32, %33, p, 1, 1, %35, 1;\n"
        "}\n"
        : MGAR_D8(0), MGAR_D8(8), MGAR_D8(16), MGAR_D8(24)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A));
  }
}

#undef MGAR_N64_REGS
#undef MGAR_D8

// ---- thread-block clusters ------------------------------------------------

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// Every thread of every block of the cluster arrives, then waits: the
// shared-memory writes before the arrival are visible to the cluster's
// reads after the wait. Warp-uniform (.aligned).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// An arrival that orders nothing: it only tells the cluster this block has
// started (its shared memory may then be written by the others, after the
// matching cluster_wait).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p` (in this block's shared memory) in
// the block of cluster rank `rank`.
__device__ __forceinline__ unsigned cluster_map(const void* p,
                                                unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// Stores into another block's shared memory (distributed shared memory):
// one float, or two at an 8-byte aligned address.
__device__ __forceinline__ void st_cluster_f32(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}
__device__ __forceinline__ void st_cluster_f2(unsigned addr, float v0,
                                              float v1) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(v0), "f"(v1)
               : "memory");
}

// ---- host: tensor maps --------------------------------------------------------

typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime once.
inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first), `strides` in
// bytes for dimensions 1 .. rank - 1, zeros out of bounds. Returns 0 on
// success, else a CUDA error code.
inline int encode_bf16_map(
    CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
    const cuuint64_t* strides, const cuuint32_t* box,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
      const_cast<void*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Streaming multiprocessors of the device (persistent grids, tile sizes),
// read once: the port runs on one kind of card.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

}  // namespace mgar
