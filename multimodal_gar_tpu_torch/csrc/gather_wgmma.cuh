// The bf16 gather-GEMM core on wgmma: the forwards of the sparse convs at
// model.dtype bfloat16, csrc/window_conv.cu: mgar_window_conv_bf16 (rows
// from the packed x-window maps) and csrc/subm_conv.cu: mgar_subm_conv_bf16
// (rows from explicit (R, 27) index maps). Kernel C (the bf16 data
// gradient, csrc/subm_conv.cu) runs the same ring with per-tap sums split
// over a thread-block cluster.
//
// Computes, for output row r,
//   out[r] = bf16(sum_k W[k]^T table[src(r, k)])
// over the 27 taps of a 3x3x3 kernel, W (27, C, D) bf16 in (dz, dy, dx)
// scan order, a bf16 table of M rows: every product exact in float32, the
// sums float32, rounded once; src(r, k) outside [0, M) is an absent tap and
// adds nothing. Each accumulator takes its chunks in one fixed order, so
// two runs give the same bits.
//
// What bounds it on the card: the row gathers and their latency (up to 27
// rows of 32-128 bytes per output row at data-dependent addresses; the
// bytes alone are 1-2 us a layer at 3.35 TB/s), and the weights, 27 C D
// bf16 (221 KB at C = D = 64) that every tile brings from L2. The products
// are few (27 C D per row) and the tensor cores take them at up to 989
// TFLOP/s. A layer is a few microseconds of work, so fixed costs count:
// the launch, a block's start (its index words, its tap masks) and the
// first chunk's latency before the pipeline runs.
//
// Design:
//  - A block is one 64-row tile: one consumer warpgroup and one producer
//    warpgroup (grid: tiles x batch items). Its index words go to shared
//    memory, and all 256 threads OR which taps the tile's rows use.
//  - K runs in chunks of 64 values: G = 64 / C taps a chunk (4, 2, 1 at
//    C = 16, 32, 64; the last chunk at C = 16 and 32 holds the taps that
//    are left and zeros). A chunk none of the tile's rows uses is skipped:
//    no weights, no gathers, no wgmma. Within a chunk an absent (row, tap)
//    is stored as zeros, without a read; which rows are gathered is not
//    driven by a per-row list.
//  - A ring of GW_STAGES = 3 stages, one chunk each: the chunk's 64 x 64
//    gathered values in wgmma's K-major canonical A layout (no swizzle),
//    and its 64 x D weight rows in the N-major B layout swizzled at the
//    row's width (2 D bytes: the 32-, 64- or 128-byte swizzle). The
//    producer gathers present taps with 16-byte cp.async, 8 lanes to a
//    core matrix (128 contiguous bytes of shared memory), and stores zeros
//    for absent ones (a zero-filling cp.async costs as much as a copy);
//    each of its threads then arrives on the stage's full mbarrier once
//    for its stores and once through cp.async.mbarrier.arrive.noinc (an
//    arrival that lands with its copies); one of them loads the weights by
//    TMA, one box of 64 rows x D columns of a 2-D tensor map over W
//    (27 C, D) (zeros past row 27 C), counted on the same barrier as
//    bytes. Per-stage full and empty mbarriers; no block barrier after the
//    tap masks.
//  - The consumer waits on the stage's full barrier, fences the async
//    proxy (the gathers are generic-proxy writes that wgmma reads), issues
//    the chunk's 4 wgmma m64nDk16 (both operands from shared memory, B
//    N-major), keeps one group in flight and releases the stage before it
//    on its empty barrier. float32 accumulators: D / 2 registers a thread.
//    The warp index and the tap mask are broadcast from lane 0
//    (__shfl_sync), so that ptxas sees the wgmma paths as non-divergent:
//    otherwise it serializes the wgmmas (its warning C7520).
//  - The store rounds each sum to bf16, two neighbouring columns a 32-bit
//    word.
//  - The wide pairs (UNetV2's decoder, the residual encoders, the pillar
//    backbone's last stage): past C = 64 a tap spans C / 64 chunks, each
//    the tap's next 64 columns, skipped with its tap; past D = 64 the
//    output's 64-column slices go to the grid's z (the weights' box the
//    slice's 64 columns, the 128-byte swizzle), so that every block keeps
//    the 64-wide pairs' stage, accumulators and shared memory, and each
//    slice gathers the rows again. At C, D <= 64 the code is the one
//    before.
//  Shared memory: 3 x (8 KB + 128 D) plus the tile's index words, 33-56
//  KB: four blocks share an SM (more blocks beat a deeper ring).
//  Tried and measured against this on the card, each no faster: boxes of
//  8 weight columns without swizzle (far slower on the 64-wide layers: TMA
//  moves a box row by row), weights by cp.async,
//  zero-filling cp.async for absent taps, 128-row tiles on two consumer
//  warpgroups, 4 or 6 stages (three or two blocks an SM), chunks of 128
//  values, a persistent grid that
//  prepares the next tile's masks while the ring runs on, and one arrival
//  a producer warp after a lagged cp.async.wait_group in place of one a
//  thread.
#pragma once

#include "cp_async.cuh"
#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace mgar {

constexpr int GW_TAPS = 27;
constexpr int GW_KC = 64;              // K values per chunk
constexpr int GW_STAGES = 3;
constexpr int GW_ROWS = 64;            // rows a tile
constexpr int GW_PRODUCERS = 128;      // producer threads
constexpr int GW_THREADS = 128 + GW_PRODUCERS;  // and a consumer warpgroup
constexpr int GW_BLOCKS_PER_SM = 4;

template <int C, int D>
struct GatherWgmma {
  static constexpr int G = C > GW_KC ? 1 : GW_KC / C;       // taps a chunk
  static constexpr int CPT = C > GW_KC ? C / GW_KC : 1;     // chunks a tap
  static constexpr int CHUNKS = (GW_TAPS + G - 1) / G * CPT;
  static constexpr int DS = D > 64 ? 64 : D;  // output columns a block
  static constexpr int D_BLOCKS = D / DS;     // slices on the grid's z
  static constexpr int A_BYTES = GW_ROWS * GW_KC * 2;
  static constexpr int B_BYTES = GW_KC * DS * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BAR_OFFSET = GW_STAGES * STAGE_BYTES;
  static constexpr int MASK_OFFSET = BAR_OFFSET + 2 * GW_STAGES * 8;
  // the ring, its barriers and the tap mask; the caller's index words
  // follow
  static constexpr int TILE_BYTES = MASK_OFFSET + 16;
  static_assert(C == 16 || C == 32 || C == 64 || C == 128 || C == 256,
                "bf16 input widths");
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                "bf16 output widths");
  static_assert(STAGE_BYTES % 1024 == 0, "stages aligned for the swizzle");
};

// The tile's output rows r0 .. r0 + 63 below R, computed and stored.
// `smem` is the block's dynamic shared memory (1024-byte aligned), with the
// caller's index words at GatherWgmma::TILE_BYTES, written and followed by
// a __syncthreads(); src_row(row, tap) is the table row feeding tile row
// `row` at `tap` (anything outside [0, M) where the tap is absent). wmap
// is a tensor map over W (27 C, D) with boxes of 64 rows x min(D, 64)
// columns, swizzled at that width (encode_weight_map). Past D = 64 the
// block computes the output columns of slice blockIdx.z.
template <int C, int D, class SrcRow>
__device__ __forceinline__ void gather_wgmma_tile(
    const __nv_bfloat16* __restrict__ feat, int M, const CUtensorMap* wmap,
    unsigned char* smem, SrcRow src_row, __nv_bfloat16* __restrict__ out,
    int r0, int R) {
  using TL = GatherWgmma<C, D>;
  constexpr int DS = TL::DS;
  const int d0 = TL::D_BLOCKS == 1 ? 0 : (int)blockIdx.z * DS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TL::BAR_OFFSET);
  uint64_t* empty = full + GW_STAGES;
  unsigned* mask = reinterpret_cast<unsigned*>(smem + TL::MASK_OFFSET);
  if (tid == 0) {
    for (int s = 0; s < GW_STAGES; ++s) {
      // each producer's stores and copies, and the TMA
      mbar_init(&full[s], 2 * GW_PRODUCERS + 1);
      mbar_init(&empty[s], 4);        // one arrival per consumer warp
    }
    *mask = 0u;
    mbar_init_fence();
  }
  __syncthreads();

  // which taps the tile's rows use
  unsigned present = 0u;
  for (int i = tid; i < GW_ROWS * GW_TAPS; i += GW_THREADS) {
    const int row = i / GW_TAPS;
    const int tap = i - row * GW_TAPS;
    const int src = src_row(row, tap);
    if (src >= 0 && src < M) present |= 1u << tap;
  }
  present = __reduce_or_sync(0xffffffffu, present);
  if (lane == 0 && present) atomicOr(mask, present);
  __syncthreads();
  const unsigned taps = __shfl_sync(0xffffffffu, *mask, 0);
  auto next_chunk = [&](int ch) {
    if constexpr (TL::CPT > 1) {
      while (ch < TL::CHUNKS && !((taps >> (ch / TL::CPT)) & 1u)) ++ch;
    } else {
      while (ch < TL::CHUNKS &&
             !((taps >> (ch * TL::G)) & ((1u << TL::G) - 1u)))
        ++ch;
    }
    return ch;
  };

  if (warp >= 4) {
    // producer warpgroup: per present chunk, its weights and gathers
    const int ptid = tid - 128;
    int n = 0;
    for (int ch = next_chunk(0); ch < TL::CHUNKS;
         ch = next_chunk(ch + 1), ++n) {
      const int s = n % GW_STAGES;
      mbar_wait(&empty[s], ((n / GW_STAGES) & 1) ^ 1);
      unsigned char* stage = smem + s * TL::STAGE_BYTES;
      __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(stage);
      const int tap0 = ch * TL::G;
      if (ptid == 0) {
        mbar_arrive_expect_tx(&full[s], TL::B_BYTES);
        // the chunk's 64 rows of W (27 C, D), columns d0 ..
        tma_load_2d(stage + TL::A_BYTES, wmap, d0, ch * GW_KC, &full[s]);
      }
      // core matrix (row group rg, k group kg) at (rg * 8 + kg) * 128 B
      for (int i = ptid; i < GW_ROWS * 8; i += GW_PRODUCERS) {
        const int rlo = i & 7;
        const int kg = (i >> 3) & 7;
        const int rg = i >> 6;
        int tap, col;
        if constexpr (TL::CPT > 1) {
          // one tap a chunk: its columns (ch % CPT) * 64 ..
          tap = ch / TL::CPT;
          col = (ch % TL::CPT) * GW_KC + kg * 8;
        } else {
          tap = tap0 + kg / (C / 8);
          col = (kg % (C / 8)) * 8;
        }
        const int src = tap < GW_TAPS ? src_row(rg * 8 + rlo, tap) : -1;
        __nv_bfloat16* dst = a_s + (rg * 8 + kg) * 64 + rlo * 8;
        if (src >= 0 && src < M)
          cp_async16(dst, feat + (size_t)src * C + col, true);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
      mbar_arrive(&full[s]);            // its zero stores
      cp_async_mbar_arrive(&full[s]);   // its copies, once they land
    }
    return;
  }

  // consumer warpgroup. A: K-major, neighbours along K 128 B apart, along
  // M 1024 B. B: N-major, swizzled, atoms of 8 rows of 2 D bytes.
  float acc[DS / 2];
#pragma unroll
  for (int i = 0; i < DS / 2; ++i) acc[i] = 0.f;
  pin_regs(acc);
  const uint64_t a_desc = gmma_desc(smem, 128, 1024);
  const uint64_t b_desc = gmma_desc(smem + TL::A_BYTES, TL::B_BYTES, 16 * DS,
                                    DS == 64 ? 1 : (DS == 32 ? 2 : 3));
  int n = 0;
  int prev = -1;
  for (int ch = next_chunk(0); ch < TL::CHUNKS;
       ch = next_chunk(ch + 1), ++n) {
    const int s = n % GW_STAGES;
    mbar_wait(&full[s], (n / GW_STAGES) & 1);
    fence_proxy_async();
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < GW_KC / 16; ++ks) {
      const uint64_t sa = (uint64_t)((s * TL::STAGE_BYTES + ks * 256) >> 4);
      const uint64_t sb =
          (uint64_t)((s * TL::STAGE_BYTES + ks * 32 * DS) >> 4);
      wgmma_ss<DS, 1>(acc, a_desc + sa, b_desc + sb);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = s;
  }
  wgmma_wait<0>();
  pin_regs(acc);

  // acc[4 j + i]: row 16 warp + g + 8 (i / 2), column 8 j + 2 t + i % 2
  // of the slice
  const int row = r0 + 16 * warp + (lane >> 2);
  const int col = d0 + (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < DS / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      if (r < R)
        *reinterpret_cast<unsigned*>(out + (size_t)r * D + 8 * j + col) =
            round_pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// Encodes the tensor map over W (27 C, D) bf16 that gather_wgmma_tile
// reads: boxes of 64 rows x min(D, 64) columns. Returns 0 or a CUDA error
// code.
inline int encode_weight_map(CUtensorMap* map, const void* w, int C, int D) {
  const int ds = D > 64 ? 64 : D;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)GW_TAPS * C};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)ds, GW_KC};
  return encode_bf16_map(map, w, 2, dims, strides, box,
                         ds == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : (ds == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B));
}

// Launches `kernel` (a kernel of GatherWgmma<C, D> whose caller adds
// `words` index words per row) over R rows of B items, one 64-row tile
// and 64-column slice a block. Returns cudaGetLastError() of the launch
// (0 = ok).
template <int C, int D, class Kernel>
int launch_gather_wgmma(Kernel kernel, int words, const void* feat,
                        const int* maps, const void* w, void* out, int B,
                        int R, int M, cudaStream_t stream) {
  const int bytes = GatherWgmma<C, D>::TILE_BYTES + GW_ROWS * words * 4;
  CUtensorMap wmap;
  const int err = encode_weight_map(&wmap, w, C, D);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid((R + GW_ROWS - 1) / GW_ROWS, B,
                  GatherWgmma<C, D>::D_BLOCKS);
  kernel<<<grid, GW_THREADS, bytes, stream>>>(
      wmap, static_cast<const __nv_bfloat16*>(feat), maps,
      static_cast<__nv_bfloat16*>(out), R, M);
  return (int)cudaGetLastError();
}

}  // namespace mgar
