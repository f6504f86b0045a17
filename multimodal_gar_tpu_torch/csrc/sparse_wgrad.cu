// Weight gradient of the 3x3x3 sparse conv, f32, sm_90a:
//   dW[k] = sum_{b, r} table[b, idx[b, r, k]]^T dout[b, r]     (27, C, D)
// table (B, M, C), idx (B, R, 27) int32 with -1 absent, dout (B, R, D).
//
// The TPU package has no Pallas kernel for this: its train step leaves the
// sparse conv's backward to XLA (jax.vjp of window_gather + einsum,
// multimodal_gar_tpu/models/sparse_backbone.py:162-172). In the port every
// sparse conv's forward is a hand-written kernel, and this is the weight
// half of their backward (the data half is csrc/subm_conv.cu).
//
// What bounds it on the card: operations, and only those of the (row, tap)
// pairs that are present: a pair feeds one gathered row of C floats and one
// dout row of D floats into a C x D outer product (4096 FMAs per 512 bytes
// at C = D = 64). The maps are sparse (1 to 6 taps of 27 per row when the
// voxels are scattered, about 16 when they are neighbours; the centre tap of
// a submanifold layer is present in every occupied row, the other 26 are
// not), the layers are small (4k to 16k rows), and a layer's whole work is
// a few microseconds of the card's FMA rate: so what counts is to do no
// work for absent taps and padding rows, to keep the gathers' latency off
// the FMA loop, to feed the FMAs from few shared-memory loads, and to
// spread uneven work over the 132 SMs.
//
// Design: two launches, no float atomics; every sum runs in a fixed order,
// so two runs give the same bits.
//   1. One block per (tap, stretch of rows). The block reads its stretch of
//      idx[.., k] once, all loads in flight together, and compacts the
//      present pairs, in row order, into a list in shared memory (warp
//      ballots and a prefix over the warps). It then walks the list in
//      tiles of TILE pairs through a ring of three stages filled with
//      16-byte cp.async copies (the gathered table rows beside their dout
//      rows), so the index-then-row latency of the next tiles hides behind
//      this tile's FMAs. A thread accumulates a TC x TD register tile of
//      the outer products (8 x 8 at the wide layers: 4 float4 loads feed 64
//      FMAs) over its share of the tile's rows; the row groups are summed
//      through shared memory in order and the block writes its C x D
//      partial. A block that finds no pair writes zeros and leaves.
//      Stretches are 256 rows up to 8k rows a launch and 512 up to 16k; the
//      centre tap takes 128-row stretches and its blocks come first in the
//      grid: its stretches are dense where the others are sparse, and the
//      longest block sets the launch's time.
//   2. The partials of a tap are summed by four lanes per float4 of dW,
//      each over every fourth partial in order, combined by shuffles. The
//      launch is a programmatic dependent of the first, so its latency
//      passes while the first kernel runs.
//   Past 128 channels a (tap, stretch) block's C x D partial is split into
//   128 x 128 pieces on blockIdx.y, each its own block with the same pair
//   list, gathering only its slices of the table and dout rows: no piece
//   holds more than the (128, 128) instance's tile. At C, D <= 128 there is
//   one piece and the code is the one before.
// Measured on an H100 at the 11 layers' training shapes: the second launch
// costs about 4 us a layer (3.5 us as a dependent launch). One launch, the
// last block of a tap summing that tap's partials, was not taken: the centre
// tap has 32 to 125 partials of C x D floats, which one block reads in more
// time than the second launch costs.
//
// mgar_sparse_wgrad_bf16 (kernel D) is the weight gradient at bf16: XLA's
// VJP of the bf16 einsum (multimodal_gar_tpu/models/sparse_backbone.py:
// 172-173, strided :298-299), dW[k] = bf16(sum_r table[fwd[r, k]]^T
// dOut[r]) with a bf16 table and dOut: the float32 sum over every present
// (row, tap) pair, rounded to bf16 once. What bounds it is the float32
// kernel's: a few microseconds of gathers a layer, spread unevenly over
// the taps (the centre tap of a submanifold layer has a pair in every
// row), behind a chain of index -> compaction -> row gather -> product
// steps. Its design, one launch a layer and no scratch:
//  - One thread-block cluster of WGRAD_CLUSTER = 8 blocks a tap, the
//    centre tap's cluster first in the grid (so it starts first: it has the
//    most pairs). Block j of a cluster takes the j-th of 8 equal shares of
//    the B R rows and walks it in stretches of up to MAX_STRETCH rows: each
//    stretch compacts its present pairs in row order (compact_pairs, as the
//    float32 kernel) from the tap's column of the maps' (27, B R) tap
//    columns (ops/sparse_maps.py: ConvMaps.fwd_taps, made once per map),
//    read coalesced: the (B R, 27) map's column costs a 32-byte sector a
//    row, and measured slower.
//  - Warp-specialised: a producer warpgroup fills a ring of up to 4 stages
//    of TILE pairs (128 at D = 64, 256 below) on full and empty mbarriers.
//    A tile whose pairs are consecutive table rows and consecutive dOut
//    rows (the centre tap of a submanifold layer, which holds most pairs)
//    comes by two TMA boxes; any other by 16-byte cp.async gathers (pairs
//    past the list zero-filled), arriving through cp.async.mbarrier.arrive.
//    Rows lie unpadded in the swizzle of their width (32, 64 or 128 bytes),
//    as TMA writes them.
//  - Products on the tensor cores. At D = 64 ((32, 64), (64, 64)) wgmma
//    m64nCk16 computes dW[k]^T with M = D = 64: A the tile's dOut rows
//    (M-major, 128-byte swizzle), B its table rows (N-major), K the pairs,
//    one group in flight. Below D = 64 an M of 64 would be mostly padding,
//    so the narrow pairs keep mma.sync m16n8k16: warp (mt, wk) owns rows
//    16 mt .. of C and every WK-th k16 step, A and B by ldmatrix.trans
//    from the swizzled rows.
//  - The block's float32 partial (the WK warps' partials below D = 64)
//    goes to the blocks of its cluster through distributed shared memory,
//    pushed: each float4 o of dW[k] into the receive buffer of the block of
//    rank o / SLICE, in the slot of the sending rank and part; one
//    barrier.cluster arrive / wait (after a relaxed arrival at the start
//    that makes every buffer live); block j then adds its slice's slots in
//    rank and part order, rounds once to bf16 and stores it.
//  - Past 64 channels (UNetV2's decoder, the residual encoders, the pillar
//    backbone's 256-channel stage) dW[k] is cut into pieces of at most
//    64 x 64 on blockIdx.y, each its own cluster of 8 blocks over the same
//    rows, gathering only its 64-column slices of the table and dOut rows
//    (TMA boxes of 64 columns, cp.async pieces of the slice) and reducing
//    its piece through distributed shared memory as above: every piece is
//    the (64, 64) instance's tile. At C, D <= 64 there is one piece and
//    the code is the one before.
//  Every sum runs in one fixed order, so two runs give the same bits.
//  Measured on an H100 and not taken: 16-block clusters and 4-block ones,
//  6 stages, tiles of 64 pairs (each slower), back-off in the mbarrier
//  waits (no change). What is left, as in kernel C: a tile's hand-off
//  costs about as much by TMA as by gathers, so the centre tap's blocks,
//  with up to 2000 pairs each at 16k rows, set a layer's time (PERF.md
//  section 6).

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using mgar::cp_async16;
using mgar::cp_async_commit;
using mgar::cp_async_wait;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TAPS = 27;
constexpr int CENTRE = 13;
constexpr int STAGES = 3;
// the wrapper grants 27 x C x D floats of scratch per GRANT rows; no
// stretch is shorter, so the partials always fit
constexpr int GRANT = 128;
// longest stretch of rows of one block: its pair list lies in shared memory
constexpr int MAX_STRETCH = 2048;
constexpr int SCAN = MAX_STRETCH / THREADS;  // index loads per thread
constexpr int PARTS = 4;                     // lanes per float4 of dW
constexpr int PER_WARP = 32 / PARTS;         // float4s of dW per warp

template <int C, int D>
struct WTile {
  static constexpr int CS = C > 128 ? 128 : C;   // a piece's C x D slice
  static constexpr int DS = D > 128 ? 128 : D;
  static constexpr int DP = D / DS;              // pieces across D
  static constexpr int PIECES = (C / CS) * DP;   // blocks per (tap, stretch)
  static constexpr int TC = (CS >= 32 && DS >= 64) ? 8 : 4;
  static constexpr int TD = (CS >= 32 && DS >= 32) ? 8 : 4;
  static constexpr int NC = TC / 4;              // float4s of a thread's c
  static constexpr int ND = TD / 4;
  static constexpr int OT = (CS / TC) * (DS / TD);  // register tiles
  static constexpr int RG = THREADS / OT;        // row groups
  static constexpr int TILE = CS + DS <= 32 ? 128 : (CS + DS <= 64 ? 64 : 32);
  static constexpr int STAGE_FLOATS = TILE * (CS + DS);
  static constexpr int RING_FLOATS = STAGES * STAGE_FLOATS;
  static constexpr int RED_FLOATS = RG * CS * DS;  // reuses the ring
  static constexpr int WORK_FLOATS =
      RING_FLOATS > RED_FLOATS ? RING_FLOATS : RED_FLOATS;
  static constexpr int SMEM_BYTES = (WORK_FLOATS + 2 * MAX_STRETCH) * 4;
  static_assert(C % CS == 0 && D % DS == 0, "pieces");
  static_assert(C % 4 == 0 && D % 4 == 0 && CS % TC == 0 && DS % TD == 0 &&
                    OT <= THREADS && THREADS % OT == 0 && TILE % RG == 0,
                "thread tiling");
  static_assert((C * D / 4) % PER_WARP == 0, "the reduction's lanes");
};

// Kernel D's cluster: the blocks a tap's rows are split over (portable)
constexpr int WGRAD_CLUSTER = 8;

// kernel D's blocks: a stage holds TILE pairs' table rows and their dOut
// rows, unpadded, each in the swizzle of its width (2 C and 2 D bytes: 32,
// 64 or 128), as TMA writes them (csrc/hopper.cuh). At D = 64 the products
// run on wgmma as dW[k]^T (M = D = 64): the dOut rows are A (M-major), the
// table rows B (N-major). Below D = 64 they run on mma.sync, by
// ldmatrix.trans from the same rows.
// pairs a stage of kernel D holds, on wgmma and on mma.sync
constexpr int WGRAD_TILE_WGMMA = 128;
constexpr int WGRAD_TILE_MMA = 256;

template <int C, int D>
struct WClusterBf16 {
  static constexpr int CS = C > 64 ? 64 : C;     // a piece's CS x DS slice
  static constexpr int DS = D > 64 ? 64 : D;
  static constexpr int DP = D / DS;              // pieces across D
  static constexpr int PIECES = (C / CS) * DP;   // clusters a tap
  static constexpr bool WGMMA = DS == 64;
  // mma.sync's tile of 256 pairs up to CS + DS = 64 (two stages of the
  // 64-row pairs' would not fit beside another block)
  static constexpr int TILE =
      WGMMA || CS + DS > 64 ? WGRAD_TILE_WGMMA : WGRAD_TILE_MMA;
  static constexpr int G_BYTES = TILE * CS * 2;    // the table rows
  static constexpr int STAGE_BYTES = G_BYTES + TILE * DS * 2;
  static constexpr int MT = CS / 16;       // mma.sync: 16-row bands of C
  static constexpr int WK = 4 / MT;        // consumer warps along k16 steps
  static constexpr int NT = DS / 8;        // n8 tiles of a warp
  static constexpr int PARTS = WGMMA ? 1 : WK;  // float32 CS x DS partials
  // the cluster's partials of this block's slice of the piece:
  // WGRAD_CLUSTER ranks x PARTS x SLICE float4s
  static constexpr int SLICE =
      (CS * DS / 4 + WGRAD_CLUSTER - 1) / WGRAD_CLUSTER;
  static constexpr int RECV_BYTES = WGRAD_CLUSTER * PARTS * SLICE * 16;
  // up to 4 stages, as many as fit beside another block of the SM
  static constexpr int FIT = (232448 / 2 - 1024 - RECV_BYTES -
                              2 * MAX_STRETCH * 4 - 256) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int RECV_OFFSET = RING_BYTES;
  static constexpr int BAR_OFFSET = RECV_OFFSET + RECV_BYTES;
  static constexpr int LIST_OFFSET = BAR_OFFSET + 2 * STAGES * 8;
  static constexpr int WARP_OFFSET = LIST_OFFSET + 2 * MAX_STRETCH * 4;
  static constexpr int SMEM_BYTES = WARP_OFFSET + WARPS * 4;
  static_assert(C % CS == 0 && D % DS == 0 && CS % 16 == 0 &&
                    DS % 16 == 0 && 4 % MT == 0 && (TILE / 16) % WK == 0,
                "bf16 tiling");
  static_assert(G_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0,
                "swizzled rows");
  static_assert(STAGES >= 2 && TILE <= 256, "ring; TMA boxes");
};

// This block's tap k and stretch [begin, end) of flattened (b, r) rows:
// the centre tap's stretches first in the grid, then the other taps'.
struct Stretch {
  int k, begin, end;
};
__device__ __forceinline__ Stretch block_stretch(int rows, int stretch,
                                                 int centre_stretch,
                                                 int n_centre, int n_other) {
  Stretch st;
  if ((int)blockIdx.x < n_centre) {
    st.k = CENTRE;
    st.begin = blockIdx.x * centre_stretch;
    st.end = min(st.begin + centre_stretch, rows);
  } else {
    const int o = blockIdx.x - n_centre;
    const int slot = o / n_other;
    st.k = slot + (slot >= CENTRE ? 1 : 0);
    st.begin = (o - slot * n_other) * stretch;
    st.end = min(st.begin + stretch, rows);
  }
  return st;
}

// Compacts the present pairs of tap k over the stretch, in row order, into
// src_s (table rows, batch offset included) and row_s (dout rows): a warp
// takes a contiguous slab of the stretch, 32 rows a pass, all its index
// loads in flight together, and places its pairs after the earlier warps'
// (warp ballots and a prefix over the warps). Returns the block's pair
// count; the lists are complete after the caller's next __syncthreads().
// idx is the (B R, 27) map, or with TAP_MAJOR its (27, rows) tap columns,
// read coalesced.
template <bool TAP_MAJOR = false>
__device__ __forceinline__ int compact_pairs(const int* __restrict__ idx,
                                             const Stretch& st, int R, int M,
                                             int* src_s, int* row_s,
                                             int* warp_pairs, int rows = 0) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slab = (st.end - st.begin + THREADS - 1) / THREADS * 32;
  const int first = st.begin + warp * slab + lane;
  int src[SCAN];
#pragma unroll
  for (int p = 0; p < SCAN; ++p) {
    const int g = first + p * 32;
    int s = -1;
    if (p * 32 < slab && g < st.end) {
      if constexpr (TAP_MAJOR)
        s = __ldg(idx + (size_t)st.k * rows + g);
      else
        s = __ldg(idx + (size_t)g * TAPS + st.k);
    }
    src[p] = (s >= 0 && s < M) ? s : -1;
  }
  unsigned has[SCAN];
  int mine = 0;
#pragma unroll
  for (int p = 0; p < SCAN; ++p) {
    has[p] = __ballot_sync(0xffffffffu, src[p] >= 0);
    mine += __popc(has[p]);
  }
  if (lane == 0) warp_pairs[warp] = mine;
  __syncthreads();
  int pos = 0, n = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) pos += warp_pairs[w];
    n += warp_pairs[w];
  }
#pragma unroll
  for (int p = 0; p < SCAN; ++p) {
    if (src[p] >= 0) {
      const int g = first + p * 32;
      const int at = pos + __popc(has[p] & ((1u << lane) - 1u));
      src_s[at] = (g / R) * M + src[p];
      row_s[at] = g;
    }
    pos += __popc(has[p]);
  }
  return n;
}

template <int C, int D>
__global__ void __launch_bounds__(THREADS, 2)
wgrad_partial_kernel(const float* __restrict__ table,
                     const int* __restrict__ idx,
                     const float* __restrict__ dout,
                     float* __restrict__ partial, int R, int M, int rows,
                     int stretch, int centre_stretch, int n_centre,
                     int n_other) {
  using TL = WTile<C, D>;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  int* src_s = reinterpret_cast<int*>(ring + TL::WORK_FLOATS);  // table rows
  int* row_s = src_s + MAX_STRETCH;                             // dout rows
  __shared__ int warp_pairs[WARPS];

  const int tid = threadIdx.x;
  const Stretch st =
      block_stretch(rows, stretch, centre_stretch, n_centre, n_other);

  // this block's piece of the partial: rows c0.., columns d0..
  const int c0 = TL::PIECES == 1 ? 0 : blockIdx.y / TL::DP * TL::CS;
  const int d0 = TL::PIECES == 1 ? 0 : blockIdx.y % TL::DP * TL::DS;

  // let the reduction's launch proceed; it waits for this grid's end itself
  asm volatile("griddepcontrol.launch_dependents;");

  const int n = compact_pairs(idx, st, R, M, src_s, row_s, warp_pairs);

  float4* dst = reinterpret_cast<float4*>(partial +
                                          (size_t)blockIdx.x * C * D);
  // float4 o of the piece's CS x DS slice -> its float4 in dst
  auto at = [&](int o) {
    if constexpr (TL::PIECES == 1) {
      return o;
    } else {
      const int c = o / (TL::DS / 4);
      return ((c0 + c) * D + d0) / 4 + (o - c * (TL::DS / 4));
    }
  };
  if (n == 0) {
    for (int o = tid; o < TL::CS * TL::DS / 4; o += THREADS)
      dst[at(o)] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  __syncthreads();

  constexpr int CS = TL::CS, DS = TL::DS;
  auto stage_tile = [&](int t, int s) {
    float* g_s = ring + s * TL::STAGE_FLOATS;
    float* d_s = g_s + TL::TILE * CS;
    constexpr int PC = CS / 4, PD = DS / 4;  // 16-byte pieces of a slice
    for (int i = tid; i < TL::TILE * PC; i += THREADS) {
      const int p = i / PC;
      const int piece = i - p * PC;
      const int pair = t * TL::TILE + p;
      const bool ok = pair < n;
      const size_t from = ok ? (size_t)src_s[pair] * C + c0 + piece * 4 : 0;
      cp_async16(g_s + p * CS + piece * 4, table + from, ok);
    }
    for (int i = tid; i < TL::TILE * PD; i += THREADS) {
      const int p = i / PD;
      const int piece = i - p * PD;
      const int pair = t * TL::TILE + p;
      const bool ok = pair < n;
      const size_t from = ok ? (size_t)row_s[pair] * D + d0 + piece * 4 : 0;
      cp_async16(d_s + p * DS + piece * 4, dout + from, ok);
    }
  };

  const int ot = tid % TL::OT;
  const int rg = tid / TL::OT;
  const int ct = ot / (DS / TL::TD);
  const int dt = ot % (DS / TL::TD);
  float acc[TL::TC][TL::TD];
#pragma unroll
  for (int i = 0; i < TL::TC; ++i)
#pragma unroll
    for (int j = 0; j < TL::TD; ++j) acc[i][j] = 0.f;

  const int tiles = (n + TL::TILE - 1) / TL::TILE;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) stage_tile(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t has landed; the stage refilled is consumed
    if (t + STAGES - 1 < tiles)
      stage_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();

    // a thread's c values are ct*4.. of each of the NC parts of the row,
    // its d values dt*4.. of each of the ND parts: neighbouring threads
    // read neighbouring float4s
    const float* g_s = ring + (t % STAGES) * TL::STAGE_FLOATS + ct * 4;
    const float* d_s = ring + (t % STAGES) * TL::STAGE_FLOATS + TL::TILE * CS +
                       dt * 4;
    const int lim = min(TL::TILE, n - t * TL::TILE);
#pragma unroll 2
    for (int row = rg; row < lim; row += TL::RG) {
      float gs[TL::TC], ds[TL::TD];
#pragma unroll
      for (int i = 0; i < TL::NC; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            g_s + row * CS + i * (CS / TL::NC));
        gs[4 * i] = v.x, gs[4 * i + 1] = v.y, gs[4 * i + 2] = v.z,
               gs[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TL::ND; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(
            d_s + row * DS + j * (DS / TL::ND));
        ds[4 * j] = v.x, ds[4 * j + 1] = v.y, ds[4 * j + 2] = v.z,
               ds[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TL::TC; ++i)
#pragma unroll
        for (int j = 0; j < TL::TD; ++j)
          acc[i][j] = fmaf(gs[i], ds[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the row groups' sums go through it

  float* red_s = ring;  // RG x CS x DS
#pragma unroll
  for (int i = 0; i < TL::TC; ++i) {
    const int c = (i / 4) * (CS / TL::NC) + ct * 4 + (i % 4);
#pragma unroll
    for (int j = 0; j < TL::ND; ++j)
      *reinterpret_cast<float4*>(red_s + (rg * CS + c) * DS +
                                 j * (DS / TL::ND) + dt * 4) =
          make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                      acc[i][4 * j + 3]);
  }
  __syncthreads();
  const float4* red4 = reinterpret_cast<const float4*>(red_s);
  for (int o = tid; o < CS * DS / 4; o += THREADS) {
    float4 s = red4[o];
    for (int r = 1; r < TL::RG; ++r) {
      const float4 v = red4[r * (CS * DS / 4) + o];
      s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
    }
    dst[at(o)] = s;
  }
}

// Four sums of dW: as float32, or each rounded to bf16 once.
__device__ __forceinline__ void store_sum(float4* dw, int o, float4 s) {
  dw[o] = s;
}
__device__ __forceinline__ void store_sum(uint2* dw, int o, float4 s) {
  dw[o] = make_uint2(mgar::round_pack_bf16(s.x, s.y),
                     mgar::round_pack_bf16(s.z, s.w));
}

// dW[k] = the sum of tap k's partials: PER_WARP float4s of dW per warp,
// PARTS lanes each, lane part summing partials part, part + PARTS, ... in
// order, then the lanes' sums combined by shuffles. Out is float4 (float32
// dW) or uint2 (four bf16).
template <class Out>
__global__ void __launch_bounds__(THREADS)
wgrad_reduce_kernel(const float4* __restrict__ partial,
                    Out* __restrict__ dw, int n_centre, int n_other,
                    int cd4) {
  // launched while the first kernel runs: wait until all of it has finished
  // and its partials are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int o = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * PER_WARP +
                lane % PER_WARP;
  const int part = lane / PER_WARP;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool live = o < TAPS * cd4;
  if (live) {
    const int k = o / cd4;
    const int slot = k - (k > CENTRE ? 1 : 0);
    const int base = k == CENTRE ? 0 : n_centre + slot * n_other;
    const int count = k == CENTRE ? n_centre : n_other;
    const float4* src = partial + (size_t)base * cd4 + (o - k * cd4);
#pragma unroll 4
    for (int q = part; q < count; q += PARTS) {
      const float4 v = src[(size_t)q * cd4];
      s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
    }
  }
#pragma unroll
  for (int step = PER_WARP; step < 32; step <<= 1) {
    s.x += __shfl_xor_sync(0xffffffffu, s.x, step);
    s.y += __shfl_xor_sync(0xffffffffu, s.y, step);
    s.z += __shfl_xor_sync(0xffffffffu, s.z, step);
    s.w += __shfl_xor_sync(0xffffffffu, s.w, step);
  }
  if (live && part == 0) store_sum(dw, o, s);
}

// The byte offset of 16-byte piece j of row p in rows of W = 32, 64 or 128
// bytes, as TMA's swizzle of that width places it (csrc/hopper.cuh).
template <int W>
__device__ __forceinline__ int piece_at(int p, int j) {
  return p * W + ((j ^ ((p * W >> 7) & (W / 16 - 1))) << 4);
}

// Kernel D: one cluster of S blocks a tap and piece (blockIdx.y), the
// centre tap's first (its note at the top). Block `rank` walks its share
// of the rows in stretches; its float32 partial stays on chip until the
// cluster adds them.
template <int C, int D>
__global__ void __launch_bounds__(THREADS, 2)
wgrad_bf16_kernel(const __grid_constant__ CUtensorMap tmap,
                  const __grid_constant__ CUtensorMap dmap,
                  const __nv_bfloat16* __restrict__ table,
                  const int* __restrict__ idx_taps,
                  const __nv_bfloat16* __restrict__ dout,
                  __nv_bfloat16* __restrict__ dw, int R, int M, int rows) {
  using TL = WClusterBf16<C, D>;
  using namespace mgar;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TL::BAR_OFFSET);
  uint64_t* empty = full + TL::STAGES;
  int* src_s = reinterpret_cast<int*>(smem + TL::LIST_OFFSET);  // table rows
  int* row_s = src_s + MAX_STRETCH;                              // dout rows
  int* warp_pairs = reinterpret_cast<int*>(smem + TL::WARP_OFFSET);
  float* recv = reinterpret_cast<float*>(smem + TL::RECV_OFFSET);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const unsigned S = cluster_size();
  const unsigned rank = cluster_rank();
  const int q = blockIdx.x / S;
  const int k = q == 0 ? CENTRE : q - 1 + (q - 1 >= CENTRE ? 1 : 0);
  const int share = (rows + (int)S - 1) / (int)S;
  const int begin = min((int)rank * share, rows);
  const int end = min(begin + share, rows);
  constexpr int CS = TL::CS, DS = TL::DS;
  // this cluster's piece of dW[k]: rows c0 .., columns d0 ..
  const int c0 = TL::PIECES == 1 ? 0 : blockIdx.y / TL::DP * CS;
  const int d0 = TL::PIECES == 1 ? 0 : blockIdx.y % TL::DP * DS;
  if (tid == 0) {
    for (int s = 0; s < TL::STAGES; ++s) {
      // each producer's copies once they land, and the TMA's bytes
      mbar_init(&full[s], 128 + 1);
      mbar_init(&empty[s], 4);    // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  cluster_arrive_relaxed();   // this block has started
  __syncthreads();

  constexpr int PC = CS / 8, PD = DS / 8;  // 16-byte pieces of a row
  // the consumer's sums: wgmma's dW^T fragment, or mma.sync's C band
  float acc[TL::WGMMA ? CS / 2 : TL::NT * 4];
#pragma unroll
  for (int i = 0; i < (TL::WGMMA ? CS / 2 : TL::NT * 4); ++i) acc[i] = 0.f;
  if constexpr (TL::WGMMA) pin_regs(acc);
  // A: the dOut rows, M-major, 128-byte swizzle, 16 rows a k16 step; B:
  // the table rows, N-major, swizzled at 2 CS bytes
  const uint64_t a_desc = gmma_desc(smem + TL::G_BYTES, 8192, 1024, 1);
  const uint64_t b_desc = gmma_desc(smem, 8192, 16 * CS,
                                    CS == 64 ? 1 : (CS == 32 ? 2 : 3));

  int done = 0;  // tiles through the ring, counted alike by both roles
  for (int s0 = begin; s0 < end; s0 += MAX_STRETCH) {
    const Stretch st{k, s0, min(s0 + MAX_STRETCH, end)};
    const int n = __shfl_sync(
        0xffffffffu,
        compact_pairs<true>(idx_taps, st, R, M, src_s, row_s, warp_pairs,
                            rows),
        0);
    __syncthreads();  // the pair lists are complete
    const int tiles = (n + TL::TILE - 1) / TL::TILE;
    if (warp >= 4) {
      // producer warpgroup: a tile of consecutive table rows and consecutive
      // dOut rows (the centre tap of a submanifold layer) by two TMA boxes,
      // any other by cp.async (pairs past n zeros)
      const int ptid = tid - 128;
      for (int t = 0; t < tiles; ++t) {
        const int u = done + t;
        const int s = u % TL::STAGES;
        const int first = t * TL::TILE;
        bool bulk = first + TL::TILE <= n;
        if (bulk) {
          const int s0 = src_s[first], r0 = row_s[first];
          bool run = true;
#pragma unroll 1
          for (int p = lane; p < TL::TILE; p += 32)
            run = run && src_s[first + p] == s0 + p &&
                  row_s[first + p] == r0 + p;
          bulk = __all_sync(0xffffffffu, run);
        }
        mbar_wait(&empty[s], ((u / TL::STAGES) & 1) ^ 1);
        unsigned char* g_s = smem + s * TL::STAGE_BYTES;
        unsigned char* d_s = g_s + TL::G_BYTES;
        if (ptid == 0) {
          mbar_arrive_expect_tx(&full[s], bulk ? TL::STAGE_BYTES : 0);
          if (bulk) {
            tma_load_2d(g_s, &tmap, c0, src_s[first], &full[s]);
            tma_load_2d(d_s, &dmap, d0, row_s[first], &full[s]);
          }
        }
        if (!bulk) {
          for (int i = ptid; i < TL::TILE * PC; i += 128) {
            const int p = i / PC;
            const int j = i - p * PC;
            const int pair = first + p;
            const bool ok = pair < n;
            cp_async16(g_s + piece_at<2 * CS>(p, j),
                       table + (ok ? (size_t)src_s[pair] * C + c0 + j * 8
                                   : 0),
                       ok);
          }
          for (int i = ptid; i < TL::TILE * PD; i += 128) {
            const int p = i / PD;
            const int j = i - p * PD;
            const int pair = first + p;
            const bool ok = pair < n;
            cp_async16(d_s + piece_at<2 * DS>(p, j),
                       dout + (ok ? (size_t)row_s[pair] * D + d0 + j * 8
                                  : 0),
                       ok);
          }
        }
        cp_async_mbar_arrive(&full[s]);
      }
    } else if constexpr (TL::WGMMA) {
      // consumer warpgroup: 4 wgmma m64nCk16 a tile, one group in flight
      int prev = -1;
      for (int t = 0; t < tiles; ++t) {
        const int u = done + t;
        const int s = u % TL::STAGES;
        mbar_wait(&full[s], (u / TL::STAGES) & 1);
        fence_proxy_async();
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < TL::TILE / 16; ++ks) {
          const uint64_t sa =
              (uint64_t)((s * TL::STAGE_BYTES + ks * 16 * 128) >> 4);
          const uint64_t sb =
              (uint64_t)((s * TL::STAGE_BYTES + ks * 32 * CS) >> 4);
          wgmma_ss_bn<CS, 1>(acc, a_desc + sa, b_desc + sb, 1);
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
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
    } else {
      // consumer warps: warp (mt, wk) takes rows 16 mt .. of C and every
      // WK-th k16 step of a tile
      const int mt = warp % TL::MT;
      const int wk = warp / TL::MT;
      for (int t = 0; t < tiles; ++t) {
        const int u = done + t;
        const int s = u % TL::STAGES;
        mbar_wait(&full[s], (u / TL::STAGES) & 1);
        const unsigned char* g_s = smem + s * TL::STAGE_BYTES;
        const unsigned char* d_s = g_s + TL::G_BYTES;
        for (int ks = wk; ks < TL::TILE / 16; ks += TL::WK) {
          // A (16 rows of C x 16 pairs): the pairs' table rows, transposed
          unsigned a[4];
          ldmatrix_x4_trans(
              a, g_s + piece_at<2 * CS>(ks * 16 + (lane & 7) +
                                            ((lane >> 4) & 1) * 8,
                                        mt * 2 + ((lane >> 3) & 1)));
#pragma unroll
          for (int j = 0; j < TL::NT / 2; ++j) {
            unsigned bfr[4];
            ldmatrix_x4_trans(
                bfr, d_s + piece_at<2 * DS>(ks * 16 + (lane & 7) +
                                                ((lane >> 3) & 1) * 8,
                                            j * 2 + (lane >> 4)));
            float(&d0)[4] = *reinterpret_cast<float(*)[4]>(acc + 8 * j);
            float(&d1)[4] = *reinterpret_cast<float(*)[4]>(acc + 8 * j + 4);
            mma_bf16_16816(d0, a, bfr[0], bfr[1]);
            mma_bf16_16816(d1, a, bfr[2], bfr[3]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }
    done += tiles;
    __syncthreads();  // the lists are free for the next stretch
  }

  // the block's partials, each float4 o of dW[k] to the block of rank
  // o / SLICE, into its slot (this rank, this part)
  cluster_wait();   // every block's receive buffer is live
  if (warp < 4) {
    const int g = lane >> 2;
    const int t4 = lane & 3;
    auto slot = [&](int e, int part) {   // e: float index in CS x DS
      const unsigned owner = e / 4 / TL::SLICE;
      return cluster_map(
          recv + ((rank * TL::PARTS + part) * TL::SLICE + e / 4 -
                  owner * TL::SLICE) * 4 + (e & 3),
          owner);
    };
    if constexpr (TL::WGMMA) {
      // acc[4 j + i]: dW^T row d = 16 warp + g + 8 (i / 2), column
      // c = 8 j + 2 t4 + i % 2
#pragma unroll
      for (int j = 0; j < CS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          st_cluster_f32(slot((8 * j + 2 * t4 + (i & 1)) * DS + 16 * warp +
                                  g + 8 * (i >> 1),
                              0),
                         acc[4 * j + i]);
    } else {
      const int mt = warp % TL::MT;
      const int wk = warp / TL::MT;
#pragma unroll
      for (int j = 0; j < TL::NT; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          st_cluster_f2(slot((mt * 16 + g + half * 8) * DS + j * 8 + t4 * 2,
                             wk),
                        acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }

  // dW[k]'s slice of this block: the partials added in rank order (and
  // part order within a rank), rounded once
  cluster_arrive();
  cluster_wait();
  constexpr int QUADS = CS * DS / 4;
  const int first = (int)rank * TL::SLICE;
  const float4* recv4 = reinterpret_cast<const float4*>(recv);
  uint2* out = reinterpret_cast<uint2*>(dw) + (size_t)k * (C * D / 4);
  for (int o = tid; o < TL::SLICE && first + o < QUADS; o += THREADS) {
    float4 v = recv4[o];
    for (int q = 1; q < (int)S * TL::PARTS; ++q) {
      const float4 x = recv4[q * TL::SLICE + o];
      v.x += x.x, v.y += x.y, v.z += x.z, v.w += x.w;
    }
    if constexpr (TL::PIECES == 1) {
      store_sum(out, first + o, v);
    } else {
      // quad e of the piece: row c0 + e / (DS / 4), columns d0 + 4 (e % ..)
      const int e = first + o;
      const int c = e / (DS / 4);
      store_sum(out, ((c0 + c) * D + d0) / 4 + (e - c * (DS / 4)), v);
    }
  }
}

// The partial launch's grid for `rows` rows. Stretches by the launch's
// rows, so that a 4k-row layer still gives the card several hundred blocks
// and a 16k-row one not many more partials (measured at 4k, 8k and 16k
// rows: half and twice these lengths are both slower); the centre tap's
// stay at 128 rows up to 16k rows.
struct Plan {
  int stretch, centre_stretch, n_other, n_centre;
  int blocks() const { return n_centre + (TAPS - 1) * n_other; }
};
Plan plan_rows(int rows) {
  Plan pl;
  pl.stretch = rows <= 8192 ? 256
                            : (rows <= 16384 ? 512
                                             : (rows <= 32768 ? 1024
                                                              : MAX_STRETCH));
  pl.centre_stretch = pl.stretch < 512 ? 128 : pl.stretch / 4;
  pl.n_other = (rows + pl.stretch - 1) / pl.stretch;
  pl.n_centre = (rows + pl.centre_stretch - 1) / pl.centre_stretch;
  return pl;
}

// The reduction, launched as a dependent of the partial launch, whose
// blocks release it as they start: its launch latency passes while they
// run, and it waits on the device for them to finish.
template <class Out>
int launch_reduce(const float* partial, Out* dw, const Plan& pl, int cd4,
                  cudaStream_t stream) {
  cudaLaunchAttribute dependent;
  dependent.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((TAPS * cd4 / PER_WARP + WARPS - 1) / WARPS);
  config.blockDim = dim3(THREADS);
  config.stream = stream;
  config.attrs = &dependent;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, wgrad_reduce_kernel<Out>,
                                 reinterpret_cast<const float4*>(partial),
                                 dw, pl.n_centre, pl.n_other, cd4);
}

template <int C, int D>
int launch(const float* table, const int* idx, const float* dout,
           float* partial, float* dw, int B, int R, int M,
           cudaStream_t stream) {
  using TL = WTile<C, D>;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_partial_kernel<C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TL::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * R;
  const Plan pl = plan_rows(rows);
  // no stretch is shorter than GRANT rows, so the partials fit the scratch
  if (pl.blocks() > TAPS * ((rows + GRANT - 1) / GRANT))
    return (int)cudaErrorInvalidValue;
  wgrad_partial_kernel<C, D>
      <<<dim3(pl.blocks(), TL::PIECES), THREADS, TL::SMEM_BYTES, stream>>>(
          table, idx, dout, partial, R, M, rows, pl.stretch,
          pl.centre_stretch, pl.n_centre, pl.n_other);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partial, reinterpret_cast<float4*>(dw), pl,
                       C * D / 4, stream);
}

// A tensor map over `rows` bf16 rows of `width` values, boxes of `tile`
// rows by min(width, 64) columns, swizzled at the box's width (kernel D's
// stage layout). Returns 0 or a CUDA error code.
inline int encode_row_map(CUtensorMap* map, const void* base, long long rows,
                          int width, int tile) {
  const int bw = width > 64 ? 64 : width;
  const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)width * 2};
  const cuuint32_t box[2] = {(cuuint32_t)bw, (cuuint32_t)tile};
  return mgar::encode_bf16_map(map, base, 2, dims, strides, box,
                               bw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                        : (bw == 32
                                               ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B));
}

template <int C, int D>
int launch_bf16(const void* table, const int* idx_taps, const void* dout,
                void* dw, int B, int R, int M, cudaStream_t stream) {
  using TL = WClusterBf16<C, D>;
  CUtensorMap tmap, dmap;
  int merr = encode_row_map(&tmap, table, (long long)B * M, C, TL::TILE);
  if (merr == 0)
    merr = encode_row_map(&dmap, dout, (long long)B * R, D, TL::TILE);
  if (merr != 0) return merr;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_bf16_kernel<C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TL::SMEM_BYTES);
  if (err == cudaSuccess && WGRAD_CLUSTER > 8)
    err = cudaFuncSetAttribute(wgrad_bf16_kernel<C, D>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = WGRAD_CLUSTER;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(TAPS * WGRAD_CLUSTER, TL::PIECES);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = TL::SMEM_BYTES;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, wgrad_bf16_kernel<C, D>, tmap, dmap,
                           static_cast<const __nv_bfloat16*>(table), idx_taps,
                           static_cast<const __nv_bfloat16*>(dout),
                           static_cast<__nv_bfloat16*>(dw), R, M, B * R);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Rows per unit of the float32 kernel's scratch: the wrapper allocates it as
// (ceil(B * R / mgar_sparse_wgrad_chunk()), 27, C, D) floats, and the
// launcher never cuts the rows into more partials than that holds.
extern "C" int mgar_sparse_wgrad_chunk() { return GRANT; }

// The (C, D) pairs of the sparse backbones' layers (VoxelBackbone8x, the
// residual ones to 128 channels, UNetV2's decoder, PillarRes18Backbone's
// 256-channel stage, FocalSparseConv's importance conv at D = 16, the input
// layer of 5 to 7 point features at (8, 16), of 9 to 15 at (16, 16)); the
// Python wrapper checks the pair before it calls. table, dout, partial and dw are 16-byte
// aligned. Launches both kernels on `stream`; returns cudaGetLastError() of
// the launches (0 = ok), or cudaErrorInvalidValue for an unsupported pair
// or sizes beyond 32-bit row numbers.
extern "C" int mgar_sparse_wgrad_f32(const float* table, const int* idx,
                                     const float* dout, float* partial,
                                     float* dw, int B, int R, int M, int C,
                                     int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || R <= 0 || M < 0 || (long long)B * R > 0x7fffffff ||
      (long long)B * M > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (C == 4 && D == 16)
    return launch<4, 16>(table, idx, dout, partial, dw, B, R, M, s);
  if (C == 8 && D == 16)
    return launch<8, 16>(table, idx, dout, partial, dw, B, R, M, s);
  if (C == 16 && D == 16)
    return launch<16, 16>(table, idx, dout, partial, dw, B, R, M, s);
  if (C == 16 && D == 32)
    return launch<16, 32>(table, idx, dout, partial, dw, B, R, M, s);
  if (C == 32 && D == 32)
    return launch<32, 32>(table, idx, dout, partial, dw, B, R, M, s);
  if (C == 32 && D == 64)
    return launch<32, 64>(table, idx, dout, partial, dw, B, R, M, s);
  if (C == 64 && D == 64)
    return launch<64, 64>(table, idx, dout, partial, dw, B, R, M, s);
  if (C == 32 && D == 16)
    return launch<32, 16>(table, idx, dout, partial, dw, B, R, M, s);
  if (C == 64 && D == 32)
    return launch<64, 32>(table, idx, dout, partial, dw, B, R, M, s);
  if (C == 64 && D == 128)
    return launch<64, 128>(table, idx, dout, partial, dw, B, R, M, s);
  if (C == 128 && D == 64)
    return launch<128, 64>(table, idx, dout, partial, dw, B, R, M, s);
  if (C == 128 && D == 128)
    return launch<128, 128>(table, idx, dout, partial, dw, B, R, M, s);
  if (C == 64 && D == 16)
    return launch<64, 16>(table, idx, dout, partial, dw, B, R, M, s);
  if (C == 256 && D == 256)
    return launch<256, 256>(table, idx, dout, partial, dw, B, R, M, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel D: bf16 table (B, M, C), the maps' tap columns (27, B R) int32
// (idx_taps[k, b R + r] = idx[b, r, k]), bf16 dout (B, R, D) and a bf16 dW
// (27, C, D): the (C, D) pairs of the sparse backbones
// (ops/kernels/sparse_wgrad.py: SUPPORTED_BF16; the Python wrapper pads a
// narrower input to 16 and checks the pair). One launch, no scratch.
// Same return convention as mgar_sparse_wgrad_f32.
extern "C" int mgar_sparse_wgrad_bf16(const void* table, const int* idx_taps,
                                      const void* dout, void* dw, int B,
                                      int R, int M, int C, int D,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || R <= 0 || M < 0 || (long long)B * R > 0x7fffffff ||
      (long long)B * M > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (C == 16 && D == 16)
    return launch_bf16<16, 16>(table, idx_taps, dout, dw, B, R, M, s);
  if (C == 16 && D == 32)
    return launch_bf16<16, 32>(table, idx_taps, dout, dw, B, R, M, s);
  if (C == 32 && D == 32)
    return launch_bf16<32, 32>(table, idx_taps, dout, dw, B, R, M, s);
  if (C == 32 && D == 64)
    return launch_bf16<32, 64>(table, idx_taps, dout, dw, B, R, M, s);
  if (C == 64 && D == 64)
    return launch_bf16<64, 64>(table, idx_taps, dout, dw, B, R, M, s);
  if (C == 32 && D == 16)
    return launch_bf16<32, 16>(table, idx_taps, dout, dw, B, R, M, s);
  if (C == 64 && D == 32)
    return launch_bf16<64, 32>(table, idx_taps, dout, dw, B, R, M, s);
  if (C == 64 && D == 16)
    return launch_bf16<64, 16>(table, idx_taps, dout, dw, B, R, M, s);
  if (C == 128 && D == 64)
    return launch_bf16<128, 64>(table, idx_taps, dout, dw, B, R, M, s);
  if (C == 64 && D == 128)
    return launch_bf16<64, 128>(table, idx_taps, dout, dw, B, R, M, s);
  if (C == 128 && D == 128)
    return launch_bf16<128, 128>(table, idx_taps, dout, dw, B, R, M, s);
  if (C == 256 && D == 256)
    return launch_bf16<256, 256>(table, idx_taps, dout, dw, B, R, M, s);
  return (int)cudaErrorInvalidValue;
}

// The C interface of mgar_sparse_wgrad_bf16: 2 since it takes the maps'
// tap columns and no scratch.
extern "C" int mgar_sparse_wgrad_bf16_abi() { return 2; }

// Kernel D's cluster size: the blocks one tap's rows are split over.
extern "C" int mgar_sparse_wgrad_bf16_cluster() { return WGRAD_CLUSTER; }
