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

#include <cuda_runtime.h>

#include "cp_async.cuh"

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
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // this block's tap and stretch of flattened (b, r) rows
  int k, begin, end;
  if ((int)blockIdx.x < n_centre) {
    k = CENTRE;
    begin = blockIdx.x * centre_stretch;
    end = min(begin + centre_stretch, rows);
  } else {
    const int o = blockIdx.x - n_centre;
    const int slot = o / n_other;
    k = slot + (slot >= CENTRE ? 1 : 0);
    begin = (o - slot * n_other) * stretch;
    end = min(begin + stretch, rows);
  }

  // this block's piece of the partial: rows c0.., columns d0..
  const int c0 = TL::PIECES == 1 ? 0 : blockIdx.y / TL::DP * TL::CS;
  const int d0 = TL::PIECES == 1 ? 0 : blockIdx.y % TL::DP * TL::DS;

  // let the reduction's launch proceed; it waits for this grid's end itself
  asm volatile("griddepcontrol.launch_dependents;");

  // compact the present pairs in row order: a warp takes a contiguous slab
  // of the stretch, 32 rows a pass
  const int slab = (end - begin + THREADS - 1) / THREADS * 32;
  const int first = begin + warp * slab + lane;
  int src[SCAN];
#pragma unroll
  for (int p = 0; p < SCAN; ++p) {
    const int g = first + p * 32;
    int s = -1;
    if (p * 32 < slab && g < end) s = __ldg(idx + (size_t)g * TAPS + k);
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

// dW[k] = the sum of tap k's partials: PER_WARP float4s of dW per warp,
// PARTS lanes each, lane part summing partials part, part + PARTS, ... in
// order, then the lanes' sums combined by shuffles.
__global__ void __launch_bounds__(THREADS)
wgrad_reduce_kernel(const float4* __restrict__ partial,
                    float4* __restrict__ dw, int n_centre, int n_other,
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
  if (live && part == 0) dw[o] = s;
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
  // Stretches by the launch's rows, so that a 4k-row layer still gives the
  // card several hundred blocks and a 16k-row one not many more partials
  // (measured at 4k, 8k and 16k rows: half and twice these lengths are both
  // slower); the centre tap's stay at 128 rows up to 16k rows.
  const int stretch =
      rows <= 8192 ? 256
                   : (rows <= 16384 ? 512
                                    : (rows <= 32768 ? 1024 : MAX_STRETCH));
  const int centre_stretch = stretch < 512 ? 128 : stretch / 4;
  const int n_other = (rows + stretch - 1) / stretch;
  const int n_centre = (rows + centre_stretch - 1) / centre_stretch;
  // no stretch is shorter than GRANT rows, so the partials fit the scratch
  if (n_centre + (TAPS - 1) * n_other > TAPS * ((rows + GRANT - 1) / GRANT))
    return (int)cudaErrorInvalidValue;
  wgrad_partial_kernel<C, D>
      <<<dim3(n_centre + (TAPS - 1) * n_other, TL::PIECES), THREADS,
         TL::SMEM_BYTES, stream>>>(
          table, idx, dout, partial, R, M, rows, stretch, centre_stretch,
          n_centre, n_other);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cd4 = C * D / 4;
  // the reduction is launched as a dependent of the first kernel, whose
  // blocks release it as they start: its launch latency passes while they
  // run, and it waits on the device for them to finish
  cudaLaunchAttribute dependent;
  dependent.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((TAPS * cd4 / PER_WARP + WARPS - 1) / WARPS);
  config.blockDim = dim3(THREADS);
  config.stream = stream;
  config.attrs = &dependent;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &config, wgrad_reduce_kernel, reinterpret_cast<const float4*>(partial),
      reinterpret_cast<float4*>(dw), n_centre, n_other, cd4);
}

}  // namespace

// Rows per unit of scratch: the wrapper allocates the scratch as
// (ceil(B * R / mgar_sparse_wgrad_chunk()), 27, C, D) floats, and the
// launcher never cuts the rows into more partials than that holds.
extern "C" int mgar_sparse_wgrad_chunk() { return GRANT; }

// The (C, D) pairs of the sparse backbones' layers (VoxelBackbone8x, the
// residual ones to 128 channels, UNetV2's decoder, PillarRes18Backbone's
// 256-channel stage, FocalSparseConv's importance conv at D = 16, the input
// layer of 5 to 8 point features at (8, 16)); the Python wrapper checks the
// pair before it calls. table, dout, partial and dw are 16-byte
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
