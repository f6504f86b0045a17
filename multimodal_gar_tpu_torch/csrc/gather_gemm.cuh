// Shared core of the gather-GEMM sparse convs: csrc/window_conv.cu (rows
// from the packed x-window maps, or from a pre-shifted table) and
// csrc/subm_conv.cu (rows from explicit (R, 27) index maps). All compute,
// for a tile of TM output rows,
//   out[r] = sum_k W[k]^T table[src(r, k)]
// over the 27 taps of a 3x3x3 kernel, W (27, C, D) in (dz, dy, dx) scan
// order; src(r, k) outside [0, M) means the tap is absent.
//
// What bounds it on the card: at 4k-40k rows the kernels are latency bound
// (row gathers at data-dependent addresses, then a short GEMM), so the
// design hides the copies behind the FMAs and keeps the loads per FMA low.
//
// Design:
//  - The 27 taps run in chunks of G taps (K = G * C input values per row:
//    G = 9, 9, 3, 3, 1, 1 at C = 4, 8, 12, 16, 32, 64; C = 8 and 12 are the
//    input layer of 5 to 11 point features, zero-padded to 8 or 12 by the
//    Python wrappers, ops/kernels/_pad.py). The block first ORs, over its
//    rows, which taps are present at all; a chunk none of whose taps is
//    present in the tile is skipped: no weights staged, no rows gathered.
//    Padding tiles beyond the stage's voxel count cost a zero store.
//  - A ring of STAGES shared-memory stages, one chunk each (the chunk's
//    K x D weights and the tile's TM x K gathered values), filled with
//    16-byte cp.async: C / 4 threads move one source row, absent taps are
//    zero-filled by the copy itself. The next chunks' copies are in flight
//    while this chunk's FMAs run; one barrier per chunk.
//  - 256 threads; a thread owns TM / (1024 / D) rows x 4 outputs (at
//    TM = 128: 8, 4 and 2 rows at D = 64, 32 and 16) and reads its rows'
//    values and the weights as float4s: per 4 k, RT + 4 loads for 16 RT
//    FMAs. Gathered rows are padded to an odd number of float4s, so that
//    the rows a quarter warp reads lie in different banks.
//  - TM = 128 amortises a chunk's weights over twice the rows; the launcher
//    takes TM = 64 where 128-row tiles would leave the card's 132 SMs less
//    than two tiles each (measured: 128-row tiles everywhere cost the 20k-
//    and 10k-row layers a quarter more time, 32-row tiles gained nothing).
//  - Past 128 channels a chunk no longer holds a whole tap: at C > 128 it
//    is a 128-channel slice of one tap's inputs (C / 128 chunks per tap),
//    and at D > 128 the output columns split over the grid's third
//    dimension, 128 to a block, each block gathering the tile's rows
//    itself. So no stage holds more than the (128, 128) instance's weights
//    (64 KiB) and (256, 256) runs 64-row tiles within the 232,448-byte
//    limit of a block. A thread still sums its outputs chunk by chunk in
//    one fixed order, so two runs give the same bits. At C, D <= 128 the
//    code is the one before: one chunk per G taps, one block per tile.
//  What is left: a tile runs every tap that any of its rows uses, so on
//  sparse maps most FMAs multiply zero-filled rows; and a tile's chunks run
//  one after the other on the block's 8 warps, about 2.5 us each at
//  C = D = 64 whatever the tile height (two warps per scheduler do not hide
//  the shared-memory latency of the FMA loop), so a layer with fewer
//  occupied tiles than SMs takes 27 such steps.
//
// The bf16 sparse convs run on the tensor cores elsewhere: the forwards on
// csrc/gather_wgmma.cuh, kernel C (the bf16 data gradient) in
// csrc/subm_conv.cu.
#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace mgar {

constexpr int GG_THREADS = 256;
constexpr int GG_TAPS = 27;
constexpr int GG_SMS = 132;  // H100: below 2 tiles per SM take the small tile

// Output rows per tile for a launch of `rows_total` rows (batch included).
inline int gg_tile_rows(long long rows_total) {
  return rows_total >= 2LL * GG_SMS * 128 ? 128 : 64;
}

template <int C, int D, int TM>
struct GatherTile {
  static constexpr int CS = C > 128 ? 128 : C;    // input channels per chunk
  static constexpr int SLICES = C / CS;           // chunks per tap
  static constexpr int DS = D > 128 ? 128 : D;    // output columns per block
  static constexpr int D_BLOCKS = D / DS;         // blocks per tile
  static constexpr int G = C <= 8 ? 9 : (C <= 16 ? 3 : 1);  // taps per chunk
  static constexpr int CHUNKS = GG_TAPS / G * SLICES;
  static constexpr int K = G * CS;                // values per row and chunk
  static constexpr int TROW = K + (((K / 4) & 1) ? 0 : 4);  // odd float4s
  static constexpr int STAGES = C == 32 ? 3 : 2;
  static constexpr int DG = DS / 4;               // threads across columns
  static constexpr int RY = GG_THREADS / DG;      // threads across rows
  static constexpr int RT = TM / RY;              // rows per thread
  static constexpr int W_FLOATS = K * DS;         // one chunk's weights
  static constexpr int STAGE_FLOATS = W_FLOATS + TM * TROW;
  // the ring and the tap mask; the caller adds its index words
  static constexpr int TILE_BYTES = STAGES * STAGE_FLOATS * 4 + 16;
  static_assert(C % 4 == 0 && D % 16 == 0 && GG_TAPS % G == 0, "shapes");
  static_assert(C % CS == 0 && D % DS == 0 && (SLICES == 1 || G == 1),
                "channel slices");
  static_assert(RT >= 1 && RY * RT == TM, "thread tiling");
  static_assert(STAGE_FLOATS % 4 == 0, "16-byte stages");
};

// Computes the tile's accumulators for output columns d0 .. d0 + DS - 1.
// `ring` is TILE_BYTES of shared memory; src_row(row, tap) is the table row
// feeding tile row `row` at `tap` (anything outside [0, M) where the tap is
// absent) and reads the block's index words in shared memory, which the
// caller has written and followed by a __syncthreads(). w is W (27, C, D),
// 16-byte aligned, as feat is.
template <int C, int D, int TM, class SrcRow>
__device__ __forceinline__ void accumulate_tile(
    const float* __restrict__ feat, int M, const float* __restrict__ w,
    float* ring, SrcRow src_row, float4 (&acc)[GatherTile<C, D, TM>::RT],
    int d0 = 0) {
  using TL = GatherTile<C, D, TM>;
  const int tid = threadIdx.x;
  unsigned* mask_s = reinterpret_cast<unsigned*>(ring + TL::STAGES *
                                                 TL::STAGE_FLOATS);
#pragma unroll
  for (int i = 0; i < TL::RT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // which taps does any row of the tile use
  if (tid == 0) *mask_s = 0u;
  unsigned present = 0u;
  for (int i = tid; i < TM * GG_TAPS; i += GG_THREADS) {
    const int row = i / GG_TAPS;
    const int tap = i - row * GG_TAPS;
    const int src = src_row(row, tap);
    if (src >= 0 && src < M) present |= 1u << tap;
  }
  present = __reduce_or_sync(0xffffffffu, present);
  __syncthreads();
  if ((tid & 31) == 0 && present) atomicOr(mask_s, present);
  __syncthreads();
  const unsigned taps = *mask_s;
  constexpr unsigned CHUNK_BITS = (1u << TL::G) - 1u;
  // chunk ch: taps (ch / SLICES) * G .. + G - 1, channels c0 .. c0 + CS - 1
  auto next_chunk = [&](int ch) {
    while (ch < TL::CHUNKS &&
           !((taps >> (ch / TL::SLICES * TL::G)) & CHUNK_BITS))
      ++ch;
    return ch;
  };

  auto stage_chunk = [&](int ch, int s) {
    float* w_s = ring + s * TL::STAGE_FLOATS;
    float* tap_s = w_s + TL::W_FLOATS;
    const int tap0 = ch / TL::SLICES * TL::G;
    const int c0 = ch % TL::SLICES * TL::CS;
    if constexpr (TL::SLICES == 1 && TL::DS == D) {
      const float* wsrc = w + (size_t)ch * TL::W_FLOATS;
      for (int i = tid; i < TL::W_FLOATS / 4; i += GG_THREADS)
        cp_async16(w_s + i * 4, wsrc + i * 4, true);
    } else {
      // K rows of W from row tap0 * C + c0, columns d0 .. d0 + DS - 1
      constexpr int PW = TL::DS / 4;
      const float* wsrc = w + ((size_t)tap0 * C + c0) * D + d0;
      for (int i = tid; i < TL::W_FLOATS / 4; i += GG_THREADS) {
        const int kr = i / PW;
        const int p = i - kr * PW;
        cp_async16(w_s + kr * TL::DS + p * 4, wsrc + (size_t)kr * D + p * 4,
                   true);
      }
    }
    constexpr int PIECES = TL::CS / 4;  // 16-byte pieces of a source slice
    for (int i = tid; i < TM * TL::G * PIECES; i += GG_THREADS) {
      const int piece = i % PIECES;
      const int rg = i / PIECES;
      const int row = rg / TL::G;
      const int g = rg - row * TL::G;
      const int src = src_row(row, tap0 + g);
      const bool ok = src >= 0 && src < M;
      cp_async16(tap_s + row * TL::TROW + g * TL::CS + piece * 4,
                 ok ? feat + (size_t)src * C + c0 + piece * 4 : feat, ok);
    }
  };

  int load = next_chunk(0);
#pragma unroll
  for (int s = 0; s < TL::STAGES - 1; ++s) {
    if (load < TL::CHUNKS) {
      stage_chunk(load, s);
      load = next_chunk(load + 1);
    }
    cp_async_commit();
  }

  const int tx = tid % TL::DG;
  const int ty = tid / TL::DG;
  int s = 0;
  for (int ch = next_chunk(0); ch < TL::CHUNKS; ch = next_chunk(ch + 1)) {
    cp_async_wait<TL::STAGES - 2>();
    __syncthreads();  // this chunk has landed; the stage refilled is consumed
    if (load < TL::CHUNKS) {
      stage_chunk(load, (s + TL::STAGES - 1) % TL::STAGES);
      load = next_chunk(load + 1);
    }
    cp_async_commit();

    const float* stage = ring + s * TL::STAGE_FLOATS;
    const float* w_s = stage + tx * 4;
    const float* a_s = stage + TL::W_FLOATS + ty * TL::TROW;
#pragma unroll 2
    for (int k4 = 0; k4 < TL::K / 4; ++k4) {
      float a[TL::RT][4];
#pragma unroll
      for (int i = 0; i < TL::RT; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            a_s + i * TL::RY * TL::TROW + k4 * 4);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 wv =
            *reinterpret_cast<const float4*>(w_s + (k4 * 4 + kk) * TL::DS);
#pragma unroll
        for (int i = 0; i < TL::RT; ++i) {
          acc[i].x = fmaf(a[i][kk], wv.x, acc[i].x);
          acc[i].y = fmaf(a[i][kk], wv.y, acc[i].y);
          acc[i].z = fmaf(a[i][kk], wv.z, acc[i].z);
          acc[i].w = fmaf(a[i][kk], wv.w, acc[i].w);
        }
      }
    }
    s = (s + 1) % TL::STAGES;
  }
  cp_async_wait<0>();
}

// Writes the tile's accumulators to out rows r0 .. r0 + TM - 1 below R,
// columns d0 .. d0 + DS - 1.
template <int C, int D, int TM>
__device__ __forceinline__ void store_tile(
    float* __restrict__ out, int r0, int R,
    const float4 (&acc)[GatherTile<C, D, TM>::RT], int d0 = 0) {
  using TL = GatherTile<C, D, TM>;
  const int tx = threadIdx.x % TL::DG;
  const int ty = threadIdx.x / TL::DG;
#pragma unroll
  for (int i = 0; i < TL::RT; ++i) {
    const int r = r0 + ty + i * TL::RY;
    if (r < R)
      *reinterpret_cast<float4*>(out + (size_t)r * D + d0 + tx * 4) = acc[i];
  }
}

}  // namespace mgar
