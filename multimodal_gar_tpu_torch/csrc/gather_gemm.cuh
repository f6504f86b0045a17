// Shared core of the gather-GEMM sparse convs: csrc/window_conv.cu (rows
// from the packed x-window maps) and csrc/subm_conv.cu (rows from explicit
// (R, 27) index maps). Both compute, for a tile of 64 output rows,
//   out[r] = sum_k W[k]^T table[src(r, k)]
// over the 27 taps of a 3x3x3 kernel, W (27, C, D) in (dz, dy, dx) scan
// order. The taps run in 9 groups of 3 (one (dz, dy) slot, dx = -1, 0, +1):
// each group stages its three tap matrices (3C x D) in shared memory,
// gathers the tile's 64 x 3 source rows into shared memory (absent taps and
// rows outside [0, M) are zeros), and accumulates (64, 3C) @ (3C, D) into
// registers. Each thread owns D/16 rows x 4 outputs and reads each weight
// as one float4; gathered rows are padded to 3C + 1 floats so that the
// threads of a warp, which read different rows, hit different banks.
#pragma once

#include <cuda_runtime.h>

namespace mgar {

constexpr int GG_ROWS = 64;
constexpr int GG_THREADS = 256;

template <int C, int D>
struct GatherTile {
  static constexpr int TROW = 3 * C + 1;       // padded gathered row
  static constexpr int DG = D / 4;             // threads across D
  static constexpr int RY = GG_THREADS / DG;   // threads across rows
  static constexpr int RT = GG_ROWS / RY;      // rows per thread
  static constexpr int W_FLOATS = 3 * C * D;   // one group's tap weights
  // weights + gathered tile; the caller adds its index words
  static constexpr int TILE_BYTES = (W_FLOATS + GG_ROWS * TROW) * 4;
  static_assert(D % 16 == 0 && RY * RT == GG_ROWS, "thread tiling");
};

// Accumulates taps 3p, 3p + 1, 3p + 2 of one 64-row tile into acc.
// w_group points at W[3p] (3C x D floats, 16-byte aligned); src_row(row, dx)
// is the table row feeding tile row `row` at tap 3p + dx, negative where the
// tap is absent. w_s and tap_s are the block's shared-memory tiles.
template <int C, int D, class SrcRow>
__device__ __forceinline__ void accumulate_group(
    const float* __restrict__ feat, int M, const float* __restrict__ w_group,
    float* w_s, float* tap_s, SrcRow src_row,
    float4 (&acc)[GatherTile<C, D>::RT]) {
  using TL = GatherTile<C, D>;
  const int tid = threadIdx.x;
  __syncthreads();  // the previous group's tiles are consumed
  const float4* wsrc = reinterpret_cast<const float4*>(w_group);
  float4* wdst = reinterpret_cast<float4*>(w_s);
  for (int i = tid; i < TL::W_FLOATS / 4; i += GG_THREADS) wdst[i] = wsrc[i];

  for (int i = tid; i < GG_ROWS * 3 * C; i += GG_THREADS) {
    const int row = i / (3 * C);
    const int k = i - row * 3 * C;  // dx * C + c
    const int dx = k / C;
    const int c = k - dx * C;
    const int src = src_row(row, dx);
    float v = 0.f;
    if (src >= 0 && src < M) v = feat[(size_t)src * C + c];
    tap_s[row * TL::TROW + k] = v;
  }
  __syncthreads();

  const int tx = tid % TL::DG;
  const int ty = tid / TL::DG;
#pragma unroll 4
  for (int k = 0; k < 3 * C; ++k) {
    const float4 wv = *reinterpret_cast<const float4*>(w_s + k * D + tx * 4);
#pragma unroll
    for (int i = 0; i < TL::RT; ++i) {
      const float t = tap_s[(ty + i * TL::RY) * TL::TROW + k];
      acc[i].x = fmaf(t, wv.x, acc[i].x);
      acc[i].y = fmaf(t, wv.y, acc[i].y);
      acc[i].z = fmaf(t, wv.z, acc[i].z);
      acc[i].w = fmaf(t, wv.w, acc[i].w);
    }
  }
}

// Writes the tile's accumulators to out rows r0 .. r0 + 63 below R.
template <int C, int D>
__device__ __forceinline__ void store_tile(
    float* __restrict__ out, int r0, int R,
    const float4 (&acc)[GatherTile<C, D>::RT]) {
  using TL = GatherTile<C, D>;
  const int tx = threadIdx.x % TL::DG;
  const int ty = threadIdx.x / TL::DG;
#pragma unroll
  for (int i = 0; i < TL::RT; ++i) {
    const int r = r0 + ty + i * TL::RY;
    if (r < R) *reinterpret_cast<float4*>(out + (size_t)r * D + tx * 4) = acc[i];
  }
}

}  // namespace mgar
