// Fused x-window 3x3x3 sparse conv (submanifold and strided), f32, sm_90a.
//
// Replaces: multimodal_gar_tpu/ops/pallas/window_conv.py: window_conv_band
// (and window_conv_pallas, which computes the same layer). Consumes the
// packed x-window maps of data/rulebook.py unchanged.
//
// Computes window_gather(features, win) @ weights
// (models/sparse_backbone.py:48-78, 172) without materialising the
// (R, 9, 3C) gathered table: for output row r, window slot p = (dz, dy) and
// dx in {-1, 0, +1}
//   out[r] += features[pos - 1 + slot] @ W[3p + dx]
// where word = win[r, p], pos = word & 0xFFFFF and
// slot = (word >> (20 + 2 * dx_index)) & 3, 3 meaning the tap is absent.
// Rows pos - 1 + slot outside [0, M) read as zero, as the zero edge rows of
// ops/voxel.py: shifted_window_table. Output rows R and table rows M are
// separate, so one kernel serves the submanifold maps (win_k, R = M) and
// the strided maps (dwin_k, R != M). Items of the batch are blockIdx.y.
//
// What bounds it on the card: the row gathers and their latency. Each
// output row reads up to 27 feature rows of C <= 64 floats at
// data-dependent addresses; the tap GEMM is only 27*C*D FMAs per row, and
// the layers have 10k-40k rows: a few hundred tiles on 132 SMs.
//
// Design: the shared gather-GEMM core (csrc/gather_gemm.cuh: tiles of 128
// or 64 output rows, taps no row of the tile uses skipped, a cp.async ring
// that gathers 16 bytes at a time while the previous chunk's FMAs run). The
// block loads its tile's 9 window words per row once; the slot select is
// done at gather time, so absent taps are plain zeros.

#include "gather_gemm.cuh"

namespace {

using mgar::GG_THREADS;
using mgar::GatherTile;

constexpr int POS_BITS = 20;
constexpr int POS_MASK = (1 << POS_BITS) - 1;
constexpr int ABSENT = (3 | (3 << 2) | (3 << 4)) << POS_BITS;

template <int C, int D, int TM>
__global__ void __launch_bounds__(GG_THREADS)
window_conv_kernel(const float* __restrict__ feat, const int* __restrict__ win,
                   const float* __restrict__ w, float* __restrict__ out, int R,
                   int M) {
  using TL = GatherTile<C, D, TM>;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  int* win_s = reinterpret_cast<int*>(ring) + TL::TILE_BYTES / 4;

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TM;
  feat += (size_t)b * M * C;
  win += (size_t)b * R * 9;
  out += (size_t)b * R * D;

  for (int i = threadIdx.x; i < TM * 9; i += GG_THREADS)
    win_s[i] = (r0 + i / 9) < R ? win[(size_t)r0 * 9 + i] : ABSENT;
  __syncthreads();

  float4 acc[TL::RT];
  mgar::accumulate_tile<C, D, TM>(
      feat, M, w, ring,
      [&](int row, int tap) {
        const int p = tap / 3;
        const int word = win_s[row * 9 + p];
        const int slot = (word >> (POS_BITS + 2 * (tap - 3 * p))) & 3;
        return slot == 3 ? -1 : (word & POS_MASK) - 1 + slot;
      },
      acc);
  mgar::store_tile<C, D, TM>(out, r0, R, acc);
}

template <int C, int D, int TM>
int launch_tile(const float* feat, const int* win, const float* w, float* out,
                int B, int R, int M, cudaStream_t stream) {
  constexpr int bytes = GatherTile<C, D, TM>::TILE_BYTES + TM * 9 * 4;
  cudaError_t err = cudaFuncSetAttribute(
      window_conv_kernel<C, D, TM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + TM - 1) / TM, B);
  window_conv_kernel<C, D, TM><<<grid, GG_THREADS, bytes, stream>>>(
      feat, win, w, out, R, M);
  return (int)cudaGetLastError();
}

template <int C, int D>
int launch(const float* feat, const int* win, const float* w, float* out,
           int B, int R, int M, cudaStream_t stream) {
  if (mgar::gg_tile_rows((long long)B * R) == 128)
    return launch_tile<C, D, 128>(feat, win, w, out, B, R, M, stream);
  return launch_tile<C, D, 64>(feat, win, w, out, B, R, M, stream);
}

// The same layer over a pre-shifted table with unpacked maps. Replaces:
// tools/probe_gather.py: probe_f (per slot a take_along_axis over the whole
// (M, 3C) table, then a 3-way one-hot select per dx and a tap GEMM). wt is
// that table seen as (3M, C): row 3 * j + s is slot s of window row j. For
// output row r, slot p and dx the source row is 3 * pos[r, p] + s with
// s = (sel[r, p] >> (2 * dx)) & 3, absent when s == 3: the select happens
// at gather time and only the chosen C floats are read, not all 3C.
template <int C, int D, int TM>
__global__ void __launch_bounds__(GG_THREADS)
window_conv_shifted_kernel(const float* __restrict__ wt,
                           const int* __restrict__ pos,
                           const int* __restrict__ sel,
                           const float* __restrict__ w,
                           float* __restrict__ out, int R, int M) {
  using TL = GatherTile<C, D, TM>;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  int* pos_s = reinterpret_cast<int*>(ring) + TL::TILE_BYTES / 4;
  int* sel_s = pos_s + TM * 9;

  const int r0 = blockIdx.x * TM;
  for (int i = threadIdx.x; i < TM * 9; i += GG_THREADS) {
    const bool in = (r0 + i / 9) < R;
    pos_s[i] = in ? pos[(size_t)r0 * 9 + i] : 0;
    sel_s[i] = in ? sel[(size_t)r0 * 9 + i] : 63;  // all three taps absent
  }
  __syncthreads();

  float4 acc[TL::RT];
  mgar::accumulate_tile<C, D, TM>(
      wt, 3 * M, w, ring,
      [&](int row, int tap) {
        const int p = tap / 3;
        const int slot = (sel_s[row * 9 + p] >> (2 * (tap - 3 * p))) & 3;
        const int j = pos_s[row * 9 + p];
        return (slot == 3 || j < 0 || j >= M) ? -1 : 3 * j + slot;
      },
      acc);
  mgar::store_tile<C, D, TM>(out, r0, R, acc);
}

template <int C, int D, int TM>
int launch_shifted_tile(const float* wt, const int* pos, const int* sel,
                        const float* w, float* out, int R, int M,
                        cudaStream_t stream) {
  constexpr int bytes = GatherTile<C, D, TM>::TILE_BYTES + 2 * TM * 9 * 4;
  cudaError_t err = cudaFuncSetAttribute(
      window_conv_shifted_kernel<C, D, TM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  window_conv_shifted_kernel<C, D, TM>
      <<<(R + TM - 1) / TM, GG_THREADS, bytes, stream>>>(wt, pos, sel, w, out,
                                                         R, M);
  return (int)cudaGetLastError();
}

template <int C, int D>
int launch_shifted(const float* wt, const int* pos, const int* sel,
                   const float* w, float* out, int R, int M,
                   cudaStream_t stream) {
  if (mgar::gg_tile_rows(R) == 128)
    return launch_shifted_tile<C, D, 128>(wt, pos, sel, w, out, R, M, stream);
  return launch_shifted_tile<C, D, 64>(wt, pos, sel, w, out, R, M, stream);
}

}  // namespace

// The (C, D) pairs of VoxelBackbone8x, its input layer at 4 and at 5 to 8
// point features (zero-padded to 8); the Python wrapper checks the pair
// before it calls. Launches on `stream`; returns cudaGetLastError() of the
// launch (0 = ok), or cudaErrorInvalidValue for an unsupported pair.
// features and weights are 16-byte aligned.
extern "C" int mgar_window_conv_f32(const float* feat, const int* win,
                                    const float* w, float* out, int B, int R,
                                    int M, int C, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || R <= 0) return (int)cudaErrorInvalidValue;
  if (C == 4 && D == 16) return launch<4, 16>(feat, win, w, out, B, R, M, s);
  if (C == 8 && D == 16) return launch<8, 16>(feat, win, w, out, B, R, M, s);
  if (C == 16 && D == 16) return launch<16, 16>(feat, win, w, out, B, R, M, s);
  if (C == 16 && D == 32) return launch<16, 32>(feat, win, w, out, B, R, M, s);
  if (C == 32 && D == 32) return launch<32, 32>(feat, win, w, out, B, R, M, s);
  if (C == 32 && D == 64) return launch<32, 64>(feat, win, w, out, B, R, M, s);
  if (C == 64 && D == 64) return launch<64, 64>(feat, win, w, out, B, R, M, s);
  return (int)cudaErrorInvalidValue;
}

// wt (M, 3C), pos and sel (R, 9) int32 unpacked, w (27, C, D), out (R, D).
// Same return convention as mgar_window_conv_f32.
extern "C" int mgar_window_conv_shifted_f32(const float* wt, const int* pos,
                                            const int* sel, const float* w,
                                            float* out, int R, int M, int C,
                                            int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || M <= 0 || M > 715827882) return (int)cudaErrorInvalidValue;
  if (C == 16 && D == 16)
    return launch_shifted<16, 16>(wt, pos, sel, w, out, R, M, s);
  if (C == 32 && D == 32)
    return launch_shifted<32, 32>(wt, pos, sel, w, out, R, M, s);
  if (C == 64 && D == 64)
    return launch_shifted<64, 64>(wt, pos, sel, w, out, R, M, s);
  return (int)cudaErrorInvalidValue;
}
