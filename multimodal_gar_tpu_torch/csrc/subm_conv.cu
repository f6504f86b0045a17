// Index-map 3x3x3 sparse conv, f32, sm_90a:
//   out[b, r] = sum_k W[k]^T table[b, idx[b, r, k]]
// table (B, M, C), idx (B, R, 27) int32 with -1 absent, W (27, C, D),
// out (B, R, D); R may differ from M.
//
// Replaces: multimodal_gar_tpu/ops/pallas/subm_conv.py: subm_conv_pallas
// (same contract as its reference subm_conv_xla, with R != M allowed). On
// the TPU the kernel turns each tap's row gather into a one-hot MXU matmul,
// because Mosaic cannot gather rows; Hopper gathers rows directly, so that
// trick is dropped. The kernel serves three uses in the port:
//   - the forward of the nbr-map path (rulebook nbr_k / down_k maps);
//   - the data gradient of every sparse conv in training: for a
//     submanifold layer dF = subm_conv(dOut, nbr, W[26 - k]^T), for a
//     strided layer dF = subm_conv(dOut, up, W[k]^T) over the inverse map
//     up[down[o, k], k] = o (ops/sparse_maps.py). Both are gathers: no
//     atomics, deterministic.
//
// What bounds it on the card: the row gathers and their latency, as in
// csrc/window_conv.cu: up to 27 rows of C <= 256 floats per output row at
// data-dependent addresses against 27*C*D FMAs per row; the layers have
// 4k-40k rows.
//
// Design: the shared gather-GEMM core (csrc/gather_gemm.cuh: tiles of 128
// or 64 output rows, taps no row of the tile uses skipped, a cp.async ring
// that gathers 16 bytes at a time while the previous chunk's FMAs run). The
// batch is on blockIdx.y, and past D = 128 the 128-column slice of the
// output on blockIdx.z; the block loads its tile's 27 index words per row
// once.

#include "gather_gemm.cuh"

namespace {

using mgar::GG_THREADS;
using mgar::GatherTile;

template <int C, int D, int TM>
__global__ void __launch_bounds__(GG_THREADS)
subm_conv_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                 const float* __restrict__ w, float* __restrict__ out, int R,
                 int M) {
  using TL = GatherTile<C, D, TM>;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  int* idx_s = reinterpret_cast<int*>(ring) + TL::TILE_BYTES / 4;

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TM;
  const int d0 = TL::D_BLOCKS == 1 ? 0 : blockIdx.z * TL::DS;
  table += (size_t)b * M * C;
  idx += (size_t)b * R * 27;
  out += (size_t)b * R * D;

  for (int i = threadIdx.x; i < TM * 27; i += GG_THREADS)
    idx_s[i] = (r0 + i / 27) < R ? idx[(size_t)r0 * 27 + i] : -1;
  __syncthreads();

  float4 acc[TL::RT];
  mgar::accumulate_tile<C, D, TM>(
      table, M, w, ring,
      [&](int row, int tap) { return idx_s[row * 27 + tap]; }, acc, d0);
  mgar::store_tile<C, D, TM>(out, r0, R, acc, d0);
}

template <int C, int D, int TM>
int launch_tile(const float* table, const int* idx, const float* w,
                float* out, int B, int R, int M, cudaStream_t stream) {
  constexpr int bytes = GatherTile<C, D, TM>::TILE_BYTES + TM * 27 * 4;
  cudaError_t err = cudaFuncSetAttribute(
      subm_conv_kernel<C, D, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + TM - 1) / TM, B, GatherTile<C, D, TM>::D_BLOCKS);
  subm_conv_kernel<C, D, TM><<<grid, GG_THREADS, bytes, stream>>>(
      table, idx, w, out, R, M);
  return (int)cudaGetLastError();
}

// the dynamic shared memory one block may take on sm_90
constexpr int MAX_SMEM = 232448;

template <int C, int D>
int launch(const float* table, const int* idx, const float* w, float* out,
           int B, int R, int M, cudaStream_t stream) {
  // the 128-row tile of the widest pairs, (128, 128) and (256, 256), is
  // past the limit
  constexpr bool fits128 =
      GatherTile<C, D, 128>::TILE_BYTES + 128 * 27 * 4 <= MAX_SMEM;
  if constexpr (fits128) {
    if (mgar::gg_tile_rows((long long)B * R) == 128)
      return launch_tile<C, D, 128>(table, idx, w, out, B, R, M, stream);
  }
  return launch_tile<C, D, 64>(table, idx, w, out, B, R, M, stream);
}

}  // namespace

// The forward (C, D) pairs of the sparse backbones (VoxelBackbone8x, the
// residual ones to 128 channels, UNetV2's decoder, PillarRes18Backbone's
// 256-channel stage, FocalSparseConv's importance conv at D = 16, the input
// layer of 5 to 8 point features at (8, 16)) and the
// transposed pairs of their data gradients; the Python wrapper checks the pair before it
// calls. Launches on `stream`; returns cudaGetLastError() of the
// launch (0 = ok), or cudaErrorInvalidValue for an unsupported pair.
// table and weights are 16-byte aligned.
extern "C" int mgar_subm_conv_f32(const float* table, const int* idx,
                                  const float* w, float* out, int B, int R,
                                  int M, int C, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || R <= 0) return (int)cudaErrorInvalidValue;
  if (C == 4 && D == 16) return launch<4, 16>(table, idx, w, out, B, R, M, s);
  if (C == 8 && D == 16) return launch<8, 16>(table, idx, w, out, B, R, M, s);
  if (C == 16 && D == 16) return launch<16, 16>(table, idx, w, out, B, R, M, s);
  if (C == 16 && D == 32) return launch<16, 32>(table, idx, w, out, B, R, M, s);
  if (C == 32 && D == 16) return launch<32, 16>(table, idx, w, out, B, R, M, s);
  if (C == 32 && D == 32) return launch<32, 32>(table, idx, w, out, B, R, M, s);
  if (C == 32 && D == 64) return launch<32, 64>(table, idx, w, out, B, R, M, s);
  if (C == 64 && D == 32) return launch<64, 32>(table, idx, w, out, B, R, M, s);
  if (C == 64 && D == 64) return launch<64, 64>(table, idx, w, out, B, R, M, s);
  if (C == 64 && D == 128)
    return launch<64, 128>(table, idx, w, out, B, R, M, s);
  if (C == 128 && D == 64)
    return launch<128, 64>(table, idx, w, out, B, R, M, s);
  if (C == 128 && D == 128)
    return launch<128, 128>(table, idx, w, out, B, R, M, s);
  if (C == 64 && D == 16) return launch<64, 16>(table, idx, w, out, B, R, M, s);
  if (C == 16 && D == 64) return launch<16, 64>(table, idx, w, out, B, R, M, s);
  if (C == 256 && D == 256)
    return launch<256, 256>(table, idx, w, out, B, R, M, s);
  return (int)cudaErrorInvalidValue;
}
