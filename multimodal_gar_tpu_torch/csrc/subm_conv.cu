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
//
// mgar_subm_conv_bf16 is the forward at model.dtype bfloat16 on the bf16
// core for Hopper (csrc/gather_wgmma.cuh: wgmma, a cp.async gather ring on
// mbarriers, weights by TMA): replaces
// multimodal_gar_tpu/models/sparse_backbone.py:169-173 and :268-299 at bf16
// (the nbr / down map gather + the bf16 einsum).
//
// mgar_subm_conv_dgrad_bf16 (kernel C) is the data gradient at bf16 on the
// float32 core's mma.sync variant (csrc/gather_gemm.cuh: GatherTileBf16):
// replaces XLA's VJP of that gather + einsum
// (multimodal_gar_tpu/models/sparse_backbone.py:162, :172-173; strided
// :298-299), dF[r] = sum_k bf16(W[k]^T dOut[inv[r, k]]) over the layer's
// inverse map, bf16 dOut and transposed weights, each tap's product
// rounded to bf16 before it joins the float32 sum, and the sums written as
// float32. What bounds it is the forward's.

#include "gather_gemm.cuh"
#include "gather_wgmma.cuh"

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

// Kernel C: each tap's product rounded, float32 out
template <int C, int D, int TM>
__global__ void __launch_bounds__(GG_THREADS)
dgrad_bf16_kernel(const __nv_bfloat16* __restrict__ table,
                  const int* __restrict__ idx,
                  const __nv_bfloat16* __restrict__ w,
                  float* __restrict__ out, int R, int M) {
  using TL = mgar::GatherTileBf16<C, D, TM>;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem4);
  int* idx_s = reinterpret_cast<int*>(smem4) + TL::TILE_BYTES / 4;

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TM;
  table += (size_t)b * M * C;
  idx += (size_t)b * R * 27;
  out += (size_t)b * R * D;

  for (int i = threadIdx.x; i < TM * 27; i += GG_THREADS)
    idx_s[i] = (r0 + i / 27) < R ? idx[(size_t)r0 * 27 + i] : -1;
  __syncthreads();

  float acc[TL::NT][4];
  mgar::accumulate_tile_bf16<C, D, TM>(
      table, M, w, ring,
      [&](int row, int tap) { return idx_s[row * 27 + tap]; }, acc);
  mgar::store_tile_bf16<C, D, TM>(out, r0, R, acc);
}

template <int C, int D, int TM>
int launch_dgrad_tile(const void* table, const int* idx, const void* w,
                      float* out, int B, int R, int M, cudaStream_t stream) {
  constexpr int bytes = mgar::GatherTileBf16<C, D, TM>::TILE_BYTES +
                        TM * 27 * 4;
  cudaError_t err = cudaFuncSetAttribute(
      dgrad_bf16_kernel<C, D, TM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + TM - 1) / TM, B);
  dgrad_bf16_kernel<C, D, TM><<<grid, GG_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(table), idx,
      static_cast<const __nv_bfloat16*>(w), out, R, M);
  return (int)cudaGetLastError();
}

template <int C, int D>
int launch_dgrad(const void* table, const int* idx, const void* w,
                 float* out, int B, int R, int M, cudaStream_t stream) {
  if (mgar::gg_tile_rows((long long)B * R) == 128)
    return launch_dgrad_tile<C, D, 128>(table, idx, w, out, B, R, M,
                                        stream);
  return launch_dgrad_tile<C, D, 64>(table, idx, w, out, B, R, M, stream);
}

// The bf16 forward on the core for Hopper (csrc/gather_wgmma.cuh)
template <int C, int D>
__global__ void __launch_bounds__(mgar::GW_THREADS, mgar::GW_BLOCKS_PER_SM)
subm_conv_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                       const __nv_bfloat16* __restrict__ table,
                       const int* __restrict__ idx,
                       __nv_bfloat16* __restrict__ out, int R, int M) {
  extern __shared__ __align__(1024) unsigned char smem[];
  int* idx_s =
      reinterpret_cast<int*>(smem + mgar::GatherWgmma<C, D>::TILE_BYTES);

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * mgar::GW_ROWS;
  table += (size_t)b * M * C;
  idx += (size_t)b * R * 27;
  out += (size_t)b * R * D;

  for (int i = threadIdx.x; i < mgar::GW_ROWS * 27; i += mgar::GW_THREADS)
    idx_s[i] = (r0 + i / 27) < R ? idx[(size_t)r0 * 27 + i] : -1;
  __syncthreads();

  mgar::gather_wgmma_tile<C, D>(
      table, M, &wmap, smem,
      [&](int row, int tap) { return idx_s[row * 27 + tap]; }, out, r0, R);
}

template <int C, int D>
int launch_wgmma(const void* table, const int* idx, const void* w, void* out,
                 int B, int R, int M, cudaStream_t stream) {
  return mgar::launch_gather_wgmma<C, D>(subm_conv_wgmma_kernel<C, D>, 27,
                                         table, idx, w, out, B, R, M,
                                         stream);
}

}  // namespace

// The forward (C, D) pairs of the sparse backbones (VoxelBackbone8x, the
// residual ones to 128 channels, UNetV2's decoder, PillarRes18Backbone's
// 256-channel stage, FocalSparseConv's importance conv at D = 16, the input
// layer of 5 to 15 point features at (8, 16), (12, 16) and (16, 16)) and
// the transposed pairs of their data gradients; the Python wrapper checks the pair before it
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
  if (C == 12 && D == 16) return launch<12, 16>(table, idx, w, out, B, R, M, s);
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

// bf16 table (B, M, C), maps (B, R, 27), bf16 W (27, C, D) and out
// (B, R, D): the forward (C, D) pairs of VoxelBackbone8x at 16 input
// channels or more (the Python wrapper pads a narrower input to 16 and
// checks the pair). Same return convention as mgar_subm_conv_f32.
extern "C" int mgar_subm_conv_bf16(const void* table, const int* idx,
                                   const void* w, void* out, int B, int R,
                                   int M, int C, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || R <= 0) return (int)cudaErrorInvalidValue;
  if (C == 16 && D == 16)
    return launch_wgmma<16, 16>(table, idx, w, out, B, R, M, s);
  if (C == 16 && D == 32)
    return launch_wgmma<16, 32>(table, idx, w, out, B, R, M, s);
  if (C == 32 && D == 32)
    return launch_wgmma<32, 32>(table, idx, w, out, B, R, M, s);
  if (C == 32 && D == 64)
    return launch_wgmma<32, 64>(table, idx, w, out, B, R, M, s);
  if (C == 64 && D == 64)
    return launch_wgmma<64, 64>(table, idx, w, out, B, R, M, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel C: bf16 dOut (B, M, C), the inverse maps (B, R, 27), the
// transposed bf16 weights W (27, C, D) and float32 dF (B, R, D), where C is
// the layer's output width and D its input width: the transposed pairs of
// VoxelBackbone8x's layers that take a data gradient. Same return
// convention as mgar_subm_conv_f32.
extern "C" int mgar_subm_conv_dgrad_bf16(const void* dout, const int* idx,
                                         const void* w, float* out, int B,
                                         int R, int M, int C, int D,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || R <= 0) return (int)cudaErrorInvalidValue;
  if (C == 16 && D == 16)
    return launch_dgrad<16, 16>(dout, idx, w, out, B, R, M, s);
  if (C == 32 && D == 16)
    return launch_dgrad<32, 16>(dout, idx, w, out, B, R, M, s);
  if (C == 32 && D == 32)
    return launch_dgrad<32, 32>(dout, idx, w, out, B, R, M, s);
  if (C == 64 && D == 32)
    return launch_dgrad<64, 32>(dout, idx, w, out, B, R, M, s);
  if (C == 64 && D == 64)
    return launch_dgrad<64, 64>(dout, idx, w, out, B, R, M, s);
  return (int)cudaErrorInvalidValue;
}
