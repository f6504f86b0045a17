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
// What bounds it on the card: per (tap, row) one gathered row of C floats
// and one dout row of D floats feed a C x D outer product; at C = D = 64
// that is 4096 FMAs per 512 bytes read, so the shared-memory reads of the
// outer products, not device memory, set the pace.
//
// Design: two launches, no float atomics, so the result is reproducible.
//   1. grid (chunks of 512 flattened rows, 27 taps). A block walks its chunk
//      64 rows at a time: it gathers the 64 table rows of tap k into shared
//      memory (zeros where absent) beside the 64 dout rows, and each thread
//      accumulates a 4 x 4 (c, d) tile of the outer products in registers
//      over its share of the rows (threads split across (c, d) tiles first,
//      the rest across rows). The row groups are summed through shared
//      memory in a fixed order and the block writes its C x D partial to
//      scratch[chunk, k].
//   2. one thread per (k, c, d) sums the partials over the chunks in order.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;         // rows staged at a time
constexpr int CHUNK = 512;       // rows per block of the first launch

template <int C, int D>
struct WTile {
  static constexpr int OT = (C / 4) * (D / 4);   // 4x4 output tiles
  static constexpr int RG = THREADS / OT;        // row groups
  static constexpr int SMEM_BYTES = (TILE * (C + D) + RG * C * D) * 4;
  static_assert(C % 4 == 0 && D % 4 == 0 && OT <= THREADS &&
                    THREADS % OT == 0, "thread tiling");
};

template <int C, int D>
__global__ void __launch_bounds__(THREADS)
wgrad_partial_kernel(const float* __restrict__ table,
                     const int* __restrict__ idx,
                     const float* __restrict__ dout,
                     float* __restrict__ partial, int R, int M, int rows) {
  using TL = WTile<C, D>;
  extern __shared__ float4 smem4[];
  float* g_s = reinterpret_cast<float*>(smem4);   // TILE x C
  float* d_s = g_s + TILE * C;                    // TILE x D
  float* red_s = d_s + TILE * D;                  // RG x C x D

  const int q = blockIdx.x;
  const int k = blockIdx.y;
  const int tid = threadIdx.x;
  const int ot = tid % TL::OT;
  const int rg = tid / TL::OT;
  const int c4 = ot / (D / 4);
  const int d4 = ot % (D / 4);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int begin = q * CHUNK;
  const int end = min(begin + CHUNK, rows);
  for (int t0 = begin; t0 < end; t0 += TILE) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < TILE * C; i += THREADS) {
      const int row = i / C;
      const int c = i - row * C;
      const int g = t0 + row;  // flattened (b, r)
      float v = 0.f;
      if (g < end) {
        const int src = idx[(size_t)g * 27 + k];
        if (src >= 0 && src < M)
          v = table[((size_t)(g / R) * M + src) * C + c];
      }
      g_s[i] = v;
    }
    for (int i = tid; i < TILE * D / 4; i += THREADS) {
      const int row = i / (D / 4);
      const int g = t0 + row;
      reinterpret_cast<float4*>(d_s)[i] =
          g < end ? reinterpret_cast<const float4*>(dout)[(size_t)g * (D / 4) +
                                                          (i - row * (D / 4))]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    for (int row = rg; row < TILE; row += TL::RG) {
      const float4 gv = *reinterpret_cast<const float4*>(g_s + row * C + c4 * 4);
      const float4 dv = *reinterpret_cast<const float4*>(d_s + row * D + d4 * 4);
      const float gs[4] = {gv.x, gv.y, gv.z, gv.w};
      const float ds[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gs[i], ds[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red_s[(rg * C + c4 * 4 + i) * D + d4 * 4 + j] = acc[i][j];
  __syncthreads();
  float* dst = partial + ((size_t)q * 27 + k) * C * D;
  for (int o = tid; o < C * D; o += THREADS) {
    float s = 0.f;
    for (int r = 0; r < TL::RG; ++r) s += red_s[r * C * D + o];
    dst[o] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                    int chunks, int n) {
  const int o = blockIdx.x * THREADS + threadIdx.x;
  if (o >= n) return;
  float s = 0.f;
  for (int q = 0; q < chunks; ++q) s += partial[(size_t)q * n + o];
  dw[o] = s;
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
  const int chunks = (rows + CHUNK - 1) / CHUNK;
  wgrad_partial_kernel<C, D><<<dim3(chunks, 27), THREADS, TL::SMEM_BYTES,
                               stream>>>(table, idx, dout, partial, R, M, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = 27 * C * D;
  wgrad_reduce_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      partial, dw, chunks, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of the first launch's chunks: the wrapper allocates the scratch as
// (ceil(B * R / mgar_sparse_wgrad_chunk()), 27, C, D) floats.
extern "C" int mgar_sparse_wgrad_chunk() { return CHUNK; }

// The (C, D) pairs of VoxelBackbone8x's 11 layers; the Python wrapper
// checks the pair before it calls. Launches both kernels on `stream`;
// returns cudaGetLastError() of the launches (0 = ok), or
// cudaErrorInvalidValue for an unsupported pair.
extern "C" int mgar_sparse_wgrad_f32(const float* table, const int* idx,
                                     const float* dout, float* partial,
                                     float* dw, int B, int R, int M, int C,
                                     int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || R <= 0 || (long long)B * R > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (C == 4 && D == 16)
    return launch<4, 16>(table, idx, dout, partial, dw, B, R, M, s);
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
  return (int)cudaErrorInvalidValue;
}
