// I3D stem conv (Conv3d_1a_7x7 after space-to-depth) with the folded eval
// BatchNorm and ReLU in the epilogue, f32, for sm_90a.
//
// Replaces: multimodal_gar_tpu/ops/pallas/stem_conv.py: _stem_conv_impl
// (public entry stem_conv_pallas), the TPU kernel of the eval stem.
//
// Computes exactly models/i3d.py: _stem_ref_s2d on the s2d input:
//   out[b, o, t, h, w] = relu(scale[o] * sum_{kt,kh,kw,c}
//       xd[b, 2t - pad_front + kt, h + kh, w + kw, c] * w2[kt, kh, kw, c, o]
//       + bias[o])
// with xd (B, T, Hp, Wp, 12) channels-last, w2 (7, 4, 4, 12, 64) DHWIO,
// out (B, 64, T_out, Hp - 3, Wp - 3) NCDHW (the layout the cuDNN body reads).
// Temporal taps outside [0, T) are the zero pad.
//
// Contract on w2: it is the space-to-depth form of a 7x7x7 kernel
// (models/i3d.py: s2d_prep). Channel ch = (eh * 2 + ew) * 3 + c of tap
// (kh, kw) holds tap (2 kh + eh, 2 kw + ew) of the 7x7 kernel, so the
// entries with 2 kh + eh == 7 or 2 kw + ew == 7 are structurally zero. The
// kernel never reads them: it does 7*7*7*3 = 1029 products per output, not
// 7*4*4*12 = 1344. The Python wrapper checks the contract.
//
// What bounds it on the card: f32 FMAs on the CUDA cores. At the mil3 clip
// (1, 15, 363, 643, 12) it is an implicit GEMM with M = 8*360*640 output
// pixels, N = 64, K = 1029: 2.4e11 FLOP against 0.1 GB of input and 0.47 GB
// of output, far above the f32 ridge point. An SM starts one warp
// instruction per scheduler and clock, so every shared-memory load takes a
// slot from an FMA, and the instructions themselves have to arrive:
// a fully unrolled temporal tap (about 10,000 FMAs, 70 KB of code) ran a
// fifth slower than the same work as a loop with a body of 450 FMAs.
//
// Design:
//  - One block per (b, t_out, 4 output rows, 128-wide W tile), 512 threads;
//    a thread owns 8 pixels contiguous along W x 8 couts of one row (64
//    accumulators). The weights of a temporal tap staged once serve 512
//    pixels, and each staged input row serves up to 4 output rows.
//  - A ring of two stages in shared memory, one temporal tap each: the
//    tap's 147 x 64 non-zero weight rows (compacted to the 7x7x3 kernel
//    while staging) and its 7 input rows of 131 pixels x 12 channels,
//    filled with 16-byte cp.async (zero-filled beyond Hp and Wp). The next
//    tap's copies are in flight while this tap's FMAs run; taps in the
//    temporal pad are skipped.
//  - The tap's K loop runs over (7x7 row hh, channel c), 21 steps with one
//    small body: the thread loads the 11 + 10 input values that the 7
//    columns ww of the row need (pixel w + ww / 2, s2d channel from hh, ww
//    and c) and reuses each for up to 4 columns; per column it loads its 8
//    weights as two float4s for 64 FMAs: 35 loads for 448 FMAs.
//  - Input rows are stored [pixel][12] with 4 floats of padding after every
//    8 pixels, so the 4 pixel groups of a warp read different banks while
//    its 8 cout groups read one address (a broadcast); a thread's couts are
//    4 tx .. 4 tx + 3 and 32 + 4 tx .. 32 + 4 tx + 3, so the 8 cout groups
//    read 128 contiguous bytes of a weight row.
//  - The epilogue applies scale, bias and ReLU and stores each thread's 8
//    pixels of a cout as two float4s: whole 32-byte sectors, 128 contiguous
//    bytes per cout and warp.
// Tensor cores (TF32/bf16 wgmma) would be faster and are left for later:
// they need an accuracy decision against the f32 reference.
//
// mgar_stem_conv_bf16 below is the model's stem at model.dtype bfloat16 on
// the tensor cores; its own note says what it computes.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "mma_bf16.cuh"

namespace {

using mgar::cp_async16;
using mgar::cp_async_commit;
using mgar::cp_async_wait;

constexpr int KT = 7;
constexpr int KS = 4;
constexpr int CIN = 12;
constexpr int COUT = 64;
constexpr int K7 = 7;                          // taps of the 7x7 kernel
constexpr int ROWS = 4;                        // output rows per block
constexpr int TILE_W = 128;                    // output pixels per row tile
constexpr int PX = 8;                          // contiguous pixels per thread
constexpr int CO = 8;                          // couts per thread
constexpr int THREADS = ROWS * (TILE_W / PX) * (COUT / CO);  // 512
constexpr int IN_W = TILE_W + KS - 1;          // 131 input pixels per row
constexpr int IN_ROWS = ROWS + KS - 1;         // 7 input rows per tap
constexpr int PX_BLOCK = PX * CIN + 4;         // 8 pixels + bank padding
constexpr int X_ROW = ((IN_W + PX - 1) / PX) * PX_BLOCK;  // 1700 floats
constexpr int W_ROWS = K7 * K7 * 3;            // 147 non-zero rows per tap
constexpr int W_SLICE = W_ROWS * COUT;         // 9408 floats
constexpr int W2_SLICE = KS * KS * CIN * COUT; // 12288 floats of w2 per tap
constexpr int STAGE = W_SLICE + IN_ROWS * X_ROW;
constexpr int SMEM_BYTES = 2 * STAGE * 4;

static_assert(PX_BLOCK % 4 == 0 && X_ROW % 4 == 0 && STAGE % 4 == 0,
              "16-byte staging");
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

// Stages temporal tap kt (input time ti) into one ring stage.
__device__ __forceinline__ void stage_tap(
    float* stage, const float* __restrict__ xd, const float* __restrict__ w2,
    int kt, size_t x_time_base, int h0, int w0, int Hp, int Wp) {
  const int tid = threadIdx.x;
  // weights: compact row (hh, ww, c) of the 7x7 kernel <- w2 row
  // (kh, kw, (eh * 2 + ew) * 3 + c), 16 chunks of 16 bytes each
  const float* wsrc = w2 + (size_t)kt * W2_SLICE;
  for (int i = tid; i < W_ROWS * (COUT / 4); i += THREADS) {
    const int row = i >> 4;
    const int part = i & 15;
    const int hh = row / (K7 * 3);
    const int rem = row - hh * (K7 * 3);
    const int ww = rem / 3;
    const int c = rem - ww * 3;
    const int src = ((hh >> 1) * KS + (ww >> 1)) * CIN +
                    ((hh & 1) * 2 + (ww & 1)) * 3 + c;
    cp_async16(stage + row * COUT + part * 4, wsrc + src * COUT + part * 4,
               true);
  }
  // input rows h0 .. h0 + 6, pixels w0 .. w0 + 130, 3 chunks per pixel
  float* xs = stage + W_SLICE;
  constexpr int ROW_CHUNKS = IN_W * (CIN / 4);
  for (int i = tid; i < IN_ROWS * ROW_CHUNKS; i += THREADS) {
    const int r = i / ROW_CHUNKS;
    const int rem = i - r * ROW_CHUNKS;
    const int q = rem / 3;
    const int part = rem - q * 3;
    const int h = h0 + r;
    const int w = w0 + q;
    const bool ok = h < Hp && w < Wp;
    const float* src =
        ok ? xd + x_time_base + ((size_t)h * Wp + w) * CIN + part * 4 : xd;
    cp_async16(xs + r * X_ROW + (q >> 3) * PX_BLOCK + (q & 7) * CIN + part * 4,
               src, ok);
  }
}

// One (hh, c) of a temporal tap: the 7 weight rows ww of 7x7 row hh at
// input channel c. xs is the thread's first pixel of input row h + hh / 2
// at s2d channel (hh & 1) * 6 + c (ew = 1 is 3 channels on), ws the weight
// row (hh, ww = 0, c) at the thread's first cout.
__device__ __forceinline__ void tap_hc(const float* xs, const float* ws,
                                       float (&acc)[PX][CO]) {
  constexpr int NPX = PX + KS - 1;
  float xv[2][NPX];
#pragma unroll
  for (int p = 0; p < NPX; ++p) {
    const int off = (p < PX ? p * CIN : PX_BLOCK + (p - PX) * CIN);
    xv[0][p] = xs[off];
    if (p < NPX - 1) xv[1][p] = xs[off + 3];
  }
#pragma unroll
  for (int ww = 0; ww < K7; ++ww) {
    const float* wr = ws + ww * 3 * COUT;
    const float4 wa = *reinterpret_cast<const float4*>(wr);
    const float4 wb = *reinterpret_cast<const float4*>(wr + COUT / 2);
    const float wv[CO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const float x = xv[ww & 1][p + (ww >> 1)];
#pragma unroll
      for (int o = 0; o < CO; ++o) acc[p][o] = fmaf(x, wv[o], acc[p][o]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
stem_conv_kernel(const float* __restrict__ xd, const float* __restrict__ w2,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int T, int Hp, int Wp, int T_out, int H_out, int W_out,
                 int pad_front, int n_wtiles, int n_htiles) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  int blk = blockIdx.x;
  const int wt = blk % n_wtiles;
  blk /= n_wtiles;
  const int ht = blk % n_htiles;
  blk /= n_htiles;
  const int to = blk % T_out;
  const int b = blk / T_out;
  const int w0 = wt * TILE_W;
  const int h0 = ht * ROWS;

  const int tid = threadIdx.x;
  const int tx = tid % (COUT / CO);  // couts 4 tx .. +3 and 32 + 4 tx .. +3
  const int ty = (tid / (COUT / CO)) % (TILE_W / PX);  // pixels ty*8 .. +7
  const int tr = tid / ((COUT / CO) * (TILE_W / PX));  // output row h0 + tr

  float acc[PX][CO];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[p][o] = 0.f;

  // temporal taps inside [0, T): a contiguous range, the same for the block
  const int t_first = 2 * to - pad_front;
  const int kt_lo = t_first < 0 ? -t_first : 0;
  const int kt_hi = T - t_first < KT ? T - t_first : KT;

  auto time_base = [&](int kt) {
    return ((size_t)b * T + (t_first + kt)) * Hp * (size_t)Wp * CIN;
  };
  if (kt_lo < kt_hi) {
    stage_tap(smem, xd, w2, kt_lo, time_base(kt_lo), h0, w0, Hp, Wp);
    cp_async_commit();
  }
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    float* stage = smem + ((kt - kt_lo) & 1) * STAGE;
    cp_async_wait<0>();
    __syncthreads();  // tap kt has landed; the other stage is consumed
    if (kt + 1 < kt_hi) {
      stage_tap(smem + ((kt + 1 - kt_lo) & 1) * STAGE, xd, w2, kt + 1,
                time_base(kt + 1), h0, w0, Hp, Wp);
      cp_async_commit();
    }
    const float* xs = stage + W_SLICE + tr * X_ROW + ty * PX_BLOCK;
    const float* ws = stage + tx * 4;
#pragma unroll 1
    for (int hc = 0; hc < K7 * 3; ++hc) {
      const int hh = hc / 3;
      const int c = hc - hh * 3;
      tap_hc(xs + (hh >> 1) * X_ROW + (hh & 1) * 6 + c,
             ws + hh * (K7 * 3 * COUT) + c * COUT, acc);
    }
  }

  // epilogue: scale, bias, ReLU; 8 contiguous pixels per cout
  const int h = h0 + tr;
  const int w = w0 + ty * PX;
  if (h >= H_out || w >= W_out) return;
  const size_t plane = (size_t)T_out * H_out * W_out;
  float* obase = out + (size_t)b * COUT * plane +
                 ((size_t)to * H_out + h) * W_out + w;
  const bool vec = (W_out & 3) == 0 && w + PX <= W_out;
#pragma unroll
  for (int o = 0; o < CO; ++o) {
    const int co = tx * 4 + (o & 3) + (o >> 2) * (COUT / 2);
    const float s = scale[co];
    const float bb = bias[co];
    float v[PX];
#pragma unroll
    for (int p = 0; p < PX; ++p) v[p] = fmaxf(fmaf(acc[p][o], s, bb), 0.f);
    float* dst = obase + (size_t)co * plane;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int p = 0; p < PX; ++p)
        if (w + p < W_out) dst[p] = v[p];
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch (0 = ok).
// xd, w2 and out are 16-byte aligned.
extern "C" int mgar_stem_conv_f32(const float* xd, const float* w2,
                                  const float* scale, const float* bias,
                                  float* out, int B, int T, int Hp, int Wp,
                                  int T_out, int pad_front, void* stream) {
  const int H_out = Hp - (KS - 1);
  const int W_out = Wp - (KS - 1);
  const int n_wtiles = (W_out + TILE_W - 1) / TILE_W;
  const int n_htiles = (H_out + ROWS - 1) / ROWS;
  const long long blocks = (long long)B * T_out * n_htiles * n_wtiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stem_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  stem_conv_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(
      xd, w2, scale, bias, out, T, Hp, Wp, T_out, H_out, W_out, pad_front,
      n_wtiles, n_htiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The stem at bfloat16 on the tensor cores (mgar_stem_conv_bf16).
//
// Replaces, at model.dtype bfloat16: multimodal_gar_tpu/models/i3d.py:290
// (XLA's conv of the s2d stem in bf16, which the JAX package takes instead
// of its Pallas stem at bf16) and the bias add at :311. Computes
//   y = bf16(sum_{kt,kh,kw,c} xd[b, 2t - pad_front + kt, h + kh, w + kw, c]
//            * w2[kt, kh, kw, c, o])            (float32 sum, one rounding)
//   out[b, o, t, h, w] = relu(bf16(y + bias[o]))          (a second one)
// with xd, w2 and bias bf16 and the eval BatchNorm's scale already folded
// into w2 (kernel * s rounded to bf16, as the JAX package folds it): the
// two roundings of the JAX package's conv output and bias add. Same shapes,
// layouts and w2 contract as the float32 kernel above; out is bf16 NCDHW.
//
// What bounds it on the card: at the mil3 clip the implicit GEMM has
// M = 8 * 360 * 640 pixels, N = 64, K = 1029 live taps: 2.4e11 FLOP, a
// quarter of a millisecond at the tensor cores' 989 TFLOP/s, against
// 0.1 GB of input and 0.24 GB of output, 0.1 ms at 3.35 TB/s.
// mma.sync reaches a fraction of that rate, and the A operand is an im2col
// gather: feeding the tensor cores from shared memory is the limit.
//
// Design (simple first; wgmma and TMA are later work):
//  - One block per (b, t_out, 4 output rows, 64-wide W tile), 8 warps; a
//    warp owns 32 pixels of one row (two m16 tiles) x all 64 couts (eight
//    n8 tiles): 64 float32 accumulators a thread.
//  - K per temporal tap: the 147 live (hh, ww, c) taps of the 7x7x3 kernel,
//    zero-padded to 160 (ten k16 steps); taps in the temporal pad are
//    skipped. A ring of two stages, one temporal tap each: the tap's
//    160 x 64 weight rows (compacted from w2 while staging, the padding
//    rows zero-filled) and its 7 input rows of 67 pixels x 12 channels,
//    filled with cp.async (16 bytes for the weights; 8 for the input, whose
//    rows start at 24-byte pixel boundaries).
//  - B fragments by ldmatrix.trans from the weight rows (padded to odd
//    16-byte units: no bank conflicts); A fragments gathered per element:
//    a table in shared memory gives, for each pair of k, the two offsets of
//    the s2d input from a pixel, so a k16 step costs a thread 8 16-bit
//    loads per m tile against 8 mma.
//  - The epilogue rounds, adds the bias, rounds and applies ReLU, writes
//    the tile to shared memory as [cout][pixel] and stores it as 16-byte
//    rows of 8 pixels.

namespace {

namespace sb {

using mgar::cp_async8;
using mgar::ldmatrix_x4_trans;
using mgar::mma_bf16_16816;
using mgar::pack_bf16;

constexpr int ROWS = 4;                         // output rows per block
constexpr int TILE_W = 64;                      // output pixels per row
constexpr int THREADS = 256;
constexpr int WARP_PX = 32;                     // pixels per warp
constexpr int IN_W = TILE_W + KS - 1;           // 67 input pixels per row
constexpr int IN_ROWS = ROWS + KS - 1;          // 7 input rows per tap
constexpr int X_ROW = IN_W * CIN;               // 804 bf16 per input row
constexpr int KLIVE = K7 * K7 * 3;              // 147 live taps per kt
constexpr int KPAD = 160;                       // padded to ten k16 steps
constexpr int WROW = COUT + 8;                  // 72: odd 16-byte units
constexpr int W_ELEMS = KPAD * WROW;            // 11520 bf16
constexpr int X_ELEMS = IN_ROWS * X_ROW;        // 5628 bf16
constexpr int STAGE = W_ELEMS + ((X_ELEMS + 7) / 8) * 8;   // bf16, 16 B
constexpr int PX = ROWS * TILE_W;               // 256 pixels per block
constexpr int OROW = PX + 8;                    // epilogue tile row
constexpr int SMEM_BYTES = 2 * STAGE * 2 + KPAD / 2 * 4;
static_assert(THREADS / 32 * WARP_PX == PX, "warp tiling");
static_assert(COUT * OROW <= 2 * STAGE, "epilogue tile fits the ring");
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
static_assert(W_ELEMS % 8 == 0 && STAGE % 8 == 0, "16-byte staging");

// offset of live tap k (hh, ww, c) in the staged input from a pixel's
// first channel; the padding taps read that channel (times a zero weight)
__device__ __forceinline__ int tap_offset(int k) {
  if (k >= KLIVE) return 0;
  const int hh = k / (K7 * 3);
  const int r = k - hh * (K7 * 3);
  const int ww = r / 3;
  const int c = r - ww * 3;
  return (hh >> 1) * X_ROW + (ww >> 1) * CIN + (hh & 1) * 6 + (ww & 1) * 3 +
         c;
}

__device__ __forceinline__ void stage_tap(
    __nv_bfloat16* stage, const __nv_bfloat16* __restrict__ xd,
    const __nv_bfloat16* __restrict__ w2, int kt, size_t x_time_base, int h0,
    int w0, int Hp, int Wp) {
  const int tid = threadIdx.x;
  // weights: compact row k = (hh, ww, c) <- w2 row (kh, kw, (eh*2+ew)*3+c),
  // 8 chunks of 16 bytes each; rows KLIVE .. KPAD - 1 zero
  const __nv_bfloat16* wsrc = w2 + (size_t)kt * W2_SLICE;
  for (int i = tid; i < KPAD * (COUT / 8); i += THREADS) {
    const int row = i >> 3;
    const int part = i & 7;
    int src = 0;
    if (row < KLIVE) {
      const int hh = row / (K7 * 3);
      const int rem = row - hh * (K7 * 3);
      const int ww = rem / 3;
      const int c = rem - ww * 3;
      src = ((hh >> 1) * KS + (ww >> 1)) * CIN +
            ((hh & 1) * 2 + (ww & 1)) * 3 + c;
    }
    cp_async16(stage + row * WROW + part * 8, wsrc + src * COUT + part * 8,
               row < KLIVE);
  }
  // input rows h0 .. h0 + 6, pixels w0 .. w0 + 66, 3 chunks of 8 bytes
  __nv_bfloat16* xs = stage + W_ELEMS;
  constexpr int ROW_CHUNKS = IN_W * (CIN / 4);
  for (int i = tid; i < IN_ROWS * ROW_CHUNKS; i += THREADS) {
    const int r = i / ROW_CHUNKS;
    const int rem = i - r * ROW_CHUNKS;
    const int q = rem / 3;
    const int part = rem - q * 3;
    const int h = h0 + r;
    const int w = w0 + q;
    const bool ok = h < Hp && w < Wp;
    const __nv_bfloat16* src =
        ok ? xd + x_time_base + ((size_t)h * Wp + w) * CIN + part * 4 : xd;
    cp_async8(xs + r * X_ROW + q * CIN + part * 4, src, ok);
  }
}

__global__ void __launch_bounds__(THREADS)
stem_conv_bf16_kernel(const __nv_bfloat16* __restrict__ xd,
                      const __nv_bfloat16* __restrict__ w2,
                      const __nv_bfloat16* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int T, int Hp, int Wp,
                      int T_out, int H_out, int W_out, int pad_front,
                      int n_wtiles, int n_htiles) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem4);
  unsigned* offs = reinterpret_cast<unsigned*>(ring + 2 * STAGE);

  int blk = blockIdx.x;
  const int wt = blk % n_wtiles;
  blk /= n_wtiles;
  const int ht = blk % n_htiles;
  blk /= n_htiles;
  const int to = blk % T_out;
  const int b = blk / T_out;
  const int w0 = wt * TILE_W;
  const int h0 = ht * ROWS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // the warp's 32 pixels: output row warp / 2, columns (warp & 1) * 32 ..
  const int wrow = warp >> 1;
  const int wcol = (warp & 1) * WARP_PX;

  // offsets of each pair of taps (2j, 2j + 1), packed in 16 bits each
  for (int j = tid; j < KPAD / 2; j += THREADS)
    offs[j] = pack_bf16((unsigned short)tap_offset(2 * j),
                        (unsigned short)tap_offset(2 * j + 1));

  float acc[2][COUT / 8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < COUT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  const int t_first = 2 * to - pad_front;
  const int kt_lo = t_first < 0 ? -t_first : 0;
  const int kt_hi = T - t_first < KT ? T - t_first : KT;
  auto time_base = [&](int kt) {
    return ((size_t)b * T + (t_first + kt)) * Hp * (size_t)Wp * CIN;
  };
  if (kt_lo < kt_hi) {
    stage_tap(ring, xd, w2, kt_lo, time_base(kt_lo), h0, w0, Hp, Wp);
    cp_async_commit();
  }
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    __nv_bfloat16* stage = ring + ((kt - kt_lo) & 1) * STAGE;
    cp_async_wait<0>();
    __syncthreads();  // tap kt has landed; the other stage is consumed
    if (kt + 1 < kt_hi) {
      stage_tap(ring + ((kt + 1 - kt_lo) & 1) * STAGE, xd, w2, kt + 1,
                time_base(kt + 1), h0, w0, Hp, Wp);
      cp_async_commit();
    }
    const unsigned short* xs =
        reinterpret_cast<const unsigned short*>(stage + W_ELEMS) +
        wrow * X_ROW + (wcol + g) * CIN;
    const __nv_bfloat16* ws = stage;
#pragma unroll 2
    for (int ks = 0; ks < KPAD / 16; ++ks) {
      const unsigned o01 = offs[ks * 8 + t4];
      const unsigned o89 = offs[ks * 8 + 4 + t4];
      const int k0 = o01 & 0xffff, k1 = o01 >> 16;
      const int k8 = o89 & 0xffff, k9 = o89 >> 16;
      unsigned a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const unsigned short* p = xs + m * 16 * CIN;
        const unsigned short* q = p + 8 * CIN;
        a[m][0] = pack_bf16(p[k0], p[k1]);
        a[m][1] = pack_bf16(q[k0], q[k1]);
        a[m][2] = pack_bf16(p[k8], p[k9]);
        a[m][3] = pack_bf16(q[k8], q[k9]);
      }
#pragma unroll
      for (int j = 0; j < COUT / 16; ++j) {
        unsigned bf[4];
        ldmatrix_x4_trans(
            bf, ws + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * WROW +
                    j * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16_16816(acc[m][2 * j], a[m], bf[0], bf[1]);
          mma_bf16_16816(acc[m][2 * j + 1], a[m], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue tile

  // epilogue: round, + bias, round, ReLU into a [cout][pixel] tile
  __nv_bfloat16* tile = ring;
#pragma unroll
  for (int n = 0; n < COUT / 8; ++n) {
    const int co = n * 8 + 2 * t4;
    const float b0 = __bfloat162float(bias[co]);
    const float b1 = __bfloat162float(bias[co + 1]);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = wrow * TILE_W + wcol + m * 16 + g + half * 8;
        const float y0 = __bfloat162float(
            __float2bfloat16_rn(acc[m][n][2 * half]));
        const float y1 = __bfloat162float(
            __float2bfloat16_rn(acc[m][n][2 * half + 1]));
        tile[co * OROW + px] =
            __float2bfloat16_rn(fmaxf(__bfloat162float(
                __float2bfloat16_rn(y0 + b0)), 0.f));
        tile[(co + 1) * OROW + px] =
            __float2bfloat16_rn(fmaxf(__bfloat162float(
                __float2bfloat16_rn(y1 + b1)), 0.f));
      }
    }
  }
  __syncthreads();
  const size_t plane = (size_t)T_out * H_out * W_out;
  const bool vec = (W_out & 7) == 0;
  for (int i = tid; i < COUT * ROWS * (TILE_W / 8); i += THREADS) {
    const int c8 = i % (TILE_W / 8);
    const int r = (i / (TILE_W / 8)) % ROWS;
    const int co = i / (TILE_W / 8 * ROWS);
    const int h = h0 + r;
    const int w = w0 + c8 * 8;
    if (h >= H_out || w >= W_out) continue;
    const __nv_bfloat16* src = tile + co * OROW + r * TILE_W + c8 * 8;
    __nv_bfloat16* dst = out + (size_t)b * COUT * plane +
                         (size_t)co * plane +
                         ((size_t)to * H_out + h) * W_out + w;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int p = 0; p < 8 && w + p < W_out; ++p) dst[p] = src[p];
    }
  }
}

}  // namespace sb

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch (0 = ok).
// xd, w2 and out are 16-byte aligned; bias holds the 64 bf16 biases.
extern "C" int mgar_stem_conv_bf16(const void* xd, const void* w2,
                                   const void* bias, void* out, int B, int T,
                                   int Hp, int Wp, int T_out, int pad_front,
                                   void* stream) {
  const int H_out = Hp - (KS - 1);
  const int W_out = Wp - (KS - 1);
  const int n_wtiles = (W_out + sb::TILE_W - 1) / sb::TILE_W;
  const int n_htiles = (H_out + sb::ROWS - 1) / sb::ROWS;
  const long long blocks = (long long)B * T_out * n_htiles * n_wtiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sb::stem_conv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sb::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  sb::stem_conv_bf16_kernel<<<(unsigned)blocks, sb::THREADS, sb::SMEM_BYTES,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xd),
      static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), T, Hp, Wp, T_out, H_out, W_out,
      pad_front, n_wtiles, n_htiles);
  return (int)cudaGetLastError();
}
