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
#include "hopper.cuh"
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
// 0.1 GB of input and 0.24 GB of output, 0.1 ms at 3.35 TB/s. At N = 64 a
// wgmma m64n64k16 keeps an SM's tensor cores 32 cycles and needs 4 KB of
// operands from shared memory (2 KB of A, 2 KB of B): the 128 bytes a cycle
// shared memory delivers. So the operand traffic, not the tensor cores,
// is the ceiling, and every extra shared-memory access costs time.
//
// Design (the mma.sync kernel before it took 1.03 ms at the mil3 clip):
//  - Persistent: min(tiles, SMs) blocks of 9 warps; a tile is (b, t_out,
//    6 output rows, 64 output pixels), walked with stride gridDim.x, W
//    fastest, so that neighbouring SMs share input rows in L2.
//  - The weights staged once per block, as they are: w2's rows (kt, kh,
//    kw, c) of 64 couts are wgmma's N-major B, which TMA loads at the
//    block's start with the 128-byte swizzle, one box of 192 rows (a
//    temporal tap) at a time: 172,032 bytes.
//  - K per (kt, kh): the whole (kw, c) window of 48 values, which is
//    contiguous in xd (4 s2d pixels x 12 channels): 1344 in all, 1.31 times
//    the 1029 live taps. In exchange an input row's window fragments serve
//    every output row that reads that row (at kh = i - r), so a warpgroup
//    loads the k16 steps of its 6 input rows once for its 3 output rows:
//    18 fragment loads for 36 wgmmas. A first version that loaded each
//    output row's own fragments over a K of 1232 (the 1029 live taps padded
//    to whole 8-value runs: one fragment load per wgmma, shared-memory
//    traffic per output row a quarter higher) was slower on the card.
//    (A compacted K of 1120 needs per-thread offset tables and does not
//    even shorten that: the four words a thread-quad loads fall in four
//    banks only if their word offsets differ mod 4, and 22 of a temporal
//    tap's 77 live pairs share one residue, so 22 groups, 11 k16 steps,
//    remain.)
//  - Input rows through a ring of 4 stages, one temporal tap each (9 input
//    rows x 68 pixels x 12 channels, 14,688 bytes), filled by TMA from one
//    producer warp over a 4-D tensor map (frames, Hp, pixel pairs, 24
//    values); the copy's out-of-bounds fill supplies the zeros beyond Hp
//    and the row's end. Full and empty mbarriers per stage, no block
//    barrier. TMA strides are multiples of 16 bytes, and a row of Wrow
//    pixels is 24 Wrow bytes, so Wrow is even: models/i3d.py:
//    s2d_prep(even_width=True) writes xd into rows of an even width, and
//    the wrapper copies only a contiguous xd of odd width.
//  - Two consumer warpgroups, each 3 output rows x 64 pixels: three m64n64
//    float32 accumulators, 96 registers a thread, A from registers
//    (wgmma.mma_async m64n64k16, RS form). A thread's A fragment of a k16
//    step is four 32-bit shared loads. The fragment's rows g and g + 8
//    (g = lane / 4) are the pixels 2g and 2g + 1 of the warp's 16, so that
//    the 32 lanes' words fall in 32 banks (a pixel is 6 words), and a
//    thread's two rows are neighbouring pixels.
//  - One group of wgmmas in flight (wait_group 1) while the next step's
//    fragments load; a stage is released once its last fragments are in
//    registers. Temporal taps in the zero pad are never loaded.
//  - The epilogue rounds, adds the bias, rounds and applies ReLU in
//    registers and stores pairs of neighbouring pixels as 32-bit words: a
//    warp's store covers four whole 32-byte sectors.

namespace {

namespace sb {

using mgar::mbar_arrive;
using mgar::mbar_arrive_expect_tx;
using mgar::mbar_wait;

constexpr int CONSUMERS = 2;                     // warpgroups
constexpr int WG_ROWS = 3;                       // output rows a warpgroup
constexpr int ROWS = CONSUMERS * WG_ROWS;        // output rows per tile
constexpr int TILE_W = 64;                       // output pixels per row
constexpr int IN_ROWS = ROWS + KS - 1;           // 9 input rows per tap
constexpr int WG_IN_ROWS = WG_ROWS + KS - 1;     // 6 of them a warpgroup
constexpr int IN_PAIRS = (TILE_W + KS) / 2;      // 34 pixel pairs (68 px)
constexpr int ROW_ELEMS = IN_PAIRS * 2 * CIN;    // 816 bf16 per input row
constexpr int STAGE_USED = IN_ROWS * ROW_ELEMS * 2;        // 14,688 bytes
constexpr int STAGE_BYTES = (STAGE_USED + 127) / 128 * 128;
constexpr int STAGES = 4;
constexpr int WIN_STEPS = KS * CIN / 16;         // 3 k16 steps a window
constexpr int KSTEPS = KS * WIN_STEPS;           // 12 k16 steps per tap
constexpr int KSTEP_BYTES = 16 * COUT * 2;       // one step's B: 2 KB
constexpr int W_TAP_BYTES = KSTEPS * KSTEP_BYTES;
constexpr int W_BYTES = KT * W_TAP_BYTES;        // 172,032
constexpr int THREADS = (CONSUMERS * 4 + 1) * 32;
constexpr int BAR_OFFSET = W_BYTES + STAGES * STAGE_BYTES;
constexpr int SMEM_BYTES = BAR_OFFSET + (2 * STAGES + 1) * 8;
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
static_assert(W_TAP_BYTES % 1024 == 0 && STAGE_BYTES % 128 == 0,
              "swizzle atoms and TMA boxes aligned");

__device__ __forceinline__ unsigned ld_shared_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ float act(float sum, float bias) {
  return fmaxf(mgar::round_bf16(mgar::round_bf16(sum) + bias), 0.f);
}

struct Tile {
  int b, to, h0, w0, frame0, kt_lo, kt_hi;
  __device__ Tile(int tile, int T, int T_out, int pad_front, int n_wtiles,
                  int n_htiles) {
    w0 = tile % n_wtiles * TILE_W;
    tile /= n_wtiles;
    h0 = tile % n_htiles * ROWS;
    tile /= n_htiles;
    to = tile % T_out;
    b = tile / T_out;
    // temporal taps inside [0, T): a contiguous range
    const int t_first = 2 * to - pad_front;
    kt_lo = t_first < 0 ? -t_first : 0;
    kt_hi = T - t_first < KT ? T - t_first : KT;
    frame0 = b * T + t_first;
  }
};

// One accumulator's outputs: output row h, pixels w (the fragment's row g)
// and w + 1 (row g + 8), couts 8 j + 2 t + e.
__device__ __forceinline__ void store_row(
    const float (&acc)[32], __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ bias, const Tile& tl, int h, int w,
    int t, int T_out, int H_out, int W_out) {
  if (h >= H_out || w >= W_out) return;
  const size_t plane = (size_t)T_out * H_out * W_out;
  __nv_bfloat16* o = out + (size_t)tl.b * COUT * plane +
                     ((size_t)tl.to * H_out + h) * W_out + w;
  const bool pairs = (W_out & 1) == 0;  // every pair 4-byte aligned
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float b = __bfloat162float(bias[8 * j + 2 * t + e]);
      const float v0 = act(acc[4 * j + e], b);
      const float v1 = act(acc[4 * j + 2 + e], b);
      __nv_bfloat16* dst = o + (size_t)(8 * j + 2 * t + e) * plane;
      if (pairs) {
        *reinterpret_cast<unsigned*>(dst) = mgar::round_pack_bf16(v0, v1);
      } else {
        dst[0] = __float2bfloat16_rn(v0);
        if (w + 1 < W_out) dst[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
stem_conv_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __nv_bfloat16* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int T, int T_out,
                      int H_out, int W_out, int pad_front, int n_wtiles,
                      int n_htiles, int n_tiles) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem + W_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFFSET);
  uint64_t* empty = full + STAGES;
  uint64_t* wbar = empty + STAGES;
  // warp-uniform by construction, so that ptxas keeps the wgmma paths
  // non-divergent
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mgar::mbar_init(&full[s], 1);
      mgar::mbar_init(&empty[s], CONSUMERS * 4);
    }
    mgar::mbar_init(wbar, 1);
    mgar::mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // producer: the weights once, then one input stage per temporal tap
    if (lane == 0) {
      mbar_arrive_expect_tx(wbar, W_BYTES);
      for (int kt = 0; kt < KT; ++kt)
        mgar::tma_load_2d(smem + kt * W_TAP_BYTES, &wmap, 0,
                          kt * KS * KS * CIN, wbar);
      int n = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const Tile tl(tile, T, T_out, pad_front, n_wtiles, n_htiles);
        for (int kt = tl.kt_lo; kt < tl.kt_hi; ++kt, ++n) {
          const int s = n % STAGES;
          mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], STAGE_USED);
          mgar::tma_load_4d(ring + s * STAGE_BYTES, &xmap, 0, tl.w0 / 2,
                            tl.h0, tl.frame0 + kt, &full[s]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows 3 wg .. 3 wg + 2 of a tile,
  // warp wq of it pixels 16 wq .. 16 wq + 15
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  // N-major B, 128-byte swizzle: atoms of 8 k rows of 64 couts (1024 B)
  const uint64_t bdesc0 = mgar::gmma_desc(smem, W_TAP_BYTES, 1024, 1);
  // this thread's A words: pixel 16 wq + 2 g of the warpgroup's first input
  // row, window values 2 t, 2 t + 1 of each 8; the fragment's row g + 8 is
  // the next pixel
  const int a_off = WG_ROWS * wg * ROW_ELEMS + (16 * wq + 2 * g) * CIN + 2 * t;
  mbar_wait(wbar, 0);

  int n = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const Tile tl(tile, T, T_out, pad_front, n_wtiles, n_htiles);
    float acc[WG_ROWS][32];
#pragma unroll
    for (int r = 0; r < WG_ROWS; ++r) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[r][i] = 0.f;
      mgar::pin_regs(acc[r]);
    }
    for (int kt = tl.kt_lo; kt < tl.kt_hi; ++kt, ++n) {
      const int s = n % STAGES;
      mbar_wait(&full[s], (n / STAGES) & 1);
      const __nv_bfloat16* xs =
          reinterpret_cast<const __nv_bfloat16*>(ring + s * STAGE_BYTES) +
          a_off;
      const uint64_t bd = bdesc0 + ((kt * W_TAP_BYTES) >> 4);
      // each k16 step of an input row's windows, loaded once, serves the
      // warpgroup's output rows r that read it as row kh = i - r
#pragma unroll
      for (int i = 0; i < WG_IN_ROWS; ++i) {
#pragma unroll
        for (int ks = 0; ks < WIN_STEPS; ++ks) {
          const __nv_bfloat16* p = xs + i * ROW_ELEMS + 16 * ks;
          unsigned a[4];
          a[0] = ld_shared_u32(p);
          a[1] = ld_shared_u32(p + CIN);
          a[2] = ld_shared_u32(p + 8);
          a[3] = ld_shared_u32(p + 8 + CIN);
          mgar::wgmma_fence();
#pragma unroll
          for (int r = 0; r < WG_ROWS; ++r) {
            const int kh = i - r;
            if (kh >= 0 && kh < KS)
              mgar::wgmma_rs_n64(
                  acc[r], a, bd + (((kh * WIN_STEPS + ks) * KSTEP_BYTES) >> 4));
          }
          mgar::wgmma_commit();
          mgar::wgmma_wait<1>();
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // its fragments are loaded
    }
    mgar::wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < WG_ROWS; ++r) {
      mgar::pin_regs(acc[r]);
      // epilogue: pixels w and w + 1 of output row h0 + 3 wg + r
      store_row(acc[r], out, bias, tl, tl.h0 + WG_ROWS * wg + r,
                tl.w0 + 16 * wq + 2 * g, t, T_out, H_out, W_out);
    }
  }
}

}  // namespace sb

}  // namespace

// The C interface's version: 2 since the wgmma kernel (xd in rows of an
// even width); the mma.sync kernel before it had none.
extern "C" int mgar_stem_conv_bf16_abi() { return 2; }

// Launches on `stream`; returns cudaGetLastError() of the launch (0 = ok).
// xd is (B, T, Hp, Wrow, 12) bf16 of which the first Wp pixels of a row
// are the input (Wrow even, >= Wp); w2 (7, 4, 4, 12, 64) bf16; bias the 64
// bf16 biases; out (B, 64, T_out, Hp - 3, Wp - 3). xd and w2 are 16-byte
// aligned.
extern "C" int mgar_stem_conv_bf16(const void* xd, const void* w2,
                                   const void* bias, void* out, int B, int T,
                                   int Hp, int Wp, int Wrow, int T_out,
                                   int pad_front, void* stream) {
  const int H_out = Hp - (KS - 1);
  const int W_out = Wp - (KS - 1);
  if (H_out <= 0 || W_out <= 0 || T_out <= 0 || (Wrow & 1) || Wrow < Wp ||
      reinterpret_cast<uintptr_t>(xd) % 16 ||
      reinterpret_cast<uintptr_t>(w2) % 16)
    return (int)cudaErrorInvalidValue;
  const int n_wtiles = (W_out + sb::TILE_W - 1) / sb::TILE_W;
  const int n_htiles = (H_out + sb::ROWS - 1) / sb::ROWS;
  const long long tiles = (long long)B * T_out * n_htiles * n_wtiles;
  if (tiles <= 0 || tiles > 0x7fffffffLL || (long long)B * T > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // xd as (frames, Hp, Wrow / 2 pixel pairs, 24 values), innermost first
  CUtensorMap xmap;
  const cuuint64_t dims[4] = {2 * CIN, (cuuint64_t)Wrow / 2, (cuuint64_t)Hp,
                              (cuuint64_t)B * T};
  const cuuint64_t strides[3] = {2 * CIN * 2, (cuuint64_t)Wrow * CIN * 2,
                                 (cuuint64_t)Hp * Wrow * CIN * 2};
  const cuuint32_t box[4] = {2 * CIN, sb::IN_PAIRS, sb::IN_ROWS, 1};
  int err = mgar::encode_bf16_map(&xmap, xd, 4, dims, strides, box);
  if (err != 0) return err;
  // w2 as (7 * 4 * 4 * 12 rows, 64 couts), a temporal tap's 192 rows a box
  CUtensorMap wmap;
  const cuuint64_t wdims[2] = {COUT, KT * KS * KS * CIN};
  const cuuint64_t wstrides[1] = {COUT * 2};
  const cuuint32_t wbox[2] = {COUT, KS * KS * CIN};
  err = mgar::encode_bf16_map(&wmap, w2, 2, wdims, wstrides, wbox,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      sb::stem_conv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sb::SMEM_BYTES);
  if (cerr != cudaSuccess) return (int)cerr;
  const int grid = tiles < mgar::sm_count() ? (int)tiles : mgar::sm_count();
  sb::stem_conv_bf16_kernel<<<grid, sb::THREADS, sb::SMEM_BYTES,
                              static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), T, T_out, H_out, W_out, pad_front,
      n_wtiles, n_htiles, (int)tiles);
  return (int)cudaGetLastError();
}
