// Rotated-BEV NMS, f32, sm_90a: suppression words, then the greedy sweep.
//
//   mgar_nms_bev_words: boxes (N, 7) sorted by descending score ->
//     words (N, W) uint64, W = ceil(N / 64): bit b of words[i][w] is set
//     iff j = 64 w + b > i and IoU_bev(box j, box i) > thr, box j's
//     rectangle clipped by box i's edges (ops/boxes3d.py:
//     boxes_iou_bev(a=j, b=i)); counters[0] += pairs that reached the
//     exact clip, counters[1] += pairs whose rectangles overlap.
//   mgar_nms_sweep: words (N, W), valid (N,) -> keep (N,), all in sorted
//     order: box i is kept iff it is valid and no kept box before it sets
//     its bit.
//
// Replaces no TPU kernel: the JAX package builds the whole N x N IoU matrix
// with XLA and sweeps it (ops/boxes3d.py: nms_bev), which at Voxel R-CNN's
// 9000 training proposals needs gigabytes (an 8 x 2 vertex buffer a pair).
// Here the matrix never exists: 10.2 MB of words at N = 9000.
//
// What bounds it on the card: the words kernel by the exact clips
// (Sutherland-Hodgman, four half-planes, an 8-vertex polygon in registers),
// only for the pairs of the upper triangle whose circumscribed circles
// meet; the rest is one distance test a pair. The sweep is a chain: each
// 64-box block is resolved by one thread from the block's diagonal words
// (staged in shared memory), then every thread ORs the kept rows into the
// words that follow, so the sweep costs about one block's latency per 64
// boxes and no host round trip.
//
// Design: words kernel, grid (W, W), 64 threads: block (cb, rb) holds the
// 64 column boxes of block cb (the clipped ones) in shared memory, each
// thread one row box i of block rb (the clipper) in registers, and writes
// words[i][cb]; blocks with cb < rb write zeros. The arithmetic follows the
// CPU version's order with round-to-nearest intrinsics, so that no product
// and sum is contracted into an FMA the CPU does not do; the sines and
// cosines come from double precision. Deterministic: no float atomics, the
// counters are integer sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 64;
constexpr int VMAX = 8;          // vertices of a rectangle-rectangle clip
constexpr int SWEEP_THREADS = 256;

struct Rect {
  float x[4], y[4];
  float cx, cy, area, radius;
};

__device__ __forceinline__ Rect make_rect(const float* __restrict__ b) {
  Rect r;
  const float c = (float)cos((double)b[6]);
  const float s = (float)sin((double)b[6]);
  const float hx = b[3] * 0.5f, hy = b[4] * 0.5f;
  const float sx[4] = {1.f, -1.f, -1.f, 1.f};
  const float sy[4] = {1.f, 1.f, -1.f, -1.f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lx = sx[k] * hx, ly = sy[k] * hy;
    r.x[k] = __fadd_rn(__fsub_rn(__fmul_rn(lx, c), __fmul_rn(ly, s)), b[0]);
    r.y[k] = __fadd_rn(__fadd_rn(__fmul_rn(lx, s), __fmul_rn(ly, c)), b[1]);
  }
  r.cx = b[0];
  r.cy = b[1];
  r.area = __fmul_rn(b[3], b[4]);
  r.radius = 0.5f * sqrtf(b[3] * b[3] + b[4] * b[4]);
  return r;
}

// slot m of (qx, qy) <- (vx, vy) when m < VMAX, with static indices only
__device__ __forceinline__ void put(float* qx, float* qy, int m, float vx,
                                    float vy) {
#pragma unroll
  for (int k = 0; k < VMAX; ++k)
    if (k == m) {
      qx[k] = vx;
      qy[k] = vy;
    }
}

__device__ __forceinline__ float side(float ex, float ey, float p1x,
                                      float p1y, float x, float y) {
  return __fsub_rn(__fmul_rn(ex, __fsub_rn(y, p1y)),
                   __fmul_rn(ey, __fsub_rn(x, p1x)));
}

// area of rectangle a clipped by the four edges of rectangle b
__device__ float overlap(const Rect& a, const Rect& b) {
  float px[VMAX], py[VMAX];
#pragma unroll
  for (int k = 0; k < VMAX; ++k) {
    px[k] = k < 4 ? a.x[k & 3] : 0.f;
    py[k] = k < 4 ? a.y[k & 3] : 0.f;
  }
  int n = 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float p1x = b.x[e], p1y = b.y[e];
    const float ex = __fsub_rn(b.x[(e + 1) & 3], p1x);
    const float ey = __fsub_rn(b.y[(e + 1) & 3], p1y);
    float qx[VMAX], qy[VMAX];
#pragma unroll
    for (int k = 0; k < VMAX; ++k) qx[k] = qy[k] = 0.f;
    int m = 0;
#pragma unroll
    for (int k = 0; k < VMAX; ++k) {
      if (k < n) {
        const float cx = px[k], cy = py[k];
        const float nx = k + 1 < n ? px[(k + 1) & (VMAX - 1)] : px[0];
        const float ny = k + 1 < n ? py[(k + 1) & (VMAX - 1)] : py[0];
        const float sc = side(ex, ey, p1x, p1y, cx, cy);
        const float sn = side(ex, ey, p1x, p1y, nx, ny);
        const bool in_c = sc >= 0.f, in_n = sn >= 0.f;
        if (in_c) {
          put(qx, qy, m, cx, cy);
          ++m;
        }
        if (in_c != in_n) {
          float den = __fsub_rn(sc, sn);
          if (fabsf(den) < 1e-12f) den = 1e-12f;
          const float t = __fdiv_rn(sc, den);
          put(qx, qy, m, __fadd_rn(cx, __fmul_rn(t, __fsub_rn(nx, cx))),
              __fadd_rn(cy, __fmul_rn(t, __fsub_rn(ny, cy))));
          ++m;
        }
      }
    }
    n = m < VMAX ? m : VMAX;
#pragma unroll
    for (int k = 0; k < VMAX; ++k) {
      px[k] = qx[k];
      py[k] = qy[k];
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < VMAX; ++k) {
    if (k < n) {
      const float nx = k + 1 < n ? px[(k + 1) & (VMAX - 1)] : px[0];
      const float ny = k + 1 < n ? py[(k + 1) & (VMAX - 1)] : py[0];
      acc = __fadd_rn(acc, __fsub_rn(__fmul_rn(px[k], ny),
                                     __fmul_rn(nx, py[k])));
    }
  }
  return fabsf(acc) * 0.5f;
}

__global__ void __launch_bounds__(BLOCK)
nms_bev_words_kernel(const float* __restrict__ boxes, int n, float thr,
                     unsigned long long* __restrict__ words, int W,
                     unsigned long long* __restrict__ counters) {
  const int cb = blockIdx.x, rb = blockIdx.y, t = threadIdx.x;
  const int i = rb * BLOCK + t;
  if (cb < rb) {
    if (i < n) words[(size_t)i * W + cb] = 0ull;
    return;
  }
  __shared__ Rect cols[BLOCK];
  const int j0 = cb * BLOCK;
  if (j0 + t < n) cols[t] = make_rect(boxes + (size_t)(j0 + t) * 7);
  __syncthreads();
  unsigned long long bits = 0ull;
  unsigned int clipped = 0, overlapping = 0;
  if (i < n) {
    const Rect b = make_rect(boxes + (size_t)i * 7);
    const int lim = min(BLOCK, n - j0);
    for (int k = (cb == rb ? t + 1 : 0); k < lim; ++k) {
      const Rect& a = cols[k];
      const float dx = a.cx - b.cx, dy = a.cy - b.cy;
      const float rs = a.radius + b.radius;
      // circumscribed circles apart (with room for rounding): disjoint
      if (dx * dx + dy * dy > rs * rs * 1.0001f + 1e-6f) continue;
      ++clipped;
      const float inter = overlap(a, b);
      if (inter > 0.f) ++overlapping;
      const float uni = fmaxf(__fsub_rn(__fadd_rn(a.area, b.area), inter),
                              1e-9f);
      if (__fdiv_rn(inter, uni) > thr) bits |= 1ull << k;
    }
    words[(size_t)i * W + cb] = bits;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    clipped += __shfl_down_sync(0xffffffffu, clipped, off);
    overlapping += __shfl_down_sync(0xffffffffu, overlapping, off);
  }
  if ((t & 31) == 0 && (clipped | overlapping)) {
    atomicAdd(counters, (unsigned long long)clipped);
    atomicAdd(counters + 1, (unsigned long long)overlapping);
  }
}

__global__ void __launch_bounds__(SWEEP_THREADS)
nms_sweep_kernel(const unsigned long long* __restrict__ words,
                 const unsigned char* __restrict__ valid, int n, int W,
                 unsigned char* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];   // W words
  __shared__ unsigned long long diag[BLOCK];
  __shared__ unsigned long long kept_bits;
  const int t = threadIdx.x;
  for (int w = t; w < W; w += SWEEP_THREADS) {
    unsigned long long r = 0ull;
    for (int b = 0; b < BLOCK; ++b) {
      const int i = w * BLOCK + b;
      if (i >= n || !valid[i]) r |= 1ull << b;
    }
    removed[w] = r;
  }
  __syncthreads();
  for (int blk = 0; blk < W; ++blk) {
    const int base = blk * BLOCK;
    if (t < BLOCK) diag[t] = base + t < n ? words[(size_t)(base + t) * W + blk]
                                          : 0ull;
    __syncthreads();
    if (t == 0) {
      unsigned long long rem = removed[blk], kb = 0ull;
      const int lim = min(BLOCK, n - base);
      for (int k = 0; k < lim; ++k)
        if (!((rem >> k) & 1ull)) {
          kb |= 1ull << k;
          rem |= diag[k];
        }
      kept_bits = kb;
    }
    __syncthreads();
    const unsigned long long kb = kept_bits;
    for (int w = blk + 1 + t; w < W; w += SWEEP_THREADS) {
      unsigned long long acc = 0ull, m = kb;
      while (m) {
        const int k = __ffsll((long long)m) - 1;
        m &= m - 1;
        acc |= words[(size_t)(base + k) * W + w];
      }
      removed[w] |= acc;
    }
    if (t < BLOCK && base + t < n) keep[base + t] = (kb >> t) & 1ull;
    __syncthreads();
  }
}

}  // namespace

extern "C" int mgar_nms_bev_words(const float* boxes, int n, float thr,
                                  unsigned long long* words,
                                  unsigned long long* counters,
                                  void* stream) {
  const int W = (n + BLOCK - 1) / BLOCK;
  if (n > 0)
    nms_bev_words_kernel<<<dim3(W, W), BLOCK, 0, (cudaStream_t)stream>>>(
        boxes, n, thr, words, W, counters);
  return (int)cudaGetLastError();
}

extern "C" int mgar_nms_sweep(const unsigned long long* words,
                              const unsigned char* valid, int n,
                              unsigned char* keep, void* stream) {
  const int W = (n + BLOCK - 1) / BLOCK;
  if (n > 0)
    nms_sweep_kernel<<<1, SWEEP_THREADS, W * sizeof(unsigned long long),
                       (cudaStream_t)stream>>>(words, valid, n, W, keep);
  return (int)cudaGetLastError();
}
