// Backward of the grid pool's neighbour gather, f32, sm_90a:
//   dF[v] = sum of dOut[e] over the kept entries e whose voxel row is v
// over an inverse map the wrapper builds (ops/kernels/neighbour_gather.py):
// perm lists the flat entries (b, r, s) in key order (key b*M + row for a
// kept entry, B*M for a masked one, stably sorted), skey the keys in that
// order, off (B*M + 1) the first sorted position of each row. dOut is
// (N, C) with N = B*R*S, dF (B*M, C).
//
// Replaces no Pallas kernel: the JAX grid pool gathers with XLA's gather and
// one-hot einsum (multimodal_gar_tpu/models/roi_grid_pool.py:125-139), whose
// VJP XLA writes itself. In the port the backward of f[bidx, rows] was
// PyTorch's sort-based index_put_ with accumulation, which adds every
// duplicate of an index in a serial loop: the padded boxes of a clip send
// all their 3,456 entries to one voxel, so one loop ran 138k-311k masked
// entries, each adding an exact zero, for 174-196 ms of a training step.
//
// What bounds it on the card: bytes. The kept rows are read once (kept x C
// x 4), every row of dF is written once (B*M x C x 4), and the map is read
// (a perm entry per kept row, off); at the train cell's shapes that is a
// few megabytes a call, microseconds of the memory rate. Masked entries sit
// after off[B*M] and are never read.
//
// Design: a group of L lanes (C/4 float4 columns at C % 4 == 0, else C
// floats, rounded up to a power of two, at most 32; wider rows loop) owns a
// work item. Item v < B*M is row v: it sums the row's first CHUNK sorted
// entries in order and, when that is the whole row, writes dF[v] (zeros for
// a row without kept entries), so no memset is needed. A row longer than
// CHUNK (x_conv4 reaches 5,573 kept entries) is split into chunks of CHUNK
// sorted positions; chunk j >= 1 starts in exactly one window of CHUNK
// sorted positions, and the item of that window (B*M + window) finds it in
// O(1) from the key at the window's start (no other row can start a chunk
// j >= 1 in the window). Each chunk of a long row writes its partial to
// scratch, and the last of them to arrive (an integer ticket per row) adds
// the partials in chunk order and writes dF[v]. So no serial chain is longer
// than CHUNK entries, the result does not depend on which chunk arrives
// last, and no float atomics are used: two runs give the same bits.
// Each lane keeps UNROLL loads in flight (the perm entries, then the rows).
// The same launch adds the entries, the kept entries and the longest row to
// `stats` (int64 [entries, kept, longest]), with no host synchronisation.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 256;
constexpr int UNROLL = 8;

__device__ __forceinline__ void set_zero(float& x) { x = 0.f; }
__device__ __forceinline__ void set_zero(float4& x) {
  x = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// the sorted entries [a, b) of one row, summed in order, at column c
template <typename V>
__device__ __forceinline__ V chunk_sum(const V* __restrict__ dout,
                                       const long long* __restrict__ perm,
                                       int a, int b, int cols, int c) {
  V acc;
  set_zero(acc);
  for (int p = a; p < b; p += UNROLL) {
    long long idx[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      idx[u] = p + u < b ? __ldg(perm + p + u) : -1;
    V x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      set_zero(x[u]);
      if (idx[u] >= 0) x[u] = __ldg(dout + idx[u] * cols + c);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (idx[u] >= 0) add_to(acc, x[u]);
  }
  return acc;
}

template <typename V>
__device__ __forceinline__ void sum_into(const V* __restrict__ dout,
                                         const long long* __restrict__ perm,
                                         int a, int b, V* dst, int cols,
                                         int lane, int L) {
  for (int c = lane; c < cols; c += L)
    dst[c] = chunk_sum(dout, perm, a, b, cols, c);
}

// A chunk of long row v (sorted entries [s, e)) has written its partial:
// take a ticket; the last chunk adds the partials in chunk order into dF.
template <typename V>
__device__ void arrive(const V* head, const V* over, int* count, V* df,
                       int v, int s, int e, int cols, int lane, int L,
                       unsigned mask) {
  __threadfence();
  __syncwarp(mask);
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(count + s / CHUNK, 1);
  ticket = __shfl_sync(mask, ticket, 0, L);
  const int chunks = (e - s + CHUNK - 1) / CHUNK;
  if (ticket != chunks - 1) return;
  __threadfence();
  for (int c = lane; c < cols; c += L) {
    V acc = __ldcg(head + (long long)(s / CHUNK) * cols + c);
    for (int j = 1; j < chunks; ++j)
      add_to(acc, __ldcg(over + (long long)((s + j * CHUNK) / CHUNK) * cols
                         + c));
    df[(long long)v * cols + c] = acc;
  }
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
neighbour_gather_bwd_kernel(const V* __restrict__ dout,
                            const long long* __restrict__ perm,
                            const int* __restrict__ skey,
                            const int* __restrict__ off, V* df, V* head,
                            V* over, int* count, long long* stats, int rows,
                            int cols, int L, int windows, int entries) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long item = t / L;
  const int lane = (int)(t % L);
  const int wl = threadIdx.x & 31;
  const unsigned mask =
      L == 32 ? 0xffffffffu : ((1u << L) - 1u) << (wl & ~(L - 1));
  int n_row = 0;
  if (item < rows) {
    const int v = (int)item;
    const int s = off[v], e = off[v + 1];
    n_row = e - s;
    if (n_row <= CHUNK) {
      sum_into(dout, perm, s, e, df + (long long)v * cols, cols, lane, L);
    } else {
      sum_into(dout, perm, s, s + CHUNK, head + (long long)(s / CHUNK) * cols,
               cols, lane, L);
      arrive(head, over, count, df, v, s, e, cols, lane, L, mask);
    }
  } else if (item < (long long)rows + windows) {
    const int w = (int)(item - rows);
    const int p0 = w * CHUNK;
    if (p0 < off[rows]) {
      const int v = skey[p0];
      const int s = off[v], e = off[v + 1];
      const int rel = p0 - s;
      const int c0 = s + (rel > 0 ? (rel + CHUNK - 1) / CHUNK : 1) * CHUNK;
      if (c0 < e && c0 < p0 + CHUNK) {          // chunk (c0 - s) / CHUNK
        sum_into(dout, perm, c0, min(c0 + CHUNK, e),
                 over + (long long)w * cols, cols, lane, L);
        arrive(head, over, count, df, v, s, e, cols, lane, L, mask);
      }
    }
  }
  const int longest = __reduce_max_sync(0xffffffffu, n_row);
  if (wl == 0 && longest > 0 &&
      longest > *reinterpret_cast<volatile long long*>(stats + 2))
    atomicMax(stats + 2, (long long)longest);
  if (t == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(stats),
              (unsigned long long)entries);
    atomicAdd(reinterpret_cast<unsigned long long*>(stats + 1),
              (unsigned long long)off[rows]);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// CHUNK: the wrapper sizes the scratch by it (windows = ceil(N / CHUNK)
// partials of C floats in head and in over, windows ints of count, zeroed).
extern "C" int mgar_neighbour_gather_chunk() { return CHUNK; }

// rows = B*M, entries = N. float4 columns where C % 4 == 0 and every
// row pointer is 16-byte aligned, else floats. Launches on `stream`;
// returns cudaGetLastError() of the launch (0 = ok), or
// cudaErrorInvalidValue for a size the kernel does not take.
extern "C" int mgar_neighbour_gather_bwd_f32(
    const float* dout, const long long* perm, const int* skey, const int* off,
    float* df, float* head, float* over, int* count, long long* stats,
    int rows, int C, long long entries, void* stream) {
  if (C <= 0 || rows <= 0 || entries < 0 || entries >= 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int windows = (int)((entries + CHUNK - 1) / CHUNK);
  const bool vec = C % 4 == 0 && aligned16(dout) && aligned16(df) &&
                   aligned16(head) && aligned16(over);
  const int cols = vec ? C / 4 : C;
  int L = 1;
  while (L < cols && L < 32) L <<= 1;
  const long long threads = ((long long)rows + windows) * L;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    neighbour_gather_bwd_kernel<float4><<<(unsigned)blocks, THREADS, 0, s>>>(
        reinterpret_cast<const float4*>(dout), perm, skey, off,
        reinterpret_cast<float4*>(df), reinterpret_cast<float4*>(head),
        reinterpret_cast<float4*>(over), count, stats, rows, cols, L,
        windows, (int)entries);
  else
    neighbour_gather_bwd_kernel<float><<<(unsigned)blocks, THREADS, 0, s>>>(
        dout, perm, skey, off, df, head, over, count, stats, rows, cols, L,
        windows, (int)entries);
  return (int)cudaGetLastError();
}
