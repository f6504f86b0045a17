// Row gather, f32, sm_90a:
//   out[r, k*C : (k+1)*C] = table[idx[r, k]]
// table (M, C), idx (R, K) int32, out (R, K*C); C a multiple of 4. A row
// whose index lies outside [0, M) is written as zeros.
//
// Replaces: the gather probes of tools/probe_gather.py: probe_a (27 rows per
// query out of a VMEM-resident table, jnp.take inside a Pallas kernel) and
// probe_e (one row per query, take_along_axis over the whole table). Those
// shapes exist because Mosaic gathers only whole-table, same-shape; on
// Hopper any thread loads any address, so one kernel serves every K.
//
// What bounds it on the card: bytes at 27 rows per query (56 MB written, a
// table that stays in L2). At one row per query the whole copy is 2 to 16
// MB, a microsecond or two of the memory rate: the launch itself (1.2 us
// for an empty kernel replayed from a CUDA graph on an H100) and the chain
// of two dependent loads behind it (the index, then the row) set the
// kernel's 2.3 to 4.4 us, and a call costs the host several times that.
//
// Design: the output is R*K gathered rows laid end to end, as float4s. A
// block copies UNROLL * 256 consecutive float4s; a thread takes UNROLL of
// them, 256 apart, so a warp always writes 512 contiguous bytes. For each of
// its float4s a warp reads the indices of the (at most 32) rows it touches
// once, one per lane and coalesced, and hands each lane its row's index by
// a shuffle; all index loads are issued first, then all row loads (read-only
// path), then the stores, which are streaming stores so that the output
// does not push the table out of L2. Measured: the streaming stores take 15%
// off the time at 27 rows per query (92% of the byte bound); two float4s a
// thread is the best of 1, 2, 4 and 8 there, and at one row per query 1, 2
// and 4 are level with one load and one store per thread (within 0.1 us).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;

// I: int where the output has fewer than 2^31 float4s, else long long
template <typename I>
__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const float4* __restrict__ table,
                  const int* __restrict__ idx, float4* __restrict__ out,
                  int M, int lanes, I total, I n_rows) {
  const int lane = threadIdx.x & 31;
  const I base = (I)blockIdx.x * (THREADS * UNROLL) + threadIdx.x;
  I at[UNROLL];
  int piece[UNROLL], hop[UNROLL], mine[UNROLL];
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    at[j] = base + j * THREADS;
    // past the end: stay on the last float4, store nothing
    const I e = at[j] < total ? at[j] : total - 1;
    const I g = e / lanes;                               // gathered row
    piece[j] = (int)(e - g * lanes);
    const I g0 = __shfl_sync(0xffffffffu, g, 0);         // the warp's first
    hop[j] = (int)(g - g0);                              // 0 .. 31
    mine[j] = g0 + lane < n_rows ? __ldg(idx + g0 + lane) : -1;
  }
  int src[UNROLL];
#pragma unroll
  for (int j = 0; j < UNROLL; ++j)
    src[j] = __shfl_sync(0xffffffffu, mine[j], hop[j]);
  float4 v[UNROLL];
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src[j] >= 0 && src[j] < M)
      v[j] = __ldg(table + (long long)src[j] * lanes + piece[j]);
  }
#pragma unroll
  for (int j = 0; j < UNROLL; ++j)
    if (at[j] < total) __stcs(out + at[j], v[j]);
}

}  // namespace

// n_rows = R * K gathered rows; table and out are 16-byte aligned. Launches
// on `stream`; returns cudaGetLastError() of the launch (0 = ok), or
// cudaErrorInvalidValue for a width that is not a multiple of 4 or a size
// the grid cannot hold.
extern "C" int mgar_row_gather_f32(const float* table, const int* idx,
                                   float* out, int M, int C,
                                   long long n_rows, void* stream) {
  if (C <= 0 || C % 4 != 0 || M <= 0 || n_rows <= 0)
    return (int)cudaErrorInvalidValue;
  const int lanes = C / 4;
  const long long total = n_rows * lanes;
  const long long per_block = (long long)THREADS * UNROLL;
  const long long blocks = (total + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* table4 = reinterpret_cast<const float4*>(table);
  float4* out4 = reinterpret_cast<float4*>(out);
  if (total + per_block <= 2147483647LL)
    row_gather_kernel<int><<<(unsigned)blocks, THREADS, 0, s>>>(
        table4, idx, out4, M, lanes, (int)total, (int)n_rows);
  else
    row_gather_kernel<long long><<<(unsigned)blocks, THREADS, 0, s>>>(
        table4, idx, out4, M, lanes, total, n_rows);
  return (int)cudaGetLastError();
}
