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
// What bounds it on the card: bytes. Every output byte is written once and
// read once from a table that fits in L2 at the probes' sizes; there is no
// arithmetic. The least traffic is table + idx + out.
//
// Design: the output is R*K gathered rows laid end to end. C/4 neighbouring
// threads copy one row as float4s (8 threads at C = 32, a whole warp at
// C = 128), so a warp reads 4 rows of 128 bytes (or one of 512) and writes
// 512 contiguous bytes. The row's index is read by each of its threads
// (a broadcast within the warp).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const float4* __restrict__ table,
                  const int* __restrict__ idx, float4* __restrict__ out,
                  int M, int lanes, long long total) {
  const long long gid = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (gid >= total) return;
  const long long g = gid / lanes;       // gathered row
  const int lane = (int)(gid - g * lanes);
  const int src = idx[g];
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (src >= 0 && src < M) v = table[(long long)src * lanes + lane];
  out[gid] = v;
}

}  // namespace

// n_rows = R * K gathered rows. Launches on `stream`; returns
// cudaGetLastError() of the launch (0 = ok), or cudaErrorInvalidValue for a
// width that is not a multiple of 4 or a size the grid cannot hold.
extern "C" int mgar_row_gather_f32(const float* table, const int* idx,
                                   float* out, int M, int C,
                                   long long n_rows, void* stream) {
  if (C <= 0 || C % 4 != 0 || M <= 0 || n_rows <= 0)
    return (int)cudaErrorInvalidValue;
  const int lanes = C / 4;
  const long long total = n_rows * lanes;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  row_gather_kernel<<<(unsigned)blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), idx,
      reinterpret_cast<float4*>(out), M, lanes, total);
  return (int)cudaGetLastError();
}
