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
// mgar_subm_conv_dgrad_bf16 (kernel C) is the data gradient at bf16:
// replaces XLA's VJP of that gather + einsum
// (multimodal_gar_tpu/models/sparse_backbone.py:162, :172-173; strided
// :298-299), dF[r] = sum_k bf16(W[k]^T dOut[inv[r, k]]) over the layer's
// inverse map, bf16 dOut (B, M, C) and transposed weights (27, C, D),
// each tap's product a float32 sum rounded to bf16 before it joins the
// float32 sum over the taps, and the sums written as float32.
//
// What bounds kernel C on the card: not its bytes (about 1 us a layer at
// 3.35 TB/s) nor its products, but the chain of dependent steps a block
// walks: its index words and tap mask, then per chunk of taps an index ->
// row gather -> product step. At 4k-16k rows a layer has 32-250 tiles of
// 64 rows, so a block per tile leaves most of the card idle and each block
// walks up to 27 taps one after another.
//
// Design: the forward core's warp-specialised ring (csrc/gather_wgmma.cuh)
// with the taps of a tile split over a thread-block cluster.
//  - A cluster of S blocks shares one 64-row tile (S = 1, 2, 4 or 8:
//    dgrad_cluster, the largest that keeps the launch within one wave of
//    the card's blocks, and 2 at least at C = 64, where a tile's chain of
//    one tap a stage is longest: 1-2 at the 16k layers, 4 at the 4k ones).
//    Every block loads the tile's index words and ORs its tap mask as it
//    loads them; block j takes the j-th of S contiguous shares of the
//    tile's present taps, in ascending order. A tap no row of the tile uses
//    costs nothing, and a tile whose present taps fill one stage is not
//    split: rank 0 takes it alone and the others leave.
//  - A stage holds G = DGRAD_KC / C = 64 / C of the block's present taps,
//    packed: the 64 rows' gathered dOut values in wgmma's K-major A layout,
//    gathered by the producer warpgroup with 16-byte cp.async (zeros stored
//    for a row's absent tap), and each tap's C x D weights by TMA from a
//    tensor map over W (27 C, D), one box a tap, swizzled at 2 D bytes, on
//    full and empty mbarriers. As many stages as fit beside the SM's other
//    blocks (4-5); 2-4 blocks an SM, by the consumer's registers.
//  - The consumer warpgroup issues each tap's C / 16 wgmma m64nDk16 from
//    shared memory into a fresh accumulator set (scale-d 0 on the first);
//    two sets of D / 2 registers take the taps in turn: tap t + 1's
//    wgmmas are in flight (wgmma.wait_group 1) while tap t's set is rounded
//    to bf16 and added to the float32 running sums, in ascending tap order.
//  - The cluster adds its blocks' float32 sums through distributed shared
//    memory, pushed: each block arrives on the cluster barrier (relaxed)
//    once its taps are known and waits on it before its stores, then
//    stores each row's sums into the receive buffer of the block that owns
//    the row (rank row / (64 / S)), in its own slot; barrier.cluster arrive
//    / wait; block j then adds its 64 / S rows' S slots in rank order from
//    its own shared memory and stores them. Unsplit, the sums are stored
//    directly.
//  - The wide pairs (UNetV2's decoder, the residual encoders, the pillar
//    backbone's last stage): past D = 64 dF's 64-column slices go to the
//    grid's z, each block taking one slice's weights (boxes of C rows x 64
//    columns) and its 3 D / 2 = 96 accumulators a thread, as at D = 64;
//    past C = 64 a stage holds one tap of C values (its C / 16 k16 steps
//    into one accumulator set, rounded once as every tap's), 2 blocks an
//    SM at C = 128 and 1 at C = 256. At C, D <= 64 the code is the one
//    before.
//  Each element sums its taps in one fixed order (ascending within a
//  block, blocks in rank order), so two runs give the same bits; against
//  one ascending float32 sum only the association differs.
//  Measured on an H100 and not taken: stages of 128 K values (fewer,
//  larger stages; slower), S = 4 or 8 wherever one wave allows (slower:
//  each split adds a prologue and a reduction), back-off in the mbarrier
//  waits, fewer arrivals a stage, one block an SM (no change). What is
//  left: a stage's hand-off costs nearly as much without its gathers and
//  weights as with them, so a tile's chain of 7-27 stages sets the time
//  (PERF.md section 6).

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

// ---- Kernel C on wgmma over a cluster (its note at the top) -------------

// blocks an SM: the consumer holds 3 DS / 2 float32 accumulators a thread
// (DS the dF columns of a block); a stage of C = 256 values takes 64 KB
constexpr int dgrad_blocks_per_sm(int DS, int C = 64) {
  return C > 128 ? 1 : (DS == 64 ? 2 : (DS == 32 ? 3 : 4));
}

// K values a stage of kernel C holds: G = DGRAD_KC / C taps, or one tap of
// C values past C = 64
constexpr int DGRAD_KC = 64;

template <int C, int D>
struct DgradTile {
  static constexpr int KC = C > DGRAD_KC ? C : DGRAD_KC;  // K a stage
  static constexpr int G = KC / C;                 // tap slots a stage
  static constexpr int KG = KC / 8;                // core matrices along K
  static constexpr int DS = D > 64 ? 64 : D;       // dF columns a block
  static constexpr int D_BLOCKS = D / DS;          // slices on the grid's z
  static constexpr int BLOCKS_PER_SM = dgrad_blocks_per_sm(DS, C);
  static constexpr int A_BYTES = 64 * KC * 2;      // 64 rows x G taps x C
  static constexpr int B_BYTES = KC * DS * 2;      // G taps x C rows of W
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RECV_BYTES = 64 * DS * 4;
  static constexpr int IDX_BYTES = 64 * 27 * 4;
  // as many stages as fit beside BLOCKS_PER_SM - 1 other blocks of the SM
  static constexpr int STAGES =
      (232448 / BLOCKS_PER_SM - 1024 - RECV_BYTES - IDX_BYTES - 256) /
      STAGE_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  // the cluster's sums of this block's rows, S slices of 64 / S rows
  static constexpr int RECV_OFFSET = RING_BYTES;
  static constexpr int BAR_OFFSET = RECV_OFFSET + RECV_BYTES;
  static constexpr int MASK_OFFSET = BAR_OFFSET + 2 * STAGES * 8;
  static constexpr int IDX_OFFSET = MASK_OFFSET + 8 * 4;   // warps' masks
  static constexpr int SMEM_BYTES = IDX_OFFSET + IDX_BYTES;
  static_assert(STAGES >= 2, "a ring of two stages at least");
  static_assert(C == 16 || C == 32 || C == 64 || C == 128 || C == 256,
                "dOut widths");
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                "dF widths");
  static_assert(STAGE_BYTES % 1024 == 0, "stages aligned for the swizzle");
};

template <int C, int D>
__global__ void __launch_bounds__(mgar::GW_THREADS,
                                  DgradTile<C, D>::BLOCKS_PER_SM)
dgrad_bf16_kernel(const __grid_constant__ CUtensorMap wmap,
                  const __nv_bfloat16* __restrict__ dout,
                  const int* __restrict__ idx, float* __restrict__ out,
                  int R, int M) {
  using TL = DgradTile<C, D>;
  using namespace mgar;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TL::BAR_OFFSET);
  uint64_t* empty = full + TL::STAGES;
  unsigned* wmask = reinterpret_cast<unsigned*>(smem + TL::MASK_OFFSET);
  int* idx_s = reinterpret_cast<int*>(smem + TL::IDX_OFFSET);
  float* recv = reinterpret_cast<float*>(smem + TL::RECV_OFFSET);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const unsigned S = cluster_size();
  const unsigned rank = cluster_rank();
  const int r0 = blockIdx.x / S * GW_ROWS;
  const int b = blockIdx.y;
  constexpr int DS = TL::DS;
  const int d0 = TL::D_BLOCKS == 1 ? 0 : (int)blockIdx.z * DS;
  dout += (size_t)b * M * C;
  idx += (size_t)b * R * 27;
  out += (size_t)b * R * D;

  // the tile's index words, and which taps its rows use
  unsigned present = 0u;
  for (int i = tid; i < GW_ROWS * 27; i += GW_THREADS) {
    const int src = (r0 + i / 27) < R ? idx[(size_t)r0 * 27 + i] : -1;
    idx_s[i] = src;
    if (src >= 0 && src < M) present |= 1u << (i % 27);
  }
  present = __reduce_or_sync(0xffffffffu, present);
  if (lane == 0) wmask[warp] = present;
  if (tid == 0) {
    for (int s = 0; s < TL::STAGES; ++s) {
      // each producer's stores and copies, and the TMA
      mbar_init(&full[s], 2 * GW_PRODUCERS + 1);
      mbar_init(&empty[s], 4);        // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  unsigned taps = 0u;
#pragma unroll
  for (int w = 0; w < 8; ++w) taps |= wmask[w];
  // this block's taps: the rank-th of S contiguous shares of the tile's
  // present taps, ascending
  taps = __shfl_sync(0xffffffffu, taps, 0);
  const int P = __popc(taps);
  // a tile whose taps fill one stage is not split: rank 0 takes it alone
  const bool split = S > 1 && P > TL::G;
  if (!split && rank > 0) return;
  if (split) cluster_arrive_relaxed();   // this block has started
  const int lo = split ? (int)(rank * P / S) : 0;
  const int T = split ? (int)((rank + 1) * P / S) - lo : P;
  unsigned mine = taps;
  for (int i = 0; i < lo; ++i) mine &= mine - 1u;
  {
    unsigned rest = mine;
    for (int i = 0; i < T; ++i) rest &= rest - 1u;
    mine ^= rest;
  }

  const int row = 16 * warp + (lane >> 2);   // the consumer's rows
  const int col = (lane & 3) * 2;            // and columns, as wgmma's
  if (warp >= 4) {
    // producer warpgroup: G taps a stage, their weights by TMA and their
    // rows by cp.async. A thread's 8 values of K (one slot) and rows are
    // the same in every stage: core matrix (rg, kg) at (KG rg + kg) 128 B.
    const int ptid = tid - 128;
    const int rlo = ptid & 7;
    const int kg = (ptid >> 3) & (TL::KG - 1);
    const int slot = kg / (C / 8);
    const int piece = kg % (C / 8);
    constexpr int RGP = 128 / (8 * TL::KG);   // row groups a pass
    unsigned rest = mine;
    for (int n = 0; rest; ++n) {
      const int s = n % TL::STAGES;
      mbar_wait(&empty[s], ((n / TL::STAGES) & 1) ^ 1);
      unsigned char* stage = smem + s * TL::STAGE_BYTES;
      int tap = -1, ns = 0;
      unsigned next = rest;
      for (; ns < TL::G && next; ++ns) {
        if (ns == slot) tap = __ffs(next) - 1;
        next &= next - 1u;
      }
      if (ptid == 0) {
        mbar_arrive_expect_tx(&full[s], ns * C * DS * 2);
        unsigned t = rest;
        for (int g = 0; g < ns; ++g, t &= t - 1u)
          tma_load_2d(stage + TL::A_BYTES + g * C * DS * 2, &wmap, d0,
                      (__ffs(t) - 1) * C, &full[s]);
      }
      rest = next;
      if constexpr (TL::KG > 16) {
        // C = 256: the stage's one tap, 64 rows x 32 core matrices, 16 a
        // thread
        if (tap >= 0) {
          __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(stage);
          for (int i = ptid; i < 64 * TL::KG; i += 128) {
            const int q = i >> 3;              // core matrix rg KG + k
            const int src = idx_s[(q / TL::KG * 8 + (i & 7)) * 27 + tap];
            __nv_bfloat16* dst = a_s + q * 64 + (i & 7) * 8;
            if (src >= 0 && src < M)
              cp_async16(dst, dout + (size_t)src * C + (q % TL::KG) * 8,
                         true);
            else
              *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      } else if (tap >= 0) {
        __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(stage);
#pragma unroll
        for (int j = 0; j < 8 / RGP; ++j) {
          const int rg = ptid / (8 * TL::KG) + RGP * j;
          const int src = idx_s[(rg * 8 + rlo) * 27 + tap];
          __nv_bfloat16* dst = a_s + (rg * TL::KG + kg) * 64 + rlo * 8;
          if (src >= 0 && src < M)
            cp_async16(dst, dout + (size_t)src * C + piece * 8, true);
          else
            *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      mbar_arrive(&full[s]);            // its zero stores
      cp_async_mbar_arrive(&full[s]);   // its copies, once they land
    }
    if (split) cluster_wait();
  } else {
    // consumer warpgroup: per tap a fresh sum of its C / 16 k16 steps
    // (scale-d 0 on the first), two sets in turn: tap t + 1's wgmmas run
    // while tap t's set is rounded to bf16 and added to the float32 sums
    float sum[DS / 2], acc0[DS / 2], acc1[DS / 2];
#pragma unroll
    for (int i = 0; i < DS / 2; ++i) sum[i] = acc0[i] = acc1[i] = 0.f;
    pin_regs(acc0);
    pin_regs(acc1);
    const uint64_t a_desc = gmma_desc(smem, 128, TL::KG * 128);
    const uint64_t b_desc = gmma_desc(smem + TL::A_BYTES, TL::B_BYTES,
                                      16 * DS,
                                      DS == 64 ? 1 : (DS == 32 ? 2 : 3));
    auto issue = [&](int t, float (&acc)[DS / 2]) {
      const int n = t / TL::G;
      const int slot = t - n * TL::G;
      const int s = n % TL::STAGES;
      if (slot == 0) {
        mbar_wait(&full[s], (n / TL::STAGES) & 1);
        fence_proxy_async();
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        const int ks = slot * (C / 16) + kk;
        const uint64_t sa = (uint64_t)((s * TL::STAGE_BYTES + ks * 256) >> 4);
        const uint64_t sb =
            (uint64_t)((s * TL::STAGE_BYTES + ks * 32 * DS) >> 4);
        wgmma_ss_bn<DS, 0>(acc, a_desc + sa, b_desc + sb, kk);
      }
      wgmma_commit();
    };
    // tap t's products are done: round them, add them, and free the stage
    // after its last tap
    auto retire = [&](int t, float (&acc)[DS / 2]) {
      pin_regs(acc);
#pragma unroll
      for (int i = 0; i < DS / 2; ++i) sum[i] += round_bf16(acc[i]);
      if (t % TL::G == TL::G - 1 || t == T - 1) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(t / TL::G) % TL::STAGES]);
      }
    };
    for (int t = 0; t < T; t += 2) {
      issue(t, acc0);
      wgmma_wait<1>();
      if (t > 0) retire(t - 1, acc1);
      if (t + 1 < T) {
        issue(t + 1, acc1);
        wgmma_wait<1>();
        retire(t, acc0);
      }
    }
    wgmma_wait<0>();
    if (T > 0) {
      if (T & 1)
        retire(T - 1, acc0);
      else
        retire(T - 1, acc1);
    }
    // sum[4 j + i]: row `row` + 8 (i / 2), column 8 j + col + i % 2; split,
    // each row goes to the block of rank row / (64 / S), into the slot of
    // this rank
    const int slice = GW_ROWS / S;
    if (split) cluster_wait();          // every block's buffer is live
#pragma unroll
    for (int j = 0; j < DS / 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v0 = sum[4 * j + 2 * half];
        const float v1 = sum[4 * j + 2 * half + 1];
        const int r = row + 8 * half;
        if (!split) {
          if (r0 + r < R)
            *reinterpret_cast<float2*>(out + (size_t)(r0 + r) * D + d0 +
                                       8 * j + col) = make_float2(v0, v1);
        } else {
          const unsigned owner = r / slice;
          st_cluster_f2(
              cluster_map(recv + ((rank * slice + r - owner * slice) * DS +
                                  8 * j + col),
                          owner),
              v0, v1);
        }
      }
    }
  }
  if (!split) return;

  // this block's rows of the tile: the S blocks' sums added in rank order
  cluster_arrive();
  cluster_wait();
  const int slice = GW_ROWS / S;
  const float4* recv4 = reinterpret_cast<const float4*>(recv);
  for (int o = tid; o < slice * DS / 4; o += GW_THREADS) {
    float4 v = recv4[o];
    for (unsigned q = 1; q < S; ++q) {
      const float4 u = recv4[q * slice * DS / 4 + o];
      v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
    }
    const int r = rank * slice + o / (DS / 4);
    if (r0 + r < R)
      *reinterpret_cast<float4*>(out + (size_t)(r0 + r) * D + d0 +
                                 (o % (DS / 4)) * 4) = v;
  }
}

// The tensor map over the transposed weights W (27 C, D) bf16 that kernel
// C reads: boxes of one tap's C rows x min(D, 64) columns, swizzled at
// that width.
inline int encode_tap_weight_map(CUtensorMap* map, const void* w, int C,
                                 int D) {
  const int ds = D > 64 ? 64 : D;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)27 * C};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)ds, (cuuint32_t)C};
  return mgar::encode_bf16_map(map, w, 2, dims, strides, box,
                               ds == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                        : (ds == 32
                                               ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B));
}

// The blocks a tile's taps are split over: the largest power of two up to
// 8 whose launch (`tiles` tiles and dF slices) still fits one wave of the
// card's blocks, and 2 at least from C = 64, where a stage holds one tap
// and a tile's chain is longest.
inline int dgrad_cluster(long long tiles, int C, int D) {
  const int ds = D > 64 ? 64 : D;
  const long long slots =
      (long long)dgrad_blocks_per_sm(ds, C) * mgar::sm_count();
  int s = 1;
  while (s < 8 && tiles * s * 2 <= slots) s *= 2;
  return C >= 64 && s == 1 ? 2 : s;
}

template <int C, int D>
int launch_dgrad(const void* dout, const int* idx, const void* w, float* out,
                 int B, int R, int M, cudaStream_t stream) {
  using TL = DgradTile<C, D>;
  CUtensorMap wmap;
  const int err = encode_tap_weight_map(&wmap, w, C, D);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      dgrad_bf16_kernel<C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TL::SMEM_BYTES);
  if (cerr != cudaSuccess) return (int)cerr;
  const int tiles = (R + mgar::GW_ROWS - 1) / mgar::GW_ROWS;
  const int S = dgrad_cluster((long long)tiles * B * TL::D_BLOCKS, C, D);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = S;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(tiles * S, B, TL::D_BLOCKS);
  config.blockDim = dim3(mgar::GW_THREADS);
  config.dynamicSmemBytes = TL::SMEM_BYTES;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  cerr = cudaLaunchKernelEx(&config, dgrad_bf16_kernel<C, D>, wmap,
                            static_cast<const __nv_bfloat16*>(dout), idx,
                            out, R, M);
  if (cerr != cudaSuccess) return (int)cerr;
  return (int)cudaGetLastError();
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
// (B, R, D): the forward (C, D) pairs of the sparse backbones at 16 input
// channels or more (ops/kernels/subm_conv.py: SUPPORTED_BF16 names the
// modules; the Python wrapper pads a narrower input to 16 and checks the
// pair). Same return convention as mgar_subm_conv_f32.
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
  if (C == 32 && D == 16)
    return launch_wgmma<32, 16>(table, idx, w, out, B, R, M, s);
  if (C == 64 && D == 32)
    return launch_wgmma<64, 32>(table, idx, w, out, B, R, M, s);
  if (C == 64 && D == 16)
    return launch_wgmma<64, 16>(table, idx, w, out, B, R, M, s);
  if (C == 128 && D == 64)
    return launch_wgmma<128, 64>(table, idx, w, out, B, R, M, s);
  if (C == 64 && D == 128)
    return launch_wgmma<64, 128>(table, idx, w, out, B, R, M, s);
  if (C == 128 && D == 128)
    return launch_wgmma<128, 128>(table, idx, w, out, B, R, M, s);
  if (C == 256 && D == 256)
    return launch_wgmma<256, 256>(table, idx, w, out, B, R, M, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel C: bf16 dOut (B, M, C), the inverse maps (B, R, 27), the
// transposed bf16 weights W (27, C, D) and float32 dF (B, R, D), where C is
// the layer's output width and D its input width: the transposed pairs of
// the sparse backbones' layers that take a data gradient
// (ops/kernels/subm_conv.py: SUPPORTED_DGRAD_BF16). Same return
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
  if (C == 16 && D == 32)
    return launch_dgrad<16, 32>(dout, idx, w, out, B, R, M, s);
  if (C == 16 && D == 64)
    return launch_dgrad<16, 64>(dout, idx, w, out, B, R, M, s);
  if (C == 32 && D == 64)
    return launch_dgrad<32, 64>(dout, idx, w, out, B, R, M, s);
  if (C == 64 && D == 128)
    return launch_dgrad<64, 128>(dout, idx, w, out, B, R, M, s);
  if (C == 128 && D == 64)
    return launch_dgrad<128, 64>(dout, idx, w, out, B, R, M, s);
  if (C == 128 && D == 128)
    return launch_dgrad<128, 128>(dout, idx, w, out, B, R, M, s);
  if (C == 256 && D == 256)
    return launch_dgrad<256, 256>(dout, idx, w, out, B, R, M, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel C's cluster size at these shapes (1 outside the widths it
// takes): the blocks one 64-row tile's taps are split over.
extern "C" int mgar_subm_conv_dgrad_bf16_cluster(int B, int R, int C,
                                                 int D) {
  if (B <= 0 || R <= 0 || C < 16 || C > 256 || D < 16 || D > 256) return 1;
  return dgrad_cluster((long long)(R + mgar::GW_ROWS - 1) / mgar::GW_ROWS * B *
                           (D > 64 ? D / 64 : 1),
                       C, D);
}
