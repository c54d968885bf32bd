// Forward tile blend of depth-sorted Gaussian pairs, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel segsplat_tpu/ops/blend_pallas.py:188
// blend_tiles_pallas_dma (body _blend_body :122). Per 16x16 tile it composites
// the tile's first min(count, K) depth-sorted pairs front to back:
//   sigma = 1/2 (a dx^2 + c dy^2) + b dx dy,  alpha = min(0.999, op e^-sigma),
//   alpha kept only where sigma >= 0 and alpha >= 1/255,
//   img = sum alpha T_before colour + T_fin bg,  alpha_out = 1 - T_fin.
//
// The early-out follows the TPU kernel exactly, not the usual per-pixel exit:
// the tile stops only at the end of a G-row block (G = 256 if K % 256 == 0,
// else 128), and only once every pixel's transmittance is below 1e-4. K may be
// any positive count (the TPU kernel asks for a multiple of G): a tile's last
// block is then partial, and the cap still falls at row K. A pixel
// already below it keeps accumulating until then; stopping it earlier changes
// logits of magnitude ~4 by more than 1e-4. sigma and alpha are computed as
// blend_common.cuh says, so the cut falls as in the plain version.
//
// Bound on the card: every pair-pixel of a row read costs about 15 fp32
// operations (one exp among them), and one that passes the cut another
// 2 CH + 3; the payload is read once and the image written once.
//
// What the first design lost: every warp computed sigma, exp, alpha and
// the cut for every row of the tile (about 25 instructions a lane), though on
// the main inputs no lane passes in 52-54 % of warp-rows; each chunk was
// loaded with plain loads between two barriers, with no copy in flight while
// the block computed; and one row at a time made T a serial chain.
//
// This design: one block per tile, one thread per pixel, a warp per 8 x 4
// block of pixels (blend_common.cuh), the CH running sums in registers.
//   Staging: rows come in chunks of 64 through a ring of 3-4 stages in shared
//   memory, each chunk one 1-D bulk copy (cp.async.bulk) that completes on
//   its stage's mbarrier. The last warp done with a chunk issues the chunk
//   three or four on into its stage, so warps wait only for rows; the block
//   meets only at a G-row block's start, where __syncthreads_or decides the
//   early-out.
//   Row lists: on each chunk, each warp tests its block against the chunk's
//   rows, lane l rows l and l + 32 (row_may_hit), and ballots the answers into
//   a 64-bit list. The test never drops a row in which a pixel of the warp
//   passes the cut, so a dropped row would have had alpha 0 at all 32 pixels
//   and the result is the same bit for bit.
//   Sweep: the warp walks its list's set bits in order, kBatch rows at a time
//   (warp-uniform): their cuts first, independent of each other, then the
//   serial transmittance and colour sums of the batch.
// What it costs and what each part bought is in PERF.md (scripts/bench_k1.py;
// scripts/k1_variants.py writes the alternatives that were timed).
//
// The indexed variant (kIndexed, entry segsplat_blend_fwd_indexed) reads no
// gathered payload: tile t's row i is table[ids[offsets[t] + i]], with the
// table's N rows per Gaussian and ids the pairs' rows of it in per-tile runs
// (the rasterizer's no-grad path: the table in depth order, ids the depth
// ranks, so the rows and their order are those of the gathered payload and
// the result is the same bits). Where it stands against the bound: the
// gathered payload costs a write and a read of 16 kW4 bytes for every slot
// of the sort (N m^2, most of them sentinels or past K), plus a copy for the
// K zero rows, all of it before K1 starts; read through the ids, only the
// rows K1 stages move, 8 bytes of id and one row each, and a Gaussian's row
// repeats over the up to m^2 tiles it covers, so the table (32 MB at CH 32
// for 200 000 Gaussians) is read from L2 after its first tile. The staging
// changes only in the fill: the refilling warp reads the chunk's ids, two a
// lane, coalesced, and each lane issues its rows' bulk copies on the stage's
// mbarrier, which expects the same n kW4 16 bytes; the count bounds every
// read, so no zero rows are needed past a run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_common.cuh"

namespace {

using namespace segsplat;

constexpr int kBatch = 2;       // rows whose cut the sweep computes together

// payload: the gathered rows in per-tile runs, or with kIndexed the table
// that ids index (ids is read only with kIndexed)
template <int CH, bool kIndexed>
__global__ void __launch_bounds__(kPx, Layout<CH>::kMinBlocks)
blend_fwd_kernel(const int32_t* __restrict__ offsets,
                 const float4* __restrict__ payload,
                 const int64_t* __restrict__ ids,
                 const float* __restrict__ bg,
                 float* __restrict__ img,
                 float* __restrict__ alpha_out,
                 int tx_n, int k_max, int g_block) {
  using L = Layout<CH>;
  constexpr int CHP = L::CHP, kW4 = L::kW4;
  __shared__ RowRing<L::kStages, L::kRows, kW4, kW4> ring;
  SEG_START

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  const int tile_x = (tile % tx_n) * kTile, tile_y = (tile / tx_n) * kTile;
  const int x = tile_x + foot_x(warp, lane);
  const int y = tile_y + foot_y(warp, lane);
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  // the pixel centres of the warp's block: [bx0, bx1] x [by0, by1]
  const float bx0 = static_cast<float>(tile_x + foot_x(warp, 0)) + 0.5f;
  const float by0 = static_cast<float>(tile_y + foot_y(warp, 0)) + 0.5f;
  const float bx1 = bx0 + static_cast<float>(kFootW - 1);
  const float by1 = by0 + static_cast<float>(kFootH - 1);
  const int start = offsets[tile];
  const int count = min(offsets[tile + 1] - start, k_max);

  float acc[CHP];
#pragma unroll
  for (int c = 0; c < CHP; ++c) acc[c] = 0.f;
  float T = 1.f;

  auto blend = [&](const float4* rows, int n) {
    // the warp's list of the chunk's rows that may hit its block: lane l
    // tests rows l and l + 32
    const bool h0 = lane < n && row_may_hit(rows[lane * kW4], rows[lane * kW4 + 1],
                                            bx0, bx1, by0, by1);
    const bool h1 = lane + 32 < n && row_may_hit(rows[(lane + 32) * kW4],
                                                 rows[(lane + 32) * kW4 + 1], bx0, bx1, by0, by1);
    uint64_t list = static_cast<uint64_t>(__ballot_sync(kFull, h0)) |
                    (static_cast<uint64_t>(__ballot_sync(kFull, h1)) << 32);
    SEG_KEPT(__popcll(list))
    SEG_MARK(3)

    while (list) {
      int r[kBatch];
      float a[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {    // the next kBatch rows of the list, in order
        r[u] = __ffsll(static_cast<long long>(list)) - 1;   // -1 once the list is empty
        list &= list - 1;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        a[u] = r[u] >= 0 ? pair_alpha(rows[r[u] * kW4], rows[r[u] * kW4 + 1], px, py) : 0.f;
      SEG_MARK(4)
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (a[u] > 0.f) {
          const float w = __fmul_rn(a[u], T);
          const float4* col = rows + r[u] * kW4 + kGeom4;
#pragma unroll
          for (int c4 = 0; c4 < CHP / 4; ++c4) {
            const float4 cv = col[c4];
            acc[4 * c4 + 0] = fmaf(w, cv.x, acc[4 * c4 + 0]);
            acc[4 * c4 + 1] = fmaf(w, cv.y, acc[4 * c4 + 1]);
            acc[4 * c4 + 2] = fmaf(w, cv.z, acc[4 * c4 + 2]);
            acc[4 * c4 + 3] = fmaf(w, cv.w, acc[4 * c4 + 3]);
          }
          T = __fmul_rn(T, __fsub_rn(1.f, a[u]));
        }
      }
      SEG_MARK(5)
    }
  };
  if constexpr (kIndexed)
    run_chunks<decltype(ring), L::kStages, L::kRows>(ring, RowsById{payload, ids + start}, count,
                                                     g_block, p, seg_, blend, [&] { return T; });
  else
    run_chunks<decltype(ring), L::kStages, L::kRows>(
        ring, payload + static_cast<size_t>(start) * kW4, count, g_block, p, seg_, blend,
        [&] { return T; });

  write_pixel<CH, CHP>(img, alpha_out, acc, T, bg, static_cast<size_t>(y) * (tx_n * kTile) + x);
  SEG_MARK(6)
  SEG_FLUSH
}

template <int CH, bool kIndexed>
int launch(const void* offsets, const void* payload, const void* ids, const void* bg, void* img,
           void* alpha, int tx_n, int ty_n, int k_max, int g_block, cudaStream_t stream) {
  blend_fwd_kernel<CH, kIndexed><<<tx_n * ty_n, kPx, 0, stream>>>(
      static_cast<const int32_t*>(offsets), static_cast<const float4*>(payload),
      static_cast<const int64_t*>(ids), static_cast<const float*>(bg), static_cast<float*>(img),
      static_cast<float*>(alpha), tx_n, k_max, g_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

SEGSPLAT_CLOCKS_ENTRY(segsplat_blend_fwd_clocks)

// Plain C entry point for ctypes. Returns a cudaError_t: the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported channel count
// or a g_block that is not positive.
extern "C" int segsplat_blend_fwd(const void* offsets, const void* payload,
                                  const void* bg, void* img, void* alpha,
                                  int tx_n, int ty_n, int k_max, int g_block,
                                  int ch, void* stream) {
  if (g_block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch) {  // ops/blend.py pads CH up to one of these widths
#define SEGSPLAT_CASE(W)                                                                    \
    case W:                                                                                 \
      return launch<W, false>(offsets, payload, nullptr, bg, img, alpha, tx_n, ty_n, k_max, \
                              g_block, s);
    SEGSPLAT_WIDTHS(SEGSPLAT_CASE)
#undef SEGSPLAT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The indexed variant: tile t blends rows table[ids[offsets[t] + i]] for
// i < min(offsets[t + 1] - offsets[t], k_max). table is [N, 2 + ceil(CH / 4)] float4s
// (16-byte aligned), ids int64 with every id read in [0, N). Returns a
// cudaError_t as segsplat_blend_fwd does.
extern "C" int segsplat_blend_fwd_indexed(const void* offsets, const void* ids,
                                          const void* table, const void* bg, void* img,
                                          void* alpha, int tx_n, int ty_n, int k_max,
                                          int g_block, int ch, void* stream) {
  if (g_block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch) {  // ops/blend.py pads CH up to one of these widths
#define SEGSPLAT_CASE(W)                                                                   \
    case W:                                                                                \
      return launch<W, true>(offsets, table, ids, bg, img, alpha, tx_n, ty_n, k_max, g_block, \
                             s);
    SEGSPLAT_WIDTHS(SEGSPLAT_CASE)
#undef SEGSPLAT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Occupancy of the kernel at ``ch`` channels on the current device: blocks of
// 256 threads an SM holds at once, static shared memory per block, registers
// per thread and local (spill) memory per thread. Returns a cudaError_t.
template <bool kIndexed>
static int occupancy_at(int ch, int* blocks_per_sm, int* smem_bytes, int* registers,
                        int* local_bytes) {
  switch (ch) {
#define SEGSPLAT_CASE(W)                                                                   \
    case W: return segsplat::occupancy(blend_fwd_kernel<W, kIndexed>, blocks_per_sm,       \
                                       smem_bytes, registers, local_bytes);
    SEGSPLAT_WIDTHS(SEGSPLAT_CASE)
#undef SEGSPLAT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int segsplat_blend_fwd_occupancy(int ch, int* blocks_per_sm, int* smem_bytes,
                                            int* registers, int* local_bytes) {
  return occupancy_at<false>(ch, blocks_per_sm, smem_bytes, registers, local_bytes);
}

// The same of the indexed variant.
extern "C" int segsplat_blend_fwd_indexed_occupancy(int ch, int* blocks_per_sm,
                                                    int* smem_bytes, int* registers,
                                                    int* local_bytes) {
  return occupancy_at<true>(ch, blocks_per_sm, smem_bytes, registers, local_bytes);
}
