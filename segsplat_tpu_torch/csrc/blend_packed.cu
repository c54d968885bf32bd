// Packed forward tile blend (two pairs per 128-float row), for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel segsplat_tpu/ops/blend_pallas2.py:141
// blend_tiles_pallas_packed (body _kernel :35). The payload is [R, 128] float32:
// each row holds two consecutive depth-sorted pairs of 64 floats,
// [mu_x, mu_y, conic a, b, c, opacity, 0, 0, CH colours, 0...], CH <= 56. Per
// 16x16 tile it composites the tile's first min(count, K) pairs front to back
// in couples (pairs 2c and 2c + 1 of the run), as the TPU kernel does:
//   w_A = alpha_A T,   w_B = alpha_B T (1 - alpha_A),
//   T <- T (1 - alpha_A)(1 - alpha_B),
// with sigma, alpha and the cut (sigma >= 0, 1/255 <= alpha <= 0.999, pair
// index < min(count, K)) as in blend_fwd.cu. The early-out is per g_block pairs
// (128 by default, whatever K is): the tile stops at a block's end once every
// pixel's transmittance is below 1e-4.
//
// Design: the TPU kernel DMAs rows [start >> 1, ...) and picks the half-row
// that holds the first pair by the parity of start (a lax.cond over two
// layouts). Here the payload is read as [2R, 64] pair rows: pair start + k is
// 16 float4s at a 256-byte stride, whatever the parity. The rest is K1's
// machinery (blend_common.cuh): one block per tile, one thread per pixel, a
// warp per 8 x 4 block of pixels, the CH running sums in registers; pairs come
// in chunks of 64 through a ring of stages in shared memory, one 1-D bulk copy
// per pair of the 2 + CH/4 float4s the blend reads, the last warp done with a
// chunk refilling its stage, and a barrier only at a g_block's start, for the
// early-out. Each warp keeps a list of the couples of a chunk that may hit its
// block: a couple is dropped only when row_may_hit rules out both its pairs,
// so its alphas are 0 at all 32 pixels, and its weights and T would not have
// moved: the result is the same bit for bit. Chunks end at g_block
// boundaries, and both are even, so a couple never straddles two chunks; a
// couple whose second pair lies past count gives it alpha 0.
//
// Bound on the card: the arithmetic is K1's (about 15 fp32 operations per
// pair-pixel read, 2 CH + 3 more per pair-pixel that passes the cut). The
// layout holds 256 bytes per pair, but only the 16 (2 + ceil(CH / 4)) bytes
// staged are read: in whole 32-byte sectors of the 256-byte-aligned pair, 160 B
// at CH = 32 (K1's row, 4 ceil((8 + CH) / 4), is also 160 B) and 256 B at
// CH = 51 (K1's 240 B). So K3's bound equals K1's at CH = 32 on the same rows
// and is no lower at CH = 51.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_common.cuh"

namespace {

using namespace segsplat;

constexpr int kPair4 = 16;      // float4s per pair in the packed layout (64 floats)

template <int CHP>
__device__ __forceinline__ void accumulate(float (&acc)[CHP], float w, const float4* col) {
#pragma unroll
  for (int c4 = 0; c4 < CHP / 4; ++c4) {
    const float4 c = col[c4];
    acc[4 * c4 + 0] = fmaf(w, c.x, acc[4 * c4 + 0]);
    acc[4 * c4 + 1] = fmaf(w, c.y, acc[4 * c4 + 1]);
    acc[4 * c4 + 2] = fmaf(w, c.z, acc[4 * c4 + 2]);
    acc[4 * c4 + 3] = fmaf(w, c.w, acc[4 * c4 + 3]);
  }
}

template <int CH>
__global__ void __launch_bounds__(kPx, Layout<CH>::kMinBlocks)
blend_packed_kernel(const int32_t* __restrict__ offsets,
                    const float4* __restrict__ pairs,
                    const float* __restrict__ bg,
                    float* __restrict__ img,
                    float* __restrict__ alpha_out,
                    int tx_n, int k_max, int g_block) {
  using L = Layout<CH>;
  constexpr int CHP = L::CHP, kW4 = L::kW4;   // a chunk of kRows pairs: 32 couples
  static_assert(kW4 <= kPair4, "the packed layout holds at most 56 colours");
  __shared__ RowRing<L::kStages, L::kRows, kW4, kPair4> ring;
  SEG_START

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  const int tile_x = (tile % tx_n) * kTile, tile_y = (tile / tx_n) * kTile;
  const int x = tile_x + foot_x(warp, lane);
  const int y = tile_y + foot_y(warp, lane);
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
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
    // the warp's list of the chunk's couples that may hit its block: lane l
    // tests couple l (pairs 2l and 2l + 1)
    const int ra = 2 * lane, rb = 2 * lane + 1;
    const bool hit = (ra < n && row_may_hit(rows[ra * kW4], rows[ra * kW4 + 1],
                                            bx0, bx1, by0, by1)) ||
                     (rb < n && row_may_hit(rows[rb * kW4], rows[rb * kW4 + 1],
                                            bx0, bx1, by0, by1));
    unsigned list = __ballot_sync(kFull, hit);
    SEG_KEPT(__popc(list))
    SEG_MARK(3)

    while (list) {
      const int r = 2 * (__ffs(static_cast<int>(list)) - 1);
      list &= list - 1;
      const float aA = pair_alpha(rows[r * kW4], rows[r * kW4 + 1], px, py);
      const float aB = r + 1 < n ? pair_alpha(rows[(r + 1) * kW4], rows[(r + 1) * kW4 + 1],
                                              px, py) : 0.f;
      SEG_MARK(4)
      const float oneA = __fsub_rn(1.f, aA);
      if (aA > 0.f) accumulate<CHP>(acc, __fmul_rn(aA, T), rows + r * kW4 + kGeom4);
      if (aB > 0.f)
        accumulate<CHP>(acc, __fmul_rn(__fmul_rn(aB, T), oneA), rows + (r + 1) * kW4 + kGeom4);
      T = __fmul_rn(T, __fmul_rn(oneA, __fsub_rn(1.f, aB)));
      SEG_MARK(5)
    }
  };
  run_chunks<decltype(ring), L::kStages, L::kRows>(
      ring, pairs + static_cast<size_t>(start) * kPair4, count, g_block, p, seg_, blend,
      [&] { return T; });

  write_pixel<CH, CHP>(img, alpha_out, acc, T, bg, static_cast<size_t>(y) * (tx_n * kTile) + x);
  SEG_MARK(6)
  SEG_FLUSH
}

template <int CH>
int launch(const void* offsets, const void* packed, const void* bg, void* img, void* alpha,
           int tx_n, int ty_n, int k_max, int g_block, cudaStream_t stream) {
  blend_packed_kernel<CH><<<tx_n * ty_n, kPx, 0, stream>>>(
      static_cast<const int32_t*>(offsets), static_cast<const float4*>(packed),
      static_cast<const float*>(bg), static_cast<float*>(img), static_cast<float*>(alpha),
      tx_n, k_max, g_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

SEGSPLAT_CLOCKS_ENTRY(segsplat_blend_packed_clocks)

// Plain C entry point for ctypes. g_block must be even. Returns a cudaError_t:
// the launch's cudaGetLastError(), or cudaErrorInvalidValue for an unsupported
// channel count or an odd g_block.
extern "C" int segsplat_blend_packed(const void* offsets, const void* packed,
                                     const void* bg, void* img, void* alpha,
                                     int tx_n, int ty_n, int k_max, int g_block,
                                     int ch, void* stream) {
  if (g_block <= 0 || g_block % 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch) {  // the channel counts blend_fwd.cu is built for
    case 19: return launch<19>(offsets, packed, bg, img, alpha, tx_n, ty_n, k_max, g_block, s);
    case 32: return launch<32>(offsets, packed, bg, img, alpha, tx_n, ty_n, k_max, g_block, s);
    case 51: return launch<51>(offsets, packed, bg, img, alpha, tx_n, ty_n, k_max, g_block, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Occupancy of the kernel at ``ch`` channels on the current device (as
// segsplat_blend_fwd_occupancy). Returns a cudaError_t.
extern "C" int segsplat_blend_packed_occupancy(int ch, int* blocks_per_sm, int* smem_bytes,
                                               int* registers, int* local_bytes) {
  switch (ch) {
    case 19: return segsplat::occupancy(blend_packed_kernel<19>, blocks_per_sm, smem_bytes,
                                        registers, local_bytes);
    case 32: return segsplat::occupancy(blend_packed_kernel<32>, blocks_per_sm, smem_bytes,
                                        registers, local_bytes);
    case 51: return segsplat::occupancy(blend_packed_kernel<51>, blocks_per_sm, smem_bytes,
                                        registers, local_bytes);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
