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
// design: one thread block per tile, one thread per pixel, the CH running sums
// in registers, pairs staged through shared memory kChunk at a time (only the
// 2 + CH/4 float4s of a pair that the blend reads), the early-out decided with
// __syncthreads_or. kChunk and g_block are even, so a couple never straddles
// two chunks; a couple whose second pair lies past count gives it alpha 0.
//
// Bound on the card: the arithmetic is K1's (about 15 fp32 operations per
// pair-pixel read, 2 CH + 3 more per pair-pixel that passes the cut). The
// layout holds 256 bytes per pair, but only the 16 (2 + ceil(CH / 4)) bytes
// staged are read: in whole 32-byte sectors of the 256-byte-aligned pair, 160 B
// at CH = 32 (K1's row, 4 ceil((8 + CH) / 4), is also 160 B) and 256 B at
// CH = 51 (K1's 240 B). So K3's bound equals K1's at CH = 32 on the same rows
// and is no lower at CH = 51.
//
// sigma and alpha use the _rn intrinsics in the plain PyTorch version's
// operation order (segsplat_tpu_torch/ops/blend.py) and expf, so the cut falls
// identically in the kernel and its plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPx = kTile * kTile;  // pixels per tile = threads per block
constexpr int kPair4 = 16;          // float4s per pair in the packed layout (64 floats)
constexpr int kGeom4 = 2;           // float4s of geometry: mu_x mu_y a b | c op pad pad
constexpr int kChunk = 64;          // pairs staged in shared memory per pass (even)
constexpr float kSatEps = 1e-4f;
constexpr float kAlphaMin = 1.0f / 255.0f;

// alpha of one staged pair at pixel (px, py), 0 where the cut fails
__device__ __forceinline__ float pair_alpha(const float4* row, float px, float py) {
  const float4 g0 = row[0];  // mu_x, mu_y, a, b
  const float4 g1 = row[1];  // c, opacity, pad, pad
  const float dx = __fsub_rn(g0.x, px);
  const float dy = __fsub_rn(g0.y, py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(g0.z, dx), dx),
                               __fmul_rn(__fmul_rn(g1.x, dy), dy));
  const float sigma = __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(g0.w, dx), dy));
  const float a = fminf(0.999f, __fmul_rn(g1.y, expf(-sigma)));
  return (sigma >= 0.f && a >= kAlphaMin) ? a : 0.f;
}

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
__global__ void __launch_bounds__(kPx)
blend_packed_kernel(const int32_t* __restrict__ offsets,
                    const float4* __restrict__ pairs,
                    const float* __restrict__ bg,
                    float* __restrict__ img,
                    float* __restrict__ alpha_out,
                    int tx_n, int k_max, int g_block) {
  constexpr int CHP = (CH + 3) / 4 * 4;  // colours padded to whole float4s
  constexpr int kW4 = kGeom4 + CHP / 4;  // float4s of a pair the blend reads
  static_assert(kW4 <= kPair4, "the packed layout holds at most 56 colours");
  __shared__ float4 rows[kChunk * kW4];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int x = (tile % tx_n) * kTile + p % kTile;
  const int y = (tile / tx_n) * kTile + p / kTile;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const int start = offsets[tile];
  const int count = min(offsets[tile + 1] - start, k_max);

  float acc[CHP];
#pragma unroll
  for (int c = 0; c < CHP; ++c) acc[c] = 0.f;
  float T = 1.f;

  for (int b0 = 0; b0 < count; b0 += g_block) {
    const int b1 = min(b0 + g_block, count);
    for (int c0 = b0; c0 < b1; c0 += kChunk) {
      const int n = min(kChunk, b1 - c0);
      __syncthreads();  // every thread is done with the previous chunk
      const float4* src = pairs + static_cast<size_t>(start + c0) * kPair4;
      for (int i = p; i < n * kW4; i += kPx) rows[i] = src[(i / kW4) * kPair4 + i % kW4];
      __syncthreads();
      for (int r = 0; r < n; r += 2) {
        const float aA = pair_alpha(rows + r * kW4, px, py);
        const float aB = r + 1 < n ? pair_alpha(rows + (r + 1) * kW4, px, py) : 0.f;
        const float oneA = __fsub_rn(1.f, aA);
        if (aA > 0.f) accumulate<CHP>(acc, __fmul_rn(aA, T), rows + r * kW4 + kGeom4);
        if (aB > 0.f)
          accumulate<CHP>(acc, __fmul_rn(__fmul_rn(aB, T), oneA),
                          rows + (r + 1) * kW4 + kGeom4);
        T = __fmul_rn(T, __fmul_rn(oneA, __fsub_rn(1.f, aB)));
      }
    }
    // block-granular early-out: stop only when no pixel of the tile is live
    if (!__syncthreads_or(T >= kSatEps)) break;
  }

  // image layout [16 ty_n, 16 tx_n, CH]: a warp writes two 16-pixel row runs
  const size_t pix = static_cast<size_t>(y) * (tx_n * kTile) + x;
  if constexpr (CH % 4 == 0) {
    float4* out = reinterpret_cast<float4*>(img + pix * CH);
#pragma unroll
    for (int c4 = 0; c4 < CH / 4; ++c4) {
      out[c4] = make_float4(__fadd_rn(acc[4 * c4 + 0], __fmul_rn(T, bg[4 * c4 + 0])),
                            __fadd_rn(acc[4 * c4 + 1], __fmul_rn(T, bg[4 * c4 + 1])),
                            __fadd_rn(acc[4 * c4 + 2], __fmul_rn(T, bg[4 * c4 + 2])),
                            __fadd_rn(acc[4 * c4 + 3], __fmul_rn(T, bg[4 * c4 + 3])));
    }
  } else {
    float* out = img + pix * CH;
#pragma unroll
    for (int c = 0; c < CH; ++c) out[c] = __fadd_rn(acc[c], __fmul_rn(T, bg[c]));
  }
  alpha_out[pix] = 1.f - T;
}

template <int CH>
void launch(const void* offsets, const void* packed, const void* bg, void* img,
            void* alpha, int tx_n, int ty_n, int k_max, int g_block,
            cudaStream_t stream) {
  blend_packed_kernel<CH><<<tx_n * ty_n, kPx, 0, stream>>>(
      static_cast<const int32_t*>(offsets), static_cast<const float4*>(packed),
      static_cast<const float*>(bg), static_cast<float*>(img),
      static_cast<float*>(alpha), tx_n, k_max, g_block);
}

}  // namespace

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
    case 19:
      launch<19>(offsets, packed, bg, img, alpha, tx_n, ty_n, k_max, g_block, s);
      break;
    case 32:
      launch<32>(offsets, packed, bg, img, alpha, tx_n, ty_n, k_max, g_block, s);
      break;
    case 51:
      launch<51>(offsets, packed, bg, img, alpha, tx_n, ty_n, k_max, g_block, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
