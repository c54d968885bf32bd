// Forward tile blend of depth-sorted Gaussian pairs, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel segsplat_tpu/ops/blend_pallas.py:188
// blend_tiles_pallas_dma (body _blend_body :122). Per 16x16 tile it composites
// the tile's first min(count, K) depth-sorted pairs front to back:
//   sigma = 1/2 (a dx^2 + c dy^2) + b dx dy,  alpha = min(0.999, op e^-sigma),
//   alpha kept only where sigma >= 0 and alpha >= 1/255,
//   img = sum alpha T_before colour + T_fin bg,  alpha_out = 1 - T_fin.
//
// Design: one thread block per tile, one thread per pixel; the CH running sums
// live in registers; payload rows are staged through shared memory kChunk rows
// at a time (coalesced float4 loads, each row then read by all 256 threads as a
// broadcast). The payload is read once per pair and the image written once.
// Every pair-pixel of a row read costs about 15 fp32 operations (one exp among
// them), and one that passes the alpha cut another 2 CH + 3, so whether fp32
// arithmetic or memory bounds it depends on the share that passes the cut.
//
// The early-out follows the TPU kernel exactly, not the usual per-pixel exit:
// the tile stops only at the end of a G-row block (G = 256 if K % 256 == 0,
// else 128), and only once every pixel's transmittance is below 1e-4. A pixel
// already below it keeps accumulating until then; stopping it earlier changes
// logits of magnitude ~4 by more than 1e-4.
//
// sigma and alpha are computed with the _rn intrinsics, which nvcc never fuses
// into FMAs, in the operation order of the plain PyTorch version
// (segsplat_tpu_torch/ops/blend.py). Both then round alpha identically, so the
// alpha >= 1/255 cut cannot fall differently in the kernel and in the plain
// version it is checked against. Built without --use_fast_math: __expf would
// not hold the 1e-4 tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPx = kTile * kTile;  // pixels per tile = threads per block
constexpr int kGeom4 = 2;           // float4s of geometry: mu_x mu_y a b | c op pad pad
constexpr int kChunk = 64;          // payload rows staged in shared memory per pass
constexpr float kSatEps = 1e-4f;
constexpr float kAlphaMin = 1.0f / 255.0f;

template <int CH>
__global__ void __launch_bounds__(kPx)
blend_fwd_kernel(const int32_t* __restrict__ offsets,
                 const float4* __restrict__ payload,
                 const float* __restrict__ bg,
                 float* __restrict__ img,
                 float* __restrict__ alpha_out,
                 int tx_n, int k_max, int g_block) {
  constexpr int CHP = (CH + 3) / 4 * 4;  // colours padded to whole float4s
  constexpr int kW4 = kGeom4 + CHP / 4;  // float4s per payload row
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
      const float4* src = payload + static_cast<size_t>(start + c0) * kW4;
      for (int i = p; i < n * kW4; i += kPx) rows[i] = src[i];
      __syncthreads();
      for (int r = 0; r < n; ++r) {
        const float4 g0 = rows[r * kW4];      // mu_x, mu_y, a, b
        const float4 g1 = rows[r * kW4 + 1];  // c, opacity, pad, pad
        const float dx = __fsub_rn(g0.x, px);
        const float dy = __fsub_rn(g0.y, py);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(g0.z, dx), dx),
                                     __fmul_rn(__fmul_rn(g1.x, dy), dy));
        const float sigma = __fadd_rn(__fmul_rn(0.5f, quad),
                                      __fmul_rn(__fmul_rn(g0.w, dx), dy));
        const float a = fminf(0.999f, __fmul_rn(g1.y, expf(-sigma)));
        if (!(sigma >= 0.f && a >= kAlphaMin)) continue;
        const float w = __fmul_rn(a, T);
#pragma unroll
        for (int c4 = 0; c4 < CHP / 4; ++c4) {
          const float4 col = rows[r * kW4 + kGeom4 + c4];
          acc[4 * c4 + 0] = fmaf(w, col.x, acc[4 * c4 + 0]);
          acc[4 * c4 + 1] = fmaf(w, col.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(w, col.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(w, col.w, acc[4 * c4 + 3]);
        }
        T = __fmul_rn(T, __fsub_rn(1.f, a));
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
void launch(const void* offsets, const void* payload, const void* bg, void* img,
            void* alpha, int tx_n, int ty_n, int k_max, int g_block,
            cudaStream_t stream) {
  blend_fwd_kernel<CH><<<tx_n * ty_n, kPx, 0, stream>>>(
      static_cast<const int32_t*>(offsets), static_cast<const float4*>(payload),
      static_cast<const float*>(bg), static_cast<float*>(img),
      static_cast<float*>(alpha), tx_n, k_max, g_block);
}

}  // namespace

// Plain C entry point for ctypes. Returns a cudaError_t: the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported channel count.
extern "C" int segsplat_blend_fwd(const void* offsets, const void* payload,
                                  const void* bg, void* img, void* alpha,
                                  int tx_n, int ty_n, int k_max, int g_block,
                                  int ch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch) {  // training renders 19 channels, the semantic path 32,
                 // render(semantic_logits=...) 51
    case 19:
      launch<19>(offsets, payload, bg, img, alpha, tx_n, ty_n, k_max, g_block, s);
      break;
    case 32:
      launch<32>(offsets, payload, bg, img, alpha, tx_n, ty_n, k_max, g_block, s);
      break;
    case 51:
      launch<51>(offsets, payload, bg, img, alpha, tx_n, ty_n, k_max, g_block, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
