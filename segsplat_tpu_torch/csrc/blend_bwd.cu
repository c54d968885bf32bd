// Backward tile blend of depth-sorted Gaussian pairs, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel segsplat_tpu/ops/blend_pallas_vjp.py:195
// _blend_bwd_pallas (body _bwd_kernel :57). Given the forward outputs (img,
// alpha = 1 - T_fin) and their cotangents (g_img, g_alpha), it gives every pair
// row a tile owns the gradient of (mu_x, mu_y, conic a, b, c, opacity, CH
// colours), with the compositing identity of the TPU kernel:
//   w_k = alpha_k T_before_k,   <g, C_rest_k> = <g, C_tot> - sum_{j<=k} w_j <g, c_j>,
//   d alpha_k = T_before_k <g, c_k> - (<g, C_rest_k> + T_fin <g, bg> - g_alpha T_fin)
//               / (1 - alpha_k),
// where <g, C_tot> = <g, img> - T_fin <g, bg>. The gradient passes only where
// alpha came unclamped from op e^-sigma (sigma >= 0, alpha >= 1/255, raw < 0.999).
//
// Design: one thread block per tile, one thread per pixel. A thread first reads
// its pixel's g_img, img, alpha and g_alpha in image layout and forms the two
// per-pixel constants above; then it sweeps the tile's rows front to back,
// carrying T and the running prefix sum_j w_j <g, c_j> in registers. Payload
// rows are staged through shared memory kChunk rows at a time, as in
// blend_fwd.cu. Each row's 6 + CH gradients are sums over the tile's 256
// pixels: warp shuffles, then one partial per warp in shared memory, then a
// cross-warp sum after each chunk that writes the chunk's rows to d_payload. A
// warp none of whose pixels passes the cut for a row writes zero partials and
// skips the shuffles. A row belongs to exactly one tile, and a tile writes only
// its own rows start .. start + min(count, K) - 1, so no atomics are needed; the
// caller zero-fills d_payload, which keeps rows past a tile's K cap and the
// K-row tail at zero. (The TPU kernel copies a whole K-row window back, which is
// right only because its grid runs tiles in order.)
//
// There is no early-out: like the TPU kernel, the backward recomputes every row
// up to count, even behind a block where the forward stopped. sigma and alpha
// are computed with the _rn intrinsics in blend_fwd.cu's order, and expf, so
// the cut falls identically in both kernels and both plain versions.
//
// Bound on the card: each pair-pixel of a row read costs about 15 fp32
// operations to recompute alpha, and one that passes the cut about 4 CH + 36
// more (the <g, c> dot product, the colour gradients, the geometry terms and its
// share of the reduction); the payload is read once, d_payload written once, and
// img, g_img, alpha and g_alpha read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPx = kTile * kTile;  // pixels per tile = threads per block
constexpr int kWarps = kPx / 32;
constexpr int kGeom = 8;            // payload prefix: mu_x mu_y a b c op pad pad
constexpr int kGeom4 = kGeom / 4;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr unsigned kFull = 0xffffffffu;

template <int CH>
__global__ void __launch_bounds__(kPx)
blend_bwd_kernel(const int32_t* __restrict__ offsets,
                 const float4* __restrict__ payload,
                 const float* __restrict__ bg,
                 const float* __restrict__ img,
                 const float* __restrict__ alpha_out,
                 const float* __restrict__ g_img,
                 const float* __restrict__ g_alpha,
                 float* __restrict__ d_payload,
                 int tx_n, int k_max) {
  constexpr int CHP = (CH + 3) / 4 * 4;  // colours padded to whole float4s
  constexpr int kW4 = kGeom4 + CHP / 4;  // float4s per payload row
  constexpr int kNV = 6 + CH;            // per-row sums: 6 geometry + CH colours
  // Payload rows staged in shared memory per pass. The staged rows and the
  // per-warp partials take kChunk (16 kW4 + 32 kNV) bytes of static shared
  // memory, which may not exceed 48 KB: 32 rows need 44 032 B at CH = 32 but
  // 66 048 B at CH = 51, so the 51-channel build stages 16 rows (33 024 B).
  constexpr int kChunk = CH > 32 ? 16 : 32;
  __shared__ float4 rows[kChunk * kW4];
  __shared__ float part[kChunk][kWarps][kNV];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32;
  const int lane = p % 32;
  const int x = (tile % tx_n) * kTile + p % kTile;
  const int y = (tile / tx_n) * kTile + p / kTile;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const int start = offsets[tile];
  const int count = min(offsets[tile + 1] - start, k_max);

  // per-pixel constants, from the image layout [16 ty_n, 16 tx_n, CH]
  const size_t pix = static_cast<size_t>(y) * (tx_n * kTile) + x;
  float g[CHP];
  float g_bg = 0.f, g_dot_img = 0.f;
#pragma unroll
  for (int c = 0; c < CHP; ++c) {
    g[c] = c < CH ? g_img[pix * CH + c] : 0.f;
    if (c < CH) {
      g_bg = fmaf(g[c], bg[c], g_bg);
      g_dot_img = fmaf(g[c], img[pix * CH + c], g_dot_img);
    }
  }
  const float t_fin = 1.f - alpha_out[pix];
  const float g_c_tot = g_dot_img - t_fin * g_bg;                  // <g, sum w c>
  const float g_suffix_const = t_fin * g_bg - g_alpha[pix] * t_fin;

  float T = 1.f;       // transmittance before the current row
  float gpref = 0.f;   // sum over rows so far of w <g, c>
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    const int n = min(kChunk, count - c0);
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
      const float expnegs = expf(-sigma);
      const float raw = __fmul_rn(g1.y, expnegs);
      const float a = fminf(0.999f, raw);
      const bool valid = sigma >= 0.f && a >= kAlphaMin;
      if (!__any_sync(kFull, valid)) {      // the whole warp adds nothing
        for (int v = lane; v < kNV; v += 32) part[r][warp][v] = 0.f;
        continue;
      }
      float gc = 0.f;                       // <g, c_k>
#pragma unroll
      for (int c4 = 0; c4 < CHP / 4; ++c4) {
        const float4 col = rows[r * kW4 + kGeom4 + c4];
        gc = fmaf(g[4 * c4 + 0], col.x, gc);
        gc = fmaf(g[4 * c4 + 1], col.y, gc);
        gc = fmaf(g[4 * c4 + 2], col.z, gc);
        gc = fmaf(g[4 * c4 + 3], col.w, gc);
      }
      const float alpha = valid ? a : 0.f;
      const float one_minus = __fsub_rn(1.f, alpha);
      const float w = __fmul_rn(alpha, T);
      gpref = fmaf(w, gc, gpref);
      const float g_c_rest = g_c_tot - gpref;                      // <g, C_rest_k>
      const float dalpha = T * gc - (g_c_rest + g_suffix_const) / one_minus;
      const float draw = (valid && raw < 0.999f) ? dalpha : 0.f;
      const float dsig = -draw * raw;
      float vals[kNV];
      vals[0] = dsig * (g0.z * dx + g0.w * dy);  // d mu_x
      vals[1] = dsig * (g1.x * dy + g0.w * dx);  // d mu_y
      vals[2] = 0.5f * dsig * dx * dx;           // d a
      vals[3] = dsig * dx * dy;                  // d b
      vals[4] = 0.5f * dsig * dy * dy;           // d c
      vals[5] = draw * expnegs;                  // d opacity
#pragma unroll
      for (int c = 0; c < CH; ++c) vals[6 + c] = w * g[c];
      T = __fmul_rn(T, one_minus);
#pragma unroll
      for (int v = 0; v < kNV; ++v) {
        float s = vals[v];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
        if (lane == 0) part[r][warp][v] = s;
      }
    }
    __syncthreads();
    // cross-warp sums: row r's value v goes to payload column v (geometry) or
    // v + 2 (colours, past the two pad columns)
    for (int i = p; i < n * kNV; i += kPx) {
      const int r = i / kNV;
      const int v = i % kNV;
      float s = 0.f;
#pragma unroll
      for (int w8 = 0; w8 < kWarps; ++w8) s += part[r][w8][v];
      d_payload[static_cast<size_t>(start + c0 + r) * (kW4 * 4) + (v < 6 ? v : v + 2)] = s;
    }
  }
}

template <int CH>
void launch(const void* offsets, const void* payload, const void* bg, const void* img,
            const void* alpha, const void* g_img, const void* g_alpha, void* d_payload,
            int tx_n, int ty_n, int k_max, cudaStream_t stream) {
  blend_bwd_kernel<CH><<<tx_n * ty_n, kPx, 0, stream>>>(
      static_cast<const int32_t*>(offsets), static_cast<const float4*>(payload),
      static_cast<const float*>(bg), static_cast<const float*>(img),
      static_cast<const float*>(alpha), static_cast<const float*>(g_img),
      static_cast<const float*>(g_alpha), static_cast<float*>(d_payload), tx_n, k_max);
}

}  // namespace

// Plain C entry point for ctypes. d_payload must be zero-filled by the caller.
// Returns a cudaError_t: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported channel count.
extern "C" int segsplat_blend_bwd(const void* offsets, const void* payload,
                                  const void* bg, const void* img, const void* alpha,
                                  const void* g_img, const void* g_alpha,
                                  void* d_payload, int tx_n, int ty_n, int k_max,
                                  int ch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch) {  // training renders 19 channels, the semantic path 32,
                 // render(semantic_logits=...) 51
    case 19:
      launch<19>(offsets, payload, bg, img, alpha, g_img, g_alpha, d_payload,
                 tx_n, ty_n, k_max, s);
      break;
    case 32:
      launch<32>(offsets, payload, bg, img, alpha, g_img, g_alpha, d_payload,
                 tx_n, ty_n, k_max, s);
      break;
    case 51:
      launch<51>(offsets, payload, bg, img, alpha, g_img, g_alpha, d_payload,
                 tx_n, ty_n, k_max, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
