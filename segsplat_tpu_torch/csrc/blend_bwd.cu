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
// Semantics. Alpha is recomputed for every row up to the tile's count, with no
// early-out (like the TPU kernel, even behind a block where the forward
// stopped); sigma and alpha use the _rn intrinsics in blend_fwd.cu's order and
// expf, so the cut falls identically in both kernels and both plain versions. A
// row belongs to exactly one tile, and a tile writes only its own rows start ..
// start + min(count, K) - 1, so blocks run in any order with no atomics; the
// caller zero-fills d_payload, which keeps rows past a tile's K cap and the
// K-row tail at zero. (The TPU kernel copies a whole K-row window back, which is
// right only because its grid runs tiles in order.)
//
// Bound on the card: each pair-pixel of a row read costs about 15 fp32
// operations to recompute alpha, and one that passes the cut about 4 CH + 36
// more (the <g, c> dot product, the colour gradients, the geometry terms and the
// reductions); the payload is read once, d_payload written once, and img,
// g_img, alpha and g_alpha read once. On the training step and the 1080p
// gradient the operations and the bytes give about the same bound.
//
// What the first design lost. It summed each row's 6 + CH values over the
// tile's pixels with a five-step __shfl_xor_sync butterfly in every warp:
// 8 warps x (6 + CH) x 5 shuffles per row, about one warp-shuffle per clock per
// SM. That is 0.50 G / 1.14 G / 1.83 G shuffles at 19 / 51 / 32 channels on
// the training step, the 51-channel render and the 1080p frame, about 2.1 /
// 4.8 / 7.7 ms at 1.8 GHz on 132 SMs; it took 1.591 / 3.545 / 5.868 ms, 0.75 of
// that (its per-warp skip of rows no pixel passes dropped the rest), 13-20x
// its bound ("NVIDIA H100 80GB HBM3, 700.00 W").
//
// This design: one block per tile, one thread per pixel, rows in chunks of R,
// each chunk copied with cp.async into one of two buffers while the block
// works on the other.
//   Prologue: the tile's g_img goes to shared memory with coalesced float4
//   loads (a tile row's 16 CH floats lie together), and img through the w / dop
//   arrays the same way for <g, img>; one thread per pixel read them with a
//   stride of CH floats before, which at 32 and 51 channels overran L1.
//   Phase A (per pixel, sequential over the chunk's rows): the thread carries T
//   and the prefix sum_j w_j <g, c_j> in registers, as before, and writes two
//   numbers per (row, pixel) into shared memory: w = alpha T_before and
//   dop = draw e^-sigma (zeros where the cut fails). dsig = -draw raw equals
//   -op dop, so the geometry needs no third array. The cut of kBatch rows is
//   computed together, <g, c> in four FMA chains, no shuffles.
//   Phase B (transposed reduction over the warp's own 32 pixels, so only
//   __syncwarp separates it from phase A): the colour gradients are the
//   product w[R, 32] x g_img[32, CH] in fp32 FMAs, each lane holding a
//   register tile of RR rows x CC channels (GR row groups x GC channel groups
//   = 32 lanes), so one shared-memory load feeds RR or CC FMAs. The geometry
//   moments, sums over pixels of dop {dx, dy, dx^2, dx dy, dy^2, 1}, take one
//   lane per row (two at R = 16, which meet in one shuffle per moment and
//   chunk), with dx and dy recomputed from the row's mu and the pixel, never
//   expanded about absolute pixel coordinates, and turn into the six gradients
//   (-op (a Sx + b Sy), ...). The warps' partials go to shared memory, where
//   one pass sums the 8 warps and writes each finished row once, in its
//   column layout.
// Shared memory: the two row buffers [2][R][kW4 float4s], g_img [256][GC CC | 1
// floats] and the w / dop arrays [8 warps][2][R][33 floats] (the odd strides
// keep both phases free of bank conflicts); the partials reuse a warp's own
// w / dop rows. That passes the 48 KB static limit, so the kernel takes dynamic
// shared memory (cudaFuncSetAttribute before every launch; its error is
// returned). What holds it now is phase A, the same per-pixel sweep as
// blend_fwd.cu's (scripts/bench_k2.py times each part; PERF.md has the shares).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_widths.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPx = kTile * kTile;  // pixels per tile = threads per block
constexpr int kWarps = kPx / 32;
constexpr int kGeom = 8;            // payload prefix: mu_x mu_y a b c op pad pad
constexpr int kGeom4 = kGeom / 4;
constexpr int kStride = 33;         // floats per row of a warp's w / dop array
constexpr int kBatch = 4;           // rows whose cut phase A computes together
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr unsigned kFull = 0xffffffffu;

template <int CH>
struct Layout {
  // Rows per chunk, and phase B's lane grid of GR row groups x GC channel
  // groups: 32 rows (4 x 5 and 4 x 8 register tiles) where two blocks of 256
  // threads fit on an SM; at 51 channels 32 rows would need 137 216 B, so 16
  // (4 x 7 tiles).
  static constexpr int R = CH > 32 ? 16 : 32;
  static constexpr int GR = CH > 32 ? 4 : 8;
  static constexpr int GC = 32 / GR;
  static constexpr int RR = R / GR;              // rows per lane
  static constexpr int CC = (CH + GC - 1) / GC;  // channels per lane
  static constexpr int kS = (GC * CC) | 1;       // floats per staged g_img row, odd
  static constexpr int kHalves = 32 / R;         // lanes per row in the geometry sums
  static constexpr int CHP = (CH + 3) / 4 * 4;   // colours padded to whole float4s
  static constexpr int kC4 = CHP / 4;
  static constexpr int kW4 = kGeom4 + kC4;       // float4s per payload row
  static constexpr int kNV = 6 + CH;             // per-row sums: 6 geometry + CH colours
  static constexpr int kNVP = kNV | 1;           // partial row stride in floats, odd
  // a warp's w and dop arrays, which its partials [R][kNVP] reuse (past 59
  // channels the partials are the larger)
  static constexpr int kWarpFloats = 2 * R * kStride > R * kNVP ? 2 * R * kStride : R * kNVP;
  static constexpr size_t kBytes =
      16 * 2 * R * kW4 + sizeof(float) * (kPx * kS + kWarps * kWarpFloats);
  static_assert(R * kHalves == 32 && RR * GR == R, "the lane grid covers the chunk");
  // two blocks an SM up to 51 channels; past that one, so that phase A's
  // CHP cotangents and phase B's RR x CC sums stay in registers
  static constexpr int kMinBlocks = CH > 51 ? 1 : 2;
  static_assert(R % kBatch == 0, "phase A's batches tile the chunk");
  static constexpr int kImgFit = kWarps * kWarpFloats / (kTile * kS);
  static constexpr int kImgRows = kImgFit < kTile ? kImgFit : kTile;  // img rows staged at once
};

template <int CH>
__global__ void __launch_bounds__(kPx, Layout<CH>::kMinBlocks)
blend_bwd_kernel(const int32_t* __restrict__ offsets,
                 const float4* __restrict__ payload,
                 const float* __restrict__ bg,
                 const float* __restrict__ img,
                 const float* __restrict__ alpha_out,
                 const float* __restrict__ g_img,
                 const float* __restrict__ g_alpha,
                 float* __restrict__ d_payload,
                 int tx_n, int k_max) {
  using L = Layout<CH>;
  constexpr int R = L::R, RR = L::RR, CC = L::CC, GC = L::GC, kS = L::kS;
  constexpr int CHP = L::CHP, kC4 = L::kC4, kW4 = L::kW4, kNV = L::kNV, kNVP = L::kNVP;
  extern __shared__ float4 smem[];
  float4* row_bufs = smem;                                     // [2][R][kW4]
  float* s_g = reinterpret_cast<float*>(row_bufs + 2 * R * kW4);   // [kPx][kS]
  float* s_wd = s_g + kPx * kS;                            // [kWarps][2][R][kStride]

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32;
  const int lane = p % 32;
  const int tile_x = (tile % tx_n) * kTile;
  const int tile_y = (tile / tx_n) * kTile;
  const int x = tile_x + p % kTile;
  const int y = tile_y + p / kTile;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const int start = offsets[tile];
  const int count = min(offsets[tile + 1] - start, k_max);
  if (count <= 0) return;                        // the whole block: nothing to write

  // copy the chunk of rows from c0 into dst, asynchronously (cp.async)
  auto stage = [&](int c0, float4* dst) {
    const float4* src = payload + static_cast<size_t>(start + c0) * kW4;
    for (int i = p; i < min(R, count - c0) * kW4; i += kPx)
      __pipeline_memcpy_async(dst + i, src + i, sizeof(float4));
    __pipeline_commit();
  };
  stage(0, row_bufs);                            // under the cotangent's staging

  // Copy tile rows ty0 .. ty1 - 1 of an image [16 ty_n, 16 tx_n, CH] into dst
  // [pixel - 16 ty0][kS] with coalesced float4 loads: a tile row's 16 CH
  // floats lie together, 16-byte aligned.
  const int img_w = tx_n * kTile;
  auto load_tile = [&](const float* src, float* dst, int ty0, int ty1) {
    constexpr int kRowF4 = 4 * CH;               // float4s in a tile row
    for (int i = p; i < (ty1 - ty0) * kRowF4; i += kPx) {
      const int ty = ty0 + i / kRowF4;
      const int f = (i % kRowF4) * 4;            // float within the tile row
      const float4 v = *reinterpret_cast<const float4*>(
          src + (static_cast<size_t>(tile_y + ty) * img_w + tile_x) * CH + f);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[((ty - ty0) * kTile + (f + j) / CH) * kS + (f + j) % CH] = e[j];
    }
  };

  // the tile's cotangent, for both phases; then the per-pixel constants, with
  // img staged through the w / dop arrays, kImgRows tile rows at a time
  float* my_g = s_g + p * kS;
  load_tile(g_img, s_g, 0, kTile);
#pragma unroll
  for (int c = CH; c < GC * CC; ++c) my_g[c] = 0.f;
  __syncthreads();
  float g_bg = 0.f, g_dot_img = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) g_bg = fmaf(my_g[c], bg[c], g_bg);
  constexpr int kImgRows = L::kImgRows;
  for (int ty0 = 0; ty0 < kTile; ty0 += kImgRows) {
    load_tile(img, s_wd, ty0, min(ty0 + kImgRows, kTile));
    __syncthreads();
    if (p / kTile >= ty0 && p / kTile < ty0 + kImgRows) {
      const float* my_img = s_wd + (p - ty0 * kTile) * kS;
#pragma unroll
      for (int c = 0; c < CH; ++c) g_dot_img = fmaf(my_g[c], my_img[c], g_dot_img);
    }
    __syncthreads();
  }
  const size_t pix = static_cast<size_t>(y) * img_w + x;
  const float t_fin = 1.f - alpha_out[pix];
  const float g_c_tot = g_dot_img - t_fin * g_bg;                  // <g, sum w c>
  const float g_suffix_const = t_fin * g_bg - g_alpha[pix] * t_fin;

  float* w_arr = s_wd + warp * L::kWarpFloats;   // [R][kStride], this warp's pixels
  float* dop_arr = w_arr + R * kStride;
  float* part = w_arr;                           // [R][kNVP], after phase B
  // phase B's lanes: colour tile rows rg RR .., channels cg CC ..; geometry
  // row gr over the warp's pixels half R .. half R + R - 1
  const int rg = lane / GC, cg = lane % GC;
  const int gr = lane % R, half = lane / R;
  const float fx = static_cast<float>(tile_x) + 0.5f;             // pixel centres of
  const float fy = static_cast<float>(tile_y + 2 * warp) + 0.5f;  // the warp's first row

  float T = 1.f;       // transmittance before the current row
  float gpref = 0.f;   // sum over rows so far of w <g, c>
  for (int c0 = 0, k = 0; c0 < count; c0 += R, ++k) {
    const int n = min(R, count - c0);
    const float4* rows = row_bufs + (k & 1) * R * kW4;
    __pipeline_wait_prior(0);
    __syncthreads();  // the chunk's rows have landed; every thread is done with
                      // the previous chunk, so the next one may go to its buffer
    if (c0 + R < count) stage(c0 + R, row_bufs + ((k + 1) & 1) * R * kW4);

    // ── phase A: this pixel's w and dop for each of the chunk's rows ──
    {
      float g[CHP];
#pragma unroll
      for (int c = 0; c < CHP; ++c) g[c] = c < CH ? my_g[c] : 0.f;
      // rows in batches of kBatch: the cut of a batch's rows first, all
      // independent, then the sequential transmittance and prefix
      for (int r0 = 0; r0 < n; r0 += kBatch) {
        float a[kBatch], raw[kBatch], ex[kBatch];
        bool ok[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const float4 g0 = rows[(r0 + u) * kW4];      // mu_x, mu_y, a, b
          const float4 g1 = rows[(r0 + u) * kW4 + 1];  // c, opacity, pad, pad
          const float dx = __fsub_rn(g0.x, px);
          const float dy = __fsub_rn(g0.y, py);
          const float quad = __fadd_rn(__fmul_rn(__fmul_rn(g0.z, dx), dx),
                                       __fmul_rn(__fmul_rn(g1.x, dy), dy));
          const float sigma = __fadd_rn(__fmul_rn(0.5f, quad),
                                        __fmul_rn(__fmul_rn(g0.w, dx), dy));
          ex[u] = expf(-sigma);
          raw[u] = __fmul_rn(g1.y, ex[u]);
          a[u] = fminf(0.999f, raw[u]);
          ok[u] = r0 + u < n && sigma >= 0.f && a[u] >= kAlphaMin;  // rows past n: none
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          float w = 0.f, dop = 0.f;
          if (ok[u]) {
            const float4* col = rows + (r0 + u) * kW4 + kGeom4;
            float q0 = 0.f, q1 = 0.f, q2 = 0.f, q3 = 0.f;   // <g, c_k> in four chains
#pragma unroll
            for (int c4 = 0; c4 < kC4; ++c4) {
              const float4 cv = col[c4];
              q0 = fmaf(g[4 * c4 + 0], cv.x, q0);
              q1 = fmaf(g[4 * c4 + 1], cv.y, q1);
              q2 = fmaf(g[4 * c4 + 2], cv.z, q2);
              q3 = fmaf(g[4 * c4 + 3], cv.w, q3);
            }
            const float gc = (q0 + q1) + (q2 + q3);
            const float one_minus = __fsub_rn(1.f, a[u]);
            w = __fmul_rn(a[u], T);
            gpref = fmaf(w, gc, gpref);
            const float g_c_rest = g_c_tot - gpref;                // <g, C_rest_k>
            const float dalpha = T * gc - __fdividef(g_c_rest + g_suffix_const, one_minus);
            dop = raw[u] < 0.999f ? dalpha * ex[u] : 0.f;
            T = __fmul_rn(T, one_minus);
          }
          w_arr[(r0 + u) * kStride + lane] = w;
          dop_arr[(r0 + u) * kStride + lane] = dop;
        }
      }
    }
    __syncwarp();

    // ── phase B: sums over the warp's 32 pixels ──
    {
      float acc[RR][CC];                        // colours: rows rg RR + i, channels cg CC + k
#pragma unroll
      for (int i = 0; i < RR; ++i)
#pragma unroll
        for (int k = 0; k < CC; ++k) acc[i][k] = 0.f;
      const float* w_rows = w_arr + rg * RR * kStride;
      const float* g_cols = s_g + warp * 32 * kS + cg * CC;
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        float wv[RR];
#pragma unroll
        for (int i = 0; i < RR; ++i) wv[i] = w_rows[i * kStride + j];
#pragma unroll
        for (int k = 0; k < CC; ++k) {
          const float gk = g_cols[j * kS + k];
#pragma unroll
          for (int i = 0; i < RR; ++i) acc[i][k] = fmaf(wv[i], gk, acc[i][k]);
        }
      }

      const float4 m0 = rows[gr * kW4];         // mu_x, mu_y, a, b
      const float4 m1 = rows[gr * kW4 + 1];     // c, opacity
      float sx = 0.f, sy = 0.f, sxx = 0.f, sxy = 0.f, syy = 0.f, so = 0.f;
#pragma unroll
      for (int jj = 0; jj < R; ++jj) {
        const int j = half * R + jj;            // pixel (j % 16, 2 warp + j / 16) of the tile
        const float dv = dop_arr[gr * kStride + j];
        const float dx = __fsub_rn(m0.x, fx + static_cast<float>(j % kTile));
        const float dy = __fsub_rn(m0.y, fy + static_cast<float>(j / kTile));
        const float tx = dv * dx, ty = dv * dy;
        sx += tx;
        sy += ty;
        sxx = fmaf(tx, dx, sxx);
        sxy = fmaf(tx, dy, sxy);
        syy = fmaf(ty, dy, syy);
        so += dv;
      }
#pragma unroll
      for (int off = R; off < 32; off <<= 1) {  // a row's lanes meet
        sx += __shfl_xor_sync(kFull, sx, off);
        sy += __shfl_xor_sync(kFull, sy, off);
        sxx += __shfl_xor_sync(kFull, sxx, off);
        sxy += __shfl_xor_sync(kFull, sxy, off);
        syy += __shfl_xor_sync(kFull, syy, off);
        so += __shfl_xor_sync(kFull, so, off);
      }
      __syncwarp();                             // the warp is done reading w and dop

#pragma unroll
      for (int i = 0; i < RR; ++i) {
        const int r = rg * RR + i;
#pragma unroll
        for (int k = 0; k < CC; ++k) {
          const int c = cg * CC + k;
          if (r < n && c < CH) part[r * kNVP + 6 + c] = acc[i][k];
        }
      }
      if (half == 0 && gr < n) {                // dsig = -op dop
        const float a = m0.z, b = m0.w, c = m1.x, op = m1.y;
        float* out = part + gr * kNVP;
        out[0] = -op * (a * sx + b * sy);       // d mu_x
        out[1] = -op * (c * sy + b * sx);       // d mu_y
        out[2] = -0.5f * op * sxx;              // d a
        out[3] = -op * sxy;                     // d b
        out[4] = -0.5f * op * syy;              // d c
        out[5] = so;                            // d opacity
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
      for (int w8 = 0; w8 < kWarps; ++w8) s += s_wd[w8 * L::kWarpFloats + r * kNVP + v];
      d_payload[static_cast<size_t>(start + c0 + r) * (kW4 * 4) + (v < 6 ? v : v + 2)] = s;
    }
  }
}

// Let the kernel take its dynamic shared memory (above the 48 KB default).
template <int CH>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(blend_bwd_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Layout<CH>::kBytes));
}

template <int CH>
int launch(const void* offsets, const void* payload, const void* bg, const void* img,
           const void* alpha, const void* g_img, const void* g_alpha, void* d_payload,
           int tx_n, int ty_n, int k_max, cudaStream_t stream) {
  const cudaError_t err = allow_smem<CH>();
  if (err != cudaSuccess) return static_cast<int>(err);
  blend_bwd_kernel<CH><<<tx_n * ty_n, kPx, Layout<CH>::kBytes, stream>>>(
      static_cast<const int32_t*>(offsets), static_cast<const float4*>(payload),
      static_cast<const float*>(bg), static_cast<const float*>(img),
      static_cast<const float*>(alpha), static_cast<const float*>(g_img),
      static_cast<const float*>(g_alpha), static_cast<float*>(d_payload), tx_n, k_max);
  return static_cast<int>(cudaGetLastError());
}

template <int CH>
int occupancy(int* blocks_per_sm, int* smem_bytes) {
  *smem_bytes = static_cast<int>(Layout<CH>::kBytes);
  cudaError_t err = allow_smem<CH>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, blend_bwd_kernel<CH>,
                                                        kPx, Layout<CH>::kBytes);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry point for ctypes. d_payload must be zero-filled by the caller.
// Returns a cudaError_t: that of cudaFuncSetAttribute (the dynamic shared
// memory) or of the launch's cudaGetLastError(), or cudaErrorInvalidValue for
// an unsupported channel count.
extern "C" int segsplat_blend_bwd(const void* offsets, const void* payload,
                                  const void* bg, const void* img, const void* alpha,
                                  const void* g_img, const void* g_alpha,
                                  void* d_payload, int tx_n, int ty_n, int k_max,
                                  int ch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch) {  // ops/blend.py pads CH up to one of these widths
#define SEGSPLAT_CASE(W)                                                           \
    case W:                                                                        \
      return launch<W>(offsets, payload, bg, img, alpha, g_img, g_alpha, d_payload, \
                       tx_n, ty_n, k_max, s);
    SEGSPLAT_WIDTHS(SEGSPLAT_CASE)
#undef SEGSPLAT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Occupancy of the kernel at ``ch`` channels on the current device: the blocks
// of 256 threads an SM holds at once and the dynamic shared memory each takes.
// Returns a cudaError_t.
extern "C" int segsplat_blend_bwd_occupancy(int ch, int* blocks_per_sm, int* smem_bytes) {
  switch (ch) {
#define SEGSPLAT_CASE(W) \
    case W: return occupancy<W>(blocks_per_sm, smem_bytes);
    SEGSPLAT_WIDTHS(SEGSPLAT_CASE)
#undef SEGSPLAT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
