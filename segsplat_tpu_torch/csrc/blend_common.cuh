// Shared machinery of the forward tile blends K1 (blend_fwd.cu) and K3
// (blend_packed.cu), for NVIDIA Hopper (sm_90a).
//
// - sigma and alpha of a pair at a pixel, with the _rn intrinsics in the plain
//   PyTorch version's operation order (segsplat_tpu_torch/ops/blend.py) and
//   expf, so the cut (sigma >= 0, alpha >= 1/255) falls identically in the
//   kernels and their plain versions. Built without --use_fast_math.
// - A warp's pixels: an 8 x 4 block of the 16 x 16 tile (warp w from
//   x = 8 (w % 2), y = 4 (w / 2); lane l at + (l % 8, l / 8)).
// - The row test ``row_may_hit``: can any pixel centre of a warp's block pass
//   the cut for this row? Exact by construction, it answers false only where
//   no pixel can pass, so a warp that skips the row blends the same bits.
//   ops/blend.py ``warp_row_may_hit`` is its plain version, in the same order.
// - Staging: a ring of chunks of rows in shared memory, filled by 1-D bulk
//   copies (cp.async.bulk, completing on an mbarrier per stage) that the last
//   warp done with a chunk issues; ``Layout`` sizes it per channel count, and
//   ``run_chunks`` is the chunk loop with the G-row block early-out.
// - A per-segment cycle counter for diagnostic builds (-DSEGSPLAT_CLOCKS):
//   scripts/bench_k1.py reads each segment's share of the warps' cycles, and
//   the warp-rows the lists kept, which it holds against the plain counter.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Per-segment cycle counters. In a build with -DSEGSPLAT_CLOCKS each warp reads
// clock64() at the borders of its segments (SEG_MARK), counts the rows its
// lists keep (SEG_KEPT), adds both to device counters at its end (SEG_FLUSH),
// and SEGSPLAT_CLOCKS_ENTRY(fn) defines the C entry ``fn(counters, reset)``
// that copies the SEGSPLAT_CLOCK_SLOTS counters out (and with reset zeroes
// them). Segments: 0 prologue, 1 staging wait, 2 barrier and early-out, 3 row
// test, 4 sweep (sigma, alpha, cut), 5 colour loop, 6 epilogue; the last slot
// holds the warp-rows the lists kept (K3: couples). Without the flag the
// marks compile to nothing.
#define SEGSPLAT_CLOCK_SEGS 7
#define SEGSPLAT_CLOCK_SLOTS (SEGSPLAT_CLOCK_SEGS + 1)
#ifdef SEGSPLAT_CLOCKS
__device__ unsigned long long segsplat_clocks[SEGSPLAT_CLOCK_SLOTS];
#endif

namespace segsplat {

struct SegClock {
#ifdef SEGSPLAT_CLOCKS
  long long t;
  long long c[SEGSPLAT_CLOCK_SLOTS];
  __device__ SegClock() {
#ifdef __CUDA_ARCH__
    t = clock64();
#endif
    for (int i = 0; i < SEGSPLAT_CLOCK_SLOTS; ++i) c[i] = 0;
  }
  __device__ __forceinline__ void mark(int i) {
#ifdef __CUDA_ARCH__
    const long long u = clock64();
    c[i] += u - t;
    t = u;
#endif
  }
  __device__ __forceinline__ void kept(int rows) { c[SEGSPLAT_CLOCK_SEGS] += rows; }
  __device__ __forceinline__ void flush() {
    if ((threadIdx.x & 31) == 0)
      for (int i = 0; i < SEGSPLAT_CLOCK_SLOTS; ++i)
        atomicAdd(&segsplat_clocks[i], static_cast<unsigned long long>(c[i]));
  }
#else
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void kept(int) {}
  __device__ __forceinline__ void flush() {}
#endif
};

}  // namespace segsplat

#define SEG_START segsplat::SegClock seg_;
#define SEG_MARK(i) seg_.mark(i);
#define SEG_KEPT(rows) seg_.kept(rows);
#define SEG_FLUSH seg_.flush();
#ifdef SEGSPLAT_CLOCKS
#define SEGSPLAT_CLOCKS_ENTRY(fn)                                                          \
  extern "C" int fn(unsigned long long* host, int reset) {                                 \
    cudaError_t err = cudaMemcpyFromSymbol(host, segsplat_clocks, sizeof(segsplat_clocks)); \
    if (err == cudaSuccess && reset) {                                                     \
      unsigned long long zero[SEGSPLAT_CLOCK_SLOTS] = {};                                  \
      err = cudaMemcpyToSymbol(segsplat_clocks, zero, sizeof(zero));                       \
    }                                                                                      \
    return static_cast<int>(err);                                                          \
  }
#else
#define SEGSPLAT_CLOCKS_ENTRY(fn)
#endif

namespace segsplat {

constexpr int kTile = 16;
constexpr int kPx = kTile * kTile;  // pixels per tile = threads per block
constexpr int kWarps = kPx / 32;
constexpr int kFootW = 8;           // a warp's pixels: kFootW x kFootH
constexpr int kFootH = 32 / kFootW;
constexpr int kGeom4 = 2;           // float4s of geometry: mu_x mu_y a b | c op pad pad
constexpr float kSatEps = 1e-4f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr unsigned kFull = 0xffffffffu;
// the row test's margins (ops/blend.py CULL_GAMMA, CULL_TAU_MARGIN, CULL_BIG)
constexpr float kCullGamma = 1.0f / 65536.0f;
constexpr float kCullTauMargin = 1e-5f;
constexpr float kCullBig = 1e30f;

// sigma = 1/2 (a dx^2 + c dy^2) + b dx dy at offset (dx, dy) = mu - pixel centre
__device__ __forceinline__ float sigma_at(float a, float b, float c, float dx, float dy) {
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx), __fmul_rn(__fmul_rn(c, dy), dy));
  return __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(b, dx), dy));
}

// alpha of a row with geometry g0 = (mu_x, mu_y, a, b), g1 = (c, op, ., .) at
// pixel centre (px, py): min(0.999, op e^-sigma), 0 where the cut fails
__device__ __forceinline__ float pair_alpha(float4 g0, float4 g1, float px, float py) {
  const float sigma = sigma_at(g0.z, g0.w, g1.x, __fsub_rn(g0.x, px), __fsub_rn(g0.y, py));
  const float a = fminf(0.999f, __fmul_rn(g1.y, expf(-sigma)));
  return (sigma >= 0.f && a >= kAlphaMin) ? a : 0.f;
}

// the tile pixel (x, y) of lane ``lane`` of warp ``warp``
__device__ __forceinline__ int foot_x(int warp, int lane) {
  return kFootW * (warp % (kTile / kFootW)) + lane % kFootW;
}
__device__ __forceinline__ int foot_y(int warp, int lane) {
  return kFootH * (warp / (kTile / kFootW)) + lane / kFootW;
}

// Can a pixel centre (px, py) in [x0, x1] x [y0, y1] pass the cut for the
// row (g0, g1)? False only where none can:
//  - op < 1/255: alpha <= op at every pixel;
//  - a conic that is not positive definite, or a non-finite conic or opacity
//    (fminf(0.999, NaN) is 0.999, so a NaN alpha passes): kept;
//  - else the minimum s of sigma over the rectangle (0 with mu inside; else on
//    a face mu lies beyond, at the clamped 1-D minimum; evaluating the other
//    face as well only adds values above the minimum) against
//    tau = ln(255 op). The kernel's sigma at a pixel and the test's s are both
//    within a relative kappa of the exact values: the rounded terms are at
//    most (1 + rho) Q and sigma >= (1 - rho) Q, for rho = |b| / sqrt(ac) and
//    Q = (a dx^2 + c dy^2) / 2, and (1 + rho) / (1 - rho) <= 4 ac / det, so
//    kappa = 4 kCullGamma ac / det, with kCullGamma some 25 times the
//    rounding of the few operations (the 1-D minimum's division may round
//    freely: a point off the minimum by a few ulp raises sigma only to second
//    order). kCullTauMargin covers logf and expf. Kept when kappa >= 1/2 or
//    s (1 - kappa) <= tau + kCullTauMargin, compared as s (det - g) and
//    (tau + kCullTauMargin) det with g = kappa det = 4 kCullGamma ac.
__device__ __forceinline__ bool row_may_hit(float4 g0, float4 g1, float x0, float x1,
                                            float y0, float y1) {
  const float a = g0.z, b = g0.w, c = g1.x, op = g1.y;
  if (op < kAlphaMin) return false;
  const float ac = __fmul_rn(a, c);
  const float det = __fsub_rn(ac, __fmul_rn(b, b));
  if (!(a > 0.f && det > 0.f && ac <= kCullBig && op <= kCullBig)) return true;
  const float dx0 = __fsub_rn(g0.x, x1), dx1 = __fsub_rn(g0.x, x0);
  const float dy0 = __fsub_rn(g0.y, y1), dy1 = __fsub_rn(g0.y, y0);
  if (dx0 <= 0.f && dx1 >= 0.f && dy0 <= 0.f && dy1 >= 0.f) return true;
  const float ux = dx0 > 0.f ? dx0 : dx1;
  const float uy = dy0 > 0.f ? dy0 : dy1;
  const float vy = fminf(fmaxf(__fdividef(__fmul_rn(-b, ux), c), dy0), dy1);
  const float vx = fminf(fmaxf(__fdividef(__fmul_rn(-b, uy), a), dx0), dx1);
  const float s = fminf(sigma_at(a, b, c, ux, vy), sigma_at(a, b, c, vx, uy));
  const float g = __fmul_rn(4.f * kCullGamma, ac);
  const float tau = __fadd_rn(logf(__fmul_rn(op, 255.f)), kCullTauMargin);
  return !(__fmul_rn(2.f, g) < det) || __fmul_rn(s, __fsub_rn(det, g)) <= __fmul_rn(tau, det);
}

// ── mbarriers and 1-D bulk copies (cp.async.bulk, the TMA's linear form) ──
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// One thread: expect ``bytes`` more on ``bar``'s current phase (its one arrival).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Copy ``bytes`` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory, completing on ``bar``'s current phase.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Wait until ``bar`` completes the phase of parity ``parity``; traps rather
// than spin for ever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (long long spins = 0;; ++spins) {
    unsigned ok;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (ok) return;
    if (spins > (1ll << 26)) __trap();
  }
}

// The staging policy of both kernels at CH channels: a row the blend reads is
// the geometry and the colours padded to whole float4s; chunks of kRows rows,
// one bit each in a warp's list; a ring of kStages chunks (28 672 / 40 960 /
// 46 080 B at 19 / 32 / 51 channels, inside the 48 KB of static shared
// memory); __launch_bounds__'s blocks per SM, which hold ptxas to 64 / 80 /
// 128 registers without spills.
template <int CH>
struct Layout {
  static constexpr int CHP = (CH + 3) / 4 * 4;    // colours padded to whole float4s
  static constexpr int kW4 = kGeom4 + CHP / 4;    // float4s of a row the blend reads
  static constexpr int kRows = 64;
  static constexpr int kStages = CH > 32 ? 3 : 4;
  static constexpr int kMinBlocks = CH > 32 ? 2 : CH > 19 ? 3 : 4;
};

// rows in the chunk from c0: up to ``rows``, ending at count or at the end of
// c0's g_block (so a block's early-out falls on a chunk's start)
__device__ __forceinline__ int chunk_len(int c0, int count, int g_block, int rows) {
  return min(min(rows, count - c0), (c0 / g_block + 1) * g_block - c0);
}

// A ring of kStages chunks of up to kRows rows in shared memory. A row is the
// first kW4 float4s of a source row kStride float4s long; chunk j goes to
// stage j % kStages, filled by 1-D bulk copies that complete on full[stage]
// (one copy per chunk where the rows are contiguous, else one per row). The
// warp that is last done with a chunk refills its stage with the chunk
// kStages on, so warps wait only for rows, never for each other.
template <int kStages, int kRows, int kW4, int kStride>
struct RowRing {
  float4 buf[kStages][kRows * kW4];
  uint64_t full[kStages];
  int done[kStages];   // warps done with the stage's chunk

  // thread 0, then a barrier before any use
  __device__ __forceinline__ void init() {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    mbar_fence_init();
  }
  // warp-collective: copy rows c0 .. c0 + n - 1 of ``src`` as chunk j (the
  // proxy fence orders the block's earlier reads of the stage before the copy)
  __device__ __forceinline__ void fill(int j, const float4* src, int c0, int n, int lane) {
    float4* dst = buf[j % kStages];
    uint64_t* bar = &full[j % kStages];
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (lane == 0) mbar_expect_tx(bar, static_cast<unsigned>(n * kW4 * sizeof(float4)));
    if constexpr (kStride == kW4) {
      if (lane == 0)
        bulk_copy(dst, src + static_cast<size_t>(c0) * kW4,
                  static_cast<unsigned>(n * kW4 * sizeof(float4)), bar);
    } else {
      __syncwarp();
      for (int r = lane; r < n; r += 32)
        bulk_copy(dst + r * kW4, src + static_cast<size_t>(c0 + r) * kStride,
                  static_cast<unsigned>(kW4 * sizeof(float4)), bar);
    }
  }
  // the rows of chunk j, once they have landed
  __device__ __forceinline__ const float4* wait(int j) {
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    return buf[j % kStages];
  }
  // warp-collective: this warp is done with chunk j; true in the warp that was
  // last, which may then refill the stage
  __device__ __forceinline__ bool release(int j, int lane) {
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = atomicAdd(&done[j % kStages], 1) == kWarps - 1;
      if (last) done[j % kStages] = 0;
    }
    return __shfl_sync(kFull, last, 0) != 0;
  }
};

// The chunk loop of K1 and K3 over a tile's first ``count`` rows of ``src``:
// fill the ring, then per chunk (rows c0 .. c0 + n - 1, cut at g_block
// boundaries) wait for its rows and call blend(rows, n); at a g_block's start,
// stop once no pixel's transmittance ``T()`` is at least kSatEps (the
// early-out; the copies in flight land first). Every thread of the block
// calls it; ``ring`` is the block's shared RowRing, ``seg_`` its clock.
template <class Ring, int kStages, int kRows, class Blend, class Trans>
__device__ __forceinline__ void run_chunks(Ring& ring, const float4* src, int count, int g_block,
                                           int p, SegClock& seg_, Blend&& blend, Trans&& T) {
  const int warp = p / 32, lane = p % 32;
  if (p == 0) ring.init();
  __syncthreads();
  if (warp == 0)
    for (int j = 0, c = 0; j < kStages && c < count; ++j) {
      const int n = chunk_len(c, count, g_block, kRows);
      ring.fill(j, src, c, n, lane);
      c += n;
    }
  SEG_MARK(0)
  for (int j = 0, c0 = 0; c0 < count; ++j) {
    const int n = chunk_len(c0, count, g_block, kRows);
    if (c0 > 0 && c0 % g_block == 0 && !__syncthreads_or(T() >= kSatEps)) {
      for (int q = j, c = c0; q < j + kStages && c < count; ++q) {
        ring.wait(q);
        c += chunk_len(c, count, g_block, kRows);
      }
      SEG_MARK(2)
      break;
    }
    SEG_MARK(2)
    const float4* rows = ring.wait(j);
    SEG_MARK(1)
    blend(rows, n);
    if (ring.release(j, lane)) {   // refill the stage with chunk j + kStages
      int c = c0;
      for (int q = 0; q < kStages && c < count; ++q) c += chunk_len(c, count, g_block, kRows);
      if (c < count) ring.fill(j + kStages, src, c, chunk_len(c, count, g_block, kRows), lane);
    }
    c0 += n;
  }
}

// img = acc + T bg and alpha = 1 - T at pixel ``pix`` of the image layout
// [16 ty_n, 16 tx_n, CH]
template <int CH, int CHP>
__device__ __forceinline__ void write_pixel(float* __restrict__ img, float* __restrict__ alpha_out,
                                            const float (&acc)[CHP], float T,
                                            const float* __restrict__ bg, size_t pix) {
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

// A kernel's occupancy on the current device: blocks of 256 threads an SM
// holds at once, static shared memory per block, registers and local (spill)
// bytes per thread. Returns a cudaError_t.
template <class Kernel>
inline int occupancy(Kernel kernel, int* blocks_per_sm, int* smem_bytes, int* registers,
                     int* local_bytes) {
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kPx, 0);
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

}  // namespace segsplat
