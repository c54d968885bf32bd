// EWA projection of 3D Gaussians to screen space, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's projection is XLA
// (segsplat_tpu/ops/rasterize.py project_gaussians). The port ran it as about
// 200 eager PyTorch operators on [N] arrays, each a launch of a few
// microseconds on the card and 12-16 microseconds of host dispatch, so the
// rendered frame waited on the host. This kernel computes the same Projected
// in one launch: one thread a Gaussian.
//
// Bit for bit the plain version's (ops/rasterize.project_gaussians_plain):
// every operator there rounds its result to float32, so every operation here
// is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn), which nvcc never contracts into an FMA, taken in the
// plain version's order, including PyTorch's own lowering:
//   * ``number / tensor`` is ``reciprocal(tensor) * number``;
//   * ``-fx * tx`` negates fx first, ``1 - 2 * s`` doubles and then subtracts;
//   * a Python number meets a float32 tensor as that number cast to float.
// The camera-space means t_cam = means3d @ R^T + t (cuBLAS) and the quaternion
// norms (a PyTorch reduction) stay eager in front of the kernel: their
// rounding is the library's, so the kernel reads them.
//
// Intrinsics fx, fy, cx, cy are read from the card (0-dim tensors, so the host
// never waits) or passed by value (Python numbers). The frustum clamp's limit
// 1.3 tan_fov per axis comes in one of three ways (lim_mode): 0, by value,
// reckoned by the host in double as Python does; 1, 1.3 * tan read from the
// card; 2, 1.3 * ((1 / f) * half_extent) with f read from the card.
//
// Bound on the card: memory. A Gaussian reads 44 bytes (t_cam, norm, scales,
// quats) and writes 29 (means2d, depth, conic, radius, valid): 14.6 MB at
// 200 000 Gaussians, 4.4 us at 3.35 TB/s. About 130 fp32 operations a
// Gaussian, four of them divisions, are far from the compute bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Params {
  const float* tcam;     // [N, 3] camera-space means
  const float* qnorm;    // [N] |quat|
  const float* scales;   // [N, 3]
  const float* quats;    // [N, 4] (w, x, y, z), not normalised
  const float* viewmat;  // world-to-view, R_w2c[i][j] at i * vm_row + j * vm_col
  int vm_row, vm_col;
  const float* f_ptr[4];  // fx, fy, cx, cy on the card, or null: use f_val
  float f_val[4];
  int lim_mode[2];        // see the header
  const float* lim_ptr[2];
  float lim_val[2];       // mode 0: the limit; mode 2: the half extent 0.5 * W or H
  float znear, eps2d, row0, width, height;
  float* means2d;         // [N, 2]
  float* depths;          // [N]
  float* conics;          // [N, 3]
  float* radii;           // [N]
  uint8_t* valid;         // [N] bool
  long long n;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp_min / torch.clamp: NaN passes through, as in PyTorch's kernels
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float frustum_lim(const Params& p, int axis) {
  switch (p.lim_mode[axis]) {
    case 1: return mul(*p.lim_ptr[axis], float(1.3));                      // 1.3 * tan
    case 2: return mul(mul(div(1.0f, *p.lim_ptr[axis]), p.lim_val[axis]),  // (half / f)
                       float(1.3));
    default: return p.lim_val[axis];
  }
}

__global__ void __launch_bounds__(256) project_kernel(const Params p) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= p.n) return;
  float v4[4];
  for (int k = 0; k < 4; ++k) v4[k] = p.f_ptr[k] ? *p.f_ptr[k] : p.f_val[k];
  const float fx = v4[0], fy = v4[1], cx = v4[2], cy = v4[3];
  float W[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) W[r][c] = p.viewmat[r * p.vm_row + c * p.vm_col];

  const float x = p.tcam[3 * i], y = p.tcam[3 * i + 1], z = p.tcam[3 * i + 2];
  bool valid = z > p.znear;
  const float zc = clamp_min(z, p.znear);
  const float lim_x = frustum_lim(p, 0), lim_y = frustum_lim(p, 1);
  const float tx = mul(clamp(div(x, zc), -lim_x, lim_x), zc);
  const float ty = mul(clamp(div(y, zc), -lim_y, lim_y), zc);

  const float qd = add(p.qnorm[i], float(1e-12));
  const float qw = div(p.quats[4 * i], qd), qx = div(p.quats[4 * i + 1], qd);
  const float qy = div(p.quats[4 * i + 2], qd), qz = div(p.quats[4 * i + 3], qd);
  const float r00 = sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz))));
  const float r01 = mul(2.0f, sub(mul(qx, qy), mul(qw, qz)));
  const float r02 = mul(2.0f, add(mul(qx, qz), mul(qw, qy)));
  const float r10 = mul(2.0f, add(mul(qx, qy), mul(qw, qz)));
  const float r11 = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz))));
  const float r12 = mul(2.0f, sub(mul(qy, qz), mul(qw, qx)));
  const float r20 = mul(2.0f, sub(mul(qx, qz), mul(qw, qy)));
  const float r21 = mul(2.0f, add(mul(qy, qz), mul(qw, qx)));
  const float r22 = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))));
  const float s0 = p.scales[3 * i], s1 = p.scales[3 * i + 1], s2 = p.scales[3 * i + 2];
  // M = R diag(s); Sigma = M M^T
  const float M[3][3] = {{mul(r00, s0), mul(r01, s1), mul(r02, s2)},
                         {mul(r10, s0), mul(r11, s1), mul(r12, s2)},
                         {mul(r20, s0), mul(r21, s1), mul(r22, s2)}};
  float S[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = r; c < 3; ++c)
      S[r][c] = S[c][r] = add(add(mul(M[r][0], M[c][0]), mul(M[r][1], M[c][1])),
                              mul(M[r][2], M[c][2]));
  // P = W Sigma, a row at a time; C = P W^T
  float P[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      P[r][c] = add(add(mul(W[r][0], S[0][c]), mul(W[r][1], S[1][c])), mul(W[r][2], S[2][c]));
  float C[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = r; c < 3; ++c)
      C[r][c] = add(add(mul(P[r][0], W[c][0]), mul(P[r][1], W[c][1])), mul(P[r][2], W[c][2]));

  const float inv_z = div(1.0f, zc);
  const float inv_z2 = mul(inv_z, inv_z);
  // J rows: [fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]
  const float j00 = mul(fx, inv_z), j02 = mul(mul(-fx, tx), inv_z2);
  const float j11 = mul(fy, inv_z), j12 = mul(mul(-fy, ty), inv_z2);
  const float a = add(add(mul(j00, add(mul(j00, C[0][0]), mul(j02, C[0][2]))),
                          mul(j02, add(mul(j00, C[0][2]), mul(j02, C[2][2])))), p.eps2d);
  const float b = add(mul(j00, add(mul(j11, C[0][1]), mul(j12, C[0][2]))),
                      mul(j02, add(mul(j11, C[1][2]), mul(j12, C[2][2]))));
  const float c = add(add(mul(j11, add(mul(j11, C[1][1]), mul(j12, C[1][2]))),
                          mul(j12, add(mul(j11, C[1][2]), mul(j12, C[2][2])))), p.eps2d);

  float det = sub(mul(a, c), mul(b, b));
  valid = valid && det > float(1e-12);
  det = det > float(1e-12) ? det : 1.0f;
  const float inv_det = div(1.0f, det);
  p.conics[3 * i] = mul(c, inv_det);
  p.conics[3 * i + 1] = mul(-b, inv_det);
  p.conics[3 * i + 2] = mul(a, inv_det);

  const float mid = mul(add(a, c), 0.5f);
  const float lam1 = add(mid, __fsqrt_rn(clamp_min(sub(mul(mid, mid), det), float(0.1))));
  const float radius = ceilf(mul(__fsqrt_rn(lam1), 3.0f));

  const float u = add(mul(mul(fx, x), inv_z), cx);
  const float v = sub(add(mul(mul(fy, y), inv_z), cy), p.row0);  // v - 0 is v, also for -0
  p.means2d[2 * i] = u;
  p.means2d[2 * i + 1] = v;
  valid = valid && add(u, radius) > 0.0f && sub(u, radius) < p.width &&
          add(v, radius) > 0.0f && sub(v, radius) < p.height;
  p.radii[i] = valid ? radius : 0.0f;
  p.valid[i] = valid;
  p.depths[i] = z;
}

}  // namespace

// Launch on ``stream``; ops/rasterize.py passes the arguments (see Params).
// Returns a cudaError_t.
extern "C" int segsplat_project(const void* tcam, const void* qnorm, const void* scales,
                                const void* quats, const void* viewmat, int vm_row,
                                int vm_col, const void* fx_ptr, const void* fy_ptr,
                                const void* cx_ptr, const void* cy_ptr, float fx, float fy,
                                float cx, float cy, int lim_mode_x, int lim_mode_y,
                                const void* lim_ptr_x, const void* lim_ptr_y,
                                float lim_val_x, float lim_val_y, float znear, float eps2d,
                                float row0, float width, float height, void* means2d,
                                void* depths, void* conics, void* radii, void* valid,
                                long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  Params p;
  p.tcam = static_cast<const float*>(tcam);
  p.qnorm = static_cast<const float*>(qnorm);
  p.scales = static_cast<const float*>(scales);
  p.quats = static_cast<const float*>(quats);
  p.viewmat = static_cast<const float*>(viewmat);
  p.vm_row = vm_row;
  p.vm_col = vm_col;
  const void* f_ptr[4] = {fx_ptr, fy_ptr, cx_ptr, cy_ptr};
  const float f_val[4] = {fx, fy, cx, cy};
  for (int k = 0; k < 4; ++k) {
    p.f_ptr[k] = static_cast<const float*>(f_ptr[k]);
    p.f_val[k] = f_val[k];
  }
  p.lim_mode[0] = lim_mode_x;
  p.lim_mode[1] = lim_mode_y;
  p.lim_ptr[0] = static_cast<const float*>(lim_ptr_x);
  p.lim_ptr[1] = static_cast<const float*>(lim_ptr_y);
  p.lim_val[0] = lim_val_x;
  p.lim_val[1] = lim_val_y;
  p.znear = znear;
  p.eps2d = eps2d;
  p.row0 = row0;
  p.width = width;
  p.height = height;
  p.means2d = static_cast<float*>(means2d);
  p.depths = static_cast<float*>(depths);
  p.conics = static_cast<float*>(conics);
  p.radii = static_cast<float*>(radii);
  p.valid = static_cast<uint8_t*>(valid);
  p.n = n;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  project_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
