// EWA projection of 3D Gaussians to screen space, forward and backward, for
// NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's projection is XLA
// (segsplat_tpu/ops/rasterize.py project_gaussians), differentiated by
// jax.grad. The port ran it as about 265 eager PyTorch operators on [N]
// arrays forward and about 430 backward, each a launch of a few microseconds
// on the card and 12-16 microseconds of host dispatch, so the rendered frame
// and the train step waited on the host. The forward kernel computes the same
// Projected in one launch, one thread a Gaussian; the backward kernel
// (segsplat_project_bwd, the projection's torch.autograd.Function) recomputes
// the forward's terms in registers, one thread a Gaussian, and gives the
// gradients of its inputs in one more launch.
//
// Bit for bit the plain versions' (ops/rasterize.project_gaussians_plain and
// project_gaussians_vjp_plain): every operator there rounds its result to
// float32, so every operation here is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), which nvcc never
// contracts into an FMA, taken in the plain version's order, including
// PyTorch's own lowering:
//   * ``number / tensor`` is ``reciprocal(tensor) * number``;
//   * ``-fx * tx`` negates fx first, ``1 - 2 * s`` doubles and then subtracts;
//   * a Python number meets a float32 tensor as that number cast to float.
// The camera-space means t_cam = means3d @ R^T + t (cuBLAS) and the quaternion
// norms (a PyTorch reduction) stay eager in front of the kernels: their
// rounding is the library's, so the kernels read them, and autograd takes
// their backward from the gradients of t_cam and the norms.
//
// Intrinsics fx, fy, cx, cy are read from the card (0-dim tensors, so the host
// never waits) or passed by value (Python numbers). The frustum clamp's limit
// 1.3 tan_fov per axis comes in one of three ways (lim_mode): 0, by value,
// reckoned by the host in double as Python does; 1, 1.3 * tan read from the
// card; 2, 1.3 * ((1 / f) * half_extent) with f read from the card.
//
// Bound on the card: memory. Forward: a Gaussian reads 44 bytes (t_cam, norm,
// scales, quats) and writes 29 (means2d, depth, conic, radius, valid): 14.6 MB
// at 200 000 Gaussians, 4.4 us at 3.35 TB/s. Backward: it reads the same 44
// and the cotangents (24: means2d, depth, conic) and writes 44 (the
// gradients of t_cam, norm, scales, quats): 112 bytes, 29 MB at 262 144
// Gaussians, 8.8 us. About 130 fp32 operations a Gaussian forward and 450
// backward, a few of them divisions, are far from the compute bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Inputs {
  const float* tcam;     // [N, 3] camera-space means
  const float* qnorm;    // [N] |quat|
  const float* scales;   // [N, 3]
  const float* quats;    // [N, 4] (w, x, y, z), not normalised
};

struct Camera {
  const float* viewmat;  // world-to-view, R_w2c[i][j] at i * vm_row + j * vm_col
  int vm_row, vm_col;
  const float* f_ptr[4];  // fx, fy, cx, cy on the card, or null: use f_val
  float f_val[4];
  int lim_mode[2];        // see the header
  const float* lim_ptr[2];
  float lim_val[2];       // mode 0: the limit; mode 2: the half extent 0.5 * W or H
  float znear, eps2d, row0, width, height;
};

struct Params {
  Inputs in;
  Camera cam;
  float* means2d;         // [N, 2]
  float* depths;          // [N]
  float* conics;          // [N, 3]
  float* radii;           // [N]
  uint8_t* valid;         // [N] bool
  long long n;
};

struct BwdParams {
  Inputs in;
  Camera cam;
  // cotangents, element strides; a null pointer reads as zero
  const float* g_means2d;  // [N, 2]
  long long gm_row, gm_col;
  const float* g_depths;   // [N]
  long long gd_row;
  const float* g_conics;   // [N, 3]
  long long gc_row, gc_col;
  float* d_tcam;           // [N, 3]
  float* d_qnorm;          // [N]
  float* d_scales;         // [N, 3]
  float* d_quats;          // [N, 4]
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

__device__ __forceinline__ float frustum_lim(const Camera& p, int axis) {
  switch (p.lim_mode[axis]) {
    case 1: return mul(*p.lim_ptr[axis], float(1.3));                      // 1.3 * tan
    case 2: return mul(mul(div(1.0f, *p.lim_ptr[axis]), p.lim_val[axis]),  // (half / f)
                       float(1.3));
    default: return p.lim_val[axis];
  }
}

// The camera as a thread reads it.
struct Cam {
  float fx, fy, cx, cy, lim_x, lim_y;
  float W[3][3];
};

__device__ __forceinline__ Cam load_camera(const Camera& p) {
  Cam k;
  float v4[4];
  for (int j = 0; j < 4; ++j) v4[j] = p.f_ptr[j] ? *p.f_ptr[j] : p.f_val[j];
  k.fx = v4[0], k.fy = v4[1], k.cx = v4[2], k.cy = v4[3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) k.W[r][c] = p.viewmat[r * p.vm_row + c * p.vm_col];
  k.lim_x = frustum_lim(p, 0);
  k.lim_y = frustum_lim(p, 1);
  return k;
}

// A Gaussian's forward terms, each rounded where the plain version rounds it
// (ops/rasterize._ewa_terms names them alike).
struct Terms {
  float x, y, z, zc, rx, ry, clx, cly, tx, ty;
  float qd, q[4], R[3][3], s[3], M[3][3], C[3][3];  // C: the upper triangle
  float inv_z, inv_z2, t02, t12, j00, j02, j11, j12;
  float A1, A2, B1, B2, D1, D2, a, b, c, det, inv_det;  // det: 1 where not keep
  bool keep;                                             // a c - b b > 1e-12
};

__device__ __forceinline__ void ewa_terms(const Inputs& in, const Cam& k, const Camera& cam,
                                          long long i, Terms& t) {
  t.x = in.tcam[3 * i], t.y = in.tcam[3 * i + 1], t.z = in.tcam[3 * i + 2];
  t.zc = clamp_min(t.z, cam.znear);
  t.rx = div(t.x, t.zc), t.ry = div(t.y, t.zc);
  t.clx = clamp(t.rx, -k.lim_x, k.lim_x), t.cly = clamp(t.ry, -k.lim_y, k.lim_y);
  t.tx = mul(t.clx, t.zc), t.ty = mul(t.cly, t.zc);

  t.qd = add(in.qnorm[i], float(1e-12));
  for (int j = 0; j < 4; ++j) t.q[j] = div(in.quats[4 * i + j], t.qd);
  const float qw = t.q[0], qx = t.q[1], qy = t.q[2], qz = t.q[3];
  t.R[0][0] = sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz))));
  t.R[0][1] = mul(2.0f, sub(mul(qx, qy), mul(qw, qz)));
  t.R[0][2] = mul(2.0f, add(mul(qx, qz), mul(qw, qy)));
  t.R[1][0] = mul(2.0f, add(mul(qx, qy), mul(qw, qz)));
  t.R[1][1] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz))));
  t.R[1][2] = mul(2.0f, sub(mul(qy, qz), mul(qw, qx)));
  t.R[2][0] = mul(2.0f, sub(mul(qx, qz), mul(qw, qy)));
  t.R[2][1] = mul(2.0f, add(mul(qy, qz), mul(qw, qx)));
  t.R[2][2] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))));
  for (int j = 0; j < 3; ++j) t.s[j] = in.scales[3 * i + j];
  // M = R diag(s); Sigma = M M^T
  for (int r = 0; r < 3; ++r)
    for (int j = 0; j < 3; ++j) t.M[r][j] = mul(t.R[r][j], t.s[j]);
  float S[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = r; c < 3; ++c)
      S[r][c] = S[c][r] = add(add(mul(t.M[r][0], t.M[c][0]), mul(t.M[r][1], t.M[c][1])),
                              mul(t.M[r][2], t.M[c][2]));
  // P = W Sigma, a row at a time; C = P W^T
  const float(*W)[3] = k.W;
  float P[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      P[r][c] = add(add(mul(W[r][0], S[0][c]), mul(W[r][1], S[1][c])), mul(W[r][2], S[2][c]));
  for (int r = 0; r < 3; ++r)
    for (int c = r; c < 3; ++c)
      t.C[r][c] = add(add(mul(P[r][0], W[c][0]), mul(P[r][1], W[c][1])), mul(P[r][2], W[c][2]));

  t.inv_z = div(1.0f, t.zc);
  t.inv_z2 = mul(t.inv_z, t.inv_z);
  // J rows: [fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]
  t.t02 = mul(-k.fx, t.tx), t.t12 = mul(-k.fy, t.ty);
  t.j00 = mul(k.fx, t.inv_z), t.j02 = mul(t.t02, t.inv_z2);
  t.j11 = mul(k.fy, t.inv_z), t.j12 = mul(t.t12, t.inv_z2);
  const float(*C)[3] = t.C;
  t.A1 = add(mul(t.j00, C[0][0]), mul(t.j02, C[0][2]));
  t.A2 = add(mul(t.j00, C[0][2]), mul(t.j02, C[2][2]));
  t.B1 = add(mul(t.j11, C[0][1]), mul(t.j12, C[0][2]));
  t.B2 = add(mul(t.j11, C[1][2]), mul(t.j12, C[2][2]));
  t.D1 = add(mul(t.j11, C[1][1]), mul(t.j12, C[1][2]));
  t.D2 = add(mul(t.j11, C[1][2]), mul(t.j12, C[2][2]));
  t.a = add(add(mul(t.j00, t.A1), mul(t.j02, t.A2)), cam.eps2d);
  t.b = add(mul(t.j00, t.B1), mul(t.j02, t.B2));
  t.c = add(add(mul(t.j11, t.D1), mul(t.j12, t.D2)), cam.eps2d);

  const float det = sub(mul(t.a, t.c), mul(t.b, t.b));
  t.keep = det > float(1e-12);
  t.det = t.keep ? det : 1.0f;
  t.inv_det = div(1.0f, t.det);
}

__global__ void __launch_bounds__(256) project_kernel(const Params p) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= p.n) return;
  const Cam k = load_camera(p.cam);
  Terms t;
  ewa_terms(p.in, k, p.cam, i, t);
  p.conics[3 * i] = mul(t.c, t.inv_det);
  p.conics[3 * i + 1] = mul(-t.b, t.inv_det);
  p.conics[3 * i + 2] = mul(t.a, t.inv_det);

  const float mid = mul(add(t.a, t.c), 0.5f);
  const float lam1 = add(mid, __fsqrt_rn(clamp_min(sub(mul(mid, mid), t.det), float(0.1))));
  const float radius = ceilf(mul(__fsqrt_rn(lam1), 3.0f));

  const float u = add(mul(mul(k.fx, t.x), t.inv_z), k.cx);
  const float v = sub(add(mul(mul(k.fy, t.y), t.inv_z), k.cy), p.cam.row0);  // v - 0 is v, also for -0
  p.means2d[2 * i] = u;
  p.means2d[2 * i + 1] = v;
  const bool valid = t.z > p.cam.znear && t.keep && add(u, radius) > 0.0f &&
                     sub(u, radius) < p.cam.width && add(v, radius) > 0.0f &&
                     sub(v, radius) < p.cam.height;
  p.radii[i] = valid ? radius : 0.0f;
  p.valid[i] = valid;
  p.depths[i] = t.z;
}

// The vector-Jacobian product of the forward above, in the order of
// ops/rasterize.project_gaussians_vjp_plain, which is autograd's chain rule
// with its conventions: clamp_min and clamp pass the gradient where the input
// lies within their bounds, ends included; where(det > 1e-12, det, 1) passes
// none through the 1; ceil gives the radius none; rows that are not valid get
// their chain-rule gradient all the same.
__global__ void __launch_bounds__(256) project_bwd_kernel(const BwdParams p) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= p.n) return;
  const Cam k = load_camera(p.cam);
  Terms t;
  ewa_terms(p.in, k, p.cam, i, t);
  const float gu = p.g_means2d ? p.g_means2d[i * p.gm_row] : 0.0f;
  const float gv = p.g_means2d ? p.g_means2d[i * p.gm_row + p.gm_col] : 0.0f;
  const float gz = p.g_depths ? p.g_depths[i * p.gd_row] : 0.0f;
  float g[3];
  for (int j = 0; j < 3; ++j) g[j] = p.g_conics ? p.g_conics[i * p.gc_row + j * p.gc_col] : 0.0f;

  // conic = (c, -b, a) / det
  float d_c = mul(g[0], t.inv_det);
  float d_b = -mul(g[1], t.inv_det);
  float d_a = mul(g[2], t.inv_det);
  const float d_inv = add(add(mul(g[0], t.c), mul(g[1], -t.b)), mul(g[2], t.a));
  const float d_det = t.keep ? -mul(d_inv, mul(t.inv_det, t.inv_det)) : 0.0f;
  d_a = add(d_a, mul(d_det, t.c));
  d_c = add(d_c, mul(d_det, t.a));
  d_b = sub(d_b, mul(mul(2.0f, t.b), d_det));

  // a = j00 A1 + j02 A2 + eps, b = j00 B1 + j02 B2, c = j11 D1 + j12 D2 + eps;
  // A1 = j00 C00 + j02 C02, A2 = j00 C02 + j02 C22, B1 = j11 C01 + j12 C02,
  // B2 = j11 C12 + j12 C22, D1 = j11 C11 + j12 C12, D2 = j11 C12 + j12 C22
  const float(*C)[3] = t.C;
  const float dA1 = mul(d_a, t.j00), dA2 = mul(d_a, t.j02);
  const float dB1 = mul(d_b, t.j00), dB2 = mul(d_b, t.j02);
  const float dD1 = mul(d_c, t.j11), dD2 = mul(d_c, t.j12);
  const float d_j00 = add(add(mul(d_a, t.A1), mul(d_b, t.B1)),
                          add(mul(dA1, C[0][0]), mul(dA2, C[0][2])));
  const float d_j02 = add(add(mul(d_a, t.A2), mul(d_b, t.B2)),
                          add(mul(dA1, C[0][2]), mul(dA2, C[2][2])));
  const float d_j11 = add(add(mul(d_c, t.D1), add(mul(dB1, C[0][1]), mul(dB2, C[1][2]))),
                          add(mul(dD1, C[1][1]), mul(dD2, C[1][2])));
  const float d_j12 = add(add(mul(d_c, t.D2), add(mul(dB1, C[0][2]), mul(dB2, C[2][2]))),
                          add(mul(dD1, C[1][2]), mul(dD2, C[2][2])));
  float dC[3][3];  // the upper triangle
  dC[0][0] = mul(dA1, t.j00);
  dC[0][1] = mul(dB1, t.j11);
  dC[0][2] = add(add(mul(dA1, t.j02), mul(dA2, t.j00)), mul(dB1, t.j12));
  dC[1][1] = mul(dD1, t.j11);
  dC[1][2] = add(add(mul(dB2, t.j11), mul(dD1, t.j12)), mul(dD2, t.j11));
  dC[2][2] = add(add(mul(dA2, t.j02), mul(dB2, t.j12)), mul(dD2, t.j12));

  // j00 = fx / z, j02 = (-fx tx) / z^2, j11 = fy / z, j12 = (-fy ty) / z^2;
  // u = (fx x) / z + cx, v = (fy y) / z + cy
  const float ux = mul(k.fx, t.x), vy = mul(k.fy, t.y);
  float d_inv_z = add(add(add(mul(d_j00, k.fx), mul(d_j11, k.fy)), mul(gu, ux)), mul(gv, vy));
  const float d_inv_z2 = add(mul(d_j02, t.t02), mul(d_j12, t.t12));
  d_inv_z = add(d_inv_z, mul(mul(2.0f, t.inv_z), d_inv_z2));
  const float d_tx = mul(mul(d_j02, t.inv_z2), -k.fx);
  const float d_ty = mul(mul(d_j12, t.inv_z2), -k.fy);
  float d_x = mul(mul(gu, t.inv_z), k.fx);
  float d_y = mul(mul(gv, t.inv_z), k.fy);
  // inv_z = 1 / zc; tx = clamp(x / zc, ±lim_x) zc, ty likewise
  float d_zc = -mul(d_inv_z, t.inv_z2);
  d_zc = add(d_zc, mul(d_tx, t.clx));
  d_zc = add(d_zc, mul(d_ty, t.cly));
  const float d_rx = (t.rx >= -k.lim_x && t.rx <= k.lim_x) ? mul(d_tx, t.zc) : 0.0f;
  const float d_ry = (t.ry >= -k.lim_y && t.ry <= k.lim_y) ? mul(d_ty, t.zc) : 0.0f;
  d_x = add(d_x, div(d_rx, t.zc));
  d_y = add(d_y, div(d_ry, t.zc));
  d_zc = sub(d_zc, mul(d_rx, div(t.rx, t.zc)));
  d_zc = sub(d_zc, mul(d_ry, div(t.ry, t.zc)));
  // zc = clamp_min(z, znear); depth = z
  const float d_z = add(t.z >= p.cam.znear ? d_zc : 0.0f, gz);
  p.d_tcam[3 * i] = d_x;
  p.d_tcam[3 * i + 1] = d_y;
  p.d_tcam[3 * i + 2] = d_z;

  // C = P W^T (upper), P = W Sigma: dP[r][j] = sum over c >= r of dC[r][c] W[c][j]
  const float(*W)[3] = k.W;
  float dP[3][3];
  for (int r = 0; r < 3; ++r)
    for (int j = 0; j < 3; ++j) {
      float acc = mul(dC[r][r], W[r][j]);
      for (int c = r + 1; c < 3; ++c) acc = add(acc, mul(dC[r][c], W[c][j]));
      dP[r][j] = acc;
    }
  // dS = W^T dP over Sigma's nine places; each of its six entries fills two
  // of them (one on the diagonal), and Sigma = M M^T, so dM = (dS + dS^T) M
  float dS[3][3];
  for (int m = 0; m < 3; ++m)
    for (int c = 0; c < 3; ++c)
      dS[m][c] = add(add(mul(W[0][m], dP[0][c]), mul(W[1][m], dP[1][c])), mul(W[2][m], dP[2][c]));
  float G[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) G[r][c] = add(dS[r][c], dS[c][r]);
  // M = R diag(s)
  float dR[3][3];
  float ds[3] = {0.0f, 0.0f, 0.0f};
  for (int r = 0; r < 3; ++r)
    for (int j = 0; j < 3; ++j) {
      const float dM = add(add(mul(G[r][0], t.M[0][j]), mul(G[r][1], t.M[1][j])),
                           mul(G[r][2], t.M[2][j]));
      dR[r][j] = mul(dM, t.s[j]);
      const float term = mul(dM, t.R[r][j]);
      ds[j] = r == 0 ? term : add(ds[j], term);
    }
  for (int j = 0; j < 3; ++j) p.d_scales[3 * i + j] = ds[j];

  // R of the normalised quaternion (w, x, y, z)
  const float qw = t.q[0], qx = t.q[1], qy = t.q[2], qz = t.q[3];
  const float(*d)[3] = dR;
  float dq[4];
  dq[0] = mul(2.0f, add(add(mul(qz, sub(d[1][0], d[0][1])), mul(qy, sub(d[0][2], d[2][0]))),
                        mul(qx, sub(d[2][1], d[1][2]))));
  dq[1] = mul(2.0f, sub(add(add(mul(qy, add(d[0][1], d[1][0])), mul(qz, add(d[0][2], d[2][0]))),
                            mul(qw, sub(d[2][1], d[1][2]))),
                        mul(mul(2.0f, qx), add(d[1][1], d[2][2]))));
  dq[2] = mul(2.0f, sub(add(add(mul(qx, add(d[0][1], d[1][0])), mul(qz, add(d[1][2], d[2][1]))),
                            mul(qw, sub(d[0][2], d[2][0]))),
                        mul(mul(2.0f, qy), add(d[0][0], d[2][2]))));
  dq[3] = mul(2.0f, sub(add(add(mul(qx, add(d[0][2], d[2][0])), mul(qy, add(d[1][2], d[2][1]))),
                            mul(qw, sub(d[1][0], d[0][1]))),
                        mul(mul(2.0f, qz), add(d[0][0], d[1][1]))));
  // q = quat / (|quat| + 1e-12)
  float dot = mul(dq[0], t.q[0]);
  for (int j = 1; j < 4; ++j) dot = add(dot, mul(dq[j], t.q[j]));
  for (int j = 0; j < 4; ++j) p.d_quats[4 * i + j] = div(dq[j], t.qd);
  p.d_qnorm[i] = -div(dot, t.qd);
}

void fill_inputs(Inputs& in, const void* tcam, const void* qnorm, const void* scales,
                 const void* quats) {
  in.tcam = static_cast<const float*>(tcam);
  in.qnorm = static_cast<const float*>(qnorm);
  in.scales = static_cast<const float*>(scales);
  in.quats = static_cast<const float*>(quats);
}

void fill_camera(Camera& p, const void* viewmat, int vm_row, int vm_col, const void* fx_ptr,
                 const void* fy_ptr, const void* cx_ptr, const void* cy_ptr, float fx, float fy,
                 float cx, float cy, int lim_mode_x, int lim_mode_y, const void* lim_ptr_x,
                 const void* lim_ptr_y, float lim_val_x, float lim_val_y, float znear,
                 float eps2d, float row0, float width, float height) {
  p.viewmat = static_cast<const float*>(viewmat);
  p.vm_row = vm_row;
  p.vm_col = vm_col;
  const void* f_ptr[4] = {fx_ptr, fy_ptr, cx_ptr, cy_ptr};
  const float f_val[4] = {fx, fy, cx, cy};
  for (int j = 0; j < 4; ++j) {
    p.f_ptr[j] = static_cast<const float*>(f_ptr[j]);
    p.f_val[j] = f_val[j];
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
}

constexpr int kThreads = 256;

unsigned blocks_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// The camera's arguments, the same in both entries (see Camera).
#define SEGSPLAT_CAMERA_ARGS                                                                   \
  const void *viewmat, int vm_row, int vm_col, const void *fx_ptr, const void *fy_ptr,        \
      const void *cx_ptr, const void *cy_ptr, float fx, float fy, float cx, float cy,          \
      int lim_mode_x, int lim_mode_y, const void *lim_ptr_x, const void *lim_ptr_y,            \
      float lim_val_x, float lim_val_y, float znear, float eps2d, float row0, float width,    \
      float height
#define SEGSPLAT_CAMERA_VALUES                                                                 \
  viewmat, vm_row, vm_col, fx_ptr, fy_ptr, cx_ptr, cy_ptr, fx, fy, cx, cy, lim_mode_x,         \
      lim_mode_y, lim_ptr_x, lim_ptr_y, lim_val_x, lim_val_y, znear, eps2d, row0, width, height

// Launch on ``stream``; ops/rasterize.py passes the arguments (see Params).
// Returns a cudaError_t.
extern "C" int segsplat_project(const void* tcam, const void* qnorm, const void* scales,
                                const void* quats, SEGSPLAT_CAMERA_ARGS, void* means2d,
                                void* depths, void* conics, void* radii, void* valid,
                                long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  Params p;
  fill_inputs(p.in, tcam, qnorm, scales, quats);
  fill_camera(p.cam, SEGSPLAT_CAMERA_VALUES);
  p.means2d = static_cast<float*>(means2d);
  p.depths = static_cast<float*>(depths);
  p.conics = static_cast<float*>(conics);
  p.radii = static_cast<float*>(radii);
  p.valid = static_cast<uint8_t*>(valid);
  p.n = n;
  project_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The backward on ``stream``: the forward's inputs and camera, the cotangents
// of means2d, depths and conics (null: zero; strides in elements), and the
// gradients of t_cam, the norms, scales and quats (see BwdParams). Returns a
// cudaError_t.
extern "C" int segsplat_project_bwd(const void* tcam, const void* qnorm, const void* scales,
                                    const void* quats, SEGSPLAT_CAMERA_ARGS,
                                    const void* g_means2d, long long gm_row, long long gm_col,
                                    const void* g_depths, long long gd_row,
                                    const void* g_conics, long long gc_row, long long gc_col,
                                    void* d_tcam, void* d_qnorm, void* d_scales, void* d_quats,
                                    long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  BwdParams p;
  fill_inputs(p.in, tcam, qnorm, scales, quats);
  fill_camera(p.cam, SEGSPLAT_CAMERA_VALUES);
  p.g_means2d = static_cast<const float*>(g_means2d);
  p.gm_row = gm_row;
  p.gm_col = gm_col;
  p.g_depths = static_cast<const float*>(g_depths);
  p.gd_row = gd_row;
  p.g_conics = static_cast<const float*>(g_conics);
  p.gc_row = gc_row;
  p.gc_col = gc_col;
  p.d_tcam = static_cast<float*>(d_tcam);
  p.d_qnorm = static_cast<float*>(d_qnorm);
  p.d_scales = static_cast<float*>(d_scales);
  p.d_quats = static_cast<float*>(d_quats);
  p.n = n;
  project_bwd_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
