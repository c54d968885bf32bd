"""Camera and geometry helpers (the reference's utils/graphics_utils.py:38-77,
utils/general_utils.py:29-99 and scene/colmap_loader.py:43-53 conventions):
numpy for the dataset readers and the scene facade, torch for the trainer."""

from __future__ import annotations

import math

import numpy as np
import torch


def get_world2view(R: np.ndarray, t: np.ndarray, translate=None,
                   scale: float = 1.0) -> np.ndarray:
    """World→view matrix from a c2w rotation and w2c translation, with the
    optional camera-center translate/scale of getWorld2View2."""
    Rt = np.zeros((4, 4), np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        c2w = np.linalg.inv(Rt)
        c2w[:3, 3] = (c2w[:3, 3] + translate) * scale
        Rt = np.linalg.inv(c2w)
    return Rt.astype(np.float32)


def get_projection_matrix(znear: float, zfar: float, fov_x: float, fov_y: float) -> np.ndarray:
    """3DGS-style perspective matrix, z mapped to [0, zfar/(zfar-znear)]
    (utils/graphics_utils.py:51-71)."""
    tan_y = math.tan(fov_y / 2)
    tan_x = math.tan(fov_x / 2)
    top, right = tan_y * znear, tan_x * znear
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP quaternion (w, x, y, z) → rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x**2 - 2 * y**2],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → COLMAP quaternion (w, x, y, z), w ≥ 0 (the
    reference's scene/colmap_loader.py:55-66)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) quaternion, normalised first → [..., 3, 3]
    rotation (the reference's build_rotation)."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s): [..., 3, 3] (utils/general_utils.py:101-110)."""
    return quat_to_rotmat(q) * s[..., None, :]


def build_covariance_3d(scaling: torch.Tensor, rotation: torch.Tensor,
                        modifier: float = 1.0) -> torch.Tensor:
    """Σ = L Lᵀ with L = R diag(modifier·s), full [..., 3, 3]."""
    L = build_scaling_rotation(modifier * scaling, rotation)
    return L @ L.transpose(-1, -2)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] → [..., 6] upper-triangular packing (xx, xy, xz, yy, yz, zz),
    the reference's on-disk covariance layout (utils/general_utils.py:64-76)."""
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], dim=-1)


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))


def get_expon_lr_func(lr_init: float, lr_final: float, lr_delay_steps: int = 0,
                      lr_delay_mult: float = 1.0, max_steps: int = 1_000_000):
    """Plenoxels exponential learning-rate decay (the reference's
    utils/general_utils.py:29-62): step → lr, in float32 as the JAX package
    computes it."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)

    def helper(step: int) -> float:
        s = f32(step)
        t = torch.clamp(s / max_steps, 0.0, 1.0)
        log_lerp = torch.exp(torch.log(f32(lr_init)) * (1 - t) + torch.log(f32(lr_final)) * t)
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(s / lr_delay_steps, 0.0, 1.0))
        else:
            delay_rate = 1.0
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        return float(delay_rate * log_lerp)

    return helper
