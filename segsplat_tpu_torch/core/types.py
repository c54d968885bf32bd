"""Core types: a fixed-capacity Gaussian table, a sparse voxel grid and a
pinhole camera.

Counterparts of segsplat_tpu/core/types.py as frozen dataclasses of tensors.
The table keeps the JAX package's fixed capacity with an ``active`` mask, so a
table converted from JAX (convert.table_from_jax_arrays) renders the same pairs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NUM_OBJECTS = 16            # identity-feature channels
NUM_SEMANTIC_CHANNELS = 32  # logit raster channels (the reference's NUM_CHANNELS)
NUM_CODEBOOK = 256          # codebook rows (train_unified_lift.py:295-297)


@dataclasses.dataclass(frozen=True)
class GaussianTable:
    """Fixed-capacity Gaussian parameter table.

    Shapes (C = capacity, R = (max_sh_degree+1)**2 - 1):
      xyz            [C, 3]   world positions
      features_dc    [C, 1, 3]  SH DC colour coefficients
      features_rest  [C, R, 3]  higher-order SH coefficients
      scaling        [C, 3]   log-scale (activation: exp)
      rotation       [C, 4]   unnormalised quaternion (activation: normalise)
      opacity        [C, 1]   logit opacity (activation: sigmoid)
      objects_dc     [C, 1, NUM_OBJECTS]  identity features
      active         [C]      bool, live-row mask
      active_sh_degree        int, SH degree in use
    """

    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    objects_dc: torch.Tensor
    active: torch.Tensor
    active_sh_degree: int
    max_sh_degree: int = 3

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_rotation(self) -> torch.Tensor:
        return self.rotation / (
            torch.linalg.norm(self.rotation, dim=-1, keepdim=True) + 1e-12)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_features(self) -> torch.Tensor:
        """[C, 1+R, 3] concatenated SH coefficients."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Sparse voxel grid (segsplat_tpu/core/types.py:120).

    ``coords`` are non-negative integer voxel coordinates in (x, y, z) order, the
    reference's ``round((p - origin) / voxel_size)`` convention. ``origin`` is the
    world position of voxel (0, 0, 0): its corner for floor-quantized grids, its
    centre for round-quantized ones. ``shape`` is the dense (Z, Y, X) extent."""

    coords: torch.Tensor                     # [V, 3] int32 (x, y, z)
    origin: torch.Tensor                     # [3] float32 world-space origin
    voxel_size: torch.Tensor                 # [] float32
    features: Optional[torch.Tensor] = None  # [V, F] optional per-voxel payload
    shape: tuple = ()                        # (Z, Y, X) dense extent

    @property
    def num_voxels(self) -> int:
        return self.coords.shape[0]

    def centers(self) -> torch.Tensor:
        """World-space voxel centres, the reference's coord·vs + origin."""
        return self.coords.to(torch.float32) * self.voxel_size + self.origin


@dataclasses.dataclass(frozen=True)
class Camera:
    """A pinhole camera in the reference's conventions: R is the camera-to-world
    rotation, T the world-to-camera translation, so W2C = [[Rᵀ, T], [0, 1]]."""

    R: torch.Tensor       # [3, 3] c2w rotation
    T: torch.Tensor       # [3] w2c translation
    fov_x: torch.Tensor   # [] radians
    fov_y: torch.Tensor   # [] radians
    width: int = 0
    height: int = 0

    def __getitem__(self, v) -> "Camera":
        """View ``v`` (an index or a slice) of a camera batch of
        ``stack_cameras``."""
        if self.R.ndim != 3:
            raise TypeError("only a camera batch (stack_cameras) can be indexed")
        return dataclasses.replace(self, R=self.R[v], T=self.T[v], fov_x=self.fov_x[v],
                                   fov_y=self.fov_y[v])

    def world_view_transform(self) -> torch.Tensor:
        """[4, 4] world→view matrix (column-vector convention)."""
        w2c = torch.zeros((4, 4), dtype=torch.float32, device=self.R.device)
        w2c[:3, :3] = self.R.T
        w2c[:3, 3] = self.T
        w2c[3, 3] = 1.0
        return w2c

    def camera_center(self) -> torch.Tensor:
        """World-space camera position = -R @ T."""
        return -self.R @ self.T

    def intrinsics(self) -> torch.Tensor:
        """[3, 3] K with the principal point at the image centre."""
        fx = self.width / (2.0 * torch.tan(self.fov_x * 0.5))
        fy = self.height / (2.0 * torch.tan(self.fov_y * 0.5))
        K = torch.zeros((3, 3), dtype=torch.float32, device=self.R.device)
        K[0, 0] = fx
        K[1, 1] = fy
        K[2, 2] = 1.0
        K[0, 2] = self.width / 2.0
        K[1, 2] = self.height / 2.0
        return K


def stack_cameras(cams) -> Camera:
    """Same-resolution cameras as one camera batch, with a leading view axis
    on ``R``, ``T``, ``fov_x`` and ``fov_y``; ``batch[v]`` takes view v back."""
    if len({(c.width, c.height) for c in cams}) != 1:
        raise ValueError("stack_cameras: mixed resolutions "
                         f"{sorted({(c.width, c.height) for c in cams})}")
    return Camera(R=torch.stack([c.R for c in cams]), T=torch.stack([c.T for c in cams]),
                  fov_x=torch.stack([torch.as_tensor(c.fov_x) for c in cams]),
                  fov_y=torch.stack([torch.as_tensor(c.fov_y) for c in cams]),
                  width=cams[0].width, height=cams[0].height)
