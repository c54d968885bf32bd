"""Scene facade (the reference's scene/__init__.py): detect the COLMAP or
Blender layout, load the cameras, and either create the Gaussian table from the
point cloud (training; ``input.ply`` and ``cameras.json`` are written into the
model dir) or load a saved iteration (``point_cloud/iteration_N/point_cloud.ply``,
auto-picked when load_iteration=-1), on a device."""

from __future__ import annotations

import json
import os
import random
from typing import List, Optional

import numpy as np
import torch

from segsplat_tpu_torch.core.transforms import fov2focal, get_world2view
from segsplat_tpu_torch.core.types import NUM_OBJECTS, Camera, GaussianTable
from segsplat_tpu_torch.io.dataset import CameraInfo, SceneInfo, load_scene
from segsplat_tpu_torch.io.ply import load_gaussian_ply, save_gaussian_ply
from segsplat_tpu_torch.utils.system import (mkdir_p, require_device,
                                             search_for_max_iteration)


def camera_to_json(idx: int, cam: CameraInfo) -> dict:
    """cameras.json entry (the reference's utils/camera_utils.py:74-94)."""
    c2w = np.linalg.inv(get_world2view(cam.R, cam.T))
    return {
        "id": idx,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [r.tolist() for r in c2w[:3, :3]],
        "fy": fov2focal(cam.fov_y, cam.height),
        "fx": fov2focal(cam.fov_x, cam.width),
    }


def to_device_camera(info: CameraInfo, resolution_scale: float = 1.0,
                     device: str | torch.device = "cuda") -> Camera:
    """CameraInfo → Camera on ``device`` at the loaded resolution."""
    device = require_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    return Camera(R=torch.as_tensor(np.asarray(info.R, np.float32), **f32),
                  T=torch.as_tensor(np.asarray(info.T, np.float32), **f32),
                  fov_x=torch.tensor(info.fov_x, **f32),
                  fov_y=torch.tensor(info.fov_y, **f32),
                  width=round(info.width / resolution_scale),
                  height=round(info.height / resolution_scale))


class Scene:
    """Cameras + the GaussianTable: created from the point cloud, or loaded."""

    def __init__(self, source_path: str, model_path: str,
                 images: str = "images", object_dir: str = "object_mask",
                 eval_split: bool = False, shuffle: bool = True,
                 load_iteration: Optional[int] = None,
                 capacity: Optional[int] = None, max_sh_degree: int = 3,
                 seed: int = 0, device: str | torch.device = "cuda"):
        device = require_device(device)
        self.model_path = model_path
        self.max_sh_degree = max_sh_degree
        self.loaded_iter = None
        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = search_for_max_iteration(
                    os.path.join(model_path, "point_cloud"))
                if self.loaded_iter is None:
                    raise FileNotFoundError(
                        f"load_iteration=-1 but no point_cloud/iteration_* "
                        f"checkpoints under {model_path}")
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")

        self.info: SceneInfo = load_scene(source_path, images=images,
                                          eval_split=eval_split,
                                          object_dir=object_dir)
        self.cameras_extent = self.info.nerf_normalization["radius"]

        if not self.loaded_iter and model_path:
            mkdir_p(model_path)
            with open(self.info.ply_path, "rb") as src, \
                    open(os.path.join(model_path, "input.ply"), "wb") as dst:
                dst.write(src.read())
            cams = [camera_to_json(i, c) for i, c in enumerate(
                self.info.train_cameras + self.info.test_cameras)]
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump(cams, f)

        self.train_cameras: List[CameraInfo] = list(self.info.train_cameras)
        self.test_cameras: List[CameraInfo] = list(self.info.test_cameras)
        if shuffle:
            random.Random(seed).shuffle(self.train_cameras)

        if self.loaded_iter:
            ply = os.path.join(model_path, "point_cloud",
                               f"iteration_{self.loaded_iter}", "point_cloud.ply")
            self.gaussians: GaussianTable = load_gaussian_table(
                ply, max_sh_degree=max_sh_degree, capacity=capacity, device=device)
        else:
            from segsplat_tpu_torch.train.trainer import init_table_from_pcd
            xyz = self.info.point_cloud_xyz.astype(np.float32)
            rgb = self.info.point_cloud_rgb.astype(np.float32)
            cap = capacity or int(2 ** np.ceil(np.log2(max(len(xyz) * 4, 1024))))
            self.gaussians = init_table_from_pcd(xyz, rgb, cap,
                                                 max_sh_degree=max_sh_degree,
                                                 seed=seed, device=device)

    def save(self, iteration: int, table: Optional[GaussianTable] = None) -> str:
        """Write ``point_cloud/iteration_N/point_cloud.ply``; returns its path."""
        table = table if table is not None else self.gaussians
        out_dir = os.path.join(self.model_path, "point_cloud", f"iteration_{iteration}")
        mkdir_p(out_dir)
        path = os.path.join(out_dir, "point_cloud.ply")
        save_gaussian_table(path, table)
        return path

    def get_train_cameras(self) -> List[CameraInfo]:
        return self.train_cameras

    def get_test_cameras(self) -> List[CameraInfo]:
        return self.test_cameras


def table_from_arrays(arrays: dict, capacity: Optional[int] = None,
                      max_sh_degree: int = 3,
                      device: str | torch.device = "cuda") -> GaussianTable:
    """Fixed-capacity GaussianTable on ``device`` from loaded [N, ...] arrays.
    Rows past N are inactive and all-zero (rotation included), as in the JAX
    package, so both render the same pairs. Default capacity: int(1.5·N)."""
    device = require_device(device)
    n = arrays["xyz"].shape[0]
    cap = capacity or max(int(n * 1.5), 1)
    r = (max_sh_degree + 1) ** 2 - 1

    def place(vals, shape):
        out = np.zeros((cap,) + shape, np.float32)
        out[:n] = np.asarray(vals, np.float32).reshape((n,) + shape)
        return torch.from_numpy(out).to(device)

    fr = arrays["features_rest"]
    if fr.shape[1] < r:
        fr = np.pad(fr, ((0, 0), (0, r - fr.shape[1]), (0, 0)))
    objects = arrays.get("objects_dc", np.zeros((n, 1, NUM_OBJECTS), np.float32))
    return GaussianTable(
        xyz=place(arrays["xyz"], (3,)),
        features_dc=place(arrays["features_dc"], (1, 3)),
        features_rest=place(fr[:, :r], (r, 3)),
        scaling=place(arrays["scaling"], (3,)),
        rotation=place(arrays["rotation"], (4,)),
        opacity=place(arrays["opacity"], (1,)),
        objects_dc=place(objects, (1, NUM_OBJECTS)),
        active=torch.arange(cap, device=device) < n,
        active_sh_degree=max_sh_degree,
        max_sh_degree=max_sh_degree)


def load_gaussian_table(path: str, max_sh_degree: int = 3,
                        capacity: Optional[int] = None,
                        load_objects: bool = True,
                        device: str | torch.device = "cuda") -> GaussianTable:
    """Gaussian checkpoint PLY → GaussianTable on ``device`` (restores the
    obj_dc_* identity features)."""
    arrays = load_gaussian_ply(path, max_sh_degree=max_sh_degree,
                               load_objects=load_objects)
    return table_from_arrays(arrays, capacity=capacity,
                             max_sh_degree=max_sh_degree, device=device)


def save_gaussian_table(path: str, table: GaussianTable) -> None:
    """Write the ACTIVE rows in the reference's Gaussian PLY layout, with the
    obj_dc_* identity features — the JAX package's format."""
    active = table.active.cpu().numpy()
    host = lambda t: t.detach().cpu().numpy()[active]
    save_gaussian_ply(path, xyz=host(table.xyz), features_dc=host(table.features_dc),
                      features_rest=host(table.features_rest),
                      opacity=host(table.opacity), scaling=host(table.scaling),
                      rotation=host(table.rotation), objects_dc=host(table.objects_dc))
