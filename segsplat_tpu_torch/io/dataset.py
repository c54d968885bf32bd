"""Scene / dataset readers: COLMAP scenes (binary or text sparse models,
llffhold train/test split, per-view object masks) and Blender/NeRF-synthetic
transforms_*.json scenes — the reference's scene/dataset_readers.py and
utils/camera_utils.py. Cameras stay host-side numpy here; scene.to_device_camera
puts one on a device."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np
from PIL import Image

from segsplat_tpu_torch.core.transforms import (focal2fov, fov2focal,
                                                get_world2view, qvec2rotmat)
from segsplat_tpu_torch.io import colmap as colmap_io
from segsplat_tpu_torch.io.ply import read_ply, write_ply


@dataclasses.dataclass
class CameraInfo:
    uid: int
    R: np.ndarray          # [3,3] c2w rotation
    T: np.ndarray          # [3] w2c translation
    fov_x: float
    fov_y: float
    image_path: str
    image_name: str
    width: int
    height: int
    object_path: Optional[str] = None  # per-view object mask

    def load_image(self, resolution_scale: float = 1.0) -> np.ndarray:
        """[H, W, 3] float32 in [0, 1], resized to the loaded resolution."""
        img = Image.open(self.image_path)
        w, h = round(self.width / resolution_scale), round(self.height / resolution_scale)
        if (w, h) != img.size:
            img = img.resize((w, h))
        return np.asarray(img.convert("RGB"), np.float32) / 255.0

    def load_objects(self, resolution_scale: float = 1.0) -> Optional[np.ndarray]:
        """[H, W] int32 object-id mask (nearest resize), or None."""
        if self.object_path is None or not os.path.exists(self.object_path):
            return None
        img = Image.open(self.object_path)
        w, h = round(self.width / resolution_scale), round(self.height / resolution_scale)
        if (w, h) != img.size:
            img = img.resize((w, h), Image.NEAREST)
        return np.asarray(img, np.int32)


@dataclasses.dataclass
class SceneInfo:
    point_cloud_xyz: np.ndarray
    point_cloud_rgb: np.ndarray  # [P,3] float in [0,1]
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def get_nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    """Scene-extent normalisation: radius = 1.1 × max camera-centre distance
    from the average centre."""
    centers = []
    for cam in cam_infos:
        c2w = np.linalg.inv(get_world2view(cam.R, cam.T))
        centers.append(c2w[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    dists = np.linalg.norm(centers - avg, axis=0)
    return {"translate": -avg.flatten(), "radius": float(dists.max()) * 1.1}


def read_colmap_cameras(cam_extrinsics, cam_intrinsics, images_folder,
                        objects_folder=None) -> List[CameraInfo]:
    infos = []
    for key in sorted(cam_extrinsics, key=lambda k: cam_extrinsics[k].name):
        extr = cam_extrinsics[key]
        intr = cam_intrinsics[extr.camera_id]
        R = np.transpose(qvec2rotmat(extr.qvec))
        T = np.array(extr.tvec)
        if intr.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            focal_x = focal_y = intr.params[0]
        elif intr.model in ("PINHOLE", "OPENCV"):
            focal_x, focal_y = intr.params[0], intr.params[1]
        else:
            raise ValueError(f"Unsupported COLMAP camera model {intr.model}")
        obj_path = None
        if objects_folder is not None:
            obj_path = os.path.join(
                objects_folder, os.path.splitext(extr.name)[0] + ".png")
        infos.append(CameraInfo(
            uid=extr.id, R=R, T=T, fov_x=focal2fov(focal_x, intr.width),
            fov_y=focal2fov(focal_y, intr.height),
            image_path=os.path.join(images_folder, extr.name),
            image_name=os.path.splitext(extr.name)[0],
            width=intr.width, height=intr.height, object_path=obj_path))
    return infos


def read_colmap_scene(path: str, images: str = "images", eval_split: bool = False,
                      object_dir: str = "object_mask", llffhold: int = 8) -> SceneInfo:
    """Binary sparse model preferred, text otherwise; every llffhold'th view is
    test when eval_split."""
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    try:
        cam_extr = colmap_io.read_extrinsics_binary(os.path.join(sparse, "images.bin"))
        cam_intr = colmap_io.read_intrinsics_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        cam_extr = colmap_io.read_extrinsics_text(os.path.join(sparse, "images.txt"))
        cam_intr = colmap_io.read_intrinsics_text(os.path.join(sparse, "cameras.txt"))

    objects_folder = os.path.join(path, object_dir)
    if not os.path.isdir(objects_folder):
        objects_folder = None
    cam_infos = read_colmap_cameras(
        cam_extr, cam_intr, os.path.join(path, images), objects_folder)

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap_io.read_points3D_binary(os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap_io.read_points3D_text(os.path.join(sparse, "points3D.txt"))
        store_point_cloud_ply(ply_path, xyz, rgb)
    else:
        xyz, rgb = fetch_point_cloud_ply(ply_path)

    return SceneInfo(
        point_cloud_xyz=np.asarray(xyz, np.float32),
        point_cloud_rgb=np.asarray(rgb, np.float32) / 255.0 if rgb.dtype == np.uint8 else rgb,
        train_cameras=train, test_cameras=test,
        nerf_normalization=get_nerfpp_norm(train or cam_infos), ply_path=ply_path)


def read_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = True, extension: str = ".png") -> SceneInfo:
    """The reference's readNerfSyntheticInfo."""

    def read_split(transforms_file):
        with open(os.path.join(path, transforms_file)) as f:
            contents = json.load(f)
        fov_x = contents["camera_angle_x"]
        infos = []
        for idx, frame in enumerate(contents["frames"]):
            file_path = os.path.join(path, frame["file_path"] + extension)
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # Blender → COLMAP camera axes
            w2c = np.linalg.inv(c2w)
            with Image.open(file_path) as im:
                width, height = im.size
            infos.append(CameraInfo(
                uid=idx, R=np.transpose(w2c[:3, :3]), T=w2c[:3, 3], fov_x=fov_x,
                fov_y=focal2fov(fov2focal(fov_x, width), height),
                image_path=file_path, image_name=os.path.basename(frame["file_path"]),
                width=width, height=height))
        return infos

    train = read_split("transforms_train.json")
    test = read_split("transforms_test.json") if os.path.exists(
        os.path.join(path, "transforms_test.json")) else []
    if not eval_split:
        train, test = train + test, []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        rng = np.random.default_rng(0)
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        rgb = rng.random((num_pts, 3))
        store_point_cloud_ply(ply_path, xyz, (rgb * 255).astype(np.uint8))
    xyz, rgb = fetch_point_cloud_ply(ply_path)
    return SceneInfo(
        point_cloud_xyz=np.asarray(xyz, np.float32),
        point_cloud_rgb=np.asarray(rgb, np.float32) / 255.0 if rgb.dtype == np.uint8 else rgb,
        train_cameras=train, test_cameras=test,
        nerf_normalization=get_nerfpp_norm(train), ply_path=ply_path)


def store_point_cloud_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    dt = np.dtype([("x", "f4"), ("y", "f4"), ("z", "f4"),
                   ("nx", "f4"), ("ny", "f4"), ("nz", "f4"),
                   ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    v = np.zeros(len(xyz), dtype=dt)
    v["x"], v["y"], v["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    v["red"], v["green"], v["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    write_ply(path, v, binary=True)


def fetch_point_cloud_ply(path: str):
    c = read_ply(path)
    xyz = c.xyz()
    if c.names and "red" in c.names:
        rgb = np.stack([c["red"], c["green"], c["blue"]], axis=1)
    else:
        rgb = np.full((len(xyz), 3), 127, np.uint8)
    return xyz, rgb


def detect_scene_type(path: str) -> str:
    if os.path.exists(os.path.join(path, "sparse")):
        return "colmap"
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "blender"
    raise ValueError(f"Could not recognise scene type at {path}")


def load_scene(path: str, images: str = "images", eval_split: bool = False,
               object_dir: str = "object_mask") -> SceneInfo:
    if detect_scene_type(path) == "colmap":
        return read_colmap_scene(path, images=images, eval_split=eval_split,
                                 object_dir=object_dir)
    return read_blender_scene(path, eval_split=eval_split)


def resolution_scale_for(width: int, height: int, resolution: int = -1) -> float:
    """The reference's resolution ladder (utils/camera_utils.py:26-43):
    explicit 1/2/4/8 divisors, or auto-downscale so the longer side is ≤1600 px
    when resolution == -1."""
    if resolution in (1, 2, 4, 8):
        return float(resolution)
    if resolution == -1:
        return width / 1600.0 if width > 1600 else 1.0
    if resolution > 0:
        return width / float(resolution)
    return 1.0
