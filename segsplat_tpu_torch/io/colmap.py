"""COLMAP sparse-reconstruction readers (binary + text) and the binary writers
of synthetic scenes, in COLMAP's public formats; the fields match the
reference's scene/colmap_loader.py:125-293. A file written here is the same
bytes as one the JAX package writes from the same inputs."""

from __future__ import annotations

import collections
import struct
from typing import Dict

import numpy as np

CameraModel = collections.namedtuple("CameraModel", ["model_id", "model_name", "num_params"])
ColmapCamera = collections.namedtuple("ColmapCamera", ["id", "model", "width", "height", "params"])
ColmapImage = collections.namedtuple(
    "ColmapImage", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"])

CAMERA_MODELS = {
    m.model_id: m for m in [
        CameraModel(0, "SIMPLE_PINHOLE", 3),
        CameraModel(1, "PINHOLE", 4),
        CameraModel(2, "SIMPLE_RADIAL", 4),
        CameraModel(3, "RADIAL", 5),
        CameraModel(4, "OPENCV", 8),
        CameraModel(5, "OPENCV_FISHEYE", 8),
        CameraModel(6, "FULL_OPENCV", 12),
        CameraModel(7, "FOV", 5),
        CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
        CameraModel(9, "RADIAL_FISHEYE", 5),
        CameraModel(10, "THIN_PRISM_FISHEYE", 12),
    ]
}


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_extrinsics_binary(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        num = _read(f, 8, "Q")[0]
        for _ in range(num):
            props = _read(f, 64, "idddddddi")
            image_id = props[0]
            name = b""
            ch = f.read(1)
            while ch != b"\x00":
                name += ch
                ch = f.read(1)
            n_pts = _read(f, 8, "Q")[0]
            data = np.frombuffer(f.read(24 * n_pts), dtype=np.float64).reshape(n_pts, 3)
            point3D_ids = data[:, 2].view(np.int64).copy() if n_pts else np.empty(0, np.int64)
            images[image_id] = ColmapImage(
                id=image_id, qvec=np.array(props[1:5]), tvec=np.array(props[5:8]),
                camera_id=props[8], name=name.decode("utf-8"),
                xys=data[:, :2].copy(), point3D_ids=point3D_ids)
    return images


def read_intrinsics_binary(path: str) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as f:
        num = _read(f, 8, "Q")[0]
        for _ in range(num):
            cam_id, model_id, width, height = _read(f, 24, "iiQQ")
            model = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * model.num_params, "d" * model.num_params))
            cameras[cam_id] = ColmapCamera(
                id=cam_id, model=model.model_name, width=width, height=height, params=params)
    return cameras


def read_points3D_binary(path: str):
    """Returns (xyz [P,3] f64, rgb [P,3] u8, errors [P] f64). One read of the
    whole file, then offset walking over the variable-length tracks."""
    with open(path, "rb") as f:
        buf = f.read()
    num = struct.unpack_from("<Q", buf, 0)[0]
    xyz = np.empty((num, 3))
    rgb = np.empty((num, 3), np.uint8)
    err = np.empty(num)
    off = 8
    unpack = struct.Struct("<QdddBBBd").unpack_from
    tlen = struct.Struct("<Q").unpack_from
    for i in range(num):
        props = unpack(buf, off)
        off += 43
        xyz[i] = props[1:4]
        rgb[i] = props[4:7]
        err[i] = props[7]
        off += 8 + 8 * tlen(buf, off)[0]
    return xyz, rgb, err


def read_extrinsics_text(path: str) -> Dict[int, ColmapImage]:
    # empty lines are kept: an image with zero points has an empty POINTS2D
    # line, and the header/points pairing depends on it
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if not ln.startswith("#")]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        el = lines[i].split()
        el2 = lines[i + 1].split() if i + 1 < len(lines) else []
        i += 2
        pts = np.array(el2, np.float64).reshape(-1, 3) if el2 else np.zeros((0, 3))
        images[int(el[0])] = ColmapImage(
            id=int(el[0]), qvec=np.array(el[1:5], np.float64),
            tvec=np.array(el[5:8], np.float64), camera_id=int(el[8]), name=el[9],
            xys=pts[:, :2], point3D_ids=pts[:, 2].astype(np.int64))
    return images


def read_intrinsics_text(path: str) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            el = ln.split()
            cameras[int(el[0])] = ColmapCamera(
                id=int(el[0]), model=el[1], width=int(el[2]), height=int(el[3]),
                params=np.array(el[4:], np.float64))
    return cameras


def read_points3D_text(path: str):
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            el = ln.split()
            xyzs.append([float(x) for x in el[1:4]])
            rgbs.append([int(x) for x in el[4:7]])
            errs.append(float(el[7]))
    return (np.array(xyzs), np.array(rgbs, np.uint8), np.array(errs))


CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS.values()}


def write_points3D_binary(path: str, xyz: np.ndarray, rgb: np.ndarray,
                          err: np.ndarray = None) -> None:
    """Minimal points3D.bin writer (for synthetic scenes): no tracks."""
    err = np.zeros(len(xyz)) if err is None else err
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<QdddBBBd", i + 1, *xyz[i], *rgb[i].astype(np.uint8), err[i]))
            f.write(struct.pack("<Q", 0))


def write_extrinsics_binary(path: str, images: Dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.point3D_ids)))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", x, y, pid))


def write_intrinsics_binary(path: str, cameras: Dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model = CAMERA_MODEL_NAMES[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model.model_id, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * model.num_params, *cam.params))
