"""Self-contained PLY I/O: Gaussian checkpoints (x/y/z, nx/ny/nz, f_dc_*,
f_rest_*, opacity, scale_*, rot_*, obj_dc_*; the reference's
scene/gaussian_model.py:363-397 layout), coloured point clouds, voxel grids
whose header comments ``voxel_size v`` / ``grid_origin x y z`` / ``grid_shape
sx sy sz`` carry the grid's metadata from one stage to the next (the
reference's minkowski_voxel_grid_from_ply_advanced.py:173-205), and the
triangles of a mesh's ``face`` element (annotated ScanNet++ meshes). The vertex
body is read with one ``np.frombuffer`` (binary) or one split (ascii)."""

from __future__ import annotations

import dataclasses
import io
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_TO_NUMPY = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NUMPY_TO_PLY = {
    "int8": "char", "uint8": "uchar", "int16": "short", "uint16": "ushort",
    "int32": "int", "uint32": "uint", "float32": "float", "float64": "double",
}


@dataclasses.dataclass
class PlyContent:
    vertex: np.ndarray               # structured array of the 'vertex' element
    comments: List[str]
    # voxel-grid metadata parsed from the comments, None where absent
    voxel_size: Optional[float] = None
    grid_origin: Optional[np.ndarray] = None
    grid_shape: Optional[Tuple[int, int, int]] = None
    faces: Optional[np.ndarray] = None   # [F, 3] int32 triangles where present

    def __getitem__(self, name):
        return self.vertex[name]

    @property
    def names(self):
        return self.vertex.dtype.names

    def xyz(self) -> np.ndarray:
        return np.stack([self.vertex["x"], self.vertex["y"], self.vertex["z"]], axis=1)


def _parse_grid_comments(comments: List[str]):
    vs, origin, shape = None, None, None
    for c in comments:
        parts = c.split()
        if not parts:
            continue
        if parts[0] == "voxel_size" and len(parts) >= 2:
            vs = float(parts[1])
        elif parts[0] == "grid_origin" and len(parts) >= 4:
            origin = np.array([float(p) for p in parts[1:4]], np.float32)
        elif parts[0] == "grid_shape" and len(parts) >= 4:
            shape = tuple(int(float(p)) for p in parts[1:4])
    return vs, origin, shape


def read_ply(path: str) -> PlyContent:
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    nl = data.find(b"\n", header_end)
    header = data[:nl].decode("ascii", errors="replace")
    body = data[nl + 1:]

    fmt = None
    comments: List[str] = []
    elements: List[tuple] = []
    for line in header.splitlines():
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "comment":
            comments.append(" ".join(tok[1:]))
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append((tok[-1], f"LIST:{tok[2]}:{tok[3]}"))
            else:
                elements[-1][2].append((tok[-1], _PLY_TO_NUMPY[tok[1]]))

    vertex = None
    faces = None
    if fmt == "ascii":
        rows = [r for r in body.decode("ascii").split("\n") if r.strip()]
        row_i = 0
        for name, count, props in elements:
            if len(rows) < row_i + count:
                raise ValueError(f"{path}: truncated ascii PLY body")
            if any(t.startswith("LIST") for _, t in props):
                if name == "face":
                    tri = [[int(x) for x in tok[1:4]] for tok in
                           (r.split() for r in rows[row_i:row_i + count])
                           if len(tok) >= 4 and tok[0] == "3"]
                    faces = np.asarray(tri, np.int32) if tri else None
                row_i += count
                continue
            flat = np.array(" ".join(rows[row_i:row_i + count]).split(),
                            dtype=np.float64).reshape(count, len(props))
            arr = np.empty(count, dtype=np.dtype(props))
            for j, (p, t) in enumerate(props):
                arr[p] = flat[:, j].astype(t)
            row_i += count
            if name == "vertex":
                vertex = arr
    else:
        byte_order = "<" if "little" in (fmt or "") else ">"
        offset = 0
        for name, count, props in elements:
            if any(t.startswith("LIST") for _, t in props):
                tri, offset = _read_binary_lists(body, offset, count, props, byte_order)
                if name == "face" and len(tri):
                    faces = tri
                continue
            dt = np.dtype([(p, byte_order + t) for p, t in props])
            arr = np.frombuffer(body, dtype=dt, count=count, offset=offset).copy()
            offset += dt.itemsize * count
            if name == "vertex":
                vertex = arr

    if vertex is None:
        raise ValueError(f"{path}: no vertex element")
    vs, origin, shape = _parse_grid_comments(comments)
    return PlyContent(vertex=vertex, comments=comments, voxel_size=vs,
                      grid_origin=origin, grid_shape=shape, faces=faces)


def _read_binary_lists(body: bytes, offset: int, count: int, props, byte_order: str):
    """A binary element with list properties: its rows with exactly three
    indices as triangles [F, 3] int32 (others skipped), and the offset past
    it. An element of one list whose rows all hold three indices is read in
    one pass; any other, row by row."""
    dts = [(np.dtype(byte_order + _PLY_TO_NUMPY[t.split(":")[1]]),
            np.dtype(byte_order + _PLY_TO_NUMPY[t.split(":")[2]]))
           if t.startswith("LIST") else np.dtype(byte_order + t) for _, t in props]
    if len(dts) == 1 and isinstance(dts[0], tuple):
        ln, it = dts[0]
        row = np.dtype([("n", ln), ("i", it, (3,))])
        if len(body) - offset >= row.itemsize * count:
            rows = np.frombuffer(body, row, count, offset)
            if (rows["n"] == 3).all():
                return rows["i"].astype(np.int32), offset + row.itemsize * count
    tri = []
    for _ in range(count):
        for dt in dts:
            if isinstance(dt, tuple):
                ln, it = dt
                n = int(np.frombuffer(body, ln, 1, offset)[0])
                offset += ln.itemsize
                if n == 3:
                    tri.append(np.frombuffer(body, it, 3, offset))
                offset += n * it.itemsize
            else:
                offset += dt.itemsize
    return np.asarray(tri, np.int32).reshape(-1, 3), offset


def write_ply(path: str, vertex: np.ndarray, comments: Optional[List[str]] = None,
              binary: bool = True) -> None:
    """Write a structured array as a PLY vertex element."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    lines = ["ply", f"format {'binary_little_endian' if binary else 'ascii'} 1.0"]
    for c in comments or []:
        lines.append(f"comment {c}")
    lines.append(f"element vertex {len(vertex)}")
    for name in vertex.dtype.names:
        lines.append(f"property {_NUMPY_TO_PLY[vertex.dtype[name].name]} {name}")
    lines.append("end_header")
    header = ("\n".join(lines) + "\n").encode("ascii")
    with open(path, "wb") as f:
        f.write(header)
        if binary:
            f.write(vertex.astype(vertex.dtype.newbyteorder("<"), copy=False).tobytes())
        else:
            cols = [np.asarray(vertex[n]) for n in vertex.dtype.names]
            out = io.StringIO()
            for i in range(len(vertex)):
                out.write(" ".join(str(c[i]) for c in cols))
                out.write("\n")
            f.write(out.getvalue().encode("ascii"))


def write_voxel_grid_ply(path: str, centers: np.ndarray, colors: np.ndarray,
                         voxel_size: float, grid_origin: np.ndarray,
                         grid_shape: Optional[Tuple[int, int, int]] = None,
                         binary: bool = False) -> None:
    """Voxel-grid PLY with the metadata header comments; ascii by default, as the
    reference writes it."""
    comments = [
        f"voxel_size {voxel_size}",
        f"grid_origin {grid_origin[0]} {grid_origin[1]} {grid_origin[2]}",
    ]
    if grid_shape is not None:
        comments.append(f"grid_shape {grid_shape[0]} {grid_shape[1]} {grid_shape[2]}")
    dt = np.dtype([("x", "f4"), ("y", "f4"), ("z", "f4"),
                   ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    v = np.empty(len(centers), dtype=dt)
    v["x"], v["y"], v["z"] = centers[:, 0], centers[:, 1], centers[:, 2]
    colors = np.asarray(colors, np.uint8)
    v["red"], v["green"], v["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]
    write_ply(path, v, comments=comments, binary=binary)


def read_voxel_grid_ply(path: str):
    """(centers [V,3] f32, colors [V,3] u8 or None, voxel_size, origin, shape).
    The last three are None when the PLY lacks the header comments; callers
    raise then (there is no inferred-spacing fallback)."""
    c = read_ply(path)
    centers = c.xyz().astype(np.float32)
    colors = None
    if c.names and "red" in c.names:
        colors = np.stack([c["red"], c["green"], c["blue"]], axis=1).astype(np.uint8)
    return centers, colors, c.voxel_size, c.grid_origin, c.grid_shape


def save_gaussian_ply(path: str, xyz, features_dc, features_rest, opacity,
                      scaling, rotation, objects_dc=None) -> None:
    """Write a Gaussian checkpoint PLY in the reference's field layout: f_dc and
    f_rest flattened channel-major, plus optional obj_dc_* identity features.
    Inputs are [N, ...] numpy arrays in table layout (features_dc [N,1,3],
    features_rest [N,R,3], objects_dc [N,1,16])."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    f_dc = np.transpose(np.asarray(features_dc, np.float32), (0, 2, 1)).reshape(n, -1)
    f_rest = np.transpose(np.asarray(features_rest, np.float32), (0, 2, 1)).reshape(n, -1)
    opacity = np.asarray(opacity, np.float32).reshape(n, -1)
    scaling = np.asarray(scaling, np.float32)
    rotation = np.asarray(rotation, np.float32)
    fields = (["x", "y", "z", "nx", "ny", "nz"]
              + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
              + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
              + ["opacity"]
              + [f"scale_{i}" for i in range(scaling.shape[1])]
              + [f"rot_{i}" for i in range(rotation.shape[1])])
    cols = [xyz, np.zeros_like(xyz), f_dc, f_rest, opacity, scaling, rotation]
    if objects_dc is not None:
        obj = np.transpose(np.asarray(objects_dc, np.float32), (0, 2, 1)).reshape(n, -1)
        fields += [f"obj_dc_{i}" for i in range(obj.shape[1])]
        cols.append(obj)
    flat = np.concatenate(cols, axis=1).astype(np.float32)
    dt = np.dtype([(f, "f4") for f in fields])
    v = np.frombuffer(np.ascontiguousarray(flat).tobytes(), dtype=dt).copy()
    write_ply(path, v, binary=True)


def _sorted_fields(names, prefix: str) -> List[str]:
    return sorted([m for m in names if m.startswith(prefix)],
                  key=lambda s: int(s.split("_")[-1]))


def load_gaussian_ply(path: str, max_sh_degree: int = 3,
                      load_objects: bool = True) -> Dict[str, np.ndarray]:
    """Load a Gaussian checkpoint PLY into [N, ...] numpy arrays in table layout.
    Restores obj_dc_* identity features when present and ``load_objects``."""
    c = read_ply(path)
    names = c.names
    n = len(c.vertex)
    xyz = c.xyz().astype(np.float32)
    opacity = np.asarray(c["opacity"], np.float32).reshape(n, 1)

    f_dc = np.stack([c[f"f_dc_{i}"] for i in range(3)], axis=1).astype(np.float32)
    features_dc = f_dc.reshape(n, 3, 1).transpose(0, 2, 1)           # [N,1,3]

    rest_names = _sorted_fields(names, "f_rest_")
    if rest_names:
        fr = np.stack([c[m] for m in rest_names], axis=1).astype(np.float32)
        features_rest = fr.reshape(n, 3, len(rest_names) // 3).transpose(0, 2, 1)
    else:
        features_rest = np.zeros((n, (max_sh_degree + 1) ** 2 - 1, 3), np.float32)

    scaling = np.stack([c[m] for m in _sorted_fields(names, "scale_")],
                       axis=1).astype(np.float32)
    rotation = np.stack([c[m] for m in _sorted_fields(names, "rot_")],
                        axis=1).astype(np.float32)

    out = dict(xyz=xyz, features_dc=features_dc, features_rest=features_rest,
               opacity=opacity, scaling=scaling, rotation=rotation)
    obj_names = _sorted_fields(names, "obj_dc_")
    if obj_names and load_objects:
        obj = np.stack([c[m] for m in obj_names], axis=1).astype(np.float32)
        out["objects_dc"] = obj.reshape(n, len(obj_names), 1).transpose(0, 2, 1)
    return out
