"""SIBR-compatible network viewer bridge (the counterpart of
segsplat_tpu/viewer.py, after the reference's gaussian_renderer/network_gui.py:26-86):
a nonblocking TCP listener that receives JSON camera messages ({resolution,
fov, view_matrix, ...}) and streams raw rendered bytes back, polled from the
training loop (pipeline/train.train(gui=...)).

The wire protocol is the JAX package's byte for byte: a 4-byte little-endian
length and a UTF-8 JSON camera message in; the frame's raw HWC RGB bytes, a
4-byte length and the ASCII verify string out; ``width == 0 or height == 0``
means "no camera". The received view matrix's Y and Z columns are negated as
the reference does.

Each frame is one ``render`` on the table's device with the default backend,
so on the card one launch of the forward blend kernel (19 channels). Only a
dropped or malformed connection (socket errors, JSON and UTF-8 decoding, a
missing message field) is caught: the connection is closed and the poll
returns. A failure of the render raises.
"""

from __future__ import annotations

import json
import socket
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from segsplat_tpu_torch.core.types import Camera
from segsplat_tpu_torch.render import render

# what ends a viewer connection without ending training
CONNECTION_ERRORS = (OSError, json.JSONDecodeError, UnicodeDecodeError, KeyError)


@dataclass
class ViewerCamera:
    """The reference's MiniCam (scene/cameras.py:69-81)."""
    width: int
    height: int
    fov_y: float
    fov_x: float
    znear: float
    zfar: float
    world_view_transform: np.ndarray  # [4,4] row-vector convention (reference)

    def to_camera(self, device: str | torch.device) -> Camera:
        """The port's Camera (column-vector W2C) on ``device``."""
        w2c = self.world_view_transform.T      # the reference stores the transpose
        f32 = dict(dtype=torch.float32, device=device)
        return Camera(R=torch.as_tensor(np.ascontiguousarray(w2c[:3, :3].T), **f32),
                      T=torch.as_tensor(np.ascontiguousarray(w2c[:3, 3]), **f32),
                      fov_x=torch.tensor(self.fov_x, **f32),
                      fov_y=torch.tensor(self.fov_y, **f32),
                      width=self.width, height=self.height)


def frame_bytes(img: torch.Tensor) -> bytes:
    """[3, H, W] float image → the wire's H·W·3 uint8 bytes: clipped to [0, 1],
    times 255, truncated (as numpy's astype), laid out HWC."""
    u8 = torch.clamp(img, 0, 1).mul(255).to(torch.uint8)
    return u8.permute(1, 2, 0).contiguous().cpu().numpy().tobytes()


class NetworkGUI:
    def __init__(self):
        self.listener: Optional[socket.socket] = None
        self.conn: Optional[socket.socket] = None
        self.addr = None

    def init(self, host: str = "127.0.0.1", port: int = 6009) -> None:
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self.listener.bind((host, port))
            self.listener.listen()
        except OSError:
            self.close()
            raise
        self.listener.settimeout(0)

    def close(self) -> None:
        """Close the connection and the listener."""
        self._drop()
        if self.listener is not None:
            self.listener.close()
            self.listener = None

    def _drop(self) -> None:
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def try_connect(self) -> bool:
        if self.listener is None:
            return False
        try:
            self.conn, self.addr = self.listener.accept()
        except OSError:                 # BlockingIOError: nobody is waiting
            return False
        print(f"\nConnected by {self.addr}")
        self.conn.settimeout(None)
        return True

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer closed")
            buf += chunk
        return bytes(buf)

    def _read(self) -> dict:
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def send(self, image_bytes: Optional[bytes], verify: str) -> None:
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(self) -> Tuple[Optional[ViewerCamera], Optional[bool],
                               Optional[bool], Optional[float]]:
        """Returns (camera, do_training, keep_alive, scaling_modifier)."""
        m = self._read()
        width, height = m["resolution_x"], m["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None
        wvt = np.asarray(m["view_matrix"], np.float32).reshape(4, 4)
        wvt[:, 1] = -wvt[:, 1]
        wvt[:, 2] = -wvt[:, 2]
        cam = ViewerCamera(width=width, height=height, fov_y=m["fov_y"],
                           fov_x=m["fov_x"], znear=m["z_near"], zfar=m["z_far"],
                           world_view_transform=wvt)
        return (cam, bool(m["train"]), bool(m["keep_alive"]),
                float(m["scaling_modifier"]))

    def poll_and_render(self, table, do_training: bool, source_path: str,
                        bg: Optional[torch.Tensor] = None) -> bool:
        """One training-loop poll (train_unified_lift.py:319-332): accept a
        connection if one is pending, then serve frames until the client lets
        training go on (``train`` true, and no camera or no keep-alive).
        While the client pauses training the poll stays here. Returns the
        possibly updated do_training flag."""
        if self.conn is None:
            self.try_connect()
        dev = table.xyz.device
        while self.conn is not None:
            try:
                cam, train_flag, keep_alive, scale_mod = self.receive()
            except CONNECTION_ERRORS:
                self._drop()
                break
            image = None
            if cam is not None:
                with torch.no_grad():
                    out = render(table, cam.to_camera(dev),
                                 bg if bg is not None else torch.zeros(3, device=dev),
                                 scaling_modifier=scale_mod)
                image = frame_bytes(out["render"])
            if train_flag is not None:
                do_training = train_flag
            try:
                self.send(image, source_path)
            except OSError:
                self._drop()
                break
            if do_training and (cam is None or not keep_alive):
                break
        return do_training
