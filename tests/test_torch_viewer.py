"""The port's SIBR viewer bridge (segsplat_tpu_torch/viewer.py) against the JAX
package's (segsplat_tpu/viewer.py), on the CPU: the camera conversion at 1e-6,
``receive`` on the same message bytes, a full socket round trip whose frame is
held at ±1 LSB against the JAX render the JAX viewer calls (backend "xla"),
the pause and resume, a length prefix that arrives in two pieces, which
errors end a connection and which propagate, the train loop's poll and the
train CLI's busy-port warning. Every socket has a timeout and every thread a
bounded join."""

import contextlib
import io
import json
import socket
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segsplat_tpu import viewer as JV
from segsplat_tpu.render import render as jax_render
from segsplat_tpu.train.trainer import init_table_from_pcd
from segsplat_tpu_torch import viewer as PV
from segsplat_tpu_torch.convert import table_from_jax_arrays
from segsplat_tpu_torch.pipeline.train import TrainRunConfig, train
from segsplat_tpu_torch.train.cli import main as cli_main
from segsplat_tpu_torch.train.trainer import OptimizationConfig
from _torch_port import torch_threads, write_blender_scene

TIMEOUT = 20.0                   # every socket and join in this file
W = H = 32


@pytest.fixture(autouse=True)
def _two_torch_threads():
    with torch_threads(2):
        yield


def _message(view_matrix, train=True, keep_alive=False, scale=1.0, width=W, height=H):
    """A SIBR camera message (network_gui.py's fields)."""
    return {"resolution_x": width, "resolution_y": height, "train": train,
            "fov_y": 0.8, "fov_x": 0.9, "z_near": 0.01, "z_far": 100.0,
            "shs_python": False, "rot_scale_python": False, "keep_alive": keep_alive,
            "scaling_modifier": scale,
            "view_matrix": np.asarray(view_matrix, np.float32).ravel().tolist(),
            "view_projection_matrix": np.eye(4, dtype=np.float32).ravel().tolist()}


def _wire(msg: dict) -> bytes:
    payload = json.dumps(msg).encode("utf-8")
    return len(payload).to_bytes(4, "little") + payload


def _view_matrix(yaw=0.3, shift=(0.1, -0.05, 4.0)):
    """A row-vector world→view matrix as SIBR sends it, before the Y/Z flip:
    a yaw and a shift that keep the table in front of the camera."""
    c, s = np.cos(yaw), np.sin(yaw)
    w2c = np.eye(4)
    w2c[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    w2c[:3, 3] = shift
    w2c[1:3, :] *= -1           # the flip that receive() undoes
    return w2c.T


@pytest.fixture(scope="module")
def tables():
    """tests/test_aux_components.py's viewer table: 32 Gaussians, capacity 48,
    SH degree 1; the JAX table and the port's copy of it."""
    rng = np.random.default_rng(0)
    jt = init_table_from_pcd((rng.random((32, 3)) * 2 - 1).astype(np.float32),
                             rng.random((32, 3)).astype(np.float32), 48, max_sh_degree=1)
    fields = {k: np.asarray(getattr(jt, k)) for k in
              ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
               "objects_dc", "active")}
    fields.update(active_sh_degree=int(jt.active_sh_degree), max_sh_degree=1)
    return jt, table_from_jax_arrays(fields, device="cpu")


def _jax_frame(jt, msg) -> np.ndarray:
    """The JAX viewer's frame of ``msg``: render(backend="xla") of the camera
    its receive() builds, clipped, ×255, truncated, HWC."""
    a, b = socket.socketpair()
    with a, b:
        b.settimeout(TIMEOUT)
        gui = JV.NetworkGUI()
        gui.conn = b
        a.sendall(_wire(msg))
        cam, _, _, scale = gui.receive()
    out = jax_render(jt, cam.to_camera(), jnp.zeros((3,)), scaling_modifier=scale)
    img = (np.clip(np.asarray(out["render"]), 0, 1) * 255).astype(np.uint8)
    return img.transpose(1, 2, 0)


class _Client:
    """A viewer client thread: connects, then runs ``script(sock, frames)``
    where ``frames`` collects what it read."""

    def __init__(self, port: int, script):
        self.frames, self.error = [], None
        self._script, self._port = script, port
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            with socket.create_connection(("127.0.0.1", self._port), timeout=TIMEOUT) as s:
                self._script(s, self.frames)
        except Exception as e:          # reported by join()
            self.error = e

    def join(self):
        self.thread.join(timeout=TIMEOUT)
        assert not self.thread.is_alive(), "the viewer client hung"
        if self.error is not None:
            raise self.error


def _recv_exact(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        assert chunk, "the server closed the connection"
        buf += chunk
    return buf


def _read_reply(s, n_image):
    """(image bytes or b"", verify string) of one reply."""
    img = _recv_exact(s, n_image) if n_image else b""
    n = int.from_bytes(_recv_exact(s, 4), "little")
    return img, _recv_exact(s, n).decode("ascii")


def _serve(script, poll, port=0):
    """A port NetworkGUI on a free port, a client running ``script``, and
    ``poll(gui)`` once the client is connected. Returns (poll's result, the
    client's frames, the gui)."""
    gui = PV.NetworkGUI()
    gui.init("127.0.0.1", port)
    try:
        client = _Client(gui.listener.getsockname()[1], script)
        deadline = time.monotonic() + TIMEOUT
        while not gui.try_connect():
            assert time.monotonic() < deadline, "no client connected"
            time.sleep(0.01)
        with contextlib.redirect_stdout(io.StringIO()):
            result = poll(gui)
        client.join()
        return result, client.frames, gui
    finally:
        gui.close()


def test_camera_matches_jax():
    rng = np.random.default_rng(1)
    wvt = rng.normal(size=(4, 4)).astype(np.float32)
    kw = dict(width=40, height=30, fov_y=0.7, fov_x=0.9, znear=0.01, zfar=50.0)
    jc = JV.ViewerCamera(world_view_transform=wvt, **kw).to_camera()
    pc = PV.ViewerCamera(world_view_transform=wvt, **kw).to_camera("cpu")
    assert (pc.width, pc.height) == (jc.width, jc.height)
    for name in ("R", "T", "fov_x", "fov_y"):
        np.testing.assert_allclose(getattr(pc, name).numpy(), np.asarray(getattr(jc, name)),
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(pc.world_view_transform().numpy(),
                               np.asarray(jc.world_view_transform()), atol=1e-6)
    np.testing.assert_allclose(pc.intrinsics().numpy(), np.asarray(jc.intrinsics()),
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["camera", "paused", "no_camera"])
def test_receive_matches_jax(kind):
    msg = {"camera": _message(_view_matrix(), keep_alive=True, scale=0.5),
           "paused": _message(_view_matrix(-0.2), train=False),
           "no_camera": _message(np.eye(4), width=0)}[kind]
    got = {}
    for name, gui in (("jax", JV.NetworkGUI()), ("port", PV.NetworkGUI())):
        a, b = socket.socketpair()
        with a, b:
            b.settimeout(TIMEOUT)
            gui.conn = b
            a.sendall(_wire(msg))
            got[name] = gui.receive()
    (jcam, *jflags), (pcam, *pflags) = got["jax"], got["port"]
    assert pflags == jflags
    if kind == "no_camera":
        assert jcam is None and pcam is None
        return
    for f in ("width", "height", "fov_y", "fov_x", "znear", "zfar"):
        assert getattr(pcam, f) == getattr(jcam, f), f
    np.testing.assert_array_equal(pcam.world_view_transform, jcam.world_view_transform)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_frame_over_the_socket_matches_jax_render(tables, scale):
    jt, pt = tables
    msg = _message(_view_matrix(), scale=scale)

    def client(s, frames):
        s.sendall(_wire(msg))
        frames.append(_read_reply(s, W * H * 3))

    do_training, frames, _ = _serve(client, lambda g: g.poll_and_render(pt, True, "srcpath"))
    assert do_training is True
    (img, verify), = frames
    assert verify == "srcpath" and len(img) == W * H * 3
    got = np.frombuffer(img, np.uint8).reshape(H, W, 3).astype(int)
    ref = _jax_frame(jt, msg).astype(int)
    assert ref.max() > 0, "the camera sees nothing"
    assert np.abs(got - ref).max() <= 1


def test_frame_bytes_truncate_as_numpy():
    rng = np.random.default_rng(2)
    img = rng.uniform(-0.2, 1.2, (3, 5, 7)).astype(np.float32)
    img[0, 0, :4] = [0.0, 1.0, 254.9999 / 255, 1.0 / 255]
    want = (np.clip(img, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0).tobytes()
    assert PV.frame_bytes(torch.from_numpy(img)) == want


def test_pause_then_resume(tables):
    _, pt = tables

    def client(s, frames):
        s.sendall(_wire(_message(_view_matrix(), train=False)))
        frames.append(_read_reply(s, W * H * 3))
        s.sendall(_wire(_message(_view_matrix(), width=0)))      # paused, no camera
        frames.append(_read_reply(s, 0))
        s.sendall(_wire(_message(_view_matrix(0.1), train=True, keep_alive=False)))
        frames.append(_read_reply(s, W * H * 3))

    do_training, frames, _ = _serve(client, lambda g: g.poll_and_render(pt, True, "p"))
    assert do_training is True
    assert [len(f[0]) for f in frames] == [W * H * 3, 0, W * H * 3]
    assert [f[1] for f in frames] == ["p"] * 3


def test_paused_client_holds_the_poll(tables):
    """A client that pauses (train false) and keeps the connection alive keeps
    the poll serving: it returns only after the client resumes."""
    _, pt = tables
    served = []

    def client(s, frames):
        for _ in range(3):
            s.sendall(_wire(_message(_view_matrix(), train=False, keep_alive=True)))
            frames.append(_read_reply(s, W * H * 3))
        s.sendall(_wire(_message(_view_matrix(), train=True, keep_alive=True)))
        frames.append(_read_reply(s, W * H * 3))
        s.sendall(_wire(_message(_view_matrix(), width=0)))
        frames.append(_read_reply(s, 0))

    def poll(gui):
        served.append(gui.poll_and_render(pt, True, "p"))
        return served[-1]

    do_training, frames, _ = _serve(client, poll)
    # keep_alive with train true serves until a message without a camera
    assert do_training is True and len(frames) == 5 and len(served) == 1


def test_split_length_prefix(tables):
    """The port reads exactly 4 length bytes, however they arrive. JAX's one
    recv(4) may return fewer on a slow link and then misreads the message."""
    _, pt = tables
    wire = _wire(_message(_view_matrix()))

    def client(s, frames):
        s.sendall(wire[:2])
        time.sleep(0.2)
        s.sendall(wire[2:])
        frames.append(_read_reply(s, W * H * 3))

    _, frames, _ = _serve(client, lambda g: g.poll_and_render(pt, True, "split"))
    assert frames[0][1] == "split" and len(frames[0][0]) == W * H * 3

    class Pieces:
        """A connection whose recv returns the message in the given pieces."""

        def __init__(self, pieces):
            self.pieces = list(pieces)

        def recv(self, n):
            head = self.pieces.pop(0)
            if len(head) > n:
                self.pieces.insert(0, head[n:])
            return head[:n]

    pieces = [wire[:2], wire[2:]]
    port = PV.NetworkGUI()
    port.conn = Pieces(pieces)
    assert port._read()["resolution_x"] == W
    jax_gui = JV.NetworkGUI()
    jax_gui.conn = Pieces(pieces)
    with pytest.raises(json.JSONDecodeError):
        jax_gui._read()


def test_a_render_failure_raises(tables, monkeypatch):
    _, pt = tables

    def broken(*args, **kwargs):
        raise RuntimeError("device fault")

    monkeypatch.setattr(PV, "render", broken)

    def client(s, frames):
        s.sendall(_wire(_message(_view_matrix())))
        s.settimeout(TIMEOUT)
        frames.append(s.recv(1))        # b"": the server gave up

    def poll(gui):
        with pytest.raises(RuntimeError, match="device fault"):
            gui.poll_and_render(pt, True, "p")
        gui.close()
        return True

    _serve(client, poll)


@pytest.mark.parametrize("how", ["closed_mid_message", "bad_json", "missing_field"])
def test_a_dropped_client_ends_only_the_connection(tables, how):
    _, pt = tables
    wire = {"closed_mid_message": _wire(_message(_view_matrix()))[:20],
            "bad_json": (5).to_bytes(4, "little") + b"{oops",
            "missing_field": _wire({"resolution_x": W})}[how]

    def client(s, frames):
        s.sendall(wire)
        if how == "closed_mid_message":
            return
        s.settimeout(TIMEOUT)
        frames.append(s.recv(1))        # b"": the server closed it

    def poll(gui):
        out = gui.poll_and_render(pt, True, "p")
        assert gui.conn is None
        # the next client is served
        def next_client(s, frames):
            s.sendall(_wire(_message(_view_matrix())))
            frames.append(_read_reply(s, W * H * 3))
        c = _Client(gui.listener.getsockname()[1], next_client)
        deadline = time.monotonic() + TIMEOUT
        while not gui.try_connect():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        gui.poll_and_render(pt, True, "next")
        c.join()
        assert c.frames[0][1] == "next"
        return out

    do_training, _, _ = _serve(client, poll)
    assert do_training is True


OPT = OptimizationConfig(iterations=3, num_classes=16)
RUN = TrainRunConfig(iterations=3, test_iterations=(), save_iterations=(),
                     checkpoint_iterations=(), num_classes=16, log_every=1,
                     raster_max_tiles_per_axis=4, raster_max_per_tile=128)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_blender_scene(tmp_path_factory.mktemp("viewer_scene"))


def test_train_polls_once_an_iteration_and_closes(scene, tmp_path):
    class Recorder:
        def __init__(self):
            self.polls, self.closed = [], False

        def poll_and_render(self, table, do_training, source_path, bg=None):
            self.polls.append((do_training, source_path, float(bg.sum())))
            return do_training

        def close(self):
            self.closed = True

    gui = Recorder()
    state = train(scene, str(tmp_path / "m"), opt=OPT, run=RUN, capacity=128, gui=gui,
                  device="cpu")
    assert state.step == 3
    assert gui.polls == [(True, scene, 0.0)] * 3 and gui.closed


def test_train_serves_a_real_client(scene, tmp_path, tables):
    """The real NetworkGUI polled by train: one frame served before the first
    step, then training goes on; train closes the listener."""
    gui = PV.NetworkGUI()
    gui.init("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]

    def client(s, frames):
        s.sendall(_wire(_message(_view_matrix())))
        frames.append(_read_reply(s, W * H * 3))

    c = _Client(port, client)
    time.sleep(0.2)                     # the connection waits in the backlog
    with contextlib.redirect_stdout(io.StringIO()):
        state = train(scene, str(tmp_path / "m"), opt=OPT, run=RUN, capacity=128, gui=gui,
                      device="cpu")
    c.join()
    assert state.step == 3 and c.frames[0][1] == scene
    assert gui.listener is None and gui.conn is None


def test_cli_warns_on_a_busy_port_and_trains(scene, tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "stdout", sys.stdout)   # the CLI timestamps stdout
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen()
        port = busy.getsockname()[1]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            state = cli_main(["-s", scene, "-m", str(tmp_path / "cli"), "--iterations", "1",
                              "--capacity", "128", "--num_classes", "16", "--port", str(port),
                              "--test_iterations", "1", "--device", "cpu"])
    assert "[WARN] viewer port unavailable" in out.getvalue()
    assert "GUI disabled" in out.getvalue() and state.step == 1
