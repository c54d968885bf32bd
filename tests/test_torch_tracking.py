"""The tracker of the port (segsplat_tpu_torch/pipeline/tracking.py, a numpy
copy whose matching runs on the host Jonker–Volgenant) against the JAX
package's (segsplat_tpu/pipeline/tracking.py, its on-device Hungarian), on
tests/test_tracking.py's sequences and on SLIC maps of the pseudo-label loop's
sweep: the id maps must be identical, as must the ``track`` CLI twin's files."""

import functools
import os
import sys

import numpy as np
import pytest
from PIL import Image

from segsplat_tpu.pipeline import tracking as JT
from segsplat_tpu_torch.pipeline import tracking as TT
from test_tracking import _make_sequence, _square
from _torch_port import torch_threads


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker (see _torch_port.torch_threads)."""
    with torch_threads(1):
        yield


def _fast_mover():
    frames = []
    for t in range(6):
        f = np.zeros((64, 64), np.int32)
        _square(f, 2 + 9 * t, 10, 6, 1)
        frames.append(f)
    return frames, None


def _swap():
    imgs, frames = [], []
    for t in range(4):
        f = np.zeros((32, 48), np.int32)
        img = np.zeros((32, 48, 3), np.float32)
        xa, xb = (4, 30) if t < 2 else (30, 4)
        _square(f, xa, 8, 8, 1)
        _square(f, xb, 8, 8, 2)
        img[8:16, xa:xa + 8] = (1.0, 0.1, 0.1)
        img[8:16, xb:xb + 8] = (0.1, 0.1, 1.0)
        frames.append(f)
        imgs.append(img)
    return frames, imgs


def _budget():
    f0 = np.zeros((32, 64), np.int32)
    _square(f0, 2, 2, 6, 1)
    _square(f0, 20, 2, 6, 2)
    f1 = np.zeros((32, 64), np.int32)
    _square(f1, 2, 2, 6, 1)
    _square(f1, 40, 20, 6, 2)
    return [f0, f1], None


def _new_object():
    frames = _make_sequence()
    extra = frames[-1].copy()
    _square(extra, 36, 2, 8, 2)
    return frames + [extra], None


def _sweep_segments():
    """SLIC + merge maps of 8 frames of the pseudo-label loop's default scene
    at 96² (the loop's settings), with the frames: dozens of regions a frame.
    Copies of one computation per worker."""
    segs, imgs = _sweep_segments_once()
    return [m.copy() for m in segs], [im.copy() for im in imgs]


@functools.lru_cache(maxsize=1)
def _sweep_segments_once():
    from segsplat_tpu_torch import pseudo_label_loop as L
    from segsplat_tpu_torch.pipeline.segment import SegmentConfig, segment_image

    g = L.build_objects(np.random.default_rng(0))
    Rs, ts, fx, fy = L.orbit_cameras(8, 96, 96)
    rgbs, _ = L.render_sweep(g, Rs, ts, fx, fy, 96, 96, device="cpu")
    imgs = [(r * 255).astype(np.uint8) for r in rgbs]
    cfg = SegmentConfig(n_segments=64, compactness=12.0, merge_thresh=0.15, min_pixels=40)
    return [segment_image(im, cfg, device="cpu") for im in imgs], imgs


CASES = {
    "scrambled": (lambda: (_make_sequence(), None), dict(min_pixels=4)),
    "occluded": (lambda: (_make_sequence(occlude_frame=3), None),
                 dict(min_pixels=4, memory_frames=5)),
    "new_object": (_new_object, dict(min_pixels=4)),
    "fast_mover_raw": (_fast_mover, dict(min_pixels=4, motion=False)),
    "fast_mover_motion": (_fast_mover, dict(min_pixels=4, motion=True, iou_threshold=0.2,
                                            centroid_fallback_frac=2.0)),
    "colour_gate": (_swap, dict(min_pixels=4, motion=False, memory_frames=5,
                                iou_threshold=0.05, color_gate=0.3,
                                centroid_fallback_frac=4.0)),
    "budget": (_budget, dict(min_pixels=4, max_ids=2)),
    "sweep": (_sweep_segments, dict(iou_threshold=0.4, memory_frames=8, min_pixels=40)),
    "sweep_gated": (_sweep_segments, dict(iou_threshold=0.3, memory_frames=8, min_pixels=40,
                                          color_gate=0.25, centroid_fallback_frac=1.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_associate_sequence_gives_identical_id_maps(case):
    make, kw = CASES[case]
    frames, images = make()
    want = JT.associate_sequence(frames, JT.TrackerConfig(**kw), images=images)
    got = TT.associate_sequence(frames, TT.TrackerConfig(**kw), images=images)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert any(w.any() for w in want)


def _split_object():
    frames, images = [], []
    for t in range(6):
        m = np.zeros((48, 48), np.int32)
        img = np.zeros((48, 48, 3), np.float32)
        x = 2 + 2 * t
        _square(m, x, 4, 6, 1)
        _square(m, x + 6, 4, 6, 2)
        img[4:10, x:x + 12] = (0.9, 0.1, 0.1)
        _square(m, x, 20, 8, 3)
        img[20:28, x:x + 8] = (0.1, 0.2, 0.9)
        _square(m, 6, 38, 8, 4)
        img[38:46, 6:14] = (0.9, 0.1, 0.1)
        frames.append(m)
        images.append(img)
    return frames, images


@pytest.mark.parametrize("with_images", (True, False))
@pytest.mark.parametrize("case", ("split_object", "sweep"))
def test_consolidate_tracks_gives_identical_id_maps(case, with_images):
    if case == "split_object":
        frames, images = _split_object()
        kw = dict(min_cooccur=3, adjacency_frac=0.5, boundary_min=4, color_thresh=0.15)
    else:
        segs, images = _sweep_segments()
        frames = JT.associate_sequence(segs, JT.TrackerConfig(min_pixels=40))
        images = [im.astype(np.float32) / 255.0 for im in images]
        kw = dict(adjacency_frac=0.5, color_thresh=0.10)
    images = images if with_images else None
    want = JT.consolidate_tracks(frames, images, JT.ConsolidateConfig(**kw))
    got = TT.consolidate_tracks(frames, images, TT.ConsolidateConfig(**kw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_track_cli_writes_the_same_files(tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    import prepare_pseudo_label as jax_cli

    from segsplat_tpu_torch import prepare_pseudo_label as cli

    segs, imgs = _sweep_segments()
    seg_dir, img_dir = tmp_path / "seg", tmp_path / "images"
    seg_dir.mkdir()
    img_dir.mkdir()
    for i, (s, im) in enumerate(zip(segs, imgs)):
        Image.fromarray(s.astype(np.uint8)).save(seg_dir / f"frame_{i:03d}.png")
        Image.fromarray(im).save(img_dir / f"frame_{i:03d}.png")
    args = ["track", "--masks", str(seg_dir), "--iou_threshold", "0.4", "--memory_frames",
            "8", "--min_pixels", "40", "--color_gate", "0.25", "--gate_images", str(img_dir),
            "--consolidate_images", str(img_dir)]
    jax_cli.main([*args, "--out", str(tmp_path / "jax")])
    cli.main([*args, "--out", str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 8
    for f in names:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes()


def test_convert_cli_writes_the_same_files(tmp_path):
    """``convert``: colour instance masks (DEVA's colour output) to gray ids,
    stable across the sequence."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    import prepare_pseudo_label as jax_cli

    from segsplat_tpu_torch import prepare_pseudo_label as cli

    rng = np.random.default_rng(2)
    palette = rng.integers(0, 256, (9, 3), dtype=np.uint8)
    palette[0] = 0
    masks = tmp_path / "colour"
    masks.mkdir()
    for i in range(4):
        ids = rng.integers(0, 9, (6, 8))
        ids[:, :2] = i % 9                       # a colour that comes and goes
        Image.fromarray(palette[np.kron(ids, np.ones((4, 4), int))]).save(masks / f"m{i}.png")
    n = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        main(["convert", "--masks", str(masks), "--out", str(tmp_path / name)])
        n[name] = sorted(os.listdir(tmp_path / name))
    assert n["jax"] == n["port"] and len(n["port"]) == 4
    for f in n["port"]:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes()
