"""The pseudo-label stage of the hard scene (results/hard_scene/
hard_slic_result.json's configuration: 20 objects, random packed layout,
textured, 30 frames at 256², 160 SLIC segments, tracker defaults) through the
port's twins and through the JAX scripts, each on its own GT sweep (the port's
dense backend, the JAX "xla"): the same id maps, and so the same tracker
consistency and track count (``pytest -s`` prints them)."""

import os
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from scripts import prepare_pseudo_label as jax_cli  # noqa: E402
from scripts import pseudo_label_loop as J  # noqa: E402

from segsplat_tpu_torch import prepare_pseudo_label as cli  # noqa: E402
from segsplat_tpu_torch import pseudo_label_loop as L  # noqa: E402
from _torch_port import torch_threads  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker (see _torch_port.torch_threads)."""
    with torch_threads(1):
        yield


HARD = dict(n_objects=20, layout="random", textured=True)


def _labels(root, loop, segment_images, track_sequence, **device):
    g = loop.build_objects(np.random.default_rng(0), **HARD)
    Rs, ts, fx, fy = loop.orbit_cameras(30, 256, 256)
    rgbs, gts = loop.render_sweep(g, Rs, ts, fx, fy, 256, 256, max_per_tile=512, **device)
    loop.write_colmap_scene(root, g, Rs, ts, fx, fy, rgbs)
    images = os.path.join(root, "images")
    segment_images(images, os.path.join(root, "seg"), n_segments=160, compactness=12.0,
                   merge_thresh=0.15, min_pixels=40, **device)
    track_sequence(os.path.join(root, "seg"), os.path.join(root, "mask"), iou_threshold=0.4,
                   memory_frames=8, min_pixels=40, gate_images=images)
    masks = sorted(os.listdir(os.path.join(root, "mask")))
    return [np.asarray(Image.open(os.path.join(root, "mask", f))) for f in masks], gts


def test_hard_scene_pseudo_labels_match_jax(tmp_path):
    want, want_gts = _labels(str(tmp_path / "jax"), J, jax_cli.segment_images,
                             jax_cli.track_sequence)
    got, gts = _labels(str(tmp_path / "port"), L, cli.segment_images, cli.track_sequence,
                       device="cpu")
    np.testing.assert_array_equal(gts, want_gts)
    assert len(got) == len(want) == 30
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    consistency, n_tracks = L.tracker_consistency(got, gts)
    assert (consistency, n_tracks) == J.tracker_consistency(want, want_gts)
    print(f"hard scene: tracker consistency {consistency:.4f}, {n_tracks} tracks")
    assert consistency > 0.75 and 5 <= n_tracks <= 255
