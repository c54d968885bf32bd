"""The lift cell's own files: the configuration loads through the harness,
the plain reference of the lift (``reference/lift.py``) loads nothing of the
program or of JAX, the scene's geometry is the configuration's for every
``--seed`` and its maps repeat by seed, and the reference's march finds a
cube's first sample."""

import subprocess
import sys

import numpy as np
import torch

from benchmark.harness.cell import load_cell
from benchmark.reference import lift as reference
from benchmark.tests.conftest import REPO

CELL = "lift-officescene"


def test_the_configuration_loads_through_the_harness():
    c = load_cell(CELL)
    assert c.traffic["loop"] == "lift" and c.chips == 1
    cfg = c.config
    assert (cfg["scene"], cfg["points"], cfg["channels"], cfg["width"], cfg["height"],
            cfg["map_h"], cfg["map_w"], cfg["cell_size"], cfg["max_tiles_per_axis"],
            cfg["precision"], cfg["reduced"]) == ("room_lift", 200_000, 512, 876, 584, 360,
                                                  540, 0.04, 8, "float32", [])
    assert {m["name"] for m in c.per_layer} == {
        "lift_upload_ms.lift", "lift_host_ms.lift", "lift_device_ms.lift",
        "device_idle_pct.lift", "lift_mfu.lift", "lift_overflow.lift"}
    assert {m["name"] for m in c.end_to_end} == {"frames_per_s", "setup_s"}


def test_the_reference_of_the_lift_is_plain():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.lift\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('segsplat_tpu_torch', 'segsplat_tpu', 'jax', 'jaxlib', 'flax')]\n"
            "print(bad)\n" % str(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_the_geometry_is_the_configurations_and_the_maps_repeat_by_seed():
    c = load_cell(CELL)
    scene = c.scene_module()
    cells, origin, centers = scene.voxels(c.config)
    assert len(cells) == c.config["voxels"] and len(np.unique(cells, axis=0)) == len(cells)
    np.testing.assert_allclose(centers, cells * c.config["cell_size"] + origin, atol=1e-6)
    c2w, intr = scene.cameras(c.config)
    assert c2w.shape == (216, 4, 4) and intr.tolist() == [700.0, 700.0, 438.0, 292.0]
    small = dict(c.config, channels=4, map_h=6, map_w=9, maps=3, points=2000)
    a, b, other = (scene.draw(small, s, "cpu") for s in (2 ** 31 + 7, 2 ** 31 + 7, 8))
    assert np.array_equal(a["cells"], other["cells"]) and len(a["maps"]) == 3
    for x, y, z in zip(a["maps"], b["maps"], other["maps"]):
        assert x.dtype == np.float16 and x.shape == (4, 6, 9)
        assert np.array_equal(x, y) and not np.array_equal(x, z)


def test_the_march_takes_the_first_sample_in_an_occupied_cell():
    """One ray down the z axis of a row of cells 0.1 m wide: it hits the
    first occupied cell whose span [c - 0.05, c + 0.05) holds a sample of
    t = 0.01 + k·0.05, and the lift adds the pixel there."""
    cells = torch.tensor([[0, 0, 3], [0, 0, 7]])
    occ = reference.occupancy(cells)
    c2w = torch.eye(4)
    hits = reference.march(occ, torch.zeros(3), 0.1, c2w, [1.0, 1.0, 0.0, 0.0], 1, 1, 0.01,
                           10.0, 0.05)
    assert hits.tolist() == [1]
    hits = reference.march(occ, torch.zeros(3), 0.1, c2w, [1.0, 1.0, 0.0, 0.0], 1, 1, 0.01,
                           0.2, 0.05)
    assert hits.tolist() == [0]
    sums, counts = reference.lift_view(torch.full((2, 1, 1), 3.0), torch.tensor([1]), 3)
    assert sums.tolist() == [[0.0, 0.0], [3.0, 3.0], [0.0, 0.0]] and counts.tolist() == [0, 1, 0]
    assert reference.view_ops(10, 512) == 5120
    assert reference.view_bytes(512, 360, 540, 2) == 512 * 360 * 540 * 2 + 2 * 2052 * 2
