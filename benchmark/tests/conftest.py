"""Fixtures of the benchmark's own tests: a copy of the benchmark at a size
the CPU holds. Run them from the root of the repository:

    python -m pytest benchmark/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# each configuration and mix at a size the CPU holds; widths as the cell's
TINY_CONFIGS = {
    "officescene-semantic32": {"gaussians": 3000},
    "officescene-unifiedlift": {"points": 2000, "capacity": 2048, "width": 64, "height": 48,
                                "contrast_samples": 512, "gt_views": 2},
}
TINY_MIXES = {
    "view": {"traced_iterations": 3, "keep_every": 2, "check_frames": 2, "warmup": 2,
             "frame": {"width": 64, "height": 48, "fov_x": 1.2, "fov_y": 0.75}},
    "train": {"traced_iterations": 2, "warmup": 1, "probe_within": 2},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; the test skips itself "
                                       "without one")


def tiny_copy(dest: Path) -> Path:
    """BENCHMARK.json and benchmark/ copied to ``dest``, every configuration
    and mix cut to ``TINY_CONFIGS``/``TINY_MIXES``. Returns ``dest``."""
    shutil.copy(REPO / "BENCHMARK.json", dest)
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for sub, cuts in (("configs", TINY_CONFIGS), ("traffic", TINY_MIXES)):
        for name, cut in cuts.items():
            p = dest / "benchmark" / sub / f"{name}.json"
            d = json.loads(p.read_text())
            d.update(cut)
            p.write_text(json.dumps(d))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    import torch

    torch.set_num_threads(2)
    return tiny_copy(tmp_path_factory.mktemp("bench"))
