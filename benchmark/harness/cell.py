"""A cell of ``BENCHMARK.json`` and the files it names, found by name:

  * ``configs/<config>.json`` (the entry's ``file``): sizes, widths, the
    scene's draw, ``source``, ``assumed``, ``reduced``;
  * ``traffic/<traffic>.json``: the mix's parameters, the loop that drives it
    (``loop``: ``loops/<loop>.py``) and the limits of its correctness check;
  * ``metrics/<metric>.py``: one reader a metric, ``read(ctx) → float | None``;
  * ``scenes/<scene>.py``: a seeded draw, ``draw(config, seed, device)``.

Nothing here knows a cell, configuration, mix or metric by name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path) -> ModuleType:
    """A Python file of the benchmark as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = "benchmark_part_" + re.sub(r"\W", "_", f"{path.parent.name}_{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path = BENCH_DIR

    def loop_module(self) -> ModuleType:
        return load_module(self.bench_dir / "loops" / f"{self.traffic['loop']}.py")

    def scene_module(self) -> ModuleType:
        return load_module(self.bench_dir / "scenes" / f"{self.config['scene']}.py")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.bench_dir / "metrics" / f"{metric}.py")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its configuration
    and traffic files read and the metrics it reports."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    bench_dir = root / "benchmark"
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, workload)],
                bench_dir=bench_dir)
