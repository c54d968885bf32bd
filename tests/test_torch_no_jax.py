"""The port imports neither JAX nor anything of the JAX package, its scripts or
its tests: an AST scan of its sources, chip_smoke.py and the kernels' bench
scripts, and an import of every port module in a process where JAX,
segsplat_tpu, scripts and tests cannot be imported."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "segsplat_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "segsplat_tpu", "scripts", "tests"}


def _top_level_imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
        ROOT / "scripts" / f
        for f in ("bench_k1.py", "bench_k2.py", "k1_variants.py", "k2_variants.py")]
    assert len(files) > 10
    # exact top-level names: segsplat_tpu_torch itself shares the prefix
    bad = [f"{f.relative_to(ROOT)}:{line} imports {name}"
           for f in files for line, name in _top_level_imports(f) if name in FORBIDDEN]
    assert not bad, bad


_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
blocked = {blocked!r}
for name in list(sys.modules):          # this image may preload jax
    if name.split(".")[0] in blocked:
        sys.modules[name] = None
for name in blocked:
    sys.modules[name] = None
import segsplat_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(segsplat_tpu_torch.__path__,
                                              "segsplat_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
importlib.import_module("chip_smoke")
print(" ".join(mods))
"""

# modules of the editing slice, named so that losing one fails here
EDIT_SLICE = ("train.editing", "ops.inpaint", "ops.inpaint_patch", "eval.lpips",
              "utils.profiling", "edit_object_removal", "edit_object_inpaint",
              "inpaint_images", "eval_inpaint_lpips", "eval_hard_scene_offline",
              "eval_hard_scene_checkpoint", "tune_class_merge", "tune_tracker")


# the multi-device modules, which must import no JAX either
PARALLEL_SLICE = ("parallel", "parallel.mesh", "parallel.multihost", "parallel.lift",
                  "parallel.render", "parallel.train")


# the viewer, the host-script twins and check_env, named so that losing one
# fails here
TOOLS_SLICE = ("viewer", "check_env", "prepare_tensor_data", "project_features",
               "build_sparse_occupancy", "aggregate_voxel_colors_onthefly",
               "voxeltovoxel_logits", "extract_gaussian_centers", "logit_confidence_map",
               "analyze_gaussian_semantics", "minkowski_voxel_grid",
               "minkowski_voxel_grid_from_ply", "minkowski_voxel_grid_density_filtered",
               "minkowski_mesh_voxel_grid", "detect_surface", "export_gaussians",
               "export_gaussian_ellipsoids", "gaussian_color_stats", "scale_sparsity_filter",
               "dist_to_mesh_filter", "debug_tools", "visualize_lseg_features")


def test_port_modules_import_with_jax_blocked():
    code = _BLOCKED_IMPORT.format(blocked=sorted(FORBIDDEN))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    mods = set(r.stdout.strip().splitlines()[-1].split())
    assert len(mods) >= 15
    missing = [m for m in EDIT_SLICE + PARALLEL_SLICE[1:] + TOOLS_SLICE
               if f"segsplat_tpu_torch.{m}" not in mods]
    assert not missing, missing
