"""The port imports neither JAX nor anything of the JAX package: an AST scan of
its sources, chip_smoke.py and the kernels' bench scripts, and an import of every port module in a
process where JAX and segsplat_tpu cannot be imported."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "segsplat_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "segsplat_tpu"}


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
print(len(mods))
"""


def test_port_modules_import_with_jax_blocked():
    code = _BLOCKED_IMPORT.format(blocked=sorted(FORBIDDEN))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip().splitlines()[-1]) >= 15
