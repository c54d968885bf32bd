"""The JAX package's public surface against the port's, on the CPU: the names
ported last (transforms, SH colour, constants, l2_loss, the JSON config
overlay, the label colouring, the package re-exports) against their JAX
counterparts; the opt-in wandb hook through a stub module; and a name-by-name
AST comparison of the two packages that fails when a public JAX name has no
twin, but for the listed exclusions."""

import ast
import dataclasses
import json
import sys
import types
from argparse import Namespace
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segsplat_tpu.core import sh as JS
from segsplat_tpu.core import transforms as JT
from segsplat_tpu.core import types as JTY
from segsplat_tpu.ops import lift_splat as JLS
from segsplat_tpu.train import losses as JL
from segsplat_tpu.utils import config as JC
from segsplat_tpu.utils import palette as JP
from segsplat_tpu_torch.core import sh as PS
from segsplat_tpu_torch.core import transforms as PT
from segsplat_tpu_torch.core import types as PTY
from segsplat_tpu_torch.ops import lift_splat as PLS
from segsplat_tpu_torch.pipeline.train import TrainRunConfig, train
from segsplat_tpu_torch.train import losses as PL
from segsplat_tpu_torch.train.trainer import OptimizationConfig
from segsplat_tpu_torch.utils import config as PC
from segsplat_tpu_torch.utils import palette as PP
from _torch_port import torch_threads, write_blender_scene

ROOT = Path(__file__).resolve().parents[1]

# public JAX names with no twin, each with its reason (ROADMAP, deliberate
# differences)
NO_TWIN = {
    # the port loads the public checkpoints' state dicts by name
    "models/clip_text.py": {"convert_torch_clip_text"},
    "models/lseg.py": {"convert_lseg_checkpoint"},
    # JAX pytree and jit helpers
    "train/trainer.py": {"table_params", "with_params", "cached_train_step"},
    # JAX NamedSharding helpers; the port shards with parallel/mesh's own
    "parallel/mesh.py": {"channel_sharding", "replicated", "view_sharding"},
    "parallel/__init__.py": {"channel_sharding", "replicated", "view_sharding"},
    # the host timers nothing read; the port times with its spans
    # (utils/profiling.annotate)
    "utils/profiling.py": {"StepTimer", "timed"},
}
# the Pallas modules, whose kernels the port has in csrc/ behind ops/blend.py
PALLAS_MODULES = {"ops/blend_pallas.py", "ops/blend_pallas2.py", "ops/blend_pallas_vjp.py"}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    with torch_threads(2):
        yield


def _public_names(path: Path, imports: bool) -> set:
    """Top-level def, class and assigned names not starting with "_"; with
    ``imports`` also the names the module imports."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")}


def test_every_public_jax_name_has_a_twin():
    jax_pkg, port_pkg = ROOT / "segsplat_tpu", ROOT / "segsplat_tpu_torch"
    missing, stale = [], []
    for path in sorted(jax_pkg.rglob("*.py")):
        rel = path.relative_to(jax_pkg).as_posix()
        if rel in PALLAS_MODULES:
            continue
        twin = port_pkg / rel
        if not twin.exists():
            missing.append(rel)
            continue
        # a package's __init__ exports what it imports
        want = _public_names(path, imports=path.name == "__init__.py")
        have = _public_names(twin, imports=True)
        missing += [f"{rel}:{n}" for n in sorted(want - have - NO_TWIN.get(rel, set()))]
        stale += [f"{rel}:{n}" for n in sorted(NO_TWIN.get(rel, set()) & have)]
        stale += [f"{rel}:{n}" for n in sorted(NO_TWIN.get(rel, set()) - want)]
    assert not missing, f"public JAX names without a twin: {missing}"
    assert not stale, f"exclusions that are ported or gone from JAX: {stale}"
    assert all((jax_pkg / m).exists() for m in PALLAS_MODULES)


def test_transforms_match_jax():
    rng = np.random.default_rng(0)        # tests/test_core.py's inputs
    s = np.exp(rng.normal(size=(16, 3)).astype(np.float32) * 0.3)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    for mod in (1.0, 0.7):
        ref = np.asarray(JT.build_covariance_3d(jnp.asarray(s), jnp.asarray(q), mod))
        got = PT.build_covariance_3d(torch.from_numpy(s), torch.from_numpy(q), mod).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)   # entries ~1
    np.testing.assert_allclose(
        PT.build_scaling_rotation(torch.from_numpy(s), torch.from_numpy(q)).numpy(),
        np.asarray(JT.build_scaling_rotation(jnp.asarray(s), jnp.asarray(q))),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(PT.strip_symmetric(torch.from_numpy(ref.copy())).numpy(),
                                  np.asarray(JT.strip_symmetric(jnp.asarray(ref))))
    for args in ((0.01, 100.0, 1.0, 0.8), (0.2, 5.0, 0.6, 1.3)):
        np.testing.assert_array_equal(PT.get_projection_matrix(*args),
                                      JT.get_projection_matrix(*args))


@pytest.mark.parametrize("degree", [0, 1, 3])
def test_sh_to_color_matches_jax(degree):
    rng = np.random.default_rng(degree)
    sh = rng.normal(size=(64, (degree + 1) ** 2, 3)).astype(np.float32)
    means = rng.normal(size=(64, 3)).astype(np.float32)
    campos = np.array([0.3, -0.2, -4.0], np.float32)
    ref = np.asarray(JS.sh_to_color(degree, jnp.asarray(sh), jnp.asarray(means),
                                    jnp.asarray(campos)))
    got = PS.sh_to_color(degree, *map(torch.from_numpy, (sh, means, campos))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert (got == 0).any() and (got > 0).any()     # the clamp is reached


def test_constants_and_l2_loss_match_jax():
    assert PTY.NUM_CODEBOOK == JTY.NUM_CODEBOOK
    assert PLS.TILE == JLS.TILE
    rng = np.random.default_rng(3)
    a, b = (rng.normal(size=(3, 20, 30)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(float(PL.l2_loss(torch.from_numpy(a), torch.from_numpy(b))),
                               float(JL.l2_loss(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


def test_load_json_config_and_colorize_labels_match_jax(tmp_path):
    cfg = tmp_path / "train.json"
    cfg.write_text(json.dumps({"iterations": 7, "lambda_dssim": 0.3, "eval": True}))
    base = dict(iterations=30_000, model_path="m", eval=False)
    assert (vars(PC.load_json_config(str(cfg), Namespace(**base)))
            == vars(JC.load_json_config(str(cfg), Namespace(**base))))
    labels = np.random.default_rng(4).integers(-2, 40, (7, 9))
    for n in (None, 12, 1):
        np.testing.assert_array_equal(PP.colorize_labels(labels, n),
                                      JP.colorize_labels(labels, n))


def test_package_reexports_match_jax():
    import segsplat_tpu.core as jcore
    import segsplat_tpu.io as jio
    import segsplat_tpu.utils as jutils
    import segsplat_tpu_torch.core as pcore
    import segsplat_tpu_torch.io as pio
    import segsplat_tpu_torch.utils as putils
    from segsplat_tpu_torch.io import ply

    for jpkg, ppkg in ((jcore, pcore), (jio, pio), (jutils, putils)):
        names = [n for n in vars(jpkg) if not n.startswith("_")
                 and not isinstance(getattr(jpkg, n), types.ModuleType)]
        assert names and all(hasattr(ppkg, n) for n in names), jpkg.__name__
    assert pcore.Camera is PTY.Camera and pcore.VoxelGrid is PTY.VoxelGrid
    assert all(getattr(pio, n) is getattr(ply, n) for n in pio.__all__)
    assert dataclasses.is_dataclass(pcore.GaussianTable)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_blender_scene(tmp_path_factory.mktemp("wandb_scene"))


class _WandbStub(types.ModuleType):
    """A stand-in for the wandb package: records init's arguments and every
    logged record."""

    def __init__(self):
        super().__init__("wandb")
        self.inits, self.logged = [], []

    def init(self, project=None, name=None):
        self.inits.append((project, name))
        stub = self

        class Run:
            def log(self, rec, step=None):
                stub.logged.append((step, dict(rec)))

        return Run()


def _train(scene, model, **run):
    return train(scene, model, opt=OptimizationConfig(iterations=3, num_classes=16),
                 run=TrainRunConfig(iterations=3, test_iterations=(3,), save_iterations=(),
                                    checkpoint_iterations=(), num_classes=16,
                                    raster_max_tiles_per_axis=4, raster_max_per_tile=128,
                                    **run),
                 capacity=128, device="cpu")


def test_wandb_hook_logs_the_metrics_records(scene, tmp_path, monkeypatch):
    stub = _WandbStub()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    monkeypatch.setenv("SEGSPLAT_WANDB", "1")
    monkeypatch.setenv("SEGSPLAT_WANDB_PROJECT", "proj")
    model = tmp_path / "run_a"
    _train(scene, str(model), log_every=1)
    assert stub.inits == [("proj", "run_a")]
    records = [json.loads(line) for line in open(model / "metrics.jsonl")]
    steps = [r for r in records if "total" in r]
    assert len(steps) == 3 and any("eval_psnr" in r for r in records)
    # each step record goes to wandb as written, at its iteration; eval
    # records stay in metrics.jsonl only, as in the JAX package
    assert stub.logged == [(r["iter"], r) for r in steps]


def test_wandb_hook_is_opt_in(scene, tmp_path, monkeypatch, capsys):
    stub = _WandbStub()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    monkeypatch.delenv("SEGSPLAT_WANDB", raising=False)
    _train(scene, str(tmp_path / "off"), log_every=1)
    assert stub.inits == [] and stub.logged == []
    # opted in without wandb installed: a warning, and metrics.jsonl only
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setenv("SEGSPLAT_WANDB", "1")
    _train(scene, str(tmp_path / "absent"), log_every=1)
    assert "[WARN] wandb unavailable" in capsys.readouterr().out
    assert (tmp_path / "absent" / "metrics.jsonl").exists()
