"""Every pre-port program at the repo's root or under scripts/ that imports
the JAX package has a twin in segsplat_tpu_torch/ of its file name (the root
train.py: train/cli.py, since a train.py module beside the train/ package
could not be imported; __graft_entry__.py: graft_entry.py, a module name
without dunders) or an entry in ``NOT_PORTED`` with its reason.
chip_smoke.py is the port's own and imports no JAX package."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "segsplat_tpu_torch"

# the pre-port programs with no twin, each with its reason (ROADMAP, "Not
# ported, on purpose")
NOT_PORTED = {
    ".verify_drive.py": "the JAX package's drive script for its TPU verify recipe; the port "
                        "is driven end to end by chip_smoke.py",
}
TWIN_OF = {"train.py": "train/cli.py", "__graft_entry__.py": "graft_entry.py"}
PORT_OWN = {"chip_smoke.py"}


def _imports_jax_package(path: Path) -> bool:
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == "segsplat_tpu" for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if node.module.split(".")[0] == "segsplat_tpu":
                return True
    return False


def _pre_port_programs() -> list:
    files = sorted(ROOT.glob("*.py")) + sorted((ROOT / "scripts").glob("*.py"))
    return [f.relative_to(ROOT).as_posix() for f in files
            if f.name not in PORT_OWN and _imports_jax_package(f)]


def test_every_pre_port_program_has_a_twin_or_a_reason():
    programs = _pre_port_programs()
    assert len(programs) > 30
    missing, twinned_anyway = [], []
    for rel in programs:
        twin = PORT / TWIN_OF.get(rel, Path(rel).name)
        if rel in NOT_PORTED:
            if twin.exists():
                twinned_anyway.append(rel)
        elif not twin.exists():
            missing.append(rel)
    assert not missing, f"pre-port programs with neither a twin nor a NOT_PORTED reason: {missing}"
    assert not twinned_anyway, f"NOT_PORTED entries that have a twin: {twinned_anyway}"


def test_not_ported_entries_are_live_and_reasoned():
    programs = set(_pre_port_programs())
    stale = sorted(set(NOT_PORTED) - programs)
    assert not stale, f"NOT_PORTED entries gone or importing no JAX package: {stale}"
    assert all(len(reason.split()) >= 5 for reason in NOT_PORTED.values())


def test_the_measurement_programs_count_as_twinned():
    for rel in ("bench.py", "scripts/perf_raster_stages.py", "scripts/perf_bin_dissect.py",
                "scripts/perf_lift_stages.py", "scripts/perf_train.py"):
        assert rel in _pre_port_programs() and rel not in NOT_PORTED
        assert (PORT / Path(rel).name).exists(), rel


def test_the_harness_programs_count_as_twinned():
    for rel in ("__graft_entry__.py", "scripts/perf_guard.py", "scripts/parity_real.py"):
        assert rel in _pre_port_programs() and rel not in NOT_PORTED
        assert (PORT / TWIN_OF.get(rel, Path(rel).name)).exists(), rel
