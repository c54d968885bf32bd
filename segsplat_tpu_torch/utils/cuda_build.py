"""Build the port's CUDA sources with nvcc into shared libraries with a plain C
interface, loaded with ctypes.

A source ``segsplat_tpu_torch/csrc/<name>.cu`` becomes
``build/kernels/<name>-<hash>.so`` at the root of the checkout, keyed by a hash of
the source, every header (``*.cuh``) beside it and the flags, at first use: an
edit to a shared header rebuilds every source. Nothing is built at import: only
a process that launches a kernel needs nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels are built on the machine with the card")
    return found


def source_key(src: Path, flags=NVCC_FLAGS) -> str:
    """Hash of a CUDA source, of every ``*.cuh`` in its directory (what its
    ``#include "..."`` lines can reach) and of the nvcc flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built, keyed by content."""
    return BUILD_DIR / f"{name}-{source_key(csrc / f'{name}.cu')}.so"


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless it is built already, and return the
    library's path. Writes the compiler log (registers, spills) beside it as
    ``.log``. Raises with the log when the compile fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out.with_suffix(".log").write_text(r.stdout)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{r.stdout}")
    os.replace(tmp, out)        # atomic: a reader never sees half a file
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build_library(name)))
    return _LOADED[name]
