"""The build key of the port's CUDA libraries (segsplat_tpu_torch/utils/cuda_build.py):
a library is reused only while its source, every header beside it and the nvcc
flags are unchanged. Needs no nvcc: ``library_path`` only hashes."""

import shutil

from segsplat_tpu_torch.utils import cuda_build


def _copy_csrc(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    return csrc


def test_key_changes_with_an_included_header(tmp_path):
    csrc = _copy_csrc(tmp_path)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "csrc holds no shared header"
    before = {n: cuda_build.library_path(n, csrc) for n in ("blend_fwd", "blend_packed")}
    assert before == {n: cuda_build.library_path(n) for n in before}   # same content
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {n: cuda_build.library_path(n, csrc) for n in before}
    assert all(after[n] != before[n] for n in before)


def test_key_changes_with_a_new_header_source_and_flags(tmp_path):
    csrc = _copy_csrc(tmp_path)
    src = csrc / "blend_bwd.cu"
    key = cuda_build.source_key(src)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    with_header = cuda_build.source_key(src)
    assert with_header != key
    src.write_text(src.read_text() + "\n")
    assert cuda_build.source_key(src) not in (key, with_header)
    flags = cuda_build.NVCC_FLAGS + ("-DSEGSPLAT_CLOCKS=1",)
    assert cuda_build.source_key(src, flags) != cuda_build.source_key(src)
