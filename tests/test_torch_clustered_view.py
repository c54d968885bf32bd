"""The view path on a clustered scene, against the benchmark's plain reference
(``benchmark/reference/raster.py``, which imports nothing of the program):
``render_semantics`` on CPU tensors (K1's plain version, and the dense
blend) at 128×96 on ~3 000 Gaussians in 4 clusters of Pareto-sized counts,
small enough K that tiles overflow it and splats wide enough that some
Gaussians pass the m×m tile rectangle. The logits and labels agree within the limits of the view
check (``benchmark/traffic/view.json``), and the rasterizer's span counts
(``pairs``, ``pairs_past_k``, ``rows``) equal the reference's binning."""

import numpy as np
import pytest
import torch

from _torch_port import torch_threads
from benchmark.reference import raster
from segsplat_tpu_torch.core.types import Camera, GaussianTable
from segsplat_tpu_torch.render import render_semantics
from segsplat_tpu_torch.utils import profiling

W, H, CH = 128, 96, 32
FOV_X, FOV_Y = 1.2, 0.75
# The view check's limits: a label whose reference logit lies below the
# reference's best counts as a mismatch. They sit below what a float32 blend
# in another summation order can move and far below the bfloat16 control's
# readings (gaps of 1.8e-2 to 2.3e-2), so the same numbers bound the logits.
MISMATCH_SHARE, GAP_MAX = 5e-4, 2e-3


def clustered_draw(n=3000, clusters=4, seed=11):
    """bench.py:105-132's clustered scene at a size the CPU holds: Pareto(1.2)
    cluster counts, N(0, 0.15 m) offsets, log N(-3.3, 0.9) scales (splats of
    ~7 px at the median and 31 px at p99 here), opacity U(0.02, 0.9)."""
    rng = np.random.default_rng(seed)
    centres = rng.random((clusters, 3)) * np.array([2.0, 1.4, 1.5]) + np.array([-1.0, -0.7, 2.5])
    w = rng.pareto(1.2, clusters) + 0.05
    counts = np.maximum((w / w.sum() * n).astype(int), 1)
    counts[0] += n - counts.sum()
    xyz = centres[np.repeat(np.arange(clusters), counts)] + rng.normal(0, 0.15, (n, 3))
    log_scales = rng.normal(-3.3, 0.9, (n, 3))
    quats = rng.normal(size=(n, 4))
    opac = rng.uniform(0.02, 0.9, n)
    logits = rng.standard_normal((n, CH))
    return [torch.as_tensor(a, dtype=torch.float32)
            for a in (xyz, log_scales, quats, opac, logits)]


@pytest.mark.parametrize("m,K,backend", [(6, 32, "cuda"), (3, 16, "cuda"), (6, 32, "dense")])
def test_clustered_view_matches_the_reference_and_counts_its_pairs(m, K, backend):
    xyz, log_scales, quats, opac, logits = clustered_draw()
    n = xyz.shape[0]
    z = torch.zeros((n, 1, 3))
    table = GaussianTable(xyz=xyz, features_dc=z, features_rest=z, scaling=log_scales,
                          rotation=quats, opacity=torch.log(opac / (1 - opac))[:, None],
                          objects_dc=torch.zeros((n, 1, 16)),
                          active=torch.ones(n, dtype=torch.bool), active_sh_degree=0)
    R, T = torch.eye(3), torch.zeros(3)
    cam = Camera(R=R, T=T, fov_x=torch.tensor(FOV_X), fov_y=torch.tensor(FOV_Y),
                 width=W, height=H)
    profiling.reset()
    profiling.enable()
    try:
        with torch_threads(2), torch.no_grad():
            sem = render_semantics(table, cam, logits, max_tiles_per_axis=m, max_per_tile=K,
                                   backend=backend)
    finally:
        profiling.disable()
    counts = {r.name: r.counts for r in profiling.records()}
    profiling.reset()

    rcam = raster.pinhole(R, T, FOV_X, FOV_Y, W, H)
    scales = torch.exp(log_scales)
    unit = quats / (torch.linalg.norm(quats, dim=-1, keepdim=True) + 1e-12)
    op = torch.sigmoid(torch.log(opac / (1 - opac)))
    with torch_threads(2), torch.no_grad():
        proj = raster.project(xyz, scales, unit, rcam)
        off = raster.bin_tiles(proj, W, H, m).offsets
        ref = raster.render(xyz, scales, unit, op, logits, torch.zeros(CH), rcam, m, K)

    # the draw does what the test needs: tiles past K, Gaussians past m tiles
    depth = off[1:] - off[:-1]
    past_k = int(torch.clamp_min(depth - K, 0).sum())
    wide = (torch.floor((proj.means2d[:, 0] + proj.radii) / 16)
            - torch.floor((proj.means2d[:, 0] - proj.radii) / 16) + 1 > m) & proj.valid
    assert past_k > 0 and int(wide.sum()) > 0

    assert counts["raster.bin"] == {"pairs": int(off[-1]), "pairs_past_k": past_k}
    # the dense blend gathers inside its chunks: no payload rows, no gather span
    assert counts.get("raster.gather") == ({"rows": n * m * m} if backend == "cuda" else None)

    img = sem.permute(1, 2, 0)
    assert img.shape == ref.shape
    assert float((img - ref).abs().max()) <= GAP_MAX
    labels = img.argmax(-1)
    gap = ref.max(-1).values - ref.gather(-1, labels[..., None])[..., 0]
    assert float((gap > 0).float().mean()) <= MISMATCH_SHARE and float(gap.max()) <= GAP_MAX
