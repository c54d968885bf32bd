"""The port's one-pass 51-channel render (segsplat_tpu_torch/render.py
``render(..., semantic_logits=...)``: RGB 3, identity 16 and logits 32) held
against JAX ``segsplat_tpu.render.render`` on the same table and camera: the
port's kernel path (its plain versions on the CPU) against JAX
``backend="pallas"`` in interpret mode, and the port's dense backend against
JAX ``backend="xla"``. Tolerances: outputs 1e-4 (abs + rel); gradients of a
seeded linear functional of ``render``, ``render_object`` and
``semantic_logits`` rtol 5e-3, atol 2e-4·max|ref| (tests/test_blend_vjp.py's)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from segsplat_tpu import render as JR
from segsplat_tpu.core.types import Camera as JaxCamera
from segsplat_tpu.core.types import GaussianTable as JaxTable
from segsplat_tpu_torch import render as PR
from segsplat_tpu_torch.convert import table_from_jax_arrays
from segsplat_tpu_torch.core.types import Camera
from _torch_port import F, H, W

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
          "objects_dc")
OUTPUTS = ("render", "render_object", "semantic_logits")
BACKENDS = [("cuda", "pallas"), ("dense", "xla")]     # (port, JAX)
RASTER = dict(max_tiles_per_axis=4, max_per_tile=128)


@pytest.fixture(scope="module")
def setup():
    """A 384-row table (300 active) with SH degree 2 active, 20-prompt logits
    (padded to 32 channels), an off-origin camera, a background and the
    functional's seeded weights, for both packages."""
    rng = np.random.default_rng(0)
    cap, n = 384, 300
    f32 = lambda a: np.asarray(a, np.float32)
    xyz = np.zeros((cap, 3))
    xyz[:n] = rng.random((n, 3)) * np.array([3.0, 2.0, 2.0]) + np.array([-1.5, -1.0, 1.5])
    fields = dict(xyz=f32(xyz), features_dc=f32(rng.normal(0, 0.5, (cap, 1, 3))),
                  features_rest=f32(rng.normal(0, 0.2, (cap, 15, 3))),
                  scaling=f32(rng.normal(-2.5, 0.3, (cap, 3))),
                  rotation=f32(rng.normal(size=(cap, 4))),
                  opacity=f32(rng.normal(0, 1, (cap, 1))),
                  objects_dc=f32(rng.normal(0, 1, (cap, 1, 16))))
    extra = dict(active=np.arange(cap) < n, active_sh_degree=np.int32(2), max_sh_degree=3)
    jtable = JaxTable(**{k: jnp.asarray(v) for k, v in fields.items()},
                      active=jnp.asarray(extra["active"]),
                      active_sh_degree=jnp.asarray(2, jnp.int32), max_sh_degree=3)
    fov_x, fov_y = 2 * math.atan(W / (2 * F)), 2 * math.atan(H / (2 * F))
    R, T = np.eye(3, dtype=np.float32), np.array([0.05, -0.02, 0.1], np.float32)
    jcam = JaxCamera(R=jnp.asarray(R), T=jnp.asarray(T), fov_x=jnp.asarray(fov_x),
                     fov_y=jnp.asarray(fov_y), width=W, height=H)
    pcam = Camera(R=torch.from_numpy(R), T=torch.from_numpy(T), fov_x=torch.tensor(fov_x),
                  fov_y=torch.tensor(fov_y), width=W, height=H)
    return dict(fields=fields, extra=extra, jtable=jtable, jcam=jcam, pcam=pcam,
                logits=f32(rng.standard_normal((cap, 20)) * 2.0),
                override=f32(rng.random((cap, 3))), bg=f32(rng.random(3)),
                weights={k: f32(rng.standard_normal((c, H, W)))
                         for k, c in zip(OUTPUTS, (3, 16, 32))})


def _port_table(s, requires_grad=False):
    table = table_from_jax_arrays({**s["fields"], **s["extra"]}, device="cpu")
    for f in FIELDS:
        getattr(table, f).requires_grad_(requires_grad)
    return table


def _jax_render(s, backend, **kw):
    with pltpu.force_tpu_interpret_mode():
        return JR.render(s["jtable"], s["jcam"], jnp.asarray(s["bg"]),
                         semantic_logits=jnp.asarray(s["logits"]), backend=backend,
                         **RASTER, **kw)


VARIANTS = {
    "default": lambda s: {},
    "scaling_modifier": lambda s: {"scaling_modifier": 0.8},
    "override_color": lambda s: {"override_color": s["override"]},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("backends", BACKENDS, ids=["cuda-pallas", "dense-xla"])
def test_render_logits_matches_jax(setup, backends, variant):
    port_backend, jax_backend = backends
    kw = VARIANTS[variant](setup)
    ref = _jax_render(setup, jax_backend, **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                                             else v for k, v in kw.items()})
    got = PR.render(_port_table(setup), setup["pcam"], torch.from_numpy(setup["bg"]),
                    semantic_logits=torch.from_numpy(setup["logits"]),
                    backend=port_backend, **RASTER,
                    **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                       for k, v in kw.items()})
    assert got["semantic_logits"].shape == (32, H, W)
    for k in OUTPUTS + ("alpha",):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    # the padded logit channels composite on a zero background: exactly 0
    assert not got["semantic_logits"][20:].any()
    assert float(got["semantic_logits"].abs().max()) > 0.1
    np.testing.assert_allclose(got["radii"].numpy(), np.asarray(ref["radii"]), rtol=1e-5)
    np.testing.assert_array_equal(got["visibility_filter"].numpy(),
                                  np.asarray(ref["visibility_filter"]))
    assert int(got["tile_overflow"]) == int(ref["tile_overflow"])


@pytest.mark.parametrize("backends", BACKENDS, ids=["cuda-pallas", "dense-xla"])
def test_render_logits_gradients_match_jax(setup, backends):
    port_backend, jax_backend = backends
    w = setup["weights"]

    def jax_loss(params, logits):
        table = dataclasses.replace(setup["jtable"], **params)
        out = JR.render(table, setup["jcam"], jnp.asarray(setup["bg"]),
                        semantic_logits=logits, backend=jax_backend, **RASTER)
        return sum(jnp.sum(jnp.asarray(w[k]) * out[k]) for k in OUTPUTS)

    with pltpu.force_tpu_interpret_mode():
        ref_g, ref_gl = jax.grad(jax_loss, argnums=(0, 1))(
            {f: jnp.asarray(setup["fields"][f]) for f in FIELDS},
            jnp.asarray(setup["logits"]))

    table = _port_table(setup, requires_grad=True)
    logits = torch.from_numpy(setup["logits"]).requires_grad_(True)
    out = PR.render(table, setup["pcam"], torch.from_numpy(setup["bg"]),
                    semantic_logits=logits, backend=port_backend, **RASTER)
    sum((torch.from_numpy(w[k]) * out[k]).sum() for k in OUTPUTS).backward()

    got = {f: getattr(table, f).grad for f in FIELDS} | {"logits": logits.grad}
    ref = {f: ref_g[f] for f in FIELDS} | {"logits": ref_gl}
    for name, r in ref.items():
        r, g = np.asarray(r), got[name].numpy()
        np.testing.assert_allclose(g, r, rtol=5e-3, atol=2e-4 * (np.abs(r).max() + 1e-6),
                                   err_msg=f"grad mismatch: {name}")
        assert np.abs(g).max() > 0, f"grad identically zero: {name}"


def test_logits_pass_keeps_the_19_channels(setup):
    """The 51-channel pass composites the same pairs as the 19-channel one,
    so RGB, identity and alpha agree (to float summation order)."""
    table, cam = _port_table(setup), setup["pcam"]
    bg = torch.from_numpy(setup["bg"])
    one = PR.render(table, cam, bg, **RASTER)
    both = PR.render(table, cam, bg, semantic_logits=torch.from_numpy(setup["logits"]),
                     **RASTER)
    assert "semantic_logits" not in one
    for k in ("render", "render_object", "alpha"):
        torch.testing.assert_close(both[k], one[k], rtol=1e-5, atol=1e-5)
    for k in ("radii", "num_pairs", "tile_overflow"):
        assert torch.equal(both[k], one[k])
