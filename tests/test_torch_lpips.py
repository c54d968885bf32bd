"""LPIPS of the port (segsplat_tpu_torch/eval/lpips.py, an NCHW ``nn.Module``
built by ``convert.lpips_from_params``) against the JAX package's on the same
``load_lpips`` parameters (the seed-0 backbone; the uniform lins stamped
"none", which the port takes unless a lin path is given and the JAX package
where its default path is absent), at tests/test_lpips.py's tolerance, rtol 2e-4 and atol 1e-6; the numpy
parts equal; both checkpoint converters round-trip."""

import numpy as np
import pytest
import torch

from segsplat_tpu.eval import lpips as JL
from segsplat_tpu_torch.convert import lpips_from_params
from segsplat_tpu_torch.eval import lpips as TL
from _torch_port import torch_threads


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker (see _torch_port.torch_threads)."""
    with torch_threads(1):
        yield


def _pair(n=2, size=64, seed=3):
    rng = np.random.default_rng(seed)
    img0 = rng.random((n, size, size, 3)).astype(np.float32)
    img1 = np.clip(img0 + 0.2 * rng.standard_normal(img0.shape), 0, 1).astype(np.float32)
    return img0, img1


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_lpips_matches_jax(net):
    params = TL.load_lpips(net=net)
    ref_params = JL.load_lpips(net=net)
    for key in ("net", "backbone_source", "lin_source"):
        assert params[key] == ref_params[key]
    assert params["backbone"].keys() == ref_params["backbone"].keys()
    for k in params["backbone"]:
        np.testing.assert_array_equal(params["backbone"][k], ref_params["backbone"][k])
    for a, b in zip(params["lins"], ref_params["lins"]):
        np.testing.assert_array_equal(a, b)

    img0, img1 = _pair()
    got = TL.lpips(img0, img1, params, device="cpu")
    want = JL.lpips(img0, img1, ref_params)
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
    assert (got > 0).all()
    assert TL.lpips(img0, img0, params, device="cpu").max() < 1e-6
    # one image, 3-D or a batch of one: a float, as the JAX function returns
    one = TL.lpips(img0[0], img1[0], params, device="cpu")
    assert isinstance(one, float) and isinstance(JL.lpips(img0[0], img1[0], ref_params), float)
    np.testing.assert_allclose(one, want[0], rtol=2e-4, atol=1e-6)
    assert isinstance(TL.lpips(img0[:1], img1[:1], params, device="cpu"), float)
    # [-1, 1] inputs, and the module passed in place of the params
    model = lpips_from_params(params)
    got_raw = TL.lpips(2 * img0 - 1, 2 * img1 - 1, model, normalize=False, device="cpu")
    np.testing.assert_allclose(got_raw, JL.lpips(2 * img0 - 1, 2 * img1 - 1, ref_params,
                                                 normalize=False), rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_converters_round_trip(net):
    params = TL.load_lpips(net=net)
    model = lpips_from_params(params)
    convs = model.convs()
    assert len(convs) == len(TL._conv_shapes(net))
    tv_idx = ([0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28] if net == "vgg"
              else [0, 3, 6, 8, 10])
    # the module's OIHW weights under torchvision's feature indices → HWIO
    sd = {}
    for i, (conv, ti) in enumerate(zip(convs, tv_idx)):
        sd[f"features.{ti}.weight"] = conv.weight.detach().numpy()
        sd[f"features.{ti}.bias"] = conv.bias.detach().numpy()
    back = TL.convert_backbone_checkpoint(sd, net)
    ref = JL.convert_backbone_checkpoint(sd, net)
    for k, v in params["backbone"].items():
        np.testing.assert_array_equal(back[k], v)
        np.testing.assert_array_equal(back[k], ref[k])
    own_keys = TL.convert_backbone_checkpoint(params["backbone"] | {
        k: v.transpose(3, 2, 0, 1) for k, v in params["backbone"].items() if k.endswith("_w")},
        net)
    for k, v in params["backbone"].items():
        np.testing.assert_array_equal(own_keys[k], v)
    # the lin heads as the reference's .pth holds them
    lin_sd = {f"lin{k}.model.1.weight": getattr(model, f"lin{k}").numpy().reshape(1, -1, 1, 1)
              for k in range(len(params["lins"]))}
    for a, b, c in zip(TL.convert_lpips_checkpoint(lin_sd, net),
                       JL.convert_lpips_checkpoint(lin_sd, net), params["lins"]):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    bad = dict(sd)
    bad[f"features.{tv_idx[0]}.weight"] = np.zeros((1, 1, 1, 1), np.float32)
    with pytest.raises(ValueError):
        TL.convert_backbone_checkpoint(bad, net)


def test_stamped_sources(tmp_path):
    lins = [np.full(c, 0.5, np.float32) for c in TL._ALEX_LINS]
    np.savez(tmp_path / "alex.npz", **{f"lin{k}": v for k, v in enumerate(lins)})
    p = TL.load_lpips("alex", lin_path=str(tmp_path / "alex.npz"), seed=2)
    assert p["lin_source"] == "checkpoint:alex.npz"
    assert p["backbone_source"] == "random(seed2)"
    for a, b in zip(p["lins"], lins):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        TL.load_lpips("squeeze")


def test_default_lins_read_no_file(monkeypatch):
    """Without ``lin_path`` the lins are the uniform 1/C, whatever lies around
    the checkout: no checkpoint is opened."""
    def refuse(*a, **k):
        raise AssertionError(f"load_lpips opened {a[:1]}")

    monkeypatch.setattr(TL.torch, "load", refuse)
    monkeypatch.setattr(TL.np, "load", refuse)
    for net, lins in (("vgg", TL._VGG_LINS), ("alex", TL._ALEX_LINS)):
        p = TL.load_lpips(net)
        assert p["lin_source"] == "none"
        for a, c in zip(p["lins"], lins):
            np.testing.assert_array_equal(a, np.ones(c, np.float32) / c)


def test_eval_inpaint_lpips_twin_matches_jax(tmp_path, monkeypatch):
    """The scoring twin against scripts/eval_inpaint_lpips.py on two written
    textured images in place of the reference's: the same crops and masks,
    and, method for method, the same hole MAE and SSIM (1e-5) and LPIPS (rtol
    2e-4); the PatchMatch rows (drawn from another generator) only in the
    port's run, below the controls."""
    import os
    import sys

    from PIL import Image

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    import eval_inpaint_lpips as jax_eval

    from segsplat_tpu_torch import eval_inpaint_lpips as port_eval

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:72, 0:90]
    paths = []
    for i in range(2):
        wave = 0.5 + 0.3 * np.sin(xx / (3.0 + i) + yy / 5.0)[..., None] * np.array([1, 0.6, -0.8])
        img = np.clip(wave + 0.1 * rng.random((72, 90, 3)), 0, 1)
        paths.append(str(tmp_path / f"img{i}.png"))
        Image.fromarray((img * 255).astype(np.uint8)).save(paths[-1])
    for a, b in zip(port_eval.natural_crops(40, 2, 1, paths=paths),
                    jax_eval.natural_crops(40, 2, 1, paths=paths)):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
    for h, w in ((40, 40), (33, 57)):
        np.testing.assert_array_equal(port_eval.stroke_mask(h, w, np.random.default_rng(h)),
                                      jax_eval.stroke_mask(h, w, np.random.default_rng(h)))
        np.testing.assert_array_equal(port_eval.rect_mask(h, w, np.random.default_rng(w)),
                                      jax_eval.rect_mask(h, w, np.random.default_rng(w)))

    monkeypatch.setattr(jax_eval, "REF_IMAGES", paths)
    common = ["--size", "40", "--per_image", "1", "--patch_iters", "2"]
    controls = ["meanfill", "noisefill", "wrongtex"]
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        got = port_eval.main([*common, "--images", *paths, "--out_json",
                              str(tmp_path / "port.json"), "--device", "cpu"])
        want = jax_eval.main([*common, "--out_json", str(tmp_path / "jax.json"),
                              "--methods", "pushpull", *controls])
    assert got["lpips_provenance"] == want["lpips_provenance"]
    ref_rows = {(r["crop"], r["mask"], r["method"]): r for r in want["rows"]}
    assert len(got["rows"]) == len(ref_rows) + len(ref_rows) // 4 == 20
    for r in got["rows"]:
        if r["method"] == "patch":
            continue
        ref = ref_rows[(r["crop"], r["mask"], r["method"])]
        assert r["hole_frac"] == ref["hole_frac"]
        np.testing.assert_allclose([r["mae_hole"], r["ssim"]], [ref["mae_hole"], ref["ssim"]],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose([r["lpips_vgg"], r["lpips_alex"]],
                                   [ref["lpips_vgg"], ref["lpips_alex"]], rtol=2e-4, atol=1e-6)
    s = got["summary"]
    assert s["patch"]["mae_hole"] < min(s[c]["mae_hole"] for c in controls)
