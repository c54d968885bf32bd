"""The port's CLIP tokenizer, CLIP text tower and LSeg (segsplat_tpu_torch/models/)
and the LSeg extraction twin against the JAX package's Flax models, on narrow
configurations, on the CPU. Weights are carried from Flax by
``convert.clip_text_from_flax``/``lseg_from_flax``, and the torch state dicts
of tests/torch_oracles_nn.py are loaded both by the port's
``load_*_state_dict`` and by the JAX converters.

Tolerance: forwards at rtol 1e-4, atol 1e-5 (tests/test_converters.py's for
LSeg; its CLIP tests use 1e-5 and 1e-5, which the text tower also meets); the
align-corners resize at 1e-5; the extraction twin's fp16 files within fp16
rounding (1e-5 + 2⁻¹⁰·|x|); tokens exact."""

import gzip
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import jax
import jax.numpy as jnp

from segsplat_tpu.models import clip_text as JC
from segsplat_tpu.models import lseg as JL
from segsplat_tpu.models import tokenizer as JT
from segsplat_tpu_torch import extract_lseg_features as extract_twin
from segsplat_tpu_torch.convert import clip_text_from_flax, lseg_from_flax
from segsplat_tpu_torch.io.provenance import RANDOM, read_weights_source
from segsplat_tpu_torch.models import tokenizer as T
from segsplat_tpu_torch.models.clip_text import (ClipTextEncoder, TextTower,
                                                 load_clip_text_state_dict)
from segsplat_tpu_torch.models.lseg import (LSegModel, LSegNet, load_lseg_state_dict,
                                            pad_to_multiple, resize_bilinear_align_corners)
from tests.torch_oracles_nn import (TorchClipText, TorchLSeg, lseg_checkpoint_dict,
                                    seed_all, to_numpy_sd)

RTOL, ATOL = 1e-4, 1e-5
CLIP_CFG = dict(width=64, layers=2, heads=2, embed_dim=32, vocab_size=50,
                context_length=12)
LSEG_CFG = dict(patch=8, width=64, depth=4, heads=2, taps=(0, 1, 2, 3),
                fusion_features=16, reassemble_dims=(16, 24, 32, 32), out_dim=8)


def _tokens():
    t = np.zeros((3, CLIP_CFG["context_length"]), np.int64)
    t[0, :5] = [48, 3, 7, 12, 49]
    t[1, :4] = [48, 30, 2, 49]
    t[2] = [48] + list(range(1, 11)) + [49]      # EOT at the last position
    return t


# ───────────────────────────── tokenizers ─────────────────────────────

PROMPTS = ["a photo of a chair", "it's a 25cm chair", "hello wow", "HeLLo  ",
           "½ cup", "", "x" * 200]


def test_hash_tokenizer_matches_jax():
    np.testing.assert_array_equal(T.HashTokenizer()(PROMPTS), JT.HashTokenizer()(PROMPTS))
    np.testing.assert_array_equal(T.HashTokenizer()("wall"), JT.HashTokenizer()("wall"))
    assert (T.CONTEXT_LENGTH, T.VOCAB_SIZE, T.SOT, T.EOT) == (
        JT.CONTEXT_LENGTH, JT.VOCAB_SIZE, JT.SOT, JT.EOT)


def test_get_tokenizer_without_merges_is_the_hash_tokenizer(monkeypatch):
    monkeypatch.delenv("SEGSPLAT_CLIP_BPE", raising=False)
    assert isinstance(T.get_tokenizer(), T.HashTokenizer)
    with pytest.raises(FileNotFoundError):
        T.ClipTokenizer()


def test_clip_tokenizer_bpe_branch_matches_jax(tmp_path, monkeypatch):
    """The byte-level BPE on tests/test_converters.py's synthetic merges table:
    the same ids as the JAX tokenizer, and the hand-derived ones."""
    merges = ["h e", "he l", "hel l", "hell o</w>", "w o", "wo w</w>"]
    bpe = tmp_path / "merges.txt.gz"
    with gzip.open(bpe, "wt", encoding="utf-8") as f:
        f.write("#version: synthetic\n" + "\n".join(merges) + "\n")
    tok, ref = T.ClipTokenizer(str(bpe)), JT.ClipTokenizer(str(bpe))
    assert tok.encode("hello") == [512 + 3] and tok.encode("wow") == [512 + 5]
    assert tok.encode("helz") == [512 + 1, tok.encoder["z</w>"]]
    np.testing.assert_array_equal(tok(PROMPTS), ref(PROMPTS))
    monkeypatch.setenv("SEGSPLAT_CLIP_BPE", str(bpe))
    assert isinstance(T.get_tokenizer(), T.ClipTokenizer)
    np.testing.assert_array_equal(T.tokenize_with(tok.encode, "hello wow"),
                                  JT.tokenize_with(ref.encode, "hello wow"))


# ───────────────────────────── CLIP text tower ─────────────────────────────

@pytest.fixture(scope="module")
def flax_clip():
    model = JC.ClipTextEncoder(**CLIP_CFG)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 12), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def test_clip_text_encoder_matches_flax(flax_clip):
    model, params = flax_clip
    tokens = _tokens()
    want = np.asarray(model.apply({"params": params}, jnp.asarray(tokens, jnp.int32)))
    enc = ClipTextEncoder(**CLIP_CFG)
    assert load_clip_text_state_dict(enc, clip_text_from_flax(params)) is None
    with torch.no_grad():
        got = enc(torch.from_numpy(tokens)).numpy()
    print(f"text encoder: max abs diff {np.abs(got - want).max():.3g} of max|ref| "
          f"{np.abs(want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_text_tower_matches_flax(flax_clip):
    _, params = flax_clip
    scaled = dict(params, __logit_scale__=np.float32(25.0))
    jt = JC.TextTower(params=scaled, config=CLIP_CFG)
    tt = TextTower(clip_text_from_flax(scaled), config=CLIP_CFG, device="cpu")
    assert not tt.random_init and tt.logit_scale == pytest.approx(25.0, rel=1e-6)
    tokens = _tokens()
    got = tt.encode(tokens)
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(jt.encode(tokens)), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, rtol=1e-6)


def test_text_tower_encode_prompts_matches_flax(flax_clip):
    """Prompt strings through the hash tokenizer, at the published context
    length 77 and vocabulary."""
    cfg = dict(CLIP_CFG, context_length=77, vocab_size=T.VOCAB_SIZE)
    model = JC.ClipTextEncoder(**cfg)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(1),
                                                 jnp.zeros((1, 77), jnp.int32))["params"])
    jt = JC.TextTower(params=params, config=cfg)
    tt = TextTower(clip_text_from_flax(params), config=cfg, device="cpu")
    prompts = ["wall", "a red chair", "floor lamp"]
    np.testing.assert_allclose(tt.encode_prompts(prompts, T.HashTokenizer()),
                               jt.encode_prompts(prompts, JT.HashTokenizer()),
                               rtol=RTOL, atol=ATOL)


def test_text_tower_random_init_is_seeded():
    a = TextTower(config=CLIP_CFG, seed=3, device="cpu")
    b = TextTower(config=CLIP_CFG, seed=3, device="cpu")
    assert a.random_init and a.logit_scale == pytest.approx(1 / 0.07, rel=1e-6)
    tokens = _tokens()
    np.testing.assert_array_equal(a.encode(tokens).numpy(), b.encode(tokens).numpy())
    c = TextTower(config=CLIP_CFG, seed=4, device="cpu")
    assert not np.array_equal(a.encode(tokens).numpy(), c.encode(tokens).numpy())


def test_clip_oracle_state_dict_loads_as_the_jax_converter_reads_it():
    """tests/torch_oracles_nn.py's OpenAI-CLIP graph, its state dict nested
    under net.clip_pretrained. as LSeg's checkpoint nests it: the port's loader
    and the JAX converter give the same forward, and both the oracle's."""
    seed_all(0)
    tm = TorchClipText(**CLIP_CFG).eval()
    sd = {"net.clip_pretrained." + k: v for k, v in tm.state_dict().items()}
    sd["net.clip_pretrained.visual.proj"] = torch.zeros(3)    # another tower: ignored
    enc = ClipTextEncoder(**CLIP_CFG)
    scale = load_clip_text_state_dict(enc, sd)
    assert scale == pytest.approx(1 / 0.07, rel=1e-5)
    params = JC.convert_torch_clip_text(to_numpy_sd(tm), heads=CLIP_CFG["heads"])
    params.pop("__logit_scale__")
    tokens = _tokens()
    with torch.no_grad():
        got = enc(torch.from_numpy(tokens)).numpy()
    want = np.asarray(JC.ClipTextEncoder(**CLIP_CFG).apply(
        {"params": params}, jnp.asarray(tokens, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, tm(torch.from_numpy(tokens)).numpy(), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(KeyError, match="lacks"):
        load_clip_text_state_dict(ClipTextEncoder(**CLIP_CFG),
                                  {k: v for k, v in sd.items() if "ln_final" not in k})


# ───────────────────────────── LSeg ─────────────────────────────

def _flax_lseg(image_size: int, seed: int = 0):
    jm = JL.LSegModel(seed=seed, image_size=image_size, **LSEG_CFG)
    return jm, jax.tree.map(np.asarray, jm.params)


@pytest.mark.parametrize("image_size,hw", [
    (32, (32, 32)),        # the position grid at its own size
    (64, (32, 48)),        # shrunk (jax.image.resize antialiases)
    (32, (48, 64)),        # grown
])
def test_lseg_matches_flax(image_size, hw):
    jm, params = _flax_lseg(image_size)
    tm = LSegModel(lseg_from_flax(params), image_size=image_size, device="cpu", **LSEG_CFG)
    img = np.random.default_rng(4).random((2, *hw, 3)).astype(np.float32)
    x = torch.from_numpy(img.transpose(0, 3, 1, 2))
    for upsample in (False, True):
        want = np.asarray(jm.features(jnp.asarray(img), upsample=upsample))
        got = tm.features(x, upsample=upsample).numpy().transpose(0, 2, 3, 1)
        assert got.shape == want.shape
        print(f"LSeg {image_size} {hw} upsample={upsample}: max abs diff "
              f"{np.abs(got - want).max():.3g} of max|ref| {np.abs(want).max():.3g}")
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    text = np.eye(LSEG_CFG["out_dim"], 3, dtype=np.float32).T
    np.testing.assert_allclose(
        tm.logits(torch.from_numpy(got.transpose(0, 3, 1, 2)), torch.from_numpy(text)).numpy(),
        np.asarray(jm.logits(jnp.asarray(got), jnp.asarray(text))), rtol=RTOL, atol=ATOL)


def test_lseg_bf16_is_close_to_fp32():
    """bfloat16 products and convolutions against float32, on the CPU: per-pixel
    cosine similarity (the card's is measured by chip_smoke.py)."""
    _, params = _flax_lseg(32)
    sd = lseg_from_flax(params)
    img = torch.from_numpy(np.random.default_rng(5).random((1, 3, 32, 48)).astype(np.float32))
    f32 = LSegModel(sd, image_size=32, device="cpu", **LSEG_CFG).features(img)
    bf16 = LSegModel(sd, image_size=32, device="cpu", compute_dtype=torch.bfloat16,
                     **LSEG_CFG).features(img)
    assert bf16.dtype == torch.float32
    cos = torch.nn.functional.cosine_similarity(bf16, f32, dim=1)
    assert float(cos.min()) > 0.99
    with pytest.raises(ValueError, match="compute_dtype"):
        LSegNet(compute_dtype=torch.float16, **LSEG_CFG)


def test_lseg_oracle_state_dict_loads_as_the_jax_converter_reads_it():
    """tests/torch_oracles_nn.py's timm ViT + DPT graph in the demo checkpoint's
    namespace, under a Lightning net. prefix: the port's loader and the JAX
    converter give the same forward, and both the oracle's."""
    seed_all(1)
    cfg = dict(LSEG_CFG, image_size=32)
    tm = TorchLSeg(**cfg).eval()
    sd = {"net." + k: v for k, v in lseg_checkpoint_dict(tm).items()}
    net = LSegNet(**cfg)
    assert load_lseg_state_dict(net, sd) == pytest.approx(1 / 0.07, rel=1e-5)
    img = np.random.default_rng(4).random((1, 32, 32, 3)).astype(np.float32)
    x = torch.from_numpy(img.transpose(0, 3, 1, 2))
    with torch.no_grad():
        got = net(x).numpy()
    params = JL.convert_lseg_checkpoint(lseg_checkpoint_dict(tm), heads=cfg["heads"])
    want = np.asarray(JL.LSegModel(params=params, image_size=32, **LSEG_CFG).features(
        jnp.asarray(img), upsample=False)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, tm(x).numpy(), rtol=RTOL, atol=ATOL)


def test_resize_and_pad_match_jax():
    """Output sizes of at least 2, as LSeg's ×2 resizes give (at an output
    size of 1 the JAX matrix averages where align_corners takes the first)."""
    rng = np.random.default_rng(6)
    for shape, (oh, ow) in (((2, 5, 7, 3), (10, 14)), ((2, 5, 7, 3), (3, 4)),
                            ((1, 1, 6, 2), (2, 12)), ((1, 8, 1, 2), (16, 2))):
        x = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(JL.resize_bilinear_align_corners(jnp.asarray(x), oh, ow))
        got = resize_bilinear_align_corners(torch.from_numpy(x.transpose(0, 3, 1, 2)), oh, ow)
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-5)
    img = np.ones((37, 50, 3), np.float32)
    got, hw = pad_to_multiple(img, 32)
    want, whw = JL.pad_to_multiple(img, 32)
    assert hw == whw == (37, 50) and got.shape == (64, 64, 3)
    np.testing.assert_array_equal(got, want)


# ───────────────────────────── the extraction twin ─────────────────────────────

def test_extract_lseg_features_twin_matches_the_jax_script(tmp_path, monkeypatch):
    """Two tiny images through both scripts at float32 on the same carried
    weights, the published net swapped for the narrow one in each script."""
    import extract_lseg_features as jax_script

    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(7)
    for name, (w, h) in (("a", (40, 30)), ("b", (26, 34))):
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
            images / f"{name}.png")
    jm, params = _flax_lseg(32)
    sd = lseg_from_flax(params)
    flax_model = JL.LSegModel
    monkeypatch.setattr(JL, "LSegModel", lambda params, compute_dtype: flax_model(
        params=jm.params, compute_dtype=compute_dtype, image_size=32, **LSEG_CFG))
    monkeypatch.setattr(extract_twin, "LSegModel", lambda state_dict, compute_dtype, device:
                        LSegModel(sd, compute_dtype=compute_dtype, image_size=32,
                                  device=device, **LSEG_CFG))
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    args = ["--images", str(images), "--short_side", "40", "--dtype", "float32"]
    written = extract_twin.main(args + ["--out_dir", str(ours), "--device", "cpu"])
    jax_script.main(args + ["--out_dir", str(theirs)])
    assert [os.path.basename(p) for p in written] == ["a.npy", "b.npy"]
    for name, shape in (("a", (8, 40, 53)), ("b", (8, 52, 40))):
        a, b = np.load(ours / f"{name}.npy"), np.load(theirs / f"{name}.npy")
        assert a.dtype == np.float16 and a.shape == b.shape == shape
        a, b = a.astype(np.float32), b.astype(np.float32)
        assert np.all(np.abs(a - b) <= 1e-5 + np.abs(b) * 2.0 ** -10)
    assert read_weights_source(str(ours)) == RANDOM == read_weights_source(str(theirs))


def test_extract_lseg_features_twin_needs_images(tmp_path, monkeypatch):
    monkeypatch.setattr(extract_twin, "LSegModel", lambda **kw: None)
    (tmp_path / "empty").mkdir()
    with pytest.raises(RuntimeError, match="no images"):
        extract_twin.main(["--images", str(tmp_path / "empty"), "--out_dir",
                           str(tmp_path / "out"), "--device", "cpu"])


def test_extract_lseg_features_twin_refuses_a_batch(tmp_path, monkeypatch, capsys):
    """``--batch`` stays for the JAX script's arguments; any value but 1 is refused."""
    monkeypatch.setattr(extract_twin, "LSegModel", lambda **kw: None)
    with pytest.raises(SystemExit):
        extract_twin.main(["--images", str(tmp_path), "--out_dir", str(tmp_path / "out"),
                           "--batch", "4", "--device", "cpu"])
    assert "images are run one at a time" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("entry", ["TextTower", "LSegModel", "extract_lseg_features"])
def test_model_entry_points_default_to_cuda(entry, tmp_path):
    """Without a card the default device raises; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device runs")
    calls = {
        "TextTower": lambda: TextTower(config=CLIP_CFG),
        "LSegModel": lambda: LSegModel(image_size=32, **LSEG_CFG),
        "extract_lseg_features": lambda: extract_twin.main(
            ["--images", str(tmp_path), "--out_dir", str(tmp_path / "out")]),
    }
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        calls[entry]()
