"""The port's query stage (segsplat_tpu_torch/pipeline/query.py, ops/knn's
nearest_neighbor_index, models/clip_text.project_features_to_labels and the CLI
twin segsplat_tpu_torch/voxeltoGaussian_logits.py) against the JAX package on
the same seeded files, on the CPU.

Tolerances: 1-NN indices equal to JAX's, or, where they differ, the two
answers' exact float64 squared distances to the query within
8·eps₃₂·(|q|² + max|r|²) (the expansion's rounding; the count of differing
indices is reported); hash embeddings bit-equal; logits at rtol 1e-5 and atol
1e-5·logit_scale; labels exact wherever the top-2 logit gap exceeds 1e-3."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp

from segsplat_tpu.models.clip_text import project_features_to_labels as jax_project
from segsplat_tpu.ops.knn import nearest_neighbor_index as jax_nn_index
from segsplat_tpu.pipeline import query as JQ
from segsplat_tpu_torch import voxeltoGaussian_logits as cli
from segsplat_tpu_torch.eval.parity import compare_semantics
from segsplat_tpu_torch.io.artifacts import save_voxel_features
from segsplat_tpu_torch.io.provenance import RANDOM, read_weights_source, write_provenance
from segsplat_tpu_torch.io.ply import read_voxel_grid_ply
from segsplat_tpu_torch.models.clip_text import project_features_to_labels
from segsplat_tpu_torch.ops.knn import nearest_neighbor_index
from segsplat_tpu_torch.pipeline import query as Q
from tests._torch_port import QUERY_PROMPTS, nn_index_mismatch, query_scene
from tests.make_goldens import CHANNELS, GOLD_DIR, PROMPTS, hash_prompt_embeddings

SCALE = 1.0 / 0.07
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-5 * SCALE
LABEL_GAP = 1e-3


def assert_logits_and_labels(logits, labels, ref_logits, ref_labels):
    np.testing.assert_allclose(logits, ref_logits, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > LABEL_GAP
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(labels)[clear], np.asarray(ref_labels)[clear])


# ───────────────────────────── 1-NN index ─────────────────────────────

def _nn_inputs(kind):
    if kind == "random":
        rng = np.random.default_rng(5)
        return ((rng.random((9000, 3)) * 4 - 2).astype(np.float32),
                (rng.random((3000, 3)) * 4 - 2).astype(np.float32))
    sc = query_scene(seed=1, n_vox=600, n_gauss=9000)
    return sc["mu"], sc["pos"]


@pytest.mark.parametrize("kind", ["random", "grid_ties"])
def test_nearest_neighbor_index_matches_jax(kind):
    """Random points, and 0.04 m grid refs with queries on bisecting planes:
    the chunk loop covers a partial tail chunk (9 000 = 2·4 096 + 808)."""
    q, r = _nn_inputs(kind)
    want = np.asarray(jax_nn_index(jnp.asarray(q), jnp.asarray(r)))
    got = nearest_neighbor_index(torch.from_numpy(q), torch.from_numpy(r))
    assert got.dtype == torch.int64 and got.shape == (len(q),)
    n_diff, gap = nn_index_mismatch(q, r, got.numpy(), want)
    print(f"{kind}: {n_diff} of {len(q)} indices differ, each a near-tie (largest "
          f"distance gap {gap:.3g})")
    if kind == "random":
        assert n_diff == 0


def test_nearest_neighbor_index_takes_the_first_of_equal_distances():
    refs = torch.tensor([[1.0, 0, 0], [-1.0, 0, 0], [1.0, 0, 0], [0, 0, 0]])
    q = torch.tensor([[0.0, 0, 0], [2.0, 0, 0], [0.5, 0, 0]])
    np.testing.assert_array_equal(nearest_neighbor_index(q, refs, chunk=2).numpy(),
                                  [3, 0, 0])


# ───────────────────────────── scoring and prompts ─────────────────────────────

def test_project_features_to_labels_matches_jax():
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((4000, 32)).astype(np.float32)
    text = hash_prompt_embeddings(["wall", "chair", "floor", "table", "lamp"], 32)
    want = np.asarray(jax_project(jnp.asarray(feats), jnp.asarray(text), SCALE))
    got = project_features_to_labels(torch.from_numpy(feats), torch.from_numpy(text),
                                     SCALE).numpy()
    assert_logits_and_labels(got, got.argmax(1), want, want.argmax(1))


def test_hash_embeddings_bit_equal(capsys):
    prompts = ["wall", "chair", "a photo of a chair", "ünïcödé", ""]
    got = Q._encode_prompts(prompts, None, 24)
    assert "[WARN] CLIP text tower unavailable" in capsys.readouterr().out
    np.testing.assert_array_equal(got, JQ._encode_prompts(prompts, None, 24))
    np.testing.assert_array_equal(got, hash_prompt_embeddings(prompts, 24))
    assert got.dtype == np.float32


def test_encode_prompts_uses_the_given_text_model():
    class Fixed:
        def encode_prompts(self, prompts):
            return np.full((len(prompts), 4), 0.5, np.float32)
    np.testing.assert_array_equal(Q._encode_prompts(["a", "b"], Fixed(), 4),
                                  np.full((2, 4), 0.5, np.float32))


def test_encode_prompts_falls_back_only_for_missing_weights(monkeypatch, tmp_path):
    """Without a text model the prompts get the hash embeddings, also when BPE
    merges are present, and no tower is built (one built here would be seeded
    random weights). A failure of a given text model is not caught."""
    import gzip

    from segsplat_tpu_torch.models import clip_text

    bpe = tmp_path / "merges.txt.gz"
    with gzip.open(bpe, "wt", encoding="utf-8") as f:
        f.write("#version: synthetic\nh e\n")
    monkeypatch.setenv("SEGSPLAT_CLIP_BPE", str(bpe))

    def no_tower(*a, **k):
        raise AssertionError("a text tower was built")
    monkeypatch.setattr(clip_text.TextTower, "__init__", no_tower)
    emb = Q._encode_prompts(["wall"], None, 8)
    np.testing.assert_array_equal(emb, hash_prompt_embeddings(["wall"], 8))

    class Broken:
        def encode_prompts(self, prompts):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        Q._encode_prompts(["wall"], Broken(), 8)


def test_text_query_mask_matches_jax():
    C, H, W = 24, 10, 12
    rng = np.random.default_rng(0)
    f = rng.standard_normal((H, W, C)).astype(np.float32)
    emb_p = hash_prompt_embeddings(["chair"], C)[0]
    f[:4] = emb_p + 0.1 * f[:4]
    for cf in (False, True):
        arr = np.transpose(f, (2, 0, 1)) if cf else f
        got = Q.text_query_mask(arr, "chair", channels_first=cf, device="cpu")
        want = JQ.text_query_mask(arr, "chair", channels_first=cf)
        assert got.shape == (H, W) and got.dtype == bool
        np.testing.assert_array_equal(got, want)
    assert got[:4].all()
    with pytest.raises(ValueError, match="3D"):
        Q.text_query_mask(f[0], "chair", device="cpu")


# ───────────────────────────── stage artifacts ─────────────────────────────

@pytest.fixture(scope="module")
def query_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("query")
    sc = query_scene()
    vox = str(root / "vox" / "ALL_nonzero_voxel_features_300vox.pt")
    save_voxel_features(vox, sc["pos"], sc["feat"], sc["coords"])
    mu = str(root / "gaussian_mu.npy")
    np.save(mu, sc["mu"])
    return dict(root=root, vox=vox, mu=mu, sc=sc)


def test_build_map_matches_jax(query_files, tmp_path):
    ours, theirs = str(tmp_path / "ours.npy"), str(tmp_path / "theirs.npy")
    got = Q.build_map(query_files["vox"], query_files["mu"], ours, device="cpu")
    JQ.build_map(query_files["vox"], query_files["mu"], theirs)
    a, b = np.load(ours), np.load(theirs)
    assert a.dtype == b.dtype == np.int64 and a.shape == b.shape
    np.testing.assert_array_equal(a, got)
    sc = query_files["sc"]
    n_diff, gap = nn_index_mismatch(sc["mu"], sc["pos"], a, b)
    print(f"build_map: {n_diff} of {len(a)} indices differ, each a near-tie (largest "
          f"distance gap {gap:.3g})")


def _read_ply_rgb(path):
    centers, colors, *_ = read_voxel_grid_ply(path)
    return centers, colors


def test_query_artifacts_match_jax(query_files, tmp_path):
    g2v = str(tmp_path / "gauss2voxel.npy")
    JQ.build_map(query_files["vox"], query_files["mu"], g2v)
    ours, theirs = str(tmp_path / "ours" / "sem.npz"), str(tmp_path / "theirs" / "sem.npz")
    os.makedirs(os.path.dirname(ours))
    os.makedirs(os.path.dirname(theirs))
    got = Q.query(query_files["vox"], g2v, query_files["mu"], QUERY_PROMPTS, ours,
                  device="cpu")
    want = JQ.query(query_files["vox"], g2v, query_files["mu"], QUERY_PROMPTS, theirs)
    a, b = np.load(ours), np.load(theirs)
    assert set(a.files) == {"labels", "logits", "prompts"}
    assert a["labels"].dtype == b["labels"].dtype and a["logits"].dtype == b["logits"].dtype
    np.testing.assert_array_equal(a["prompts"], b["prompts"])
    assert_logits_and_labels(a["logits"], a["labels"], b["logits"], b["labels"])
    assert_logits_and_labels(got["logits"], got["voxel_labels"][np.load(g2v)],
                             want["logits"], want["voxel_labels"][np.load(g2v)])
    for suffix in ("_gaussians.ply", "_voxels.ply"):
        ca, cola = _read_ply_rgb(ours.replace(".npz", suffix))
        cb, colb = _read_ply_rgb(theirs.replace(".npz", suffix))
        np.testing.assert_array_equal(ca, cb)
        assert (cola != colb).any(axis=1).mean() < 0.01
    assert all(r.ok for r in compare_semantics(ours, theirs))


def test_query_voxels_matches_jax(query_files, tmp_path):
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    got = Q.query_voxels(query_files["vox"], QUERY_PROMPTS, ours, device="cpu")
    want = JQ.query_voxels(query_files["vox"], QUERY_PROMPTS, theirs)
    assert_logits_and_labels(got["logits"], got["labels"], want["logits"], want["labels"])
    a = np.load(ours)
    np.testing.assert_array_equal(a["labels"], got["labels"])
    ca, _ = _read_ply_rgb(ours.replace(".npz", "_voxels.ply"))
    np.testing.assert_array_equal(ca, query_files["sc"]["pos"])


def test_golden_semantics_through_the_port(tmp_path):
    """The golden voxel features through the port's query_voxels diff clean
    against tests/golden/golden_semantics.npz in the port's parity harness."""
    ours = str(tmp_path / "semantics.npz")
    out = Q.query_voxels(os.path.join(GOLD_DIR, "golden_voxel_features.pt"), PROMPTS, ours,
                         device="cpu")
    assert out["logits"].shape[1] == len(PROMPTS) == 2 and CHANNELS == 6
    reports = compare_semantics(ours, os.path.join(GOLD_DIR, "golden_semantics.npz"))
    assert all(r.ok for r in reports), [r.line() for r in reports]


def test_convert_and_provenance(query_files, tmp_path):
    """convert keeps every array; a random-weights stamp travels with the
    artifacts and the query refuses it unless allowed; strict mode refuses
    unstamped features."""
    src_dir = tmp_path / "tainted"
    src_dir.mkdir()
    vox = str(src_dir / "vox.pt")
    sc = query_files["sc"]
    save_voxel_features(vox, sc["pos"], sc["feat"], sc["coords"])
    write_provenance(str(src_dir), RANDOM, stage="lift")

    npz = str(tmp_path / "converted" / "vox.npz")
    os.makedirs(os.path.dirname(npz))
    Q.convert_pt_to_npz(vox, npz)
    d = np.load(npz)
    np.testing.assert_array_equal(d["pos"], sc["pos"])
    np.testing.assert_array_equal(d["feat"], sc["feat"].astype(np.float32))
    np.testing.assert_array_equal(d["coords"], sc["coords"])
    assert read_weights_source(npz) == RANDOM

    g2v = str(tmp_path / "g2v.npy")
    Q.build_map(vox, query_files["mu"], g2v, device="cpu")
    with pytest.raises(RuntimeError, match="RANDOM weights"):
        Q.query(vox, g2v, query_files["mu"], QUERY_PROMPTS, str(tmp_path / "s.npz"),
                device="cpu")
    with pytest.raises(RuntimeError, match="RANDOM weights"):
        Q.query_voxels(npz, QUERY_PROMPTS, str(tmp_path / "v.npz"), device="cpu")
    out_dir = tmp_path / "allowed"
    out_dir.mkdir()
    Q.query(vox, g2v, query_files["mu"], QUERY_PROMPTS, str(out_dir / "s.npz"),
            allow_random_weights=True, save_ply=False, device="cpu")
    assert read_weights_source(str(out_dir / "s.npz")) == RANDOM
    with pytest.raises(RuntimeError, match="NO weights-provenance"):
        Q.query(query_files["vox"], g2v, query_files["mu"], QUERY_PROMPTS,
                str(tmp_path / "strict.npz"), require_provenance=True, device="cpu")


def test_query_cli_twin_on_cpu(query_files, tmp_path, capsys):
    vox, mu = query_files["vox"], query_files["mu"]
    npz = str(tmp_path / "vox.npz")
    cli.main(["convert", "--pt", vox, "--out", npz])
    g2v = str(tmp_path / "gauss2voxel.npy")
    cli.main(["build_map", "--vox", npz, "--gauss", mu, "--out", g2v, "--device", "cpu"])
    np.testing.assert_array_equal(np.load(g2v),
                                  Q.build_map(vox, mu, str(tmp_path / "m.npy"), device="cpu"))
    sem = str(tmp_path / "sem.npz")
    cli.main(["query", "--vox", npz, "--map", g2v, "--gauss", mu, "--prompt", *QUERY_PROMPTS,
              "--out", sem, "--device", "cpu"])
    labels = np.load(sem)["labels"]
    hist = dict(zip(*[x.tolist() for x in np.unique(labels, return_counts=True)]))
    assert f"[INFO] label histogram: {hist}" in capsys.readouterr().out
    ref = Q.query(vox, g2v, mu, QUERY_PROMPTS, str(tmp_path / "ref.npz"), save_ply=False,
                  device="cpu")
    np.testing.assert_array_equal(labels, ref["labels"])
    assert os.path.exists(sem.replace(".npz", "_gaussians.ply"))


def test_query_cli_twin_refuses_a_batch(query_files, tmp_path, capsys):
    """``--batch`` stays for the reference's arguments; only its default is taken."""
    g2v = tmp_path / "gauss2voxel.npy"
    with pytest.raises(SystemExit):
        cli.main(["build_map", "--vox", query_files["vox"], "--gauss", query_files["mu"],
                  "--out", str(g2v), "--batch", "1000", "--device", "cpu"])
    assert "chunks of 4 096 centres" in capsys.readouterr().err
    assert not g2v.exists()


@pytest.mark.parametrize("entry", ["build_map", "query", "query_cli", "text_query_mask"])
def test_entry_points_default_to_cuda(entry, query_files, tmp_path):
    """Without a card the default device raises; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device runs")
    vox, mu = query_files["vox"], query_files["mu"]
    g2v = str(tmp_path / "g2v.npy")
    Q.build_map(vox, mu, g2v, device="cpu")
    calls = {
        "build_map": lambda: Q.build_map(vox, mu, str(tmp_path / "m.npy")),
        "query": lambda: Q.query(vox, g2v, mu, QUERY_PROMPTS, str(tmp_path / "s.npz")),
        "query_cli": lambda: cli.main(["query", "--vox", vox, "--map", g2v, "--gauss", mu,
                                       "--prompt", "wall", "--out", str(tmp_path / "c.npz")]),
        "text_query_mask": lambda: Q.text_query_mask(np.ones((4, 4, 8), np.float32), "wall"),
    }
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        calls[entry]()
    assert not os.path.exists(tmp_path / "s.npz") and not os.path.exists(tmp_path / "c.npz")
