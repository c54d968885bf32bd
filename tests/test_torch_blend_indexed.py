"""K1's indexed variant on the no-grad render path (segsplat_tpu_torch/ops/blend.py
``blend_tiles_indexed``, taken by ops/rasterize.py ``rasterize``), on the CPU:
which path ``rasterize`` takes, the same bits as the gathered payload's path,
the span counts it gives (none of gathered rows), and the wrapper's checks. The card is stood in by
patching ``_on_card`` (and the projection's launch by its plain version), as
tests/test_torch_rasterize.py does for the projection; the kernel itself is
held against K1 on the card by tests/test_torch_blend_cuda.py."""

import pytest
import torch

from segsplat_tpu_torch.ops import blend as B
from segsplat_tpu_torch.ops import rasterize as Pr
from segsplat_tpu_torch.parallel.render import rasterize_strip
from segsplat_tpu_torch.utils import profiling as TP
from _torch_port import F, H, SCENES, W, scene, viewmat


@pytest.fixture
def on_card(monkeypatch):
    """The card stood in: the gates see the Gaussians on it, the projection
    runs its plain version (the kernel's bits)."""
    monkeypatch.setattr(Pr, "_on_card", lambda means3d: True)
    monkeypatch.setattr(Pr, "_project_on_card", lambda *a: Pr.project_gaussians_plain(*a))


@pytest.fixture
def spans():
    """Spans record (``profiling.enable``) for the test; yields a reader of
    the last ``raster.gather`` count ``rows`` (None where it counts none, or
    where no such span ran)."""
    TP.reset()
    TP.enable()

    def rows():
        counts = [r.counts.get("rows") for r in TP.records() if r.name == "raster.gather"]
        return counts[-1] if counts else None
    try:
        yield rows
    finally:
        TP.disable()
        TP.reset()


def _inputs(kind: str, ch: int, view: str = "rotated", requires_grad: bool = False):
    seed, n, log_scale, opac = SCENES[kind]
    sc = {k: torch.as_tensor(v) for k, v in scene(seed, n, log_scale, opac, ch=ch).items()}
    if requires_grad:
        for k in ("colors", "opac", "xyz"):
            sc[k].requires_grad_(True)
    vm = torch.as_tensor(viewmat(view))
    if view == "behind":
        vm = torch.as_tensor(viewmat("identity"))
        vm[2, 3] = -10.0            # every Gaussian behind the camera
    return sc, vm


def _render(sc, vm, m: int, K: int, width: int = W, height: int = H, strip=None, **kw):
    args = (sc["xyz"], sc["scales"], sc["quats"], sc["opac"], sc["colors"], vm,
            F, F, W / 2, H / 2)
    kw = dict(bg=sc["bg"], max_tiles_per_axis=m, max_per_tile=K, **kw)
    if strip is not None:
        return rasterize_strip(*strip, *args, width, height, **kw)
    return Pr.rasterize(*args, width, height, **kw)


def _staged_rows(sc, vm, m: int, K: int, pair_cap=None, opacity_cull=False) -> int:
    """Σ_t min(count_t, K) of the frame's tiles, the offsets cut at pair_cap,
    from the binning alone."""
    proj = Pr.project_gaussians_plain(sc["xyz"], sc["scales"], sc["quats"], vm,
                                      F, F, W / 2, H / 2, W, H)
    _, _, off, _ = Pr.bin_gaussian_ranks(proj, W, H, m,
                                         opacities=sc["opac"] if opacity_cull else None)
    off = off.long()
    if pair_cap is not None:
        off = torch.clamp_max(off, pair_cap)
    return int(torch.clamp_max(torch.diff(off), K).sum())


# ── which route rasterize takes ──

# name: (backend, the Gaussians on the card, grad mode, an input needs grad,
# traced by torch.compile, the route)
DISPATCH_CASES = {
    "cpu": ("cuda", False, False, False, False, "gathered"),
    "card_no_grad_mode": ("cuda", True, False, False, False, "indexed"),
    "card_grad_mode_nothing_needs_grad": ("cuda", True, True, False, False, "indexed"),
    "card_needs_grad_no_grad_mode": ("cuda", True, False, True, False, "indexed"),
    "card_needs_grad": ("cuda", True, True, True, False, "gathered"),
    "card_compiled": ("cuda", True, False, False, True, "gathered"),
    "cpu_dense": ("dense", False, False, False, False, "dense"),
    "card_dense": ("dense", True, False, False, False, "dense"),
}
ROUTES = {"indexed": "blend_tiles_indexed", "gathered": "_gather_payload",
          "dense": "_blend_tiles"}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_rasterize_blend_dispatch(case, monkeypatch, spans):
    """Every route bins once (``bin_pairs``). The indexed route runs only on
    the card's ``"cuda"`` backend, outside a compile trace, with nothing for
    autograd to record; the dense backend takes neither it nor the gathered
    route; everywhere else the gathered payload and K1's op. The count
    ``rows`` is the gathered rows (N·m², no cap) on the gathered route; the
    indexed route gathers no pair's row and gives none, and the dense blend
    gathers inside its chunks. The kernel's launch counter moves only on the
    card (never here)."""
    backend, card, grad_mode, needs_grad, compiled, route = DISPATCH_CASES[case]
    monkeypatch.setattr(Pr, "_on_card", lambda means3d: card)
    monkeypatch.setattr(Pr, "_project_on_card", lambda *a: Pr.project_gaussians_plain(*a))
    ran = []
    for name in ("bin_pairs", *ROUTES.values()):
        fn = getattr(Pr, name)
        monkeypatch.setattr(Pr, name, lambda *a, _fn=fn, _name=name, **k: (
            ran.append(_name), _fn(*a, **k))[1])
    sc, vm = _inputs("light", 32, requires_grad=needs_grad)
    m, K = 4, 128
    render = (torch.compile(_render, backend="eager") if compiled else _render)
    before = B.blend_tiles_indexed.launches
    with torch.set_grad_enabled(grad_mode):
        out = render(sc, vm, m, K, backend=backend)
    assert ran == ["bin_pairs", ROUTES[route]]
    assert B.blend_tiles_indexed.launches == before
    if not compiled:
        n = sc["xyz"].shape[0]
        assert spans() == (n * m * m if route == "gathered" else None)
    assert out["image"].requires_grad == (grad_mode and needs_grad)


# ── the same bits as the gathered payload's path ──

# name: (scene kind, CH, m, K, pair_cap as a share of the frame's pairs, view,
# strip (index, of n) or None, opacity_cull)
EQUAL_CASES = {
    "k200_below_deepest_tile": ("deep", 32, 4, 200, None, "rotated", None, False),
    "k384_three_blocks": ("deep", 32, 4, 384, None, "rotated", None, False),
    "pair_cap_below": ("deep", 32, 4, 200, 0.5, "rotated", None, False),
    "pair_cap_above": ("deep", 32, 4, 200, 1.5, "rotated", None, False),
    "strip_tile_row0": ("deep", 32, 4, 200, None, "rotated", (1, 3), False),
    "empty_frame": ("light", 32, 4, 128, None, "behind", None, False),
    "opacity_cull": ("opaque", 32, 4, 256, None, "rotated", None, True),
    "ch8": ("deep", 8, 4, 200, None, "rotated", None, False),
    "ch19": ("faint", 19, 3, 256, None, "rotated", None, False),
    "ch24": ("deep", 24, 4, 200, None, "rotated", None, False),
    "ch51": ("deep", 51, 4, 384, None, "rotated", None, False),
}


@pytest.mark.parametrize("case", sorted(EQUAL_CASES))
def test_indexed_path_gives_the_gathered_paths_bits(case, monkeypatch, spans):
    """``rasterize`` under no_grad on the indexed path (the card stood in)
    against the gathered payload's path: image, alpha and the pair counts
    equal (torch.equal), and no ``rows`` count. A cap below the frame's pairs
    takes rows K1 would read (Σ_t min(count_t, K) falls)."""
    kind, ch, m, K, cap_share, view, strip, cull = EQUAL_CASES[case]
    sc, vm = _inputs(kind, ch, view)
    kw = dict(opacity_cull=cull, strip=strip)
    with torch.no_grad():
        ref = _render(sc, vm, m, K, **kw)
        pairs = int(ref["num_pairs"])
        cap = None if cap_share is None else int(pairs * cap_share)
        if cap is not None:
            ref = _render(sc, vm, m, K, pair_cap=cap, **kw)
        monkeypatch.setattr(Pr, "_on_card", lambda means3d: True)
        monkeypatch.setattr(Pr, "_project_on_card", lambda *a: Pr.project_gaussians_plain(*a))
        got = _render(sc, vm, m, K, pair_cap=cap, **kw)
    for key in ("image", "alpha", "num_pairs", "tile_overflow", "radii", "visible"):
        assert torch.equal(got[key], ref[key]), key
    if view == "behind":
        assert pairs == 0
        assert torch.equal(got["image"], sc["bg"].expand_as(got["image"]))
    else:
        assert spans() is None
    if case == "k200_below_deepest_tile":
        assert int(ref["tile_overflow"]) > 0, "no tile is deeper than K"
    if cap_share is not None and strip is None:
        staged = _staged_rows(sc, vm, m, K, cap, cull)
        full = _staged_rows(sc, vm, m, K, None, cull)
        assert staged < full if cap_share < 1 else staged == full


# ── the wrapper ──

def _wrapper_args(ch: int = 19, K: int = 200):
    sc, vm = _inputs("deep", ch)
    proj = Pr.project_gaussians_plain(sc["xyz"], sc["scales"], sc["quats"], vm,
                                      F, F, W / 2, H / 2, W, H)
    order, rank_sorted, offsets, (tx_n, ty_n) = Pr.bin_gaussian_ranks(proj, W, H, 4)
    table = B.make_payload(proj.means2d, proj.conics, sc["opac"], sc["colors"])[order]
    gathered = Pr.build_blend_inputs(proj, sc["colors"], sc["opac"], W, H, 4, K)
    return (offsets, rank_sorted, table, sc["bg"], tx_n, ty_n, K), gathered


def test_blend_tiles_indexed_matches_blend_tiles_on_the_gathered_rows():
    args, gi = _wrapper_args()
    got = B.blend_tiles_indexed(*args)
    ref = B.blend_tiles(gi.offsets, gi.sorted_payload, args[3], gi.tx_n, gi.ty_n, args[-1])
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("fault", ["ids_int32", "ids_2d", "table_width", "table_f64",
                                   "offsets_int64", "k_zero", "ch_too_wide"])
def test_blend_tiles_indexed_checks_its_inputs(fault):
    """Inputs the kernel cannot read raise ValueError on every device."""
    offsets, ids, table, bg, tx_n, ty_n, K = _wrapper_args()[0]
    if fault == "ids_int32":
        ids = ids.int()
    elif fault == "ids_2d":
        ids = ids[:, None]
    elif fault == "table_width":
        table = table[:, :-4].contiguous()
    elif fault == "table_f64":
        table = table.double()
    elif fault == "offsets_int64":
        offsets = offsets.long()
    elif fault == "k_zero":
        K = 0
    elif fault == "ch_too_wide":
        bg = torch.zeros(B.MAX_CH + 1)
        table = torch.zeros((table.shape[0], B.payload_width(B.MAX_CH + 1)))
    with pytest.raises(ValueError):
        B.blend_tiles_indexed(offsets, ids, table, bg, tx_n, ty_n, K)


def test_indexed_path_counts_only_the_binning(on_card, spans):
    """With spans recording, the indexed path's ``raster.bin`` counts
    ``pairs`` and ``pairs_past_k`` as the gathered path's does, and its
    ``raster.gather`` (the N-row table) counts nothing."""
    sc, vm = _inputs("deep", 32)
    with torch.no_grad():
        out = _render(sc, vm, 4, 200)
    counts = {r.name: r.counts for r in TP.records() if r.name.startswith("raster.")}
    assert counts["raster.gather"] == {}
    assert counts["raster.bin"] == {"pairs": int(out["num_pairs"]),
                                    "pairs_past_k": int(out["tile_overflow"])}
    assert int(out["tile_overflow"]) > 0
