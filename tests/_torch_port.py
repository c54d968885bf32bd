"""Shared seeded scenes for the port's parity tests (tests/test_torch_*.py) and
for chip_smoke.py: the same numpy inputs go to the JAX package and to
segsplat_tpu_torch. Imports no JAX at module level (``jax_draws`` imports it
when called)."""

import contextlib

import numpy as np

W, H, F = 64, 48, 60.0          # the camera of tests/test_blend_pallas.py


def scene(seed: int, n: int = 500, log_scale: float = -2.5,
          opac_range=(0.3, 0.95), ch: int = 8) -> dict:
    """Gaussians in front of the W×H camera. log_scale -1.5 with a few thousand
    Gaussians makes tiles several hundred pairs deep."""
    rng = np.random.default_rng(seed)
    xyz = rng.random((n, 3)) * np.array([3.0, 2.0, 2.0]) + np.array([-1.5, -1.0, 1.5])
    scales = np.exp(rng.normal(log_scale, 0.3, (n, 3)))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(xyz=f32(xyz), scales=f32(scales), quats=f32(q),
                opac=f32(rng.uniform(*opac_range, (n,))),
                colors=f32(rng.standard_normal((n, ch)) * 2.0),
                bg=f32(rng.random(ch)))


def viewmat(kind: str) -> np.ndarray:
    """World→view matrix: the identity, or a yaw of 0.1 rad plus a shift."""
    vm = np.eye(4, dtype=np.float32)
    if kind == "rotated":
        a = 0.1
        vm[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        vm[:3, 3] = [0.05, -0.02, 0.1]
    return vm


# scene kinds of the blend parity cases: (seed, n, log_scale, opacity range)
SCENES = {
    "light": (0, 500, -2.5, (0.3, 0.95)),      # shallow tiles, one block
    "deep": (1, 4000, -1.5, (0.02, 0.15)),     # > 256 rows, transmittance stays up
    "opaque": (2, 3000, -1.5, (0.9, 0.99)),    # saturates within the first block
    # wide and faint, as the training step's scene: ~73 % of pair-pixels pass
    # the cut, nothing saturates, and no tile's count (225-230) is a multiple
    # of 16, so the backward's last chunk of rows is partial
    "faint": (3, 230, -0.4, (0.02, 0.1)),
}

# blend cases, name: (scene kind, K, pair_cap as a fraction of the real pairs).
# G = 256 when K % 256 == 0, else 128; at K = 200 a tile's second block holds
# rows 128-199 only.
BLEND_CASES = {
    "k128_one_block": ("light", 128, None),
    "k256_one_block": ("light", 256, None),
    "k384_three_blocks_carry": ("deep", 384, None),
    "k384_opaque_early_out": ("opaque", 384, None),
    "pair_cap_half": ("light", 128, 0.5),
    "wide_faint_k256": ("faint", 256, None),
    "k200_partial_block": ("deep", 200, None),
}

# the packed blend K3's cases: every blend case, plus an opaque scene at K = 256,
# where K3's 128-pair early-out stops tiles that K1's one 256-row block does not
PACKED_CASES = dict(BLEND_CASES, k256_opaque_early_out=("opaque", 256, None))
PACKED_G = 128                  # K3's early-out block, whatever K is


def blend_case_args(case: str, device, ch: int = 32, packed: bool = False):
    """The blend's arguments ``(offsets, sorted_payload, bg, tx_n, ty_n, K)`` for
    a PACKED_CASES case, projected and binned by the port on ``device`` with the
    identity camera and m = 4; with ``packed`` the payload is K3's [R, 128]."""
    import torch

    from segsplat_tpu_torch.ops.rasterize import build_blend_inputs, project_gaussians

    kind, K, cap_frac = PACKED_CASES[case]
    seed, n, log_scale, opac_range = SCENES[kind]
    sc = {k: torch.as_tensor(v, device=device)
          for k, v in scene(seed, n, log_scale, opac_range, ch=ch).items()}
    proj = project_gaussians(sc["xyz"], sc["scales"], sc["quats"],
                             torch.as_tensor(viewmat("identity"), device=device),
                             F, F, W / 2, H / 2, W, H)
    bi = build_blend_inputs(proj, sc["colors"], sc["opac"], W, H, 4, K, packed=packed)
    if cap_frac is not None:
        cap = int(int(bi.num_pairs) * cap_frac)
        bi = build_blend_inputs(proj, sc["colors"], sc["opac"], W, H, 4, K, pair_cap=cap,
                                packed=packed)
    return bi.offsets, bi.sorted_payload, sc["bg"], bi.tx_n, bi.ty_n, K


K_ODD = 200                     # a per-tile K that is no multiple of 128


def odd_k_raster(device, backend: str, ch: int = 19):
    """``rasterize`` of the deep scene (rotated view, m = 4) at K = K_ODD on
    ``backend``, with the gradient of a seeded linear functional of image and
    alpha. Tiles hold more than K pairs, so the cap cuts them inside a partial
    128-row block; nothing saturates, so the kernels' block early-out never
    fires and the two backends blend the same pairs. Returns (image, alpha,
    tile_overflow, {input name: gradient})."""
    import torch

    from segsplat_tpu_torch.ops.rasterize import rasterize

    seed, n, log_scale, opac_range = SCENES["deep"]
    sc = scene(seed, n, log_scale, opac_range, ch=ch)
    t = {k: torch.as_tensor(v, device=device).requires_grad_(True) for k, v in sc.items()}
    out = rasterize(t["xyz"], t["scales"], t["quats"], t["opac"], t["colors"],
                    torch.as_tensor(viewmat("rotated"), device=device), F, F, W / 2, H / 2,
                    W, H, bg=t["bg"], max_tiles_per_axis=4, max_per_tile=K_ODD,
                    backend=backend)
    rng = np.random.default_rng(ch)
    w_img, w_alpha = (torch.as_tensor(rng.standard_normal(out[k].shape).astype(np.float32),
                                      device=device) for k in ("image", "alpha"))
    ((out["image"] * w_img).sum() + (out["alpha"] * w_alpha).sum()).backward()
    return (out["image"].detach(), out["alpha"].detach(), out["tile_overflow"],
            {k: v.grad for k, v in t.items()})


# degenerate tiles for the backward: a 3×2-tile frame with K = 128 whose tiles
# hold these many pairs; empty tiles, one past the cap, one just past it
DEGENERATE_COUNTS = (0, 300, 0, 77, 0, 129)
DEGENERATE_K = 128


def degenerate_case_args(device, ch: int = 19):
    """The blend's arguments ``(offsets, sorted_payload, bg, tx_n, ty_n, K)`` for
    DEGENERATE_COUNTS: seeded pairs drawn inside and around their tile, with K
    zero rows past the end."""
    import torch

    from segsplat_tpu_torch.ops.blend import make_payload

    tx_n, ty_n = 3, 2
    counts = np.array(DEGENERATE_COUNTS)
    tiles = np.repeat(np.arange(tx_n * ty_n), counts)
    n = tiles.size
    rng = np.random.default_rng(11)
    mu = np.stack([(tiles % tx_n) * 16 + rng.uniform(-4.0, 20.0, n),
                   (tiles // tx_n) * 16 + rng.uniform(-4.0, 20.0, n)], 1)
    a, c = rng.uniform(0.02, 0.2, n), rng.uniform(0.02, 0.2, n)
    b = rng.uniform(-0.5, 0.5, n) * np.sqrt(a * c)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    rows = make_payload(f32(mu), f32(np.stack([a, b, c], 1)), f32(rng.uniform(0.02, 0.3, n)),
                        f32(rng.standard_normal((n, ch)) * 2.0))
    payload = torch.nn.functional.pad(rows, (0, 0, 0, DEGENERATE_K))
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
                              device=device)
    return offsets, payload, f32(rng.random(ch)), tx_n, ty_n, DEGENERATE_K


def assert_case_exercised(case: str, offsets: np.ndarray, k_max: int, rows_read: int,
                          g: int = 0):
    """The case's scene reaches what its name promises: a third block, a
    partial last block cut at K, or a tile that stops early; every other case
    reads all its rows. ``g`` is the early-out block (0: K1's, 256 if
    K % 256 == 0 else 128)."""
    counts = np.minimum(np.diff(offsets), k_max)
    g = g or (256 if k_max % 256 == 0 else 128)
    if "three_blocks" in case:
        assert counts.max() > 2 * g, f"{case}: the third block is never reached"
    if "partial_block" in case:
        assert k_max % g and counts.max() == k_max > g, f"{case}: no tile fills K"
    if "early_out" in case:
        assert counts.max() > g and rows_read < counts.sum(), f"{case}: no tile stops early"
    else:
        assert rows_read == counts.sum(), f"{case}: read {rows_read} of {counts.sum()} rows"


def jax_g_block(k_max: int, g: int) -> int:
    """The block to give the JAX Pallas blends, which ask that it divide K: the
    port's ``g`` where it does, else one K-row block. Where no tile saturates
    (no early-out), both give the same blend."""
    return g if k_max % g == 0 else k_max


def owned_rows(offsets: np.ndarray, k_max: int, n_rows: int) -> np.ndarray:
    """[n_rows] bool: the payload rows some tile blends, its first
    min(count, K). The backward leaves every other row at exactly 0."""
    owned = np.zeros(n_rows, bool)
    for s, e in zip(offsets[:-1], offsets[1:]):
        owned[s:s + min(e - s, k_max)] = True
    return owned


def rows_around_tile(rng, n, origin=(16.0, 16.0), spread=24.0, log_scale=(-3.0, 3.0),
                     op_range=(0.0, 1.0)) -> np.ndarray:
    """n seeded pair rows [n, 8] (mu, conic a b c, opacity, 0, 0) about the
    16×16 tile whose first pixel is at ``origin``: a positive definite conic of
    random orientation with pixel std devs e^log_scale, mu within ``spread`` of
    the tile's centre."""
    mu = np.asarray(origin, np.float64) + 8.0 + rng.uniform(-spread, spread, (n, 2))
    s1, s2 = np.exp(rng.uniform(*log_scale, (2, n)))
    th = rng.uniform(0, np.pi, n)
    cos, sin = np.cos(th), np.sin(th)
    # conic = inverse covariance R diag(1/s1², 1/s2²) Rᵀ
    a = cos ** 2 / s1 ** 2 + sin ** 2 / s2 ** 2
    c = sin ** 2 / s1 ** 2 + cos ** 2 / s2 ** 2
    b = cos * sin * (1 / s1 ** 2 - 1 / s2 ** 2)
    rows = np.zeros((n, 8), np.float32)
    rows[:, 0:2], rows[:, 2], rows[:, 3], rows[:, 4] = mu, a, b, c
    rows[:, 5] = rng.uniform(*op_range, n)
    return rows


def edge_rows(origin=(16.0, 16.0)) -> np.ndarray:
    """Pair rows [n, 8] at the edges of the kernels' row test, about the 16×16
    tile whose first pixel is at ``origin`` (pixel centres origin + 0.5 ..
    origin + 15.5; the warps' 8×4 blocks start at x + 0, 8 and y + 0, 4, 8,
    12): opacity just below, at and just above 1/255 and at the 0.999 clamp;
    mu inside a block, just outside one, on pixel centres and block edges;
    conics that are not positive definite or have a ≤ 0; splats wider than the
    tile; mu far outside it; a conic with rho next to 1."""
    a_min = np.float32(1.0) / np.float32(255.0)
    below, above = np.nextafter(a_min, np.float32(0)), np.nextafter(a_min, np.float32(1))
    ox, oy = origin
    rows = []

    def row(mx, my, a, b, c, op):       # mx, my relative to the tile at (16, 16)
        rows.append([ox - 16.0 + mx, oy - 16.0 + my, a, b, c, op, 0, 0])

    for op in (below, a_min, above, 0.999, 0.9995, 1.0, 0.5):
        row(20.0, 20.0, 0.5, 0.0, 0.5, op)           # mu inside a block
        row(23.9, 19.5, 0.5, 0.1, 0.5, op)           # just outside a block
        row(24.5, 20.5, 2.0, 0.0, 2.0, op)           # mu on a pixel centre at a block corner
    for mx in (16.5, 23.5, 24.5, 31.5, 16.0, 24.0, 32.0):   # mu on footprint edges
        for my in (16.5, 19.5, 20.5, 31.5, 20.0):
            row(mx, my, 1.5, 0.3, 0.8, 0.7)
            row(mx, my, 40.0, 0.0, 40.0, 0.05)       # tight: one pixel or none
    for b in (-0.9, 0.9, 2.0, -5.0):                 # not positive definite
        row(10.0, 40.0, 0.5, b, 0.5, 0.8)
    for a in (0.0, -0.3, -1e-9):                     # a <= 0
        row(24.0, 24.0, a, 0.0, 0.5, 0.8)
        row(60.0, -10.0, a, 0.0, -0.5, 0.8)
    for sd in (40.0, 200.0, 5000.0):                 # wider than the tile
        c = 1.0 / sd ** 2
        row(-3 * sd, 24.0, c, 0.0, c, 0.9)
        row(24.0, 24.0 + 2.5 * sd, c, 0.3 * c, c, 0.6)
    for far in (1e3, 1e5, -1e6):                     # far outside
        row(far, 24.0, 0.3, 0.0, 0.3, 0.99)
        row(24.0, far, 1e-9, 0.0, 1e-9, 0.99)
    row(40.0, 40.0, 1e-3, 1e-3 * 0.99999, 1e-3, 0.9)  # rho next to 1
    return np.asarray(rows, np.float32)


# edge tiles for the forward kernels: a 3×2-tile frame with K = 384 (G = 128)
# whose tiles hold these many pairs: empty, one row, past the cap (the early-out
# may stop it), partial last chunks of 77 and 190 rows, one just past a block
EDGE_COUNTS = (0, 1, 500, 77, 190, 129)
EDGE_K = 384


def edge_case_args(device, ch: int = 19):
    """The blend's arguments ``(offsets, sorted_payload, bg, tx_n, ty_n, K)`` for
    EDGE_COUNTS: each tile's run is one seeded row that hits it, then
    ``edge_rows`` about it, then seeded rows about it of every size and
    opacity, cut to its count; K zero rows past the end."""
    import torch

    from segsplat_tpu_torch.ops.blend import make_payload

    tx_n, ty_n = 3, 2
    rng = np.random.default_rng(13)
    runs = []
    for t, n in enumerate(EDGE_COUNTS):
        origin = (16.0 * (t % tx_n), 16.0 * (t // tx_n))
        first = rows_around_tile(rng, 1, origin, spread=4.0, log_scale=(1.0, 2.0),
                                 op_range=(0.3, 0.9))
        rest = rows_around_tile(rng, max(n, 1), origin, log_scale=(-2.0, 4.0),
                                op_range=(0.0, 1.0))
        runs.append(np.concatenate([first, edge_rows(origin), rest])[:n])
    rows = np.concatenate(runs)
    f32 = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)
    payload = make_payload(f32(rows[:, 0:2]), f32(rows[:, 2:5]), f32(rows[:, 5]),
                           f32(rng.standard_normal((len(rows), ch)) * 2.0))
    payload = torch.nn.functional.pad(payload, (0, 0, 0, EDGE_K))
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(EDGE_COUNTS)]).astype(np.int32),
                              device=device)
    return offsets, payload, f32(rng.random(ch)), tx_n, ty_n, EDGE_K


# ───────────────────────────── feature lifting ─────────────────────────────

LIFT_VS = 0.22                                       # tests/test_lift_splat.py's grid
LIFT_ORIGIN = np.array([-1.3, -0.9, -1.1], np.float32)


def lift_occupancy(rng, Z=10, Y=8, X=12, fill=0.06) -> np.ndarray:
    """tests/test_lift_splat.py's occupancy: a sparse random grid in front of a
    solid back wall, 1-based ids in raster order."""
    occ = np.zeros((Z, Y, X), np.int32)
    mask = rng.random((Z, Y, X)) < fill
    mask[0, :, :] = True
    ids = np.cumsum(mask.ravel()).reshape(Z, Y, X)
    occ[mask] = ids[mask]
    return occ


def lift_camera(i: int, n: int, scale: float = 1.0) -> np.ndarray:
    """[4, 4] c2w of view i of n on a circle of radius 2.5·scale about the
    grid, looking at its centre (tests/test_lift_splat.py's cameras)."""
    ang = 2 * np.pi * i / max(n, 1)
    pos = np.array([2.5 * np.sin(ang), 0.3, -2.5 * np.cos(ang)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, fwd, pos * scale
    return c2w


def occupied_voxels(occ: np.ndarray, vs: float, origin: np.ndarray):
    """(centres [V, 3] f32 in (x, y, z), ids [V] int32) of an occupancy grid."""
    coords = np.argwhere(occ > 0)                                 # (z, y, x)
    ids = occ[coords[:, 0], coords[:, 1], coords[:, 2]].astype(np.int32)
    return coords[:, ::-1].astype(np.float32) * vs + origin, ids


def officescene_lift_scene(n_views: int = 8, seed: int = 1) -> dict:
    """bench.py's officescene-scale lift inputs (bench.py:294-325) in numpy:
    876×584 rays, 109 000 voxels at 0.04 m drawn without repeats from a
    60×44×42 box at (-1.2, -0.9, 1.0), fp16 [512, 292, 438] feature maps
    (upsampled ×2 by the lift), fx = fy = 350, views rotated by 0.02 rad each.
    ``feats`` draws one view at a time, in the order of bench.py's one draw."""
    rng = np.random.default_rng(seed)
    W, H, C = 876, 584, 512
    vs = 0.04
    nv = 109_000
    coords = rng.choice(60 * 44 * 42, size=nv, replace=False)
    ii = np.stack(np.unravel_index(coords, (60, 44, 42)), axis=1)
    origin = np.array([-1.2, -0.9, 1.0], np.float32)
    centers = (origin + ii * vs).astype(np.float32)
    fx = 700.0 * 0.5
    intr = np.tile(np.array([fx, fx, W / 2, H / 2], np.float32), (n_views, 1))
    c2ws = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    for i in range(n_views):
        a = 0.02 * i
        c2ws[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]

    def feats():
        for _ in range(n_views):
            yield rng.random((C, H // 2, W // 2)).astype(np.float16)

    return dict(W=W, H=H, C=C, vs=vs, origin=origin, grid_shape=(60, 44, 42),
                centers=centers, intr=intr, c2ws=c2ws, feats=feats)


# ─────────────────────────── query and pipeline ───────────────────────────

QUERY_PROMPTS = ["wall", "chair", "floor"]


def query_scene(seed: int = 0, n_vox: int = 300, n_gauss: int = 2000, channels: int = 16,
                vs: float = 0.04) -> dict:
    """A voxel table and Gaussian centres for the query stage: ``n_vox``
    distinct voxel centres on a 0.04 m grid (12³ cells at (-1.2, -0.9, 1.0)),
    seeded fp16 features, and ``n_gauss`` centres of which a quarter sit
    halfway from a voxel centre to the next cell (on the bisecting plane where
    that cell is occupied: 1-NN near-ties), a quarter on a voxel centre and the
    rest anywhere in the box."""
    rng = np.random.default_rng(seed)
    cells = rng.choice(12 ** 3, size=n_vox, replace=False)
    ii = np.stack(np.unravel_index(cells, (12, 12, 12)), axis=1)
    origin = np.array([-1.2, -0.9, 1.0], np.float32)
    pos = (origin + ii * vs).astype(np.float32)
    q = n_gauss // 4
    mid = pos[rng.integers(0, n_vox, q)].copy()
    mid[np.arange(q), rng.integers(0, 3, q)] += vs / 2   # halfway to the next cell
    on_voxel = pos[rng.integers(0, n_vox, q)]
    anywhere = origin + rng.random((n_gauss - 2 * q, 3)) * 12 * vs
    mu = np.concatenate([mid, on_voxel, anywhere]).astype(np.float32)
    feat = rng.standard_normal((n_vox, channels)).astype(np.float16)
    return dict(pos=pos, feat=feat, coords=ii[:, ::-1].astype(np.int64), mu=mu)


def nn_tie_bound(queries: np.ndarray, refs: np.ndarray) -> np.ndarray:
    """Per query, the float64 distance gap within which two 1-NN answers are a
    near-tie of the float32 expansion -2·q·r + |r|²: 8·eps₃₂·(|q|² + max|r|²)."""
    q2 = (queries.astype(np.float64) ** 2).sum(1)
    return 8 * np.finfo(np.float32).eps * (q2 + (refs.astype(np.float64) ** 2).sum(1).max())


def nn_index_mismatch(queries, refs, got, want):
    """(how many 1-NN indices differ, the largest gap between the two answers'
    exact squared distances to the query); raises where a gap exceeds the tie
    bound."""
    q = queries.astype(np.float64)
    d = lambda i: ((q - refs[i].astype(np.float64)) ** 2).sum(1)
    gap = np.abs(d(got) - d(want))
    bad = gap > nn_tie_bound(queries, refs)
    if bad.any():
        raise AssertionError(f"{int(bad.sum())} 1-NN indices differ beyond the tie bound "
                             f"(largest gap {gap.max():.3g})")
    return int((np.asarray(got) != np.asarray(want)).sum()), float(gap.max())


def blender_to_camera_json(transforms_json: str, out_path: str, params, size=None) -> list:
    """The lift's {"images", "cameras"} camera JSON for a Blender-style scene,
    written as tests/test_cli_e2e.py writes it: each frame's c2w in Blender axes
    flipped to COLMAP's, inverted to (R, tvec); one camera with ``params``
    [fx, fy, cx, cy] and, with ``size`` (W, H), its image size. Returns the
    frames' image names without their suffix."""
    import json
    import os

    with open(transforms_json) as f:
        frames = json.load(f)["frames"]
    images, names = {}, []
    for i, fr in enumerate(frames):
        c2w = np.array(fr["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        name = os.path.basename(fr["file_path"])
        names.append(name)
        images[str(i)] = {"name": name + ".png", "camera_id": "0", "R": w2c[:3, :3].tolist(),
                          "tvec": w2c[:3, 3].tolist()}
    cam = {"params": [float(x) for x in params]}
    if size is not None:
        cam["width"], cam["height"] = int(size[0]), int(size[1])
    with open(out_path, "w") as f:
        json.dump({"images": images, "cameras": {"0": cam}}, f)
    return names


def write_seeded_maps(lseg_dir: str, names, channels: int, h: int, w: int,
                      seed: int = 3) -> None:
    """Seeded [channels, h, w] fp16 feature maps ``<name>.npy``, one per view,
    with no provenance stamp."""
    import os

    os.makedirs(lseg_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name in names:
        np.save(os.path.join(lseg_dir, f"{name}.npy"),
                rng.random((channels, h, w)).astype(np.float16))


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to ``n`` for the block, then restored. The
    suite runs test files in several worker processes at once; a worker whose
    torch ops each take every core oversubscribes them, and its threads'
    spin-waits slow every worker many times over."""
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def write_blender_scene(root, n_views: int = 3, size: int = 32, n_points: int = 96,
                        seed: int = 0) -> str:
    """tests/test_train_pipeline.py's Blender-style scene under ``root``:
    ``n_views`` noise images of size² around the origin, ``n_points`` random
    points in [-1, 1]³. Returns ``root`` as a string."""
    import json
    import os

    from PIL import Image

    from segsplat_tpu_torch.io.dataset import store_point_cloud_ply

    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        pos = np.array([3 * np.sin(ang), 0.0, 3 * np.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right = right / np.linalg.norm(right)
        up = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, fwd, pos
        c2w[:3, 1:3] *= -1
        Image.fromarray((rng.random((size, size, 3)) * 255).astype(np.uint8)).save(
            os.path.join(root, f"r_{i}.png"))
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.9, "frames": frames}, f)
    xyz = (rng.random((n_points, 3)) * 2 - 1).astype(np.float32)
    store_point_cloud_ply(os.path.join(root, "points3d.ply"), xyz,
                          (rng.random((n_points, 3)) * 255).astype(np.uint8))
    return str(root)


# ───────────── PatchMatch (ops/inpaint_patch.py): the JAX draws, near-ties ─────────────
def jax_draws(seed: int):
    """The PatchMatch draws of the JAX ``inpaint_texture(..., seed=seed)``, as
    ``segsplat_tpu_torch.ops.inpaint_patch.torch_draws`` hands them out: per
    level ``key, sub = split(key)``; per PatchMatch iteration ``split(sub, 4)``,
    the key carried across the EM rounds; ``randint(k3, (2, bucket), -radius,
    radius + 1)`` and the two restarts at the bucket size, of which the first
    Nh columns are kept."""
    import jax
    import jax.numpy as jnp
    import torch

    key = [jax.random.PRNGKey(seed)]

    def draw(h, w, n, bucket, pm_iters, em_iters):
        key[0], k = jax.random.split(key[0])
        local = np.empty((em_iters, pm_iters, 2, n), np.int64)
        glob = np.empty_like(local)
        for e in range(em_iters):
            for it in range(pm_iters):
                k, k2y, k2x, k3 = jax.random.split(k, 4)
                radius = jnp.maximum((jnp.int32(max(h, w)) >> jnp.int32(it)).astype(jnp.int32), 2)
                local[e, it] = np.asarray(jax.random.randint(k3, (2, bucket), -radius,
                                                             radius + 1))[:, :n]
                glob[e, it, 0] = np.asarray(jax.random.randint(k2y, (bucket,), 0, h))[:n]
                glob[e, it, 1] = np.asarray(jax.random.randint(k2x, (bucket,), 0, w))[:n]
        return torch.from_numpy(local), torch.from_numpy(glob)

    return draw


def patch_costs(img: np.ndarray, targets: np.ndarray, sources: np.ndarray,
                patch: int) -> np.ndarray:
    """Float64 patch SSD between the edge-clamped patches of ``img`` [H, W, C]
    at ``targets`` and at ``sources`` ([N, 2] (y, x) each)."""
    r = patch // 2
    h, w = img.shape[:2]
    pad = np.pad(img.astype(np.float64), ((r, r), (r, r), (0, 0)), mode="edge")
    offs = np.arange(-r, r + 1)

    def patches(yx):
        ys = yx[:, 0, None, None] + offs[None, :, None] + r
        xs = yx[:, 1, None, None] + offs[None, None, :] + r
        return pad[np.clip(ys, 0, h + 2 * r - 1), np.clip(xs, 0, w + 2 * r - 1)]

    return ((patches(targets) - patches(sources)) ** 2).sum(axis=(1, 2, 3))


def nnf_near_ties(img, hole_yx, got, want, patch: int, channels: int):
    """How many entries of two NNFs ([N, 2]) differ, and the largest gap of
    their two sources' float64 patch costs against the hole pixel's patch on
    ``img``; raises where a gap exceeds the float32 rounding of a
    patch²·C-term sum, 2·patch²·C·eps₃₂ times the larger cost."""
    diff = np.flatnonzero((got != want).any(axis=1))
    if not len(diff):
        return 0, 0.0
    tgt = hole_yx[diff]
    c_got = patch_costs(img, tgt, got[diff], patch)
    c_want = patch_costs(img, tgt, want[diff], patch)
    gap = np.abs(c_got - c_want)
    bound = 2 * patch * patch * channels * np.finfo(np.float32).eps * np.maximum(c_got, c_want)
    if (gap > bound).any():
        raise AssertionError(f"{int((gap > bound).sum())} of {len(diff)} differing NNF entries "
                             f"are no near-tie (largest gap {gap.max():.3g})")
    return len(diff), float(gap.max())


# ───────────── several ranks on the CPU (segsplat_tpu_torch/parallel/) ─────────────

def run_ranks(script: str, mode: str, world: int, workdir, *args, timeout: float = 240.0):
    """Run ``python SCRIPT worker MODE RANK WORLD INIT WORKDIR ARGS...`` as
    ``world`` processes that meet at a ``file://`` rendezvous under
    ``workdir`` (no ports to race for). Fails, and never skips, when a rank
    exits non-zero, prints no WORKER_OK, or the launch outlasts ``timeout``
    seconds. Returns each rank's stdout."""
    import os
    import subprocess
    import sys
    import time

    workdir = str(workdir)
    init = os.path.join(workdir, f"rendezvous_{mode}")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(world):
        out = open(os.path.join(workdir, f"{mode}_rank{rank}.out"), "w+")
        err = open(os.path.join(workdir, f"{mode}_rank{rank}.err"), "w+")
        logs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, script, "worker", mode, str(rank), str(world), init, workdir,
             *map(str, args)], stdout=out, stderr=err, text=True, env=env))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f"{mode}: {world} ranks outlasted {timeout} s")
    texts = []
    for p, (out, err) in zip(procs, logs):
        out.seek(0)
        err.seek(0)
        texts.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    bad = [f"rank {r}: exit {rc}\n{o[-2000:]}\n{e[-4000:]}"
           for r, (rc, o, e) in enumerate(texts) if rc != 0 or "WORKER_OK" not in o]
    assert not bad, f"{mode}:\n" + "\n".join(bad)
    return [o for _, o, _ in texts]


def worker_main(argv, modes: dict) -> None:
    """The ``worker`` entry of a test file run by ``run_ranks``: join the gloo
    group, run ``modes[MODE](rank, world, workdir, *args)`` on one torch
    thread, leave the group and print WORKER_OK."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    from segsplat_tpu_torch.parallel import multihost

    mode, rank, world, init, workdir, *args = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    multihost.initialize(f"file://{init}", world, rank, backend="gloo")
    try:
        modes[mode](rank, world, workdir, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("WORKER_OK", flush=True)


PARALLEL_STEP = 10_000          # Adam updates already taken (see test_torch_train_step)


def port_train_setup(n_views: int = 4, seed: int = 0, device="cpu"):
    """A port TrainState built from numpy alone, with anisotropic Gaussians,
    SH degree 2 and Adam moments as after PARALLEL_STEP updates (so an update
    depends on the gradient's size, not only its sign), and ``n_views``
    cameras of W×H with GT images and block mask ids (confident pixels, so the
    codebook's losses are not 0). Returns (state, cfg, cameras, gts, objs)."""
    import dataclasses

    import torch

    from segsplat_tpu_torch.core.types import Camera
    from segsplat_tpu_torch.train import trainer as PT
    from segsplat_tpu_torch.train.densify import PARAM_FIELDS

    rng = np.random.default_rng(seed)
    n, cap = 300, 384
    pts = (rng.random((n, 3)) * np.array([3.0, 2.0, 2.0])
           + np.array([-1.5, -1.0, 1.5])).astype(np.float32)
    table = PT.init_table_from_pcd(pts, rng.random((n, 3)).astype(np.float32), cap,
                                   device=device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    with torch.no_grad():
        table.scaling.add_(f32(rng.normal(0, 0.5, (cap, 3))))
        table.features_rest.copy_(f32(rng.normal(0, 0.2, table.features_rest.shape)))
        table.rotation.copy_(f32(rng.normal(size=(cap, 4))))
        table.opacity.copy_(f32(rng.normal(0, 1, (cap, 1))))
    table = dataclasses.replace(table, active_sh_degree=2)
    # the classification weight at 1: the codebook logits' share of the
    # codebook's gradient is then a third of it (at the default 1e-4, 5e-5)
    cfg = PT.OptimizationConfig(num_classes=16, w_cls=1.0)
    state = PT.init_state(table, cfg, spatial_lr_scale=2.0, seed=seed)
    for p in [getattr(table, f) for f in PARAM_FIELDS] + [state.code_book]:
        opt = state.gauss_opt if p is not state.code_book else state.cls_opt
        opt.state[p] = {"step": torch.tensor(float(PARALLEL_STEP)),
                        "exp_avg": f32(rng.random(p.shape) * 1e-3),
                        "exp_avg_sq": f32(rng.random(p.shape) * 1e-3)}
    state.step = PARALLEL_STEP
    fov_x, fov_y = 2 * np.arctan(W / (2 * F)), 2 * np.arctan(H / (2 * F))
    cams, gts, objs = [], [], []
    for v in range(n_views):
        a = 0.05 * v
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                     np.float32)
        T = np.array([0.05 - 0.03 * v, -0.02, 0.1], np.float32)
        cams.append(Camera(R=f32(R), T=f32(T), fov_x=f32(fov_x), fov_y=f32(fov_y),
                           width=W, height=H))
        gts.append(f32(rng.random((3, H, W))))
        objs.append(torch.as_tensor(((np.arange(H)[:, None] // 12) * 4
                                     + (np.arange(W)[None, :] + 8 * v) // 16) % 16,
                                    dtype=torch.int32, device=device))
    return state, cfg, cams, gts, objs
