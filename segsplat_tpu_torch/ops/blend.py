"""Tile blend: kernels K1 (forward), K2 (backward) and K3 (packed forward) of
the port, their plain PyTorch versions, and the three as registered ops
(``segsplat_torch::blend_fwd``, ``::blend_bwd``, ``::blend_packed``), K1's op
differentiable through K2's.

``blend_tiles`` composites every 16×16 tile against its depth-sorted pair
payload run. On a CUDA tensor it launches the hand-written kernel
``segsplat_tpu_torch/csrc/blend_fwd.cu`` (built with nvcc for sm_90a, bound with
ctypes) or raises; on a CPU tensor it runs ``blend_tiles_plain``.
``blend_tiles_bwd`` is its backward: ``csrc/blend_bwd.cu`` on CUDA tensors,
``blend_tiles_bwd_plain`` on CPU tensors. ``blend`` is the differentiable blend
that training renders through: K1's op, whose autograd calls K2's.

``blend_tiles_indexed`` is K1's indexed variant, for renders that need no
gradient: it reads each pair's row from a per-Gaussian table through the
pair's id, so no gathered payload is built (the same bits as ``blend_tiles``
on the gathered rows).

K1 replaces the TPU kernel ``segsplat_tpu/ops/blend_pallas.py:188``
``blend_tiles_pallas_dma``. Its semantics are kept exactly: pixel centres at
+0.5, sigma ≥ 0 and 1/255 ≤ alpha ≤ 0.999, a per-tile cap of K rows, and the
early-out at G-row block boundaries (G = 256 if K % 256 == 0, else 128) once
every pixel's transmittance is below 1e-4. K may be any positive count: where it
is no multiple of G (the TPU kernel asks that it be one), a tile's last block
is partial and the cap still falls at row K. Its layout is not: a payload row is
``[mu_x, mu_y, conic a, b, c, opacity, 0, 0, CH colours]`` padded to a multiple
of 4 floats (16-byte loads) instead of the TPU's 128 lanes, and the K zero rows
past the end stay.

K2 replaces ``segsplat_tpu/ops/blend_pallas_vjp.py:195`` ``_blend_bwd_pallas``:
per-pair gradients from the forward outputs and their cotangents, with alpha
recomputed for every row up to the tile's count — no early-out, so rows behind
a block where the forward stopped get the gradient of the exact compositing, as
on the TPU. d_payload rows that no tile owns (past a tile's K cap, the K-row
tail) are zero.

K3 replaces ``segsplat_tpu/ops/blend_pallas2.py:141``
``blend_tiles_pallas_packed``: K1's blend on a packed payload ``[R, 128]`` that
holds two consecutive pairs of 64 floats per row (CH ≤ 56), composited in
couples — T_couple = (1−αA)(1−αB), wA = αA·T, wB = αB·T·(1−αA) — with the
early-out per ``g_block`` = 128 pairs whatever K is. ``blend_tiles_packed``
launches ``csrc/blend_packed.cu`` on CUDA tensors and runs
``blend_tiles_packed_plain`` on CPU tensors; it has no backward, as on the TPU.

Row lists (K1 and K3). A warp owns an 8×4 block of its tile's pixels
(``WARP_FOOTPRINT``). Once a chunk of rows lands in shared memory, each warp
tests every row against its block with ``warp_row_may_hit``'s test and keeps a
bitmask; it then blends only the rows whose bit is set. The test is exact by
construction: it drops a row only where no pixel centre of the block can pass
the sigma and alpha cut, so the dropped row has alpha 0 at every pixel of the
warp and the result is the same bit for bit. ``blend_tiles_warp_rows`` and
``blend_tiles_packed_warp_rows`` count the warp-rows read, kept and hit.

Channel widths. Each kernel is built for a ladder of widths, written once in
``csrc/blend_widths.cuh`` and read from there as KERNEL_WIDTHS (K1, K2) and
PACKED_WIDTHS (K3); the wrappers run CH at ``kernel_width(CH)``, the next one,
on zero colours, bg and cotangents appended, and cut the image and d_payload
back to CH. So K1 and K2
take any 1 ≤ CH ≤ 120 and K3 any CH ≤ 56, as the TPU kernels do (8 + CH
colours in one 128-lane row; K3's 64-float pair), and a CH outside raises on
every device.

Bound on the card (K1): every pair-pixel of a row read costs about 15 fp32
operations (one exp among them), and one that passes the cut another 2·CH + 3;
the payload is read once per pair and the image written once. Which of the two
bounds it depends on the share of pair-pixels that pass the cut. K2's and K3's
bounds are reckoned the same way (``blend_bwd.cu`` and ``blend_packed.cu`` have
their counts).
"""

from __future__ import annotations

import ctypes
import functools
import re

import torch

from segsplat_tpu_torch.utils import cuda_build

TILE = 16
PX = TILE * TILE
GEOM = 8              # payload prefix: mu_x, mu_y, conic a/b/c, opacity, 0, 0
SAT_EPS = 1e-4        # a tile stops once every pixel's transmittance is below this
KERNEL_CHANNELS = (19, 32, 51)  # the main paths' widths: training, semantic, one pass
PACKED_HALF = 64      # floats per pair in K3's packed layout
PACKED_MAX_CH = PACKED_HALF - GEOM   # colours a packed pair can hold: 56
MAX_CH = 128 - GEOM   # K1 and K2 take what the TPU kernels take: 8 + CH ≤ 128 lanes
_PLAIN_CHUNK_ELEMS = 1 << 24    # [tiles, G, 256] elements per plain-version chunk
WARP_FOOTPRINT = (8, 4)         # the pixels of one warp in K1 and K3: 8 wide, 4 high
ALPHA_MIN = 1.0 / 255.0
# the row test's margins (csrc/blend_common.cuh): kappa = 4·CULL_GAMMA·ac/det
# bounds the relative rounding of sigma in the kernel and in the test itself;
# CULL_TAU_MARGIN covers logf's and expf's rounding of the threshold
CULL_GAMMA = 2.0 ** -16
CULL_TAU_MARGIN = 1e-5
CULL_BIG = 1e30


def _width_ladder(macro: str) -> tuple:
    """The widths of ``#define <macro>(X) X(4) X(8) ...`` in
    ``csrc/blend_widths.cuh``, the ``case`` labels of the kernels' switches."""
    text = (cuda_build.CSRC / "blend_widths.cuh").read_text()
    body = re.search(rf"^#define {macro}\(X\)(.*)$", text, re.MULTILINE).group(1)
    return tuple(int(w) for w in re.findall(r"X\((\d+)\)", body))


# the widths each kernel is built for; a launch at CH runs the smallest width
# ≥ CH on zero-padded colours
KERNEL_WIDTHS = _width_ladder("SEGSPLAT_WIDTHS")
PACKED_WIDTHS = _width_ladder("SEGSPLAT_PACKED_WIDTHS")


def payload_width(ch: int) -> int:
    """Floats per payload row for ``ch`` colour channels."""
    return -(-(GEOM + ch) // 4) * 4


def g_block(k_max: int) -> int:
    """Rows per early-out block, as the TPU kernel picks it."""
    return 256 if k_max % 256 == 0 else 128


def kernel_width(ch: int, widths=KERNEL_WIDTHS) -> int:
    """The smallest width in ``widths`` that holds ``ch`` channels. Raises for a
    CH outside 1 .. max(widths) (120 for K1 and K2, 56 for K3), on every
    device."""
    if ch >= 1:
        for w in widths:
            if ch <= w:
                return w
    raise ValueError(f"the blend kernels take 1 to {widths[-1]} channels, got {ch}")


def pad_rows(payload: torch.Tensor, ch: int, width: int) -> torch.Tensor:
    """Payload rows of ``ch`` colours as rows of ``width`` colours. Where the
    row's float4 padding already has room (``payload_width`` equal) the rows are
    returned as they are, and the kernel reads their pad columns (zeros from
    ``make_payload``) as the extra colours; else the colours are copied into
    rows with zero columns appended. An extra colour changes neither alpha nor
    T nor any other channel, so its image and gradient are only cut away."""
    if payload_width(width) == payload.shape[1]:
        return payload
    return torch.nn.functional.pad(payload[:, :GEOM + ch], (0, payload_width(width) - GEOM - ch))


def _pad_last(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with zeros appended to its last axis up to ``width``."""
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def make_payload(means2d: torch.Tensor, conics: torch.Tensor,
                 opacities: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian payload rows [N, payload_width(CH)] in the kernel's layout."""
    n, ch = colors.shape
    pad = payload_width(ch) - GEOM - ch
    z = functools.partial(torch.zeros, dtype=colors.dtype, device=colors.device)
    return torch.cat([means2d, conics, opacities[:, None], z((n, GEOM - 6)),
                      colors, z((n, pad))], dim=1)


def _check_common(offsets, payload, bg, tx_n, ty_n, name):
    if offsets.dtype != torch.int32 or offsets.shape != (tx_n * ty_n + 1,):
        raise ValueError(f"offsets must be int32 [{tx_n * ty_n + 1}], got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    if bg.dtype != torch.float32 or bg.dim() != 1 or bg.shape[0] < 1:
        raise ValueError(f"bg must be float32 [CH], got {bg.dtype} {tuple(bg.shape)}")
    devices = {offsets.device, payload.device, bg.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    for n, t in (("offsets", offsets), (name, payload), ("bg", bg)):
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")


def _check(offsets, sorted_payload, bg, tx_n, ty_n, k_max):
    if k_max <= 0:
        raise ValueError(f"k_max must be positive, got {k_max}")
    _check_common(offsets, sorted_payload, bg, tx_n, ty_n, "sorted_payload")
    kernel_width(bg.shape[0])
    w = payload_width(bg.shape[0])
    if (sorted_payload.dtype != torch.float32 or sorted_payload.dim() != 2
            or sorted_payload.shape[1] != w or sorted_payload.shape[0] < k_max):
        raise ValueError(f"sorted_payload must be float32 [L+{k_max}, {w}], got "
                         f"{sorted_payload.dtype} {tuple(sorted_payload.shape)}")


def _check_packed(offsets, packed_payload, bg, tx_n, ty_n, k_max, g_block):
    """K3's inputs, checked alike on every device (alignment included)."""
    if g_block <= 0 or g_block % 2 or k_max <= 0:
        raise ValueError(f"g_block must be positive and even and k_max positive, got "
                         f"g_block {g_block}, k_max {k_max}")
    _check_common(offsets, packed_payload, bg, tx_n, ty_n, "packed_payload")
    if bg.shape[0] > PACKED_MAX_CH:
        raise ValueError(f"the packed payload holds at most {PACKED_MAX_CH} channels, "
                         f"got {bg.shape[0]}")
    rows = k_max // 2 + 2
    if (packed_payload.dtype != torch.float32 or packed_payload.dim() != 2
            or packed_payload.shape[1] != 2 * PACKED_HALF or packed_payload.shape[0] < rows):
        raise ValueError(f"packed_payload must be float32 [R ≥ {rows}, {2 * PACKED_HALF}], "
                         f"got {packed_payload.dtype} {tuple(packed_payload.shape)}")
    if packed_payload.data_ptr() % 16:
        raise ValueError("packed_payload must be 16-byte aligned for float4 loads")


def _pixel_centres(tiles: torch.Tensor, tx_n: int):
    """Centres (+0.5) of the tiles' 256 pixels in image coordinates: (px, py),
    each [C, 1, PX]."""
    pid = torch.arange(PX, device=tiles.device)
    px = ((tiles % tx_n)[:, None] * TILE + pid % TILE).float()[:, None] + 0.5
    py = ((tiles // tx_n)[:, None] * TILE + pid // TILE).float()[:, None] + 0.5
    return px, py


def _block_alpha(win, px, py, live):
    """One G-row block of a chunk of tiles, as both kernels compute it: payload
    rows win [C, G, W ≥ 6], pixel centres, and the rows the tile reads live [C, G].
    Returns (dx, dy, e^-sigma, raw = op·e^-sigma, alpha — clamped, and 0 where
    the cut fails — and the cut mask), each [C, G, PX]."""
    mu_x, mu_y = win[..., 0:1], win[..., 1:2]
    ca, cb, cc, op = win[..., 2:3], win[..., 3:4], win[..., 4:5], win[..., 5:6]
    dx = mu_x - px
    dy = mu_y - py
    sigma = _sigma(ca, cb, cc, dx, dy)
    expnegs = torch.exp(-sigma)
    raw = op * expnegs
    a = torch.clamp_max(raw, 0.999)
    valid = (sigma >= 0.0) & (a >= 1.0 / 255.0) & live[..., None]
    return dx, dy, expnegs, raw, torch.where(valid, a, 0.0), valid


def _sigma(ca, cb, cc, dx, dy):
    """sigma in the kernels' operation order, unfused (csrc/blend_common.cuh)."""
    return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy


def _warp_origins(footprint=WARP_FOOTPRINT):
    """(x, y) of each warp's first pixel in its tile, [8] each: warp w covers
    ``footprint`` = (fw, fh) pixels from x = fw·(w mod 16/fw), y = fh·(w div 16/fw)."""
    fw, fh = footprint
    w = torch.arange(PX // 32)
    return fw * (w % (TILE // fw)), fh * (w // (TILE // fw))


def warp_row_may_hit(rows: torch.Tensor, tiles: torch.Tensor, tx_n: int,
                     footprint=WARP_FOOTPRINT) -> torch.Tensor:
    """The kernels' row test (csrc/blend_common.cuh ``row_may_hit``), in its
    operation order: can any pixel centre of a warp's block pass the cut
    sigma ≥ 0, op·e^-sigma ≥ 1/255 for this row? rows [C, G, W ≥ 6] of tiles
    [C]; returns [C, G, 8] bool, one per warp. False only where no pixel can
    pass:
      - op < 1/255: alpha ≤ op everywhere;
      - otherwise a row whose conic is not positive definite or not finite, or
        whose opacity is not finite, is kept;
      - otherwise the minimum s of sigma over the block's rectangle of pixel
        centres (0 when mu lies inside; else the clamped 1-D minimum on the
        faces mu lies beyond) must exceed tau = ln(255·op) with margins:
        kappa = 4·CULL_GAMMA·ac/det bounds the relative rounding of sigma
        (|b dx dy| ≤ rho·Q, sigma ≥ (1-rho)·Q for Q = (a dx² + c dy²)/2 and
        rho = |b|/sqrt(ac), and (1+rho)/(1-rho) ≤ 4ac/det); kept if
        kappa ≥ 1/2 or s·(1 - kappa) ≤ tau + CULL_TAU_MARGIN, compared as
        s·(det - g) ≤ tau·det with g = 4·CULL_GAMMA·ac.
    The kernel divides for the 1-D minimum with ``__fdividef`` (≤ 2 ulp), so
    its s may differ from this one by a few ulp; both are exact."""
    dev = rows.device
    fw, fh = footprint
    ox, oy = (o.to(dev) for o in _warp_origins(footprint))
    fx0 = ((tiles % tx_n)[:, None] * TILE + ox[None, :]).float()[:, None, :] + 0.5
    fy0 = ((tiles // tx_n)[:, None] * TILE + oy[None, :]).float()[:, None, :] + 0.5
    fx1, fy1 = fx0 + (fw - 1), fy0 + (fh - 1)                        # [C, 1, 8]
    mu_x, mu_y = rows[..., 0:1], rows[..., 1:2]                       # [C, G, 1]
    ca, cb, cc, op = rows[..., 2:3], rows[..., 3:4], rows[..., 4:5], rows[..., 5:6]
    ac = ca * cc
    det = ac - cb * cb
    keep = ~((ca > 0) & (det > 0) & (ac <= CULL_BIG) & (op <= CULL_BIG))
    dx0, dx1, dy0, dy1 = mu_x - fx1, mu_x - fx0, mu_y - fy1, mu_y - fy0   # [C, G, 8]
    inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)
    ux = torch.where(dx0 > 0, dx0, dx1)
    uy = torch.where(dy0 > 0, dy0, dy1)
    vy = torch.fmin(torch.fmax((-cb * ux) / cc, dy0), dy1)
    vx = torch.fmin(torch.fmax((-cb * uy) / ca, dx0), dx1)
    s = torch.fmin(_sigma(ca, cb, cc, ux, vy), _sigma(ca, cb, cc, vx, uy))
    g = (4.0 * CULL_GAMMA) * ac
    tau = torch.log(op * 255.0) + CULL_TAU_MARGIN
    hit = ~(2.0 * g < det) | (s * (det - g) <= tau * det)
    return ~(op < ALPHA_MIN) & (keep | inside | hit)


def _per_warp(valid: torch.Tensor, footprint=WARP_FOOTPRINT) -> torch.Tensor:
    """[C, G, PX] per pixel → [C, G, 8]: any pixel of each warp's block."""
    fw, fh = footprint
    c, g = valid.shape[:2]
    v = valid.reshape(c, g, TILE // fh, fh, TILE // fw, fw)
    return v.any(5).any(3).reshape(c, g, PX // 32)


def _pair_weights(a, trans):
    """K1's compositing of one block: a [C, G, PX] alphas in depth order, trans
    [C, PX] the carried transmittance. Returns (weights [C, G, PX], the block's
    transmittance product [C, PX])."""
    cum = torch.cumprod(1.0 - a, dim=1)                            # T after row
    cum_before = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
    return a * trans[:, None, :] * cum_before, cum[:, -1]


def _couple_weights(a, trans):
    """K3's compositing of one block, in couples (pairs 2c, 2c + 1):
    T_couple = (1−αA)(1−αB), wA = αA·tA, wB = αB·tA·(1−αA) with tA the
    transmittance before the couple (blend_pallas2.py:105-111)."""
    c, g, px = a.shape
    a_a, a_b = a[:, 0::2], a[:, 1::2]
    cum = torch.cumprod((1.0 - a_a) * (1.0 - a_b), dim=1)
    cum_before = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
    t_a = trans[:, None, :] * cum_before
    w = torch.stack([a_a * t_a, a_b * t_a * (1.0 - a_a)], dim=2)  # [C, G/2, 2, PX]
    return w.reshape(c, g, px), cum[:, -1]


def _plain_forward(offsets, pairs, bg, tx_n: int, ty_n: int, k_max: int, G: int,
                   weights, work=None):
    """The forward blend of K1 and K3, chunked over tiles: per G-row block the
    rows a tile reads, their alphas, ``weights`` (``_pair_weights`` or
    ``_couple_weights``), the transmittance carried across blocks, and the
    early-out once every pixel's transmittance is below SAT_EPS.

    pairs [rows, W ≥ 8 + CH] holds one pair per row. Returns (img, alpha in
    image layout, rows_read, pixels_hit, tiles_stopped): the rows the blend
    reads, the pair-pixels of those rows that pass the cut, and the tiles that
    stop before their last row. With a dict ``work`` it also adds the
    warp-rows read, kept by ``warp_row_may_hit`` and hit (some pixel of the
    warp passes the cut) under "read", "kept" and "hit"; K3's lists test
    couples, so with ``_couple_weights`` a warp-row is a couple."""
    dev = pairs.device
    ch = bg.shape[0]
    num_tiles = tx_n * ty_n
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (G * PX))
    off = offsets.long()
    counts = torch.clamp_max(off[1:] - off[:-1], k_max)
    g = torch.arange(G, device=dev)
    last = pairs.shape[0] - 1           # rows past a tile's count are read clamped, unused
    img = torch.empty((num_tiles, PX, ch), dtype=torch.float32, device=dev)
    alpha = torch.empty((num_tiles, PX), dtype=torch.float32, device=dev)
    rows_read = torch.zeros((), dtype=torch.int64, device=dev)
    pixels_hit = torch.zeros((), dtype=torch.int64, device=dev)
    tiles_stopped = torch.zeros((), dtype=torch.int64, device=dev)

    for t0 in range(0, num_tiles, chunk):
        tiles = torch.arange(t0, min(t0 + chunk, num_tiles), device=dev)
        c = tiles.shape[0]
        start, cnt = off[tiles], counts[tiles]
        px, py = _pixel_centres(tiles, tx_n)
        acc = torch.zeros((c, PX, ch), dtype=torch.float32, device=dev)
        trans = torch.ones((c, PX), dtype=torch.float32, device=dev)
        done = torch.zeros((c,), dtype=torch.bool, device=dev)
        tile_rows = torch.zeros((c,), dtype=torch.int64, device=dev)
        for b in range(-(-k_max // G)):            # the last block partial where G ∤ K
            if bool(done.all()):
                break
            live = ((b * G + g)[None, :] < cnt[:, None]) & ~done[:, None]  # [C, G]
            tile_rows += live.sum(1)
            win = pairs[torch.clamp_max(start[:, None] + b * G + g[None, :], last)]  # [C, G, W]
            _, _, _, _, a, valid = _block_alpha(win, px, py, live)
            pixels_hit += valid.sum()
            if work is not None:
                _count_warp_rows(work, win, tiles, tx_n, live, valid,
                                 weights is _couple_weights)
            w, t_block = weights(a, trans)
            acc += torch.bmm(w.transpose(1, 2), win[..., GEOM:GEOM + ch])  # [C, PX, CH]
            trans = trans * t_block
            done |= ((b + 1) * G >= cnt) | (trans.amax(dim=1) < SAT_EPS)
        img[t0:t0 + c] = acc + trans[..., None] * bg
        alpha[t0:t0 + c] = 1.0 - trans
        rows_read += tile_rows.sum()
        tiles_stopped += (tile_rows < cnt).sum()

    img = img.reshape(ty_n, tx_n, TILE, TILE, ch).permute(0, 2, 1, 3, 4)
    alpha = alpha.reshape(ty_n, tx_n, TILE, TILE).permute(0, 2, 1, 3)
    return (img.reshape(ty_n * TILE, tx_n * TILE, ch),
            alpha.reshape(ty_n * TILE, tx_n * TILE),
            int(rows_read), int(pixels_hit), int(tiles_stopped))


def _count_warp_rows(work, win, tiles, tx_n, live, valid, couples: bool):
    kept = warp_row_may_hit(win, tiles, tx_n) & live[..., None]         # [C, G, 8]
    hit = _per_warp(valid)
    if couples:     # a couple is read where its first pair is
        live, kept, hit = live[:, 0::2], kept[:, 0::2] | kept[:, 1::2], hit[:, 0::2] | hit[:, 1::2]
    work["read"] += int(live.sum()) * (PX // 32)
    work["kept"] += int(kept.sum())
    work["hit"] += int(hit.sum())


def blend_tiles_warp_rows(offsets, sorted_payload, bg, tx_n: int, ty_n: int,
                          k_max: int) -> dict:
    """K1's row lists on these inputs, by its plain version: the warp-rows the
    blend reads (a warp-row is one row against one warp's 8×4 pixels, early-out
    included), those ``warp_row_may_hit`` keeps, and those where some pixel
    passes the cut. {"read", "kept", "hit"}; hit ≤ kept ≤ read."""
    _check(offsets, sorted_payload, bg, tx_n, ty_n, k_max)
    work = {"read": 0, "kept": 0, "hit": 0}
    _plain_forward(offsets, sorted_payload, bg, tx_n, ty_n, k_max, g_block(k_max),
                   _pair_weights, work)
    return work


def blend_tiles_plain_with_work(offsets, sorted_payload, bg, tx_n: int, ty_n: int,
                                k_max: int):
    """``blend_tiles_plain``, plus the work the kernel's bound counts on these
    inputs: the payload rows the blend reads (early-out included), and the
    pair-pixels of those rows that pass the sigma and alpha cut and so
    accumulate colour; and the tiles that stop early. Returns (img, alpha,
    rows_read, pixels_hit, tiles_stopped)."""
    _check(offsets, sorted_payload, bg, tx_n, ty_n, k_max)
    return _plain_forward(offsets, sorted_payload, bg, tx_n, ty_n, k_max,
                          g_block(k_max), _pair_weights)


def blend_tiles_plain(offsets, sorted_payload, bg, tx_n: int, ty_n: int, k_max: int):
    """Plain PyTorch version of the kernel, on any device: the same blockwise
    math as the TPU kernel (a G-row block's transmittance as a cumulative
    product, carried across blocks, with the block early-out), chunked over
    tiles so it fits on the card at 1080p.

    offsets [T+1] int32 run starts; sorted_payload [L+K, payload_width(CH)]
    float32 with ≥ K zero rows past the last run; bg [CH] float32. Returns
    (img [16·ty_n, 16·tx_n, CH], alpha [16·ty_n, 16·tx_n])."""
    return blend_tiles_plain_with_work(offsets, sorted_payload, bg, tx_n, ty_n, k_max)[:2]


@functools.cache
def _kernel_fn(name: str, n_ptrs: int, n_ints: int, entry: str = ""):
    """The C entry point ``segsplat_<name><entry>`` of ``csrc/<name>.cu``:
    ``n_ptrs`` pointers, ``n_ints`` ints, then the stream; returns a
    cudaError_t."""
    fn = getattr(cuda_build.load_library(name), f"segsplat_{name}{entry}")
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def forward_at_width(forward, offsets, payload, bg, tx_n: int, ty_n: int, k_max: int,
                     *rest, packed: bool = False):
    """Run ``forward`` (a kernel's launch; in the tests its plain version) at the
    width it is built for that holds bg's CH channels (``kernel_width``): bg
    zero-padded, K1's rows by ``pad_rows`` (K3's packed pairs hold 64 floats
    already, zero past the colours), the image cut back to CH. Returns (img,
    alpha)."""
    ch = bg.shape[0]
    width = kernel_width(ch, PACKED_WIDTHS if packed else KERNEL_WIDTHS)
    if width == ch:
        return forward(offsets, payload, bg, tx_n, ty_n, k_max, *rest)
    rows = payload if packed else pad_rows(payload, ch, width)
    img, alpha = forward(offsets, rows, _pad_last(bg, width), tx_n, ty_n, k_max, *rest)
    return img[..., :ch].contiguous(), alpha


def backward_at_width(backward, offsets, payload, bg, img, alpha, g_img, g_alpha,
                      tx_n: int, ty_n: int, k_max: int):
    """Run ``backward`` (K2's launch, or its plain version's d_payload) at the
    width K2 is built for that holds CH: bg, img and g_img zero-padded, the rows
    by ``pad_rows``, d_payload cut back to the caller's columns (0 past the
    colours, as K2 leaves them). A zero cotangent channel adds nothing to
    ⟨g, c⟩ or ⟨g, img⟩, so the real columns get the same gradient. Returns
    d_payload."""
    ch = bg.shape[0]
    width = kernel_width(ch)
    if width == ch:
        return backward(offsets, payload, bg, img, alpha, g_img, g_alpha, tx_n, ty_n, k_max)
    d_rows = backward(offsets, pad_rows(payload, ch, width), _pad_last(bg, width),
                      _pad_last(img, width), alpha, _pad_last(g_img, width), g_alpha,
                      tx_n, ty_n, k_max)
    return _pad_last(d_rows[:, :GEOM + ch], payload.shape[1])


def _launch_forward(name, offsets, payload, bg, tx_n, ty_n, k_max, g):
    """Launch the forward kernel of ``csrc/<name>.cu`` (K1 or K3) on CUDA
    tensors at bg's width, one it is built for; returns (img, alpha). Raises on
    a misaligned payload or a launch that CUDA refuses (an unbuilt width among
    them)."""
    dev = payload.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    ch = bg.shape[0]
    if payload.data_ptr() % 16:
        raise ValueError("the payload must be 16-byte aligned for float4 loads")
    fn = _kernel_fn(name, 5, 5)
    img = torch.empty((ty_n * TILE, tx_n * TILE, ch), dtype=torch.float32, device=dev)
    alpha = torch.empty((ty_n * TILE, tx_n * TILE), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(offsets.data_ptr(), payload.data_ptr(), bg.data_ptr(),
                 img.data_ptr(), alpha.data_ptr(), tx_n, ty_n, k_max, g, ch,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return img, alpha


def blend_tiles(offsets, sorted_payload, bg, tx_n: int, ty_n: int, k_max: int):
    """Blend all tiles (see ``blend_tiles_plain`` for the arguments and result).
    CUDA tensors launch the kernel, which counts in ``blend_tiles.launches``;
    CPU tensors run the plain version. Raises on anything else."""
    _check(offsets, sorted_payload, bg, tx_n, ty_n, k_max)
    if sorted_payload.device.type == "cpu":
        return blend_tiles_plain(offsets, sorted_payload, bg, tx_n, ty_n, k_max)
    out = forward_at_width(functools.partial(_launch_forward, "blend_fwd"), offsets,
                           sorted_payload, bg, tx_n, ty_n, k_max, g_block(k_max))
    blend_tiles.launches += 1
    return out


blend_tiles.launches = 0


def _check_indexed(offsets, ids, table, bg, tx_n, ty_n, k_max):
    if k_max <= 0:
        raise ValueError(f"k_max must be positive, got {k_max}")
    _check_common(offsets, table, bg, tx_n, ty_n, "table")
    kernel_width(bg.shape[0])
    w = payload_width(bg.shape[0])
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] != w:
        raise ValueError(f"table must be float32 [N, {w}], got {table.dtype} "
                         f"{tuple(table.shape)}")
    if ids.dtype != torch.int64 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError(f"ids must be contiguous int64 [L], got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    if ids.device != table.device:
        raise ValueError(f"ids are on {ids.device}, the table on {table.device}")


def blend_tiles_indexed_plain(offsets, ids, table, bg, tx_n: int, ty_n: int, k_max: int):
    """``blend_tiles_indexed`` on any device: the rows gathered by the ids,
    with K zero rows appended, through ``blend_tiles_plain``."""
    rows = torch.nn.functional.pad(table[ids], (0, 0, 0, k_max))
    return blend_tiles_plain(offsets, rows, bg, tx_n, ty_n, k_max)


def _launch_indexed(offsets, table, bg, tx_n, ty_n, k_max, ids):
    """Launch K1's indexed variant on CUDA tensors at bg's width, one it is
    built for; returns (img, alpha)."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"blend_fwd runs on cuda or cpu tensors, got {dev}")
    if table.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned for its rows' bulk copies")
    ch = bg.shape[0]
    fn = _kernel_fn("blend_fwd", 6, 5, "_indexed")
    img = torch.empty((ty_n * TILE, tx_n * TILE, ch), dtype=torch.float32, device=dev)
    alpha = torch.empty((ty_n * TILE, tx_n * TILE), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(offsets.data_ptr(), ids.data_ptr(), table.data_ptr(), bg.data_ptr(),
                 img.data_ptr(), alpha.data_ptr(), tx_n, ty_n, k_max, g_block(k_max), ch,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blend_fwd (indexed) kernel launch failed: cudaError {err}")
    return img, alpha


def blend_tiles_indexed(offsets, ids, table, bg, tx_n: int, ty_n: int, k_max: int):
    """K1 on rows it fetches through their ids, with no gathered payload:
    tile t blends table[ids[offsets[t] + i]] for i < min(count_t, K), which
    is ``blend_tiles`` on the payload ``table[ids]`` (K zero rows appended),
    bit for bit. table [N, payload_width(CH)] float32 (``make_payload``'s
    rows), ids int64 [L ≥ offsets[-1]], every id a tile reads in [0, N) (not
    checked: that would wait for the card); the rest as ``blend_tiles_plain``.

    CUDA tensors launch K1's indexed variant (``segsplat_blend_fwd_indexed``)
    on the current stream, which counts in ``blend_tiles_indexed.launches``
    (not in ``blend_tiles.launches``); CPU tensors run ``blend_tiles_indexed_plain``. Not differentiable: the
    rasterizer takes it only where nothing needs a gradient."""
    _check_indexed(offsets, ids, table, bg, tx_n, ty_n, k_max)
    if table.device.type == "cpu":
        return blend_tiles_indexed_plain(offsets, ids, table, bg, tx_n, ty_n, k_max)
    out = forward_at_width(_launch_indexed, offsets, table, bg, tx_n, ty_n, k_max, ids)
    blend_tiles_indexed.launches += 1
    return out


blend_tiles_indexed.launches = 0


# ─────────────────────────── packed forward: kernel K3 ───────────────────────────

def pack_payload(rows: torch.Tensor, k_max: int) -> torch.Tensor:
    """K3's packed payload from depth-sorted pair rows [L, W ≤ 64] in
    ``make_payload``'s layout, without K1's K-row tail: each row padded to 64
    floats, K + 4 + (L + K + 4) % 2 zero rows appended (an even total, as
    segsplat_tpu/ops/rasterize.py:431-439 pads), two consecutive pairs per
    128-float row. Returns [R, 128]."""
    n, w = rows.shape
    if w > PACKED_HALF:
        raise ValueError(f"the packed payload holds at most {PACKED_MAX_CH} channels "
                         f"(rows of ≤ {PACKED_HALF} floats), got rows of {w}")
    pad = k_max + 4 + (n + k_max + 4) % 2
    packed = torch.nn.functional.pad(rows, (0, PACKED_HALF - w, 0, pad))
    return packed.reshape(-1, 2 * PACKED_HALF)


def blend_tiles_packed_plain_with_work(offsets, packed_payload, bg, tx_n: int,
                                       ty_n: int, k_max: int, g_block: int = 128):
    """Plain PyTorch version of kernel K3, on any device, with its work as
    ``blend_tiles_plain_with_work`` counts it (pairs read, pair-pixels passing
    the cut, tiles that stop early). The packed rows are read as [2R, 64] pair
    rows, so the run start's parity needs no case. Returns (img, alpha,
    rows_read, pixels_hit, tiles_stopped)."""
    _check_packed(offsets, packed_payload, bg, tx_n, ty_n, k_max, g_block)
    return _plain_forward(offsets, packed_payload.view(-1, PACKED_HALF), bg, tx_n, ty_n,
                          k_max, g_block, _couple_weights)


def blend_tiles_packed_warp_rows(offsets, packed_payload, bg, tx_n: int, ty_n: int,
                                 k_max: int, g_block: int = 128) -> dict:
    """K3's row lists on these inputs (as ``blend_tiles_warp_rows``; a
    warp-row is one couple against one warp's pixels, kept where the test
    keeps either pair)."""
    _check_packed(offsets, packed_payload, bg, tx_n, ty_n, k_max, g_block)
    work = {"read": 0, "kept": 0, "hit": 0}
    _plain_forward(offsets, packed_payload.view(-1, PACKED_HALF), bg, tx_n, ty_n, k_max,
                   g_block, _couple_weights, work)
    return work


def blend_tiles_packed_plain(offsets, packed_payload, bg, tx_n: int, ty_n: int,
                             k_max: int, g_block: int = 128):
    """Plain PyTorch version of kernel K3. offsets [T+1] int32 pair offsets;
    packed_payload [R, 128] float32 from ``pack_payload``; bg [CH ≤ 56].
    Returns (img [16·ty_n, 16·tx_n, CH], alpha [16·ty_n, 16·tx_n])."""
    return blend_tiles_packed_plain_with_work(offsets, packed_payload, bg, tx_n, ty_n,
                                              k_max, g_block)[:2]


@torch.library.custom_op("segsplat_torch::blend_packed", mutates_args=())
def blend_tiles_packed(offsets: torch.Tensor, packed_payload: torch.Tensor, bg: torch.Tensor,
                       tx_n: int, ty_n: int, k_max: int,
                       g_block: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed blend (arguments as ``blend_tiles_packed_plain``), registered
    as the op ``segsplat_torch::blend_packed``. CUDA tensors launch kernel K3,
    which counts in ``blend_tiles_packed.launches``; CPU tensors run the plain
    version. Raises on anything else. No backward."""
    _check_packed(offsets, packed_payload, bg, tx_n, ty_n, k_max, g_block)
    if packed_payload.device.type == "cpu":
        return blend_tiles_packed_plain(offsets, packed_payload, bg, tx_n, ty_n, k_max,
                                        g_block)
    out = forward_at_width(functools.partial(_launch_forward, "blend_packed"), offsets,
                           packed_payload, bg, tx_n, ty_n, k_max, g_block, packed=True)
    blend_tiles_packed.launches += 1
    return out


@blend_tiles_packed.register_fake
def _(offsets, packed_payload, bg, tx_n, ty_n, k_max, g_block=128):
    hw = (ty_n * TILE, tx_n * TILE)
    return packed_payload.new_empty(hw + (bg.shape[0],)), packed_payload.new_empty(hw)


blend_tiles_packed.launches = 0


# ───────────────────────────── backward: kernel K2 ─────────────────────────────

def _to_tiles(x: torch.Tensor, tx_n: int, ty_n: int) -> torch.Tensor:
    """[16·ty_n, 16·tx_n, ...] image layout → [T, 256, ...] tile layout."""
    rest = x.shape[2:]
    x = x.reshape(ty_n, TILE, tx_n, TILE, *rest).transpose(1, 2)
    return x.reshape(tx_n * ty_n, PX, *rest)


def _check_bwd(offsets, sorted_payload, bg, img, alpha, g_img, g_alpha,
               tx_n, ty_n, k_max):
    _check(offsets, sorted_payload, bg, tx_n, ty_n, k_max)
    hw = (ty_n * TILE, tx_n * TILE)
    for name, t, shape in (("img", img, hw + bg.shape), ("g_img", g_img, hw + bg.shape),
                           ("alpha", alpha, hw), ("g_alpha", g_alpha, hw)):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != sorted_payload.device:
            raise ValueError(f"{name} is on {t.device}, the payload on "
                             f"{sorted_payload.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _d_bg(alpha, g_img):
    """d bg = Σ_px T_fin · g_img, a plain reduction (XLA's on the TPU too), as
    one vector-matrix product that reads g_img once."""
    return (1.0 - alpha).reshape(-1) @ g_img.reshape(-1, g_img.shape[-1])


def blend_tiles_bwd_plain_with_work(offsets, sorted_payload, bg, img, alpha,
                                    g_img, g_alpha, tx_n: int, ty_n: int, k_max: int):
    """Plain PyTorch version of kernel K2, on any device: the TPU kernel's
    blockwise math (G-row blocks, the transmittance as a cumulative product
    and the ⟨g, c⟩ prefix as a cumulative sum, both carried across blocks), with
    no early-out, chunked over tiles. Also counts the work K2's bound needs on
    these inputs: rows read (every row up to each tile's count) and the
    pair-pixels of those rows that pass the sigma and alpha cut.

    img, alpha are the forward's outputs and g_img, g_alpha their cotangents,
    all in image layout. Returns (d_payload [L+K, W] with zeros in rows no tile
    owns, d_bg [CH], rows_read, pixels_hit)."""
    _check_bwd(offsets, sorted_payload, bg, img, alpha, g_img, g_alpha,
               tx_n, ty_n, k_max)
    dev = sorted_payload.device
    ch = bg.shape[0]
    num_tiles = tx_n * ty_n
    G = g_block(k_max)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (4 * G * PX))
    off = offsets.long()
    counts = torch.clamp_max(off[1:] - off[:-1], k_max)
    g = torch.arange(G, device=dev)
    last = sorted_payload.shape[0] - 1
    img_t, g_img_t = _to_tiles(img, tx_n, ty_n), _to_tiles(g_img, tx_n, ty_n)
    t_fin_t = 1.0 - _to_tiles(alpha, tx_n, ty_n)
    g_alpha_t = _to_tiles(g_alpha, tx_n, ty_n)
    d_payload = torch.zeros_like(sorted_payload)
    rows_read = torch.zeros((), dtype=torch.int64, device=dev)
    pixels_hit = torch.zeros((), dtype=torch.int64, device=dev)

    for t0 in range(0, num_tiles, chunk):
        tiles = torch.arange(t0, min(t0 + chunk, num_tiles), device=dev)
        c = tiles.shape[0]
        start, cnt = off[tiles], counts[tiles]
        px, py = _pixel_centres(tiles, tx_n)
        gi = g_img_t[t0:t0 + c]                                        # [C, PX, CH]
        t_fin = t_fin_t[t0:t0 + c]                                     # [C, PX]
        g_bg = gi @ bg                                                 # ⟨g, bg⟩
        g_c_tot = (gi * img_t[t0:t0 + c]).sum(-1) - t_fin * g_bg       # ⟨g, Σ w c⟩
        g_suffix_const = t_fin * g_bg - g_alpha_t[t0:t0 + c] * t_fin
        trans = torch.ones((c, PX), dtype=torch.float32, device=dev)
        gpref = torch.zeros((c, PX), dtype=torch.float32, device=dev)
        for b in range(-(-k_max // G)):            # the last block partial where G ∤ K
            live_row = (b * G + g)[None, :] < cnt[:, None]             # [C, G]
            if not bool(live_row.any()):
                break
            rows_read += live_row.sum()
            idx = torch.clamp_max(start[:, None] + b * G + g[None, :], last)
            win = sorted_payload[idx]                                  # [C, G, W]
            dx, dy, expnegs, raw, a, valid = _block_alpha(win, px, py, live_row)
            ca, cb, cc = win[..., 2:3], win[..., 3:4], win[..., 4:5]
            pixels_hit += valid.sum()
            one_minus = 1.0 - a
            cum = torch.cumprod(one_minus, dim=1)
            cum_before = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
            t_before = trans[:, None, :] * cum_before
            w = a * t_before
            gc = torch.bmm(win[..., GEOM:GEOM + ch], gi.transpose(1, 2))  # ⟨g, c_k⟩
            pref_in = torch.cumsum(w * gc, dim=1)
            g_c_rest = g_c_tot[:, None, :] - (gpref[:, None, :] + pref_in)
            dalpha = t_before * gc - (g_c_rest + g_suffix_const[:, None, :]) / one_minus
            draw = torch.where(valid & (raw < 0.999), dalpha, 0.0)
            dsig = -draw * raw
            drow = torch.zeros((c, G, sorted_payload.shape[1]), dtype=torch.float32,
                               device=dev)
            drow[..., 0] = (dsig * (ca * dx + cb * dy)).sum(-1)
            drow[..., 1] = (dsig * (cc * dy + cb * dx)).sum(-1)
            drow[..., 2] = 0.5 * (dsig * dx * dx).sum(-1)
            drow[..., 3] = (dsig * dx * dy).sum(-1)
            drow[..., 4] = 0.5 * (dsig * dy * dy).sum(-1)
            drow[..., 5] = (draw * expnegs).sum(-1)
            drow[..., GEOM:GEOM + ch] = torch.bmm(w, gi)
            d_payload[idx[live_row]] = drow[live_row]                  # owned rows only
            trans = trans * cum[:, -1]
            gpref = gpref + pref_in[:, -1]

    return d_payload, _d_bg(alpha, g_img), int(rows_read), int(pixels_hit)


def blend_tiles_bwd_plain(offsets, sorted_payload, bg, img, alpha, g_img, g_alpha,
                          tx_n: int, ty_n: int, k_max: int):
    """Plain PyTorch version of K2 (see ``blend_tiles_bwd_plain_with_work``).
    Returns (d_payload, d_bg)."""
    d_payload, d_bg, _, _ = blend_tiles_bwd_plain_with_work(
        offsets, sorted_payload, bg, img, alpha, g_img, g_alpha, tx_n, ty_n, k_max)
    return d_payload, d_bg


def blend_tiles_bwd(offsets, sorted_payload, bg, img, alpha, g_img, g_alpha,
                    tx_n: int, ty_n: int, k_max: int):
    """Backward of ``blend_tiles`` (arguments as ``blend_tiles_bwd_plain_with_work``).
    CUDA tensors launch kernel K2, which counts in ``blend_tiles_bwd.launches``;
    CPU tensors run the plain version. Raises on anything else, and when CUDA
    refuses the kernel's dynamic shared memory or its launch.
    Returns (d_payload, d_bg)."""
    _check_bwd(offsets, sorted_payload, bg, img, alpha, g_img, g_alpha,
               tx_n, ty_n, k_max)
    dev = sorted_payload.device
    if dev.type == "cpu":
        return blend_tiles_bwd_plain(offsets, sorted_payload, bg, img, alpha,
                                     g_img, g_alpha, tx_n, ty_n, k_max)
    if dev.type != "cuda":
        raise ValueError(f"blend_tiles_bwd runs on cuda or cpu tensors, got {dev}")
    d_payload = backward_at_width(_launch_backward, offsets, sorted_payload, bg, img, alpha,
                                  g_img, g_alpha, tx_n, ty_n, k_max)
    blend_tiles_bwd.launches += 1
    return d_payload, _d_bg(alpha, g_img)


blend_tiles_bwd.launches = 0


def _launch_backward(offsets, sorted_payload, bg, img, alpha, g_img, g_alpha,
                     tx_n, ty_n, k_max):
    """Launch K2 on CUDA tensors at bg's width, one it is built for; returns
    d_payload. Raises on a misaligned payload or a launch CUDA refuses."""
    if sorted_payload.data_ptr() % 16:
        raise ValueError("sorted_payload must be 16-byte aligned for float4 loads")
    # the kernel reads img and g_img as float4s: a view that starts off a
    # 16-byte boundary is copied to one that does not
    img, g_img = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (img, g_img))
    fn = _kernel_fn("blend_bwd", 8, 4)
    d_payload = torch.zeros_like(sorted_payload)     # rows no tile owns stay 0
    dev = sorted_payload.device
    with torch.cuda.device(dev):
        err = fn(offsets.data_ptr(), sorted_payload.data_ptr(), bg.data_ptr(),
                 img.data_ptr(), alpha.data_ptr(), g_img.data_ptr(), g_alpha.data_ptr(),
                 d_payload.data_ptr(), tx_n, ty_n, k_max, bg.shape[0],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blend_bwd kernel launch failed: cudaError {err}")
    return d_payload


def blend_tiles_bwd_occupancy(ch: int) -> tuple[int, int]:
    """Kernel K2's occupancy on the current card at ``ch`` channels: (blocks of
    256 threads an SM holds at once, dynamic shared memory bytes per block), as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives them."""
    fn = cuda_build.load_library("blend_bwd").segsplat_blend_bwd_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    err = fn(ch, ctypes.byref(blocks), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"blend_bwd occupancy query failed: cudaError {err}")
    return blocks.value, smem.value


def blend_forward_occupancy(name: str, ch: int, entry: str = "") -> dict:
    """Occupancy of the forward kernel ``csrc/<name>.cu`` (``blend_fwd``, K1, or
    ``blend_packed``, K3; ``entry`` ``"_indexed"``: K1's indexed variant) at
    ``ch`` channels on the current card: blocks of 256 threads an SM holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), static shared
    memory per block, registers and local (spill) bytes per thread
    (``cudaFuncGetAttributes``)."""
    fn = getattr(cuda_build.load_library(name), f"segsplat_{name}{entry}_occupancy")
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(4)]
    err = fn(ch, *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"{name} occupancy query failed: cudaError {err}")
    return dict(zip(("blocks_per_sm", "smem_bytes", "registers", "local_bytes"),
                    (v.value for v in vals)))


# ───────────────────────── K1 and K2 as registered ops ─────────────────────────
#
# K1, K2 and K3 are operators of the namespace ``segsplat_torch``, so that
# ``torch.compile`` and ``torch.export`` keep each blend as one opaque node:
# the frame around it compiles whole, and its kernel launches at run time (K3's
# op is ``blend_tiles_packed`` itself, above). The implementations of K1's and
# K2's ops call the module's wrappers by their global names when they run
# (``blend_tiles``, ``blend_tiles_bwd``), so a caller that swaps the module
# attribute (the plain version for a reference step) swaps what the op runs,
# and ``blend`` stays differentiable through it; the wrappers' checks, device
# dispatch and launch counts stay where they are. The fake implementations
# give only the shapes and dtypes of the outputs.


@torch.library.custom_op("segsplat_torch::blend_fwd", mutates_args=())
def blend_fwd_op(offsets: torch.Tensor, sorted_payload: torch.Tensor, bg: torch.Tensor,
                 tx_n: int, ty_n: int, k_max: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``blend_tiles`` as one op: (img [16·ty_n, 16·tx_n, CH], alpha)."""
    return blend_tiles(offsets, sorted_payload, bg, tx_n, ty_n, k_max)


@blend_fwd_op.register_fake
def _(offsets, sorted_payload, bg, tx_n, ty_n, k_max):
    hw = (ty_n * TILE, tx_n * TILE)
    return sorted_payload.new_empty(hw + (bg.shape[0],)), sorted_payload.new_empty(hw)


@torch.library.custom_op("segsplat_torch::blend_bwd", mutates_args=())
def blend_bwd_op(offsets: torch.Tensor, sorted_payload: torch.Tensor, bg: torch.Tensor,
                 img: torch.Tensor, alpha: torch.Tensor, g_img: torch.Tensor,
                 g_alpha: torch.Tensor, tx_n: int, ty_n: int,
                 k_max: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``blend_tiles_bwd`` as one op: (d_payload shaped like sorted_payload, d_bg [CH])."""
    return blend_tiles_bwd(offsets, sorted_payload, bg, img, alpha, g_img, g_alpha,
                           tx_n, ty_n, k_max)


@blend_bwd_op.register_fake
def _(offsets, sorted_payload, bg, img, alpha, g_img, g_alpha, tx_n, ty_n, k_max):
    return torch.empty_like(sorted_payload), bg.new_empty(bg.shape)


def _blend_setup_context(ctx, inputs, output):
    """The residuals of K1's op are its inputs and outputs only, as the TPU
    package's ``blend_core`` custom VJP keeps (blend_pallas_vjp.py:267-311)."""
    offsets, sorted_payload, bg, tx_n, ty_n, k_max = inputs
    ctx.save_for_backward(offsets, sorted_payload, bg, *output)
    ctx.dims = (tx_n, ty_n, k_max)


@torch.autograd.function.once_differentiable
def _blend_backward(ctx, g_img, g_alpha):
    """K2's op on the forward's residuals and cotangents."""
    offsets, sorted_payload, bg, img, alpha = ctx.saved_tensors
    d_payload, d_bg = torch.ops.segsplat_torch.blend_bwd(
        offsets, sorted_payload, bg, img, alpha, g_img.contiguous(), g_alpha.contiguous(),
        *ctx.dims)
    return None, d_payload, d_bg, None, None, None


blend_fwd_op.register_autograd(_blend_backward, setup_context=_blend_setup_context)


def blend(offsets, sorted_payload, bg, tx_n: int, ty_n: int, k_max: int):
    """Differentiable ``blend_tiles``: gradients flow to ``sorted_payload`` and
    ``bg`` through kernel K2 (its plain version on CPU tensors)."""
    return torch.ops.segsplat_torch.blend_fwd(offsets, sorted_payload, bg, tx_n, ty_n, k_max)

