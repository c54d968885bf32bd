"""Tile blend: kernels K1 (forward) and K2 (backward) of the port, their plain
PyTorch versions, and the autograd Function that joins them.

``blend_tiles`` composites every 16×16 tile against its depth-sorted pair
payload run. On a CUDA tensor it launches the hand-written kernel
``segsplat_tpu_torch/csrc/blend_fwd.cu`` (built with nvcc for sm_90a, bound with
ctypes) or raises; on a CPU tensor it runs ``blend_tiles_plain``.
``blend_tiles_bwd`` is its backward: ``csrc/blend_bwd.cu`` on CUDA tensors,
``blend_tiles_bwd_plain`` on CPU tensors. ``blend`` is the differentiable blend
(``torch.autograd.Function``) that training renders through.

K1 replaces the TPU kernel ``segsplat_tpu/ops/blend_pallas.py:188``
``blend_tiles_pallas_dma``. Its semantics are kept exactly: pixel centres at
+0.5, sigma ≥ 0 and 1/255 ≤ alpha ≤ 0.999, a per-tile cap of K rows, and the
early-out at G-row block boundaries (G = 256 if K % 256 == 0, else 128) once
every pixel's transmittance is below 1e-4. Its layout is not: a payload row is
``[mu_x, mu_y, conic a, b, c, opacity, 0, 0, CH colours]`` padded to a multiple
of 4 floats (16-byte loads) instead of the TPU's 128 lanes, and the K zero rows
past the end stay.

K2 replaces ``segsplat_tpu/ops/blend_pallas_vjp.py:195`` ``_blend_bwd_pallas``:
per-pair gradients from the forward outputs and their cotangents, with alpha
recomputed for every row up to the tile's count — no early-out, so rows behind
a block where the forward stopped get the gradient of the exact compositing, as
on the TPU. d_payload rows that no tile owns (past a tile's K cap, the K-row
tail) are zero.

Bound on the card (K1): every pair-pixel of a row read costs about 15 fp32
operations (one exp among them), and one that passes the cut another 2·CH + 3;
the payload is read once per pair and the image written once. Which of the two
bounds it depends on the share of pair-pixels that pass the cut. K2's bound is
reckoned the same way (``blend_bwd.cu`` has its counts).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from segsplat_tpu_torch.utils import cuda_build

TILE = 16
PX = TILE * TILE
GEOM = 8              # payload prefix: mu_x, mu_y, conic a/b/c, opacity, 0, 0
SAT_EPS = 1e-4        # a tile stops once every pixel's transmittance is below this
KERNEL_CHANNELS = (19, 32)      # channel counts both kernels are built for
_PLAIN_CHUNK_ELEMS = 1 << 24    # [tiles, G, 256] elements per plain-version chunk


def payload_width(ch: int) -> int:
    """Floats per payload row for ``ch`` colour channels."""
    return -(-(GEOM + ch) // 4) * 4


def g_block(k_max: int) -> int:
    """Rows per early-out block, as the TPU kernel picks it."""
    return 256 if k_max % 256 == 0 else 128


def make_payload(means2d: torch.Tensor, conics: torch.Tensor,
                 opacities: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian payload rows [N, payload_width(CH)] in the kernel's layout."""
    n, ch = colors.shape
    pad = payload_width(ch) - GEOM - ch
    z = functools.partial(torch.zeros, dtype=colors.dtype, device=colors.device)
    return torch.cat([means2d, conics, opacities[:, None], z((n, GEOM - 6)),
                      colors, z((n, pad))], dim=1)


def _check(offsets, sorted_payload, bg, tx_n, ty_n, k_max):
    ch = bg.shape[0] if bg.dim() == 1 else -1
    if k_max <= 0 or k_max % 128:
        raise ValueError(f"k_max must be a positive multiple of 128, got {k_max}")
    if offsets.dtype != torch.int32 or offsets.shape != (tx_n * ty_n + 1,):
        raise ValueError(f"offsets must be int32 [{tx_n * ty_n + 1}], got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    if bg.dtype != torch.float32 or ch < 1:
        raise ValueError(f"bg must be float32 [CH], got {bg.dtype} {tuple(bg.shape)}")
    if (sorted_payload.dtype != torch.float32 or sorted_payload.dim() != 2
            or sorted_payload.shape[1] != payload_width(ch)
            or sorted_payload.shape[0] < k_max):
        raise ValueError(f"sorted_payload must be float32 [L+{k_max}, "
                         f"{payload_width(ch)}], got {sorted_payload.dtype} "
                         f"{tuple(sorted_payload.shape)}")
    devices = {offsets.device, sorted_payload.device, bg.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    for name, t in (("offsets", offsets), ("sorted_payload", sorted_payload), ("bg", bg)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _pixel_centres(tiles: torch.Tensor, tx_n: int):
    """Centres (+0.5) of the tiles' 256 pixels in image coordinates: (px, py),
    each [C, 1, PX]."""
    pid = torch.arange(PX, device=tiles.device)
    px = ((tiles % tx_n)[:, None] * TILE + pid % TILE).float()[:, None] + 0.5
    py = ((tiles // tx_n)[:, None] * TILE + pid // TILE).float()[:, None] + 0.5
    return px, py


def _block_alpha(win, px, py, live):
    """One G-row block of a chunk of tiles, as both kernels compute it: payload
    rows win [C, G, W], pixel centres, and the rows the tile reads live [C, G].
    Returns (dx, dy, e^-sigma, raw = op·e^-sigma, alpha — clamped, and 0 where
    the cut fails — and the cut mask), each [C, G, PX]."""
    mu_x, mu_y = win[..., 0:1], win[..., 1:2]
    ca, cb, cc, op = win[..., 2:3], win[..., 3:4], win[..., 4:5], win[..., 5:6]
    dx = mu_x - px
    dy = mu_y - py
    # the kernels compute sigma in this operation order, unfused
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    expnegs = torch.exp(-sigma)
    raw = op * expnegs
    a = torch.clamp_max(raw, 0.999)
    valid = (sigma >= 0.0) & (a >= 1.0 / 255.0) & live[..., None]
    return dx, dy, expnegs, raw, torch.where(valid, a, 0.0), valid


def blend_tiles_plain_with_work(offsets, sorted_payload, bg, tx_n: int, ty_n: int,
                                k_max: int):
    """``blend_tiles_plain``, plus the work the kernel's bound counts on these
    inputs: the payload rows the blend reads (early-out included), and the
    pair-pixels of those rows that pass the sigma and alpha cut and so
    accumulate colour. Returns (img, alpha, rows_read, pixels_hit)."""
    _check(offsets, sorted_payload, bg, tx_n, ty_n, k_max)
    dev = sorted_payload.device
    ch = bg.shape[0]
    num_tiles = tx_n * ty_n
    G = g_block(k_max)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (G * PX))
    off = offsets.long()
    counts = torch.clamp_max(off[1:] - off[:-1], k_max)
    g = torch.arange(G, device=dev)
    img = torch.empty((num_tiles, PX, ch), dtype=torch.float32, device=dev)
    alpha = torch.empty((num_tiles, PX), dtype=torch.float32, device=dev)
    rows_read = torch.zeros((), dtype=torch.int64, device=dev)
    pixels_hit = torch.zeros((), dtype=torch.int64, device=dev)

    for t0 in range(0, num_tiles, chunk):
        tiles = torch.arange(t0, min(t0 + chunk, num_tiles), device=dev)
        c = tiles.shape[0]
        start, cnt = off[tiles], counts[tiles]
        px, py = _pixel_centres(tiles, tx_n)
        acc = torch.zeros((c, PX, ch), dtype=torch.float32, device=dev)
        trans = torch.ones((c, PX), dtype=torch.float32, device=dev)
        done = torch.zeros((c,), dtype=torch.bool, device=dev)
        for b in range(k_max // G):
            if bool(done.all()):
                break
            live = ((b * G + g)[None, :] < cnt[:, None]) & ~done[:, None]  # [C, G]
            rows_read += live.sum()
            win = sorted_payload[start[:, None] + b * G + g[None, :]]      # [C, G, W]
            _, _, _, _, a, valid = _block_alpha(win, px, py, live)
            pixels_hit += valid.sum()
            cum = torch.cumprod(1.0 - a, dim=1)                            # T after row
            cum_before = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
            w = a * trans[:, None, :] * cum_before
            acc += torch.bmm(w.transpose(1, 2), win[..., GEOM:GEOM + ch])  # [C, PX, CH]
            trans = trans * cum[:, -1]
            done |= ((b + 1) * G >= cnt) | (trans.amax(dim=1) < SAT_EPS)
        img[t0:t0 + c] = acc + trans[..., None] * bg
        alpha[t0:t0 + c] = 1.0 - trans

    img = img.reshape(ty_n, tx_n, TILE, TILE, ch).permute(0, 2, 1, 3, 4)
    alpha = alpha.reshape(ty_n, tx_n, TILE, TILE).permute(0, 2, 1, 3)
    return (img.reshape(ty_n * TILE, tx_n * TILE, ch),
            alpha.reshape(ty_n * TILE, tx_n * TILE), int(rows_read), int(pixels_hit))


def blend_tiles_plain(offsets, sorted_payload, bg, tx_n: int, ty_n: int, k_max: int):
    """Plain PyTorch version of the kernel, on any device: the same blockwise
    math as the TPU kernel (a G-row block's transmittance as a cumulative
    product, carried across blocks, with the block early-out), chunked over
    tiles so it fits on the card at 1080p.

    offsets [T+1] int32 run starts; sorted_payload [L+K, payload_width(CH)]
    float32 with ≥ K zero rows past the last run; bg [CH] float32. Returns
    (img [16·ty_n, 16·tx_n, CH], alpha [16·ty_n, 16·tx_n])."""
    img, alpha, _, _ = blend_tiles_plain_with_work(offsets, sorted_payload, bg,
                                                   tx_n, ty_n, k_max)
    return img, alpha


@functools.cache
def _kernel_fn():
    fn = cuda_build.load_library("blend_fwd").segsplat_blend_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def blend_tiles(offsets, sorted_payload, bg, tx_n: int, ty_n: int, k_max: int):
    """Blend all tiles (see ``blend_tiles_plain`` for the arguments and result).
    CUDA tensors launch the kernel, which counts in ``blend_tiles.launches``;
    CPU tensors run the plain version. Raises on anything else."""
    _check(offsets, sorted_payload, bg, tx_n, ty_n, k_max)
    dev = sorted_payload.device
    if dev.type == "cpu":
        return blend_tiles_plain(offsets, sorted_payload, bg, tx_n, ty_n, k_max)
    if dev.type != "cuda":
        raise ValueError(f"blend_tiles runs on cuda or cpu tensors, got {dev}")
    ch = bg.shape[0]
    if ch not in KERNEL_CHANNELS:
        raise ValueError(f"the CUDA blend is built for CH in {KERNEL_CHANNELS}, got {ch}")
    if sorted_payload.data_ptr() % 16:
        raise ValueError("sorted_payload must be 16-byte aligned for float4 loads")
    fn = _kernel_fn()
    img = torch.empty((ty_n * TILE, tx_n * TILE, ch), dtype=torch.float32, device=dev)
    alpha = torch.empty((ty_n * TILE, tx_n * TILE), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(offsets.data_ptr(), sorted_payload.data_ptr(), bg.data_ptr(),
                 img.data_ptr(), alpha.data_ptr(), tx_n, ty_n, k_max,
                 g_block(k_max), ch, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed: cudaError {err}")
    blend_tiles.launches += 1
    return img, alpha


blend_tiles.launches = 0


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
    """d bg = Σ_px T_fin · g_img, a plain reduction (XLA's on the TPU too)."""
    return ((1.0 - alpha)[..., None] * g_img).sum((0, 1))


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
        for b in range(k_max // G):
            live_row = (b * G + g)[None, :] < cnt[:, None]             # [C, G]
            if not bool(live_row.any()):
                break
            rows_read += live_row.sum()
            idx = start[:, None] + b * G + g[None, :]
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


@functools.cache
def _bwd_kernel_fn():
    fn = cuda_build.load_library("blend_bwd").segsplat_blend_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def blend_tiles_bwd(offsets, sorted_payload, bg, img, alpha, g_img, g_alpha,
                    tx_n: int, ty_n: int, k_max: int):
    """Backward of ``blend_tiles`` (arguments as ``blend_tiles_bwd_plain_with_work``).
    CUDA tensors launch kernel K2, which counts in ``blend_tiles_bwd.launches``;
    CPU tensors run the plain version. Raises on anything else.
    Returns (d_payload, d_bg)."""
    _check_bwd(offsets, sorted_payload, bg, img, alpha, g_img, g_alpha,
               tx_n, ty_n, k_max)
    dev = sorted_payload.device
    if dev.type == "cpu":
        return blend_tiles_bwd_plain(offsets, sorted_payload, bg, img, alpha,
                                     g_img, g_alpha, tx_n, ty_n, k_max)
    if dev.type != "cuda":
        raise ValueError(f"blend_tiles_bwd runs on cuda or cpu tensors, got {dev}")
    ch = bg.shape[0]
    if ch not in KERNEL_CHANNELS:
        raise ValueError(f"the CUDA blend is built for CH in {KERNEL_CHANNELS}, got {ch}")
    if sorted_payload.data_ptr() % 16:
        raise ValueError("sorted_payload must be 16-byte aligned for float4 loads")
    fn = _bwd_kernel_fn()
    d_payload = torch.zeros_like(sorted_payload)     # rows no tile owns stay 0
    with torch.cuda.device(dev):
        err = fn(offsets.data_ptr(), sorted_payload.data_ptr(), bg.data_ptr(),
                 img.data_ptr(), alpha.data_ptr(), g_img.data_ptr(), g_alpha.data_ptr(),
                 d_payload.data_ptr(), tx_n, ty_n, k_max, ch,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blend_bwd kernel launch failed: cudaError {err}")
    blend_tiles_bwd.launches += 1
    return d_payload, _d_bg(alpha, g_img)


blend_tiles_bwd.launches = 0


class _Blend(torch.autograd.Function):
    """``blend_tiles`` forward, ``blend_tiles_bwd`` backward: the counterpart of
    the TPU package's ``blend_core`` custom VJP (blend_pallas_vjp.py:267-311).
    The residuals are the forward's inputs and outputs only."""

    @staticmethod
    def forward(ctx, offsets, sorted_payload, bg, tx_n, ty_n, k_max):
        img, alpha = blend_tiles(offsets, sorted_payload, bg, tx_n, ty_n, k_max)
        ctx.save_for_backward(offsets, sorted_payload, bg, img, alpha)
        ctx.dims = (tx_n, ty_n, k_max)
        return img, alpha

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_img, g_alpha):
        offsets, sorted_payload, bg, img, alpha = ctx.saved_tensors
        d_payload, d_bg = blend_tiles_bwd(offsets, sorted_payload, bg, img, alpha,
                                          g_img.contiguous(), g_alpha.contiguous(),
                                          *ctx.dims)
        return None, d_payload, d_bg, None, None, None


def blend(offsets, sorted_payload, bg, tx_n: int, ty_n: int, k_max: int):
    """Differentiable ``blend_tiles``: gradients flow to ``sorted_payload`` and
    ``bg`` through kernel K2 (its plain version on CPU tensors)."""
    return _Blend.apply(offsets, sorted_payload, bg, tx_n, ty_n, k_max)
