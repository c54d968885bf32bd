"""Texture-synthesising 2D hole filling: multi-scale PatchMatch with patch
voting (the counterpart of segsplat_tpu/ops/inpaint_patch.py; Barnes et al.
2009, Kwatra et al. 2005). It fills removed-object holes with texture where
``ops/inpaint.py`` gives the smooth membrane:

  - coarse to fine over a pyramid of hole masks (a coarse pixel is a hole if
    any child is);
  - per level, a nearest-neighbour field (NNF) over the list of hole pixels:
    ``pm_iters`` PatchMatch iterations, each trying for every hole pixel its
    current source, the four neighbours' propagated sources, one local random
    search (radius halving each iteration) and one global random restart,
    scored by the patch SSD on the current estimate;
  - an M-step in which every hole patch votes its source patch onto the pixels
    it covers (p² shifted scatter-adds, in a fixed order, each writing a pixel
    at most once, so the sums are the same bits on every device);
  - ``em_iters`` E/M rounds a level, then the estimate and the NNF go up a
    level.

The per-level tables (hole list, neighbour indices, the source-validity map
from a summed-area table) are numpy on the host, as in the JAX package; the
levels run on the device. The random draws of the PatchMatch come from a CPU
``torch.Generator`` seeded with ``seed`` and are moved to the device, so the
card and the CPU fill from the same draws; ``_pm_level_at`` takes them as
arguments, so a test can feed it the JAX package's. The initial NNF is drawn
with numpy's ``default_rng(seed + level)`` at the JAX package's padded
(power-of-two) hole count, of which the first entries are used, so both
packages start from the same field. Known pixels come back bit-identical.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from segsplat_tpu_torch.ops.inpaint import _resize, inpaint_pushpull
from segsplat_tpu_torch.utils.system import require_device

_INF = 1e30
# propagation offsets of the four neighbours (left, right, up, down), planar (dy; dx)
_DELTAS = ((0, 0, -1, 1), (-1, 1, 0, 0))

Draw = Callable[[int, int, int, int, int, int], Tuple[torch.Tensor, torch.Tensor]]


def _level_masks(hole: np.ndarray, levels: int) -> List[np.ndarray]:
    """The hole mask's pyramid, coarsest first: a coarse pixel (ceil halves) is
    a hole if any of its children is, so nothing synthesised leaks into known
    pixels on the way up."""
    masks = [hole.astype(bool)]
    for _ in range(levels - 1):
        m = masks[-1]
        h2, w2 = (m.shape[0] + 1) // 2, (m.shape[1] + 1) // 2
        pad = np.zeros((h2 * 2, w2 * 2), bool)
        pad[:m.shape[0], :m.shape[1]] = m
        masks.append(pad.reshape(h2, 2, w2, 2).any(axis=(1, 3)))
    return masks[::-1]


def _host_level(mask: np.ndarray, patch: int):
    """A level's tables from its hole mask: (hole_yx [Nh, 2], nbr_idx [Nh, 4]
    (a missing neighbour is the pixel itself), src_ok [H, W] bool (patch
    inside the frame and hole-free), idx_map [H, W] int32 (hole-list index or
    -1))."""
    h, w = mask.shape
    ys, xs = np.nonzero(mask)
    hole_yx = np.stack([ys, xs], axis=1).astype(np.int32)
    idx_map = np.full((h, w), -1, np.int32)
    idx_map[ys, xs] = np.arange(len(ys), dtype=np.int32)

    nbr = np.empty((len(ys), 4), np.int32)
    for j, (dy, dx) in enumerate(((0, -1), (0, 1), (-1, 0), (1, 0))):
        ny = np.clip(ys + dy, 0, h - 1)
        nx = np.clip(xs + dx, 0, w - 1)
        n = idx_map[ny, nx]
        nbr[:, j] = np.where(n >= 0, n, idx_map[ys, xs])

    r = patch // 2
    c = np.cumsum(np.cumsum(mask.astype(np.int64), 0), 1)
    cp = np.zeros((h + 1, w + 1), np.int64)
    cp[1:, 1:] = c
    y0 = np.clip(np.arange(h) - r, 0, h)
    y1 = np.clip(np.arange(h) + r + 1, 0, h)
    x0 = np.clip(np.arange(w) - r, 0, w)
    x1 = np.clip(np.arange(w) + r + 1, 0, w)
    holes_in_win = (cp[y1][:, x1] - cp[y0][:, x1] - cp[y1][:, x0] + cp[y0][:, x0])
    src_ok = holes_in_win == 0
    src_ok[:r] = src_ok[h - r:] = False
    src_ok[:, :r] = src_ok[:, w - r:] = False
    if not src_ok.any():                    # a fully masked level: allow all
        src_ok = ~mask
        if not src_ok.any():
            src_ok = np.ones_like(mask)
    return hole_yx, nbr, src_ok, idx_map


def _patch_mat(img: torch.Tensor, patch: int) -> torch.Tensor:
    """[H, W, C] → [H, W, patch²·C]: the edge-clamped patch around each pixel,
    shifts in (dy, dx) row-major order, each shift's C channels together."""
    r = patch // 2
    h, w, _ = img.shape
    padded = F.pad(img.permute(2, 0, 1)[None], (r, r, r, r), mode="replicate")[0]
    padded = padded.permute(1, 2, 0)
    return torch.cat([padded[r + dy:r + dy + h, r + dx:r + dx + w]
                      for dy in range(-r, r + 1) for dx in range(-r, r + 1)], dim=-1)


def _pm_level_at(img, hole_m, hole_yx, nbr_idx, src_ok, init_nnf, local, glob,
                 patch: int, pm_iters: int, em_iters: int):
    """One pyramid level of EM texture optimisation at given draws.

    img [H, W, C] float32, the estimate; hole_m [H, W] bool; hole_yx [2, Nh],
    nbr_idx [4, Nh], init_nnf [2, Nh] int64 (planar); src_ok [H, W] bool;
    local [em_iters, pm_iters, 2, Nh], the local search's offsets, and glob
    [em_iters, pm_iters, 2, Nh], the restarts' (y; x), int64. Returns (the
    level's estimate [H, W, C], its NNF [2, Nh])."""
    h, w, cch = img.shape
    dev = img.device
    deltas = torch.tensor(_DELTAS, dtype=torch.int64, device=dev)
    hy, hx = hole_yx[0], hole_yx[1]

    def cost_of(pmat, tgt_rows, cand):
        cy = cand[0].clamp(0, h - 1)
        cx = cand[1].clamp(0, w - 1)
        ok = (src_ok[cy, cx] & (cand[0] >= 0) & (cand[0] < h)
              & (cand[1] >= 0) & (cand[1] < w))
        d = pmat[cy, cx] - tgt_rows
        return torch.where(ok, (d * d).sum(-1), _INF)

    def consider(nnf, best, cand, pmat, tgt_rows):
        c = cost_of(pmat, tgt_rows, cand)
        take = c < best
        return torch.where(take[None], cand, nnf), torch.where(take, c, best)

    nnf = init_nnf
    r = patch // 2
    for e in range(em_iters):
        pmat = _patch_mat(img, patch)
        tgt_rows = pmat[hy, hx]                                   # [Nh, p²C]
        for it in range(pm_iters):
            best = cost_of(pmat, tgt_rows, nnf)
            # propagation: if the neighbour at p + δ matches s, p tries s - δ
            for j in range(4):
                nnf, best = consider(nnf, best, nnf[:, nbr_idx[j]] - deltas[:, j:j + 1],
                                     pmat, tgt_rows)
            nnf, best = consider(nnf, best, nnf + local[e, it], pmat, tgt_rows)
            nnf, best = consider(nnf, best, glob[e, it], pmat, tgt_rows)

        # M-step: each hole patch votes its source patch onto the pixels it covers
        acc = torch.zeros((h * w, cch), dtype=torch.float32, device=dev)
        wgt = torch.zeros((h * w,), dtype=torch.float32, device=dev)
        sy = nnf[0].clamp(0, h - 1)
        sx = nnf[1].clamp(0, w - 1)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                ty, tx = hy + dy, hx + dx
                inb = (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)
                tflat = (ty * w + tx)[inb]
                vote = img[(sy + dy).clamp(0, h - 1), (sx + dx).clamp(0, w - 1)][inb]
                acc.index_add_(0, tflat, vote)
                wgt.index_add_(0, tflat, torch.ones_like(tflat, dtype=torch.float32))
        synth = (acc / torch.clamp_min(wgt, 1e-8)[:, None]).reshape(h, w, cch)
        img = torch.where((hole_m & (wgt.reshape(h, w) > 0))[..., None], synth, img)
    return img, nnf


def torch_draws(seed: int) -> Draw:
    """The PatchMatch draws of ``inpaint_texture`` from one CPU
    ``torch.Generator`` seeded with ``seed``: a callable (level h, level w, Nh,
    the JAX package's padded count, pm_iters, em_iters) → (local, glob) for
    ``_pm_level_at``, on the CPU, drawn at Nh. Iteration ``it`` searches
    locally within max(max(h, w) >> it, 2)."""
    gen = torch.Generator().manual_seed(seed)

    def draw(h: int, w: int, n: int, bucket: int, pm_iters: int, em_iters: int):
        local = torch.empty((em_iters, pm_iters, 2, n), dtype=torch.int64)
        glob = torch.empty_like(local)
        for e in range(em_iters):
            for it in range(pm_iters):
                radius = max(max(h, w) >> it, 2)
                local[e, it] = torch.randint(-radius, radius + 1, (2, n), generator=gen)
                glob[e, it, 0] = torch.randint(0, h, (n,), generator=gen)
                glob[e, it, 1] = torch.randint(0, w, (n,), generator=gen)
        return local, glob

    return draw


def inpaint_texture_at(image, hole, draw: Draw, patch: int = 7, levels: Optional[int] = None,
                       pm_iters: int = 6, em_iters: int = 3, seed: int = 0, init_fill=None,
                       device: str | torch.device = "cuda"):
    """``inpaint_texture`` with the PatchMatch draws from ``draw`` (see
    ``torch_draws``). Returns (the filled [H, W, C] float32 numpy image, each
    level's final NNF [Nh, 2] int64, coarsest first)."""
    device = require_device(device)
    img = np.asarray(image, np.float32)
    hole = np.asarray(hole, bool)
    if not hole.any():
        return img.copy(), []
    h, w = hole.shape
    if levels is None:      # the coarsest level ≳ 4·patch on its short side
        levels = max(1, int(np.floor(np.log2(max(min(h, w) / (4 * patch), 1)))) + 1)

    img_t = torch.from_numpy(img).to(device)
    if init_fill is not None:
        est = torch.from_numpy(np.where(hole[..., None], np.asarray(init_fill, np.float32),
                                        img)).to(device)
    else:
        est = inpaint_pushpull(img_t, torch.from_numpy(hole).to(device), device=device)
    nnfs: List[np.ndarray] = []
    prev_idx_map = None
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    for li, m in enumerate(_level_masks(hole, levels)):
        lh, lw = m.shape
        # known pixels from the original image at this scale; only the hole
        # carries the coarser estimate up
        chw = lambda x: x.permute(2, 0, 1)[None]
        lvl_base = _resize(chw(img_t), lh, lw)[0].permute(1, 2, 0)
        lvl_est = _resize(chw(est), lh, lw)[0].permute(1, 2, 0)
        m_t = to_dev(m)
        lvl_img = torch.where(m_t[..., None], lvl_est, lvl_base)
        hole_yx, nbr, src_ok, idx_map = _host_level(m, patch)
        nh = len(hole_yx)
        bucket = max(8, 1 << int(np.ceil(np.log2(max(nh, 1)))))

        rng = np.random.default_rng(seed + li)
        sy, sx = np.nonzero(src_ok)
        pick = rng.integers(0, len(sy), bucket)[:nh]    # drawn at the JAX package's bucket
        init = np.stack([sy[pick], sx[pick]], axis=1).astype(np.int64)
        if nnfs:                                        # upsample the parent NNF
            par = prev_idx_map[hole_yx[:, 0] // 2, hole_yx[:, 1] // 2]
            up = nnfs[-1][np.clip(par, 0, len(nnfs[-1]) - 1)] * 2 + (hole_yx & 1)
            init = np.where((par >= 0)[:, None], up, init)

        local, glob = draw(lh, lw, nh, bucket, pm_iters, em_iters)
        est, nnf = _pm_level_at(lvl_img, m_t, to_dev(hole_yx.T.astype(np.int64)),
                                to_dev(nbr.T.astype(np.int64)), to_dev(src_ok),
                                to_dev(init.T), local.to(device), glob.to(device),
                                patch=patch, pm_iters=pm_iters, em_iters=em_iters)
        nnfs.append(nnf.T.cpu().numpy())
        prev_idx_map = idx_map

    out = np.where(hole[..., None], est.cpu().numpy(), img)
    return out.astype(np.float32), nnfs


def inpaint_texture(image, hole, patch: int = 7, levels: Optional[int] = None,
                    pm_iters: int = 6, em_iters: int = 3, seed: int = 0, init_fill=None,
                    device: str | torch.device = "cuda") -> np.ndarray:
    """Fill ``hole`` of ``image`` with synthesised texture on ``device``.

    image [H, W, C] float; hole [H, W] bool (True = fill). Returns float32
    [H, W, C] (numpy); known pixels are bit-identical. ``init_fill``: an
    [H, W, C] image whose hole content seeds the estimate in place of the
    push–pull fill (the previous frame's fill, see ``inpaint_sequence``)."""
    return inpaint_texture_at(image, hole, torch_draws(seed), patch=patch, levels=levels,
                              pm_iters=pm_iters, em_iters=em_iters, seed=seed,
                              init_fill=init_fill, device=device)[0]


def inpaint_sequence(images, masks, patch: int = 7, pm_iters: int = 6, em_iters: int = 3,
                     seed: int = 0, device: str | torch.device = "cuda") -> List[np.ndarray]:
    """Temporally seeded texture fill of a frame sequence: frame 0 starts from
    its push–pull fill, every later frame's hole from the previous frame's
    fill, all with ``seed``, so static background synthesises alike from frame
    to frame. Returns the filled float32 frames."""
    out = []
    prev = None
    for img, m in zip(images, masks):
        prev = inpaint_texture(img, m, patch=patch, pm_iters=pm_iters, em_iters=em_iters,
                               seed=seed, init_fill=prev, device=device)
        out.append(prev)
    return out
