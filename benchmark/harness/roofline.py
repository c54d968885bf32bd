"""Peaks and the blend kernels' bounds: the yardstick of every roofline and MFU
reader. Copied from ``chip_smoke.py:260-261, 522-570`` (``PEAK_FP32_FLOPS``,
``PEAK_HBM_BYTES``, ``_bound``, ``k1_bound``, ``k2_bound``), with the payload
row width (``segsplat_tpu_torch/ops/blend.py:payload_width``) copied beside
them, so that a later change to the program cannot move the yardstick.

Peaks: NVIDIA's data sheet for one H100 SXM at 700 W, dense float32 outside
the tensor cores and HBM3 bandwidth.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
GEOM = 8      # payload row prefix: mu_x, mu_y, conic a, b, c, opacity, 0, 0
PX = 256      # pixels a tile


def payload_width(ch: int) -> int:
    """Floats per payload row for ``ch`` colour channels (float4-padded)."""
    return -(-(GEOM + ch) // 4) * 4


def bound(ops: float, bytes_: float):
    """(bound ms, what bounds it): the larger of fp32 operations over 67 TFLOP/s
    and bytes over 3.35 TB/s."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, bytes_ / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def k1_bound(rows: int, hits: int, ch: int, num_tiles: int):
    """K1's bound on this data: every pair-pixel of a row read costs dx, dy,
    sigma, exp, alpha and the cut (15 ops); one that passes the cut CH fmas, the
    weight and T's update (2·CH + 3). Bytes: the rows read, offsets, bg, image
    and alpha written. Returns (ms, what bounds it, ops, bytes)."""
    ops = rows * PX * 15 + hits * (2 * ch + 3)
    bytes_ = (rows * payload_width(ch) * 4 + (num_tiles + 1) * 4 + ch * 4
              + num_tiles * PX * (ch + 1) * 4)
    return bound(ops, bytes_) + (ops, bytes_)


def k2_bound(payload_rows: int, rows: int, hits: int, ch: int, num_tiles: int):
    """K2's bound on this data: 15 ops per pair-pixel of every row up to the
    count (alpha recomputed, no early-out), and per pair-pixel that passes the
    cut 4·CH + 36 (the <g, c> product, the colour terms, the sums over the
    tile's pixels, the transmittance, prefix and geometry terms). Bytes: the
    rows read, the whole d_payload written, img, g_img, alpha, g_alpha,
    offsets and bg read. Returns (ms, what bounds it, ops, bytes)."""
    w = payload_width(ch) * 4
    ops = rows * PX * 15 + hits * (4 * ch + 36)
    bytes_ = (rows * w + payload_rows * w + num_tiles * PX * (2 * ch + 2) * 4
              + (num_tiles + 1) * 4 + ch * 4)
    return bound(ops, bytes_) + (ops, bytes_)


# float32 operations a Gaussian's projection needs (reference/raster.project,
# per Gaussian): camera transform 18, frustum clamp 8, quaternion normalise
# 13, rotation matrix 42, R·diag(s) 9, Σ 30, W·Σ 45, W·Σ·Wᵀ 30, 1/z 2,
# Jacobian 7, 2-D covariance 30, determinant 3, conic 5, eigenvalue 6,
# radius 3, screen position 6, on-screen test 8.
PROJECT_OPS = 265
# its backward, by autograd's rule of about twice the forward
PROJECT_BWD_OPS = 2 * PROJECT_OPS


def blend_ops(work: dict, backward: bool = False) -> float:
    """K1's (and with ``backward`` K2's) counted operations on a frame's work."""
    ch, t = work["channels"], work["tiles"]
    ops = k1_bound(work["rows_fwd"], work["hits_fwd"], ch, t)[2]
    if backward:
        ops += k2_bound(work["payload_rows"], work["rows_bwd"], work["hits_bwd"], ch, t)[2]
    return ops
