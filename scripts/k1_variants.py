#!/usr/bin/env python3
"""Write the alternative designs of kernel K1 (segsplat_tpu_torch/csrc/blend_fwd.cu)
for scripts/bench_k1.py, which times them on the card beside the kernel.

    python3 scripts/k1_variants.py [--out build/k1_variants]
    python3 scripts/bench_k1.py --only k1 --variant b1=build/k1_variants/b1.cu ...

Each variant is the kernel's source with csrc/blend_common.cuh pasted in place
of its #include (so it builds alone) and one text edit, found by anchors in the
sources (the script raises if an anchor is gone):
  all_rows  no row lists: every warp sweeps every row of a chunk;
  bbox      the row test by the bounding box of the ellipse
            sigma <= (tau + margin) / (1 - kappa), grown for the rounding of
            det, in place of the minimum of sigma over the warp's block;
  strip     each warp on a 16 x 2 strip of the tile in place of an 8 x 4 block;
  b1, b4    the cut computed for 1 or 4 rows of the list at a time, not 2;
  mb3_19    __launch_bounds__ with 3 blocks per SM at 19 channels, not 4;
  mb2_32    with 2 blocks per SM at 32 channels, not 3.
Every variant blends the same bits as the kernel; bench_k1.py checks each
against the plain version.
"""

from __future__ import annotations

import argparse
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "segsplat_tpu_torch" / "csrc"
SOURCE = CSRC / "blend_fwd.cu"
HEADER = CSRC / "blend_common.cuh"

INCLUDE = '#include "blend_common.cuh"\n'
LISTS = ("    const bool h0 = lane < n && row_may_hit(", "    uint64_t list =")
ALL_ROWS = "    const bool h0 = lane < n, h1 = lane + 32 < n;\n"
TEST_CALL = "row_may_hit(rows["
BULK = "// ── mbarriers and 1-D bulk copies"
FOOT = "constexpr int kFootW = 8;"
BATCH = "constexpr int kBatch = 2;"
MIN_BLOCKS = "CH > 19 ? 3 : 4;"

BBOX = """\
// Does the bounding box of the ellipse sigma <= (tau + margin) / (1 - kappa)
// meet the block? Exact with row_may_hit's margins, the box grown by 4 kappa
// for the rounding of det.
__device__ __forceinline__ bool row_may_hit_bbox(float4 g0, float4 g1, float x0, float x1,
                                                 float y0, float y1) {
  const float a = g0.z, b = g0.w, c = g1.x, op = g1.y;
  if (op < kAlphaMin) return false;
  const float ac = a * c;
  const float det = ac - b * b;
  if (!(a > 0.f && det > 0.f && ac <= kCullBig && op <= kCullBig)) return true;
  const float kappa = 4.f * kCullGamma * ac / det;
  if (!(kappa < 0.25f)) return true;
  const float t = (logf(op * 255.f) + kCullTauMargin) / (1.f - kappa);
  const float grow = 1.f + 4.f * kappa;
  const float rx = sqrtf(2.f * t * c / det) * grow + 1e-3f;
  const float ry = sqrtf(2.f * t * a / det) * grow + 1e-3f;
  return g0.x - x1 <= rx && g0.x - x0 >= -rx && g0.y - y1 <= ry && g0.y - y0 >= -ry;
}

"""


def once(src: str, anchor: str, count: int = 1) -> str:
    if src.count(anchor) != count:
        raise ValueError(f"anchor not found {count} time(s): {anchor!r}")
    return anchor


def variants(src: str, header: str) -> dict:
    """{name: standalone CUDA source} for the kernel source and its header."""
    for anchor in (INCLUDE, *LISTS, BATCH):
        once(src, anchor)
    once(src, TEST_CALL, 2)
    for anchor in (BULK, FOOT, MIN_BLOCKS):
        once(header, anchor)

    def build(kernel: str = src, head: str = header) -> str:
        return kernel.replace(INCLUDE, head)

    a, b = (src.index(x) for x in LISTS)
    return {
        "all_rows": build(src[:a] + ALL_ROWS + src[b:]),
        "bbox": build(src.replace(TEST_CALL, "row_may_hit_bbox(rows["),
                      header.replace(BULK, BBOX + BULK)),
        "strip": build(head=header.replace(FOOT, "constexpr int kFootW = 16;")),
        "b1": build(src.replace(BATCH, "constexpr int kBatch = 1;")),
        "b4": build(src.replace(BATCH, "constexpr int kBatch = 4;")),
        "mb3_19": build(head=header.replace(MIN_BLOCKS, "CH > 19 ? 3 : 3;")),
        "mb2_32": build(head=header.replace(MIN_BLOCKS, "CH > 19 ? 2 : 4;")),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k1_variants")
    a = ap.parse_args()
    a.out.mkdir(parents=True, exist_ok=True)
    for name, text in variants(SOURCE.read_text(), HEADER.read_text()).items():
        (a.out / f"{name}.cu").write_text(text)
        print(a.out / f"{name}.cu")


if __name__ == "__main__":
    main()
