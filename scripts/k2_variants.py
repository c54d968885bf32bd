#!/usr/bin/env python3
"""Write diagnostic variants of kernel K2 (segsplat_tpu_torch/csrc/blend_bwd.cu)
for scripts/bench_k2.py, which times them on the card beside the kernel.

    python3 scripts/k2_variants.py [--out build/k2_variants]
    python3 scripts/bench_k2.py --diagnostic noA=build/k2_variants/noA.cu ...

Each variant is the kernel's source with one text edit, found by anchors in the
source (the script raises if an anchor is gone):
  empty   returns once the first chunk's copy has landed: the launch, the
          d_payload zero-fill and nothing else;
  noAB    no phase A arithmetic (w and dop are a copy of mu_x) and no phase B
          sums: the staging of rows and cotangents, the shared-memory traffic
          of the chunk loop, the cross-warp pass and the writes;
  noA     without phase A's arithmetic;
  noB     without phase B's sums;
  clocks  the kernel as it is, with clock64() read by each warp at the borders
          of its segments (prologue, the wait and barrier before a chunk with
          the next chunk's copy, phase A, phase B's colour product, its
          geometry and partials, the barrier before the cross-warp pass, the
          pass); each warp adds its cycles to a device counter per segment, and
          ``segsplat_k2_clocks`` reads (and with ``reset`` zeroes) them.
Only ``clocks`` gives right gradients; the others are timed without a check.
"""

from __future__ import annotations

import argparse
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "segsplat_tpu_torch" / "csrc" / "blend_bwd.cu"

SEGMENTS = ("prologue", "wait_stage", "phase_a", "phase_b_colour", "phase_b_geometry",
            "barrier", "cross_warp")

A_BODY = ("      // rows in batches of kBatch", "    __syncwarp();\n\n    // ── phase B")
A_TRIVIAL = ("      for (int r = 0; r < n; ++r) {\n"
             "        const float w = rows[r * kW4].x;\n"
             "        w_arr[r * kStride + lane] = w;\n"
             "        dop_arr[r * kStride + lane] = w;\n"
             "      }\n    }\n")
B_COLOUR = ("#pragma unroll 4\n      for (int j = 0; j < 32; ++j) {",
            "      const float4 m0 = rows[gr * kW4];")
B_GEOM = ("#pragma unroll\n      for (int jj = 0; jj < R; ++jj) {",
          "#pragma unroll\n      for (int off = R; off < 32; off <<= 1) {")
LOOP = "  for (int c0 = 0, k = 0; c0 < count; c0 += R, ++k) {\n"
STAGED = "    if (c0 + R < count) stage(c0 + R, row_bufs + ((k + 1) & 1) * R * kW4);\n"
END_A = "    __syncwarp();\n\n    // ── phase B"
MID_SYNC = "    __syncthreads();\n    // cross-warp sums"
LOOP_END = "(v < 6 ? v : v + 2)] = s;\n    }\n  }\n}"
FIRST_COPY = "  stage(0, row_bufs);"


def cut(src: str, anchors, insert: str = "") -> str:
    a, b = (src.index(x) for x in anchors)
    return src[:a] + insert + src[b:]


def put(src: str, anchor: str, text: str, after: bool = True) -> str:
    if src.count(anchor) != 1:
        raise ValueError(f"anchor not found once in {SOURCE.name}: {anchor!r}")
    i = src.index(anchor) + (len(anchor) if after else 0)
    return src[:i] + text + src[i:]


def line_of(src: str, anchor: str) -> str:
    """The whole line (with its newline) that holds ``anchor``."""
    i = src.index(anchor)
    return src[src.rindex("\n", 0, i) + 1:src.index("\n", i) + 1]


def variants(src: str) -> dict:
    for anchor in (A_BODY[:1] + B_COLOUR + B_GEOM + (LOOP, STAGED, END_A, MID_SYNC,
                                                      LOOP_END, FIRST_COPY)):
        if src.count(anchor) != 1:
            raise ValueError(f"anchor not found once in {SOURCE.name}: {anchor!r}")
    no_a = cut(src, A_BODY, A_TRIVIAL)
    no_b = cut(cut(src, B_COLOUR), B_GEOM)
    out = {"noA": no_a, "noB": no_b, "noAB": cut(cut(no_a, B_COLOUR), B_GEOM),
           "empty": put(src, line_of(src, FIRST_COPY), "  __pipeline_wait_prior(0);\n"
                        "  return;\n")}

    mark = lambda i: f"    K2_MARK({i})\n"
    c = put(src, "namespace {\n", "\n__device__ unsigned long long k2_clocks[%d];\n"
            "#define K2_MARK(i) { const long long u_ = clock64(); c_[i] += u_ - t_; "
            "t_ = u_; }\n" % len(SEGMENTS), after=False)
    c = put(c, line_of(c, FIRST_COPY), "  long long t_ = clock64();\n  long long c_[%d] = {};\n"
            % len(SEGMENTS), after=False)
    c = put(c, LOOP, mark(0), after=False)
    c = put(c, STAGED, mark(1))
    c = put(c, END_A, mark(2), after=False)
    c = put(c, B_COLOUR[1], mark(3), after=False)
    c = c.replace(MID_SYNC, mark(4) + MID_SYNC.replace("\n", "\n" + mark(5), 1))
    c = c.replace(LOOP_END, "(v < 6 ? v : v + 2)] = s;\n    }\n" + mark(6) +
                  "  }\n  if (lane == 0)\n"
                  "    for (int i = 0; i < %d; ++i)\n"
                  "      atomicAdd(&k2_clocks[i], static_cast<unsigned long long>(c_[i]));\n}"
                  % len(SEGMENTS))
    c += ("\nextern \"C\" int segsplat_k2_clocks(unsigned long long* host, int reset) {\n"
          "  cudaError_t err = cudaMemcpyFromSymbol(host, k2_clocks, sizeof(k2_clocks));\n"
          "  if (err == cudaSuccess && reset) {\n"
          "    unsigned long long zero[%d] = {};\n"
          "    err = cudaMemcpyToSymbol(k2_clocks, zero, sizeof(zero));\n"
          "  }\n  return static_cast<int>(err);\n}\n" % len(SEGMENTS))
    out["clocks"] = c
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k2_variants")
    a = ap.parse_args()
    a.out.mkdir(parents=True, exist_ok=True)
    for name, text in variants(SOURCE.read_text()).items():
        (a.out / f"{name}.cu").write_text(text)
        print(a.out / f"{name}.cu")


if __name__ == "__main__":
    main()
