#!/usr/bin/env python
"""Per-channel colour statistics of a Gaussian or point PLY, the twin of the
repo's scripts/gaussian_color_stats.py with the same flags (the reference's
voxel_to_gaussian/semantics_stats/gaussian_features_dc_stats.py:1-95 and
gaussian_rgb_stats.py:1-48 behind ``--mode {dc,rgb}``), with the same field
resolution order:
  dc  mode: features_dc (2-D) → {features_dc,feature,color}_{0,1,2} →
            f_dc_{0,1,2} → red/green/blue
  rgb mode: red/green/blue → color     (histogram range pinned to (0,255))
Per channel it prints min/max/mean/std/25th/75th percentile and the
histogram; dc mode also writes ``<ply>_<Channel>_hist.png`` per channel where
matplotlib imports (and warns where it does not). Host numpy, no ``--device``.

    python -m segsplat_tpu_torch.gaussian_color_stats --ply point_cloud.ply [--mode dc|rgb]
"""

from __future__ import annotations

import warnings
from argparse import ArgumentParser

import numpy as np

from segsplat_tpu_torch.io.ply import read_ply


def _stack(ply, names):
    return np.stack([np.asarray(ply[n], np.float64) for n in names], axis=1)


def get_features_dc(ply) -> np.ndarray:
    """[N,3] SH-DC colours, the reference's resolution ladder
    (gaussian_features_dc_stats.py:6-46)."""
    fields = ply.names
    if "features_dc" in fields:
        v = np.asarray(ply["features_dc"], np.float64)
        return v[:, :3] if v.ndim == 2 and v.shape[1] >= 3 else v.reshape(-1, 3)
    for prefix in ("features_dc", "feature", "color"):
        if all(f"{prefix}_{i}" in fields for i in range(3)):
            return _stack(ply, [f"{prefix}_{i}" for i in range(3)])
    if all(f"f_dc_{i}" in fields for i in range(3)):
        return _stack(ply, [f"f_dc_{i}" for i in range(3)])
    if all(c in fields for c in ("red", "green", "blue")):
        return _stack(ply, ["red", "green", "blue"])
    print("Available vertex fields:", fields)
    raise ValueError("No features_dc, f_dc_0/1/2, or RGB fields found in PLY file.")


def get_rgb(ply) -> np.ndarray:
    """[N,3] uint8-range colours (gaussian_rgb_stats.py:7-17)."""
    fields = ply.names
    if all(c in fields for c in ("red", "green", "blue")):
        return _stack(ply, ["red", "green", "blue"])
    if "color" in fields:
        return np.asarray(ply["color"], np.float64)
    raise ValueError("No RGB color fields found in PLY file.")


def channel_stats(vals: np.ndarray, bins: int, hist_range=None) -> dict:
    return {
        "min": float(np.min(vals)),
        "max": float(np.max(vals)),
        "mean": float(np.mean(vals)),
        "std": float(np.std(vals)),
        "25_percentile": float(np.percentile(vals, 25)),
        "75_percentile": float(np.percentile(vals, 75)),
        "histogram": np.histogram(vals, bins=bins, range=hist_range)[0].tolist(),
    }


def color_stats(colors: np.ndarray, bins: int = 32, mode: str = "dc") -> dict:
    names = ("Red", "Green", "Blue") if mode == "dc" else ("R", "G", "B")
    rng = (0, 255) if mode == "rgb" else None
    return {name: channel_stats(colors[:, i], bins, rng) for i, name in enumerate(names)}


def _save_hist_pngs(ply_path: str, colors: np.ndarray, bins: int) -> None:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        warnings.warn("matplotlib unavailable: histogram PNGs not written")
        return
    for i, channel in enumerate(("Red", "Green", "Blue")):
        fig = plt.figure(figsize=(8, 4))
        plt.hist(colors[:, i], bins=bins, color=channel.lower(), alpha=0.7)
        plt.title(f"Histogram of {channel} values")
        plt.xlabel(f"{channel} value")
        plt.ylabel("Count")
        plt.grid(True)
        png_path = f"{ply_path}_{channel}_hist.png"
        plt.savefig(png_path)
        plt.close(fig)
        print(f"Saved histogram PNG: {png_path}")


def main(argv=None):
    p = ArgumentParser(description="RGB / SH-DC color statistics of a Gaussian PLY")
    p.add_argument("--ply", required=True)
    p.add_argument("--bins", type=int, default=32)
    p.add_argument("--mode", choices=("dc", "rgb"), default="dc",
                   help="dc = features_dc ladder + histogram PNGs "
                        "(gaussian_features_dc_stats.py); rgb = uint8 "
                        "red/green/blue, 0-255 hist range (gaussian_rgb_stats.py)")
    p.add_argument("--no_png", action="store_true",
                   help="skip the per-channel histogram PNGs in dc mode")
    args = p.parse_args(argv)

    ply = read_ply(args.ply)
    colors = get_features_dc(ply) if args.mode == "dc" else get_rgb(ply)
    stats = color_stats(colors, bins=args.bins, mode=args.mode)
    suffix = " (features_dc)" if args.mode == "dc" else ""
    print(f"Statistics for {args.ply}{suffix}:")
    for i, (channel, st) in enumerate(stats.items()):
        hdr = (f"{channel} channel (features_dc[{i}]):" if args.mode == "dc"
               else f"{channel} channel:")
        print(f"\n{hdr}")
        for k, v in st.items():
            print(f"  {k}: {v}" if k == "histogram" else f"  {k}: {v:.4f}")
    if args.mode == "dc" and not args.no_png:
        _save_hist_pngs(args.ply, colors, args.bins)
    return stats


if __name__ == "__main__":
    main()
