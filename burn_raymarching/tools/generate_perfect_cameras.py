"""Fabricate ideal circular-orbit camera poses for a frame sequence.

Equivalent of the reference's generate_perfect_cameras.ts: when SfM fails,
synthesize a perfect circular orbit (radius 2.0, height 0.5, fov 50) over the
thinned image list, targets pointing at the origin.

Usage: python -m burn_raymarching.tools.generate_perfect_cameras
           [--images data/tomato/images_nobg] [--ext jpg] [--interval 24]
           [--out data/cameras_filtered.json] [--radius 2.0] [--height 0.5]
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np


def perfect_orbit(files: list[str], prefix: str, radius: float = 2.0,
                  height: float = 0.5, fov: float = 50.0) -> list[dict]:
    n = len(files)
    cams = []
    for i, name in enumerate(files):
        angle = (i / n) * 2.0 * math.pi
        origin = np.array([math.cos(angle) * radius, height,
                           math.sin(angle) * radius])
        d = -origin / np.linalg.norm(origin)
        cams.append({
            "file": prefix + name,
            "fov": fov,
            "origin": origin.tolist(),
            "target": (origin + d).tolist(),
        })
    return cams


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--images", default="data/tomato/images_nobg")
    parser.add_argument("--ext", default="jpg")
    parser.add_argument("--interval", type=int, default=24)
    parser.add_argument("--out", default="data/cameras_filtered.json")
    parser.add_argument("--radius", type=float, default=2.0)
    parser.add_argument("--height", type=float, default=0.5)
    parser.add_argument("--fov", type=float, default=50.0)
    args = parser.parse_args(argv)

    files = sorted(f for f in os.listdir(args.images)
                   if f.endswith("." + args.ext))[::args.interval]
    cams = perfect_orbit(files, args.images.rstrip("/") + "/",
                         args.radius, args.height, args.fov)

    from burn_raymarching.data.scene_io import save_cameras

    save_cameras(cams, args.out)
    print(f"✅ Fabricated {len(cams)} perfect-orbit cameras → {args.out}")


if __name__ == "__main__":
    main()
