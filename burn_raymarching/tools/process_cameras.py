"""Camera thinning + outlier rejection + recentering.

Equivalent of the reference's process_cameras.ts: keep every INTERVAL-th
camera, reject cameras whose target sits further than OUTLIER_THRESHOLD x the
mean distance from the provisional center, then recenter the scene on the
inliers' mean target.

Usage: python -m burn_raymarching.tools.process_cameras
           [--in data/cameras.json] [--out data/cameras_filtered.json]
           [--interval 8] [--threshold 1.5] [--scale 1.0]
"""

from __future__ import annotations

import argparse

import numpy as np


def process_cameras(cams: list[dict], interval: int = 8,
                    threshold: float = 1.5, scale: float = 1.0,
                    return_transform: bool = False):
    thinned = cams[::interval]
    targets = np.array([c["target"] for c in thinned], np.float64)
    center0 = targets.mean(axis=0)
    dists = np.linalg.norm(targets - center0, axis=1)
    keep = dists <= dists.mean() * threshold
    inliers = [c for c, k in zip(thinned, keep) if k]
    removed = len(thinned) - len(inliers)
    if removed:
        print(f"🚨 Rejected {removed} outlier cameras")

    final_center = np.array([c["target"] for c in inliers],
                            np.float64).mean(axis=0)
    out = []
    for c in inliers:
        out.append({
            "file": c["file"],
            "fov": c["fov"],
            "origin": ((np.asarray(c["origin"]) - final_center)
                       * scale).tolist(),
            "target": ((np.asarray(c["target"]) - final_center)
                       * scale).tolist(),
        })
    if return_transform:
        return out, final_center, scale
    return out


def transform_points(points: np.ndarray, center: np.ndarray,
                     scale: float) -> np.ndarray:
    """Apply the camera recentering to a sparse point prior.

    colmap_to_json --points-out writes points3D in the COLMAP world frame;
    after process_cameras recenters/scales the cameras the scene lives at
    (p - center) * scale — a prior left in the old frame is offset by the
    full recenter shift (found by the round-3 capture-chain integration
    test). The TS reference tooling has no point path, so this transform is
    this repository's own addition.
    """
    return ((np.asarray(points, np.float64).reshape(-1, 3) - center)
            * scale).astype(np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--in", dest="input", default="data/cameras.json")
    parser.add_argument("--out", default="data/cameras_filtered.json")
    parser.add_argument("--interval", type=int, default=8)
    parser.add_argument("--threshold", type=float, default=1.5)
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--points-in", dest="points_in", default=None,
                        help="points.json prior (colmap_to_json "
                        "--points-out) to carry through the SAME "
                        "recenter/scale transform")
    parser.add_argument("--points-out", dest="points_out", default=None)
    args = parser.parse_args(argv)

    from burn_raymarching.data.scene_io import load_cameras, save_cameras

    cams = load_cameras(args.input)
    out, center, scale = process_cameras(cams, args.interval, args.threshold,
                                         args.scale, return_transform=True)
    save_cameras(out, args.out)
    print(f"✅ Processed {len(cams)} -> {len(out)} valid cameras → {args.out}")

    if args.points_in:
        import json

        if not args.points_out:
            # In-place overwrite would double-transform the prior on a
            # pipeline retry with no error anywhere — require an explicit
            # destination.
            raise SystemExit("--points-in requires --points-out (in-place "
                             "overwrite would double-transform the prior "
                             "if the command is re-run)")
        with open(args.points_in) as f:
            pts = np.asarray(json.load(f)["points"], np.float32)
        pts = transform_points(pts, center, scale)
        with open(args.points_out, "w") as f:
            json.dump({"points": pts.reshape(-1).tolist()}, f)
        print(f"✅ Recentered {pts.shape[0]} prior points → "
              f"{args.points_out}")


if __name__ == "__main__":
    main()
