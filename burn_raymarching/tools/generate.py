"""Synthetic dataset generator — renders GT targets + cameras.json.

Equivalent of the reference's generate binary (src/bin/generate.rs:20-112):
three "dango" spheres (red/green/blue at x = -0.3/0/0.3, r = 0.2/0.15/0.2),
10 cameras (8-ring at radius 2.5 / y=0.5, one top with the z=-0.001 nudge,
one from below), rendered with the non-differentiable GT renderer and saved
through the gamma-2.2 pipeline.

Usage: python -m burn_raymarching.tools.generate [--out data] [--size 256]
"""

from __future__ import annotations

import argparse
import math
import os


def default_cameras(out_dir: str = "data", fov: float = 50.0,
                    radius: float = 2.5) -> list[dict]:
    """The reference's 10-camera rig (generate.rs:43-80)."""
    cams = []
    for i in range(8):
        angle = i * (2.0 * math.pi / 8)
        cams.append({
            "file": f"{out_dir}/target_{i}.png",
            "origin": [radius * math.cos(angle), 0.5,
                       radius * math.sin(angle)],
            "target": [0.0, 0.0, 0.0],
            "fov": fov,
        })
    # Top view, z nudged to dodge the degenerate up-vector cross product.
    cams.append({"file": f"{out_dir}/target_8.png",
                 "origin": [0.0, 2.5, -0.001],
                 "target": [0.0, 0.0, 0.0], "fov": fov})
    cams.append({"file": f"{out_dir}/target_9.png",
                 "origin": [0.0, -1.5, -2.0],
                 "target": [0.0, 0.0, 0.0], "fov": fov})
    return cams


def ring_cameras(views: int, out_dir: str = "data", fov: float = 50.0,
                 radius: float = 2.5) -> list[dict]:
    """COLMAP-capture-style rig for configs 4-5: ``views`` cameras over two
    orbit rings (y = 0.5 and y = 1.2) plus top and below views."""
    cams = []
    n_ring = max(views - 2, 1)
    n_low = (n_ring + 1) // 2
    for i in range(n_ring):
        low = i < n_low
        k = i if low else i - n_low
        count = n_low if low else n_ring - n_low
        angle = k * (2.0 * math.pi / max(count, 1))
        y = 0.5 if low else 1.2
        r = radius if low else radius * 0.85
        cams.append({
            "file": f"{out_dir}/target_{i}.png",
            "origin": [r * math.cos(angle), y, r * math.sin(angle)],
            "target": [0.0, 0.0, 0.0],
            "fov": fov,
        })
    cams.append({"file": f"{out_dir}/target_{n_ring}.png",
                 "origin": [0.0, 2.5, -0.001],
                 "target": [0.0, 0.0, 0.0], "fov": fov})
    cams.append({"file": f"{out_dir}/target_{n_ring + 1}.png",
                 "origin": [0.0, -1.5, -2.0],
                 "target": [0.0, 0.0, 0.0], "fov": fov})
    return cams[:views]


def knot_scene(n: int = 400, scale: float = 0.85, tube_radius: float = 0.055):
    """Procedural GT scene for large-M configs: ``n`` small spheres along a
    trefoil knot, hue varying with the curve parameter."""
    import numpy as np

    t = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    p = np.stack([
        (2.0 + np.cos(3.0 * t)) * np.cos(2.0 * t),
        np.sin(3.0 * t),
        (2.0 + np.cos(3.0 * t)) * np.sin(2.0 * t),
    ], axis=1)
    p = p / np.abs(p).max() * scale
    hue = t / (2.0 * np.pi)
    colors = np.stack([
        0.5 + 0.5 * np.cos(2.0 * np.pi * (hue + s))
        for s in (0.0, 1.0 / 3.0, 2.0 / 3.0)
    ], axis=1)
    radii = np.full((n, 1), tube_radius)
    return (p.astype(np.float32), colors.astype(np.float32),
            radii.astype(np.float32))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="data")
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--scene", choices=["dango", "knot"], default="dango",
                        help="dango: the reference's 3 spheres; knot: a "
                             "procedural trefoil of --knot-n small spheres "
                             "(large-scene configs)")
    parser.add_argument("--knot-n", type=int, default=400)
    parser.add_argument("--views", type=int, default=0,
                        help="override the camera count (default: the "
                             "reference's 10-camera rig; >0 uses a two-ring "
                             "COLMAP-style rig)")
    parser.add_argument("--gt-k", dest="gt_k", type=float, default=32.0,
                        help="GT soft-min k (raise for fine structures; "
                             "reference renderer.rs uses 32)")
    parser.add_argument("--gt-sharp", dest="gt_sharp", type=float,
                        default=10.0,
                        help="GT compositor exp(-s*d) and mask exp(-s*d^2) "
                             "sharpness (reference uses 10; fine structures "
                             "need more or the targets themselves halo)")
    parser.add_argument("--gt-hard-mask", dest="gt_hard_mask",
                        action="store_true",
                        help="binary silhouette targets (Gaussian mask "
                             "thresholded at 1/2) — the hard-edge statistic "
                             "of chromakeyed real captures")
    args = parser.parse_args(argv)

    from burn_raymarching.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()

    import jax.numpy as jnp

    from burn_raymarching.data.camera import create_camera_rays
    from burn_raymarching.data.image_io import save_array_as_image
    from burn_raymarching.data.scene_io import save_cameras
    from burn_raymarching.render.gt import render_gt

    if args.scene == "knot":
        c, col, r = knot_scene(args.knot_n)
        centers = jnp.asarray(c)
        colors = jnp.asarray(col)
        radii = jnp.asarray(r)
    else:
        # GT scene (generate.rs:29-40).
        centers = jnp.asarray([[-0.3, 0.0, 0.0], [0.0, 0.0, 0.0],
                               [0.3, 0.0, 0.0]], jnp.float32)
        colors = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                              [0.0, 0.0, 1.0]], jnp.float32)
        radii = jnp.asarray([[0.2], [0.15], [0.2]], jnp.float32)

    cams = (ring_cameras(args.views, args.out) if args.views
            else default_cameras(args.out))
    os.makedirs(args.out, exist_ok=True)
    print(f"Generating {len(cams)} target images...")
    import jax

    import functools

    render = jax.jit(functools.partial(
        render_gt, smooth_k=args.gt_k, weight_sharpness=args.gt_sharp,
        mask_sharpness=args.gt_sharp, hard_mask=args.gt_hard_mask))
    for cam in cams:
        print(f"  -> Rendering {cam['file']}")
        ro, rd = create_camera_rays(args.size, args.size, cam["origin"],
                                    cam["target"], cam["fov"])
        img = render(ro, rd, centers, colors, radii)
        save_array_as_image(img, args.size, args.size, cam["file"])

    save_cameras(cams, os.path.join(args.out, "cameras.json"))
    if args.scene == "knot":
        # GT surface samples as the init prior — the synthetic analog of
        # COLMAP's sparse points3D (tools/colmap_to_json --points-out).
        import json

        import numpy as np

        with open(os.path.join(args.out, "points.json"), "w") as f:
            json.dump({"points": np.asarray(centers).reshape(-1).tolist()},
                      f)
        print(f"  -> Wrote {centers.shape[0]} prior points to "
              f"{args.out}/points.json")
    print(f"🎉 Done! All images and {args.out}/cameras.json generated.")


if __name__ == "__main__":
    main()
