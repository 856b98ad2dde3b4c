"""Where the remaining error lives: silhouette / interior / background.

Round-3 closed the representational ceiling (Gaussian coverage → ~48 dB)
but trained runs sit at ~27.6; this decomposes the residual squared error
of a trained scene over the GT views into three pixel classes so round 4
optimizes the right thing:

  * edge     — within ±EDGE_PX of the GT object-mask boundary (silhouette
               placement / anti-aliasing / sub-pixel geometry);
  * interior — object pixels away from the boundary (color/lighting fit);
  * background — everything else (halo / stray primitives).

Usage:
  python scripts/diag_error_decomp.py [--run runs/c4_hybrid_deep]
          [--data runs/c4_r2/data] [--views 10] [--edge-px 2]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def dilate(mask: np.ndarray, r: int) -> np.ndarray:
    """8-neighborhood binary dilation, r iterations (numpy-only)."""
    out = mask.copy()
    for _ in range(r):
        m = out
        for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
            rolled = np.roll(m, sh, axis=ax)
            # np.roll wraps; zero the wrapped edge row/col.
            if ax == 0:
                rolled[0 if sh == 1 else -1, :] = False
            else:
                rolled[:, 0 if sh == 1 else -1] = False
            out |= rolled
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run", default="runs/c4_hybrid_deep")
    p.add_argument("--scene", default=None,
                   help="scene json (default <run>/scene_c5.json)")
    p.add_argument("--data", default="runs/c4_r2/data")
    p.add_argument("--views", type=int, default=10)
    p.add_argument("--edge-px", dest="edge_px", type=int, default=2)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--coverage", default="gaussian")
    p.add_argument("--mask-sharp", dest="mask_sharp", type=float,
                   default=40.0)
    p.add_argument("--softmax-sharp", dest="softmax_sharp", type=float,
                   default=40.0)
    p.add_argument("--smooth-k", dest="smooth_k", type=float, default=128.0)
    p.add_argument("--cull-budget", dest="cull_budget", type=int,
                   default=2048)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    from burn_raymarching.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from burn_raymarching.data.camera import create_camera_rays
    from burn_raymarching.data.image_io import load_image_as_array
    from burn_raymarching.data.scene_io import (
        load_cameras,
        load_scene_json,
    )
    from burn_raymarching.models.scene import (
        pad_params,
        raw_from_physical,
    )
    from burn_raymarching.render.preview import CullRender, render_tiled
    from burn_raymarching.train.evaluate import encode_u8
    from burn_raymarching.utils.padding import bucket_size

    scene = load_scene_json(args.scene
                            or os.path.join(args.run, "scene_c5.json"))
    # Exported radii are softplus(raw) (scene_io.py); the forward adds the
    # +0.01 offset, so re-encode from radii + 0.01.
    raw = raw_from_physical(scene["centers"], scene["colors"],
                            scene["radii"] + 0.01,
                            light_dir=scene["light_dir"],
                            ambient=float(scene["ambient_intensity"][0]))
    padded, mask = pad_params(raw, bucket_size(scene["num_spheres"]))
    cams = load_cameras(os.path.join(args.data, "cameras.json"))
    stride = max(len(cams) // args.views, 1)
    cams = cams[::stride][: args.views]

    from burn_raymarching.ops.kernels import select_kernels

    cull = CullRender(
        tile=512, k_budget=args.cull_budget,
        march_normal_fn=select_kernels(True).culled_march_normal_fn)

    sums = {k: 0.0 for k in ("edge", "interior", "background")}
    counts = {k: 0 for k in sums}
    for cam in cams:
        ro, rd = create_camera_rays(args.size, args.size, cam["origin"],
                                    cam["target"], cam["fov"])
        tgt = load_image_as_array(cam["file"])
        img = render_tiled(padded, ro, rd, smooth_k=args.smooth_k,
                           mask=mask, chunk=16384,
                           softmax_sharpness=args.softmax_sharp,
                           mask_sharpness=args.mask_sharp,
                           coverage_mode=args.coverage,
                           cull=cull, order_wh=(args.size, args.size))
        err = (encode_u8(img).astype(np.float64)
               - encode_u8(np.asarray(tgt)).astype(np.float64)) ** 2
        err = err.reshape(args.size, args.size, 3).sum(axis=2)
        obj = (np.asarray(tgt).reshape(args.size, args.size, 3).sum(axis=2)
               > 0.01)
        grown = dilate(obj, args.edge_px)
        shrunk = ~dilate(~obj, args.edge_px)
        edge = grown & ~shrunk
        interior = shrunk
        background = ~grown
        for name, m in (("edge", edge), ("interior", interior),
                        ("background", background)):
            sums[name] += float(err[m].sum())
            counts[name] += int(m.sum())

    total = sum(sums.values())
    out = {"run": args.run, "views": len(cams), "edge_px": args.edge_px}
    for name in sums:
        mse = sums[name] / max(counts[name], 1) / 3.0
        out[name] = {
            "err_frac": round(sums[name] / total, 4),
            "pixel_frac": round(counts[name] / sum(counts.values()), 4),
            "psnr_db": round(20 * np.log10(255) - 10 * np.log10(max(mse,
                                                                    1e-9)),
                             2),
        }
    with open(os.path.join(args.run, "error_decomp.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
