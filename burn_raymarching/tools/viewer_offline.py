"""Offline scene viewer — batch novel-view renderer for scene.json.

Headless substitute for the reference's interactive winit/WGSL viewer
(src/bin/viewer.rs + shader.wgsl): accelerator hosts have no window system,
so this renders orbit frames (or a single pose) to PNGs / an MP4 via the SAME
inference forward model the reference's fragment shader implements —
exponential smooth-min k=32, learnable light + ambient blend, exp(-10d)
color weights. The scene.json contract is preserved, so the reference's own
native viewer still opens our exports.

Two shading models:
  --model train  — the differentiable renderer's forward (softmax composite,
                   sigmoid coverage): what training optimized.
  --model viewer — the reference viewer's shading, WGSL-exact
                   (shader.wgsl:43-128): hard hit test (march with
                   epsilon/t_max), TETRAHEDRAL 4-tap normals, exp-weight
                   colors normalized by sum, black background. Golden-pinned
                   on the reference's committed scene.json
                   (tests/test_viewer_shader.py).

Usage:
  python -m burn_raymarching.tools.viewer_offline scene.json
      [--out orbit] [--frames 60] [--size 512] [--radius 2.5] [--height 0.5]
      [--model viewer|train] [--video orbit.mp4]
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np


def render_pose(scene, eye, target, size, model="viewer", fov=50.0,
                chunk=16384):
    import jax
    import jax.numpy as jnp

    from burn_raymarching.data.camera import create_camera_rays
    from burn_raymarching.render.diff import render_diff
    from burn_raymarching.render.preview import render_tiled
    from burn_raymarching.models.scene import SceneParams

    centers = jnp.asarray(scene["centers"])
    colors = jnp.asarray(scene["colors"])
    radii = jnp.asarray(scene["radii"])
    light_dir = jnp.asarray(scene["light_dir"])
    ambient = jnp.asarray(scene["ambient_intensity"])

    ro, rd = create_camera_rays(size, size, eye, target, fov)
    if model == "train":
        # Physical params straight into the differentiable forward.
        img = np.asarray(jax.jit(render_diff)(
            ro, rd, centers, colors, radii, light_dir, ambient,
            jnp.float32(32.0)))
    else:
        img = np.asarray(_viewer_shade(ro, rd, centers, colors, radii,
                                       light_dir, ambient))
    return img


def _viewer_shade(ro, rd, centers, colors, radii, light_dir, ambient):
    """The viewer shader's forward model, WGSL-exact (shader.wgsl:43-128):

      * map(): pairwise smin_exp fold at k=32 (:43-61) ≡ one LogSumExp over
        all spheres — computed max-subtracted here (identical math; the
        shader's raw exp sum underflows past d ≈ 2.7 to d=+inf, which only
        fast-forwards rays that have already missed — final pixels agree);
        direct length(p−c)−r distances, NO training-path epsilons;
      * 100-step march, hit ε = 0.001, t_max = 20 (:102-108);
      * TETRAHEDRAL 4-tap normals, eps 0.001, plain normalize (:63-72) —
        not the training renderer's 6-tap central differences;
      * calc_color: exp(−10·d) weights normalized by (sum + 1e-5) (:74-86);
      * ambient + diffuse·(1−ambient) blend (:117-124), black miss (:111).
    """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def shade(ro, rd):
        def map_wgsl(p):
            """[N, 3] → [N] scene distance: smin_exp fold ≡ -log Σe^{-kd}/k
            (shader.wgsl:43-61)."""
            diff = p[:, None, :] - centers[None, :, :]
            d = jnp.sqrt(jnp.sum(diff * diff, axis=2)) - radii.reshape(1, -1)
            val = d * -32.0
            mx = jnp.max(val, axis=1, keepdims=True)
            return -(jnp.log(jnp.sum(jnp.exp(val - mx), axis=1))
                     + mx[:, 0]) / 32.0

        def body(_, carry):
            t, hit = carry
            p = ro + rd * t
            d = map_wgsl(p)[:, None]
            hit = hit | (d[:, 0] < 0.001)
            step = jnp.where((hit | (t[:, 0] > 20.0))[:, None], 0.0, d)
            return t + step, hit

        t0 = jnp.zeros((ro.shape[0], 1), jnp.float32)
        hit0 = jnp.zeros((ro.shape[0],), bool)
        t, hit = jax.lax.fori_loop(0, 100, body, (t0, hit0))

        p = ro + rd * t
        # Tetrahedral 4-tap normals (shader.wgsl:63-72): k=(1,-1), eps 1e-3.
        eps = 0.001
        taps = jnp.asarray([[1.0, -1.0, -1.0], [-1.0, -1.0, 1.0],
                            [-1.0, 1.0, -1.0], [1.0, 1.0, 1.0]], jnp.float32)
        n_raw = sum(taps[i] * map_wgsl(p + taps[i] * eps)[:, None]
                    for i in range(4))
        normal = n_raw / jnp.maximum(
            jnp.sqrt(jnp.sum(n_raw * n_raw, axis=1, keepdims=True)), 1e-20)
        ld = light_dir / jnp.sqrt(jnp.sum(light_dir * light_dir))
        diff = jnp.maximum(jnp.sum(normal * ld[None, :], axis=1,
                                   keepdims=True), 0.0)
        dd = p[:, None, :] - centers[None, :, :]
        dists = (jnp.sqrt(jnp.sum(dd * dd, axis=2))
                 - radii.reshape(1, -1))
        w = jnp.exp(dists * -10.0)
        color = (jnp.dot(w, colors, precision=jax.lax.Precision.HIGHEST)
                 / (jnp.sum(w, axis=1, keepdims=True) + 1e-5))
        lighting = ambient + diff * (1.0 - ambient)
        out = color * lighting
        return jnp.where(hit[:, None], out, 0.0)

    return shade(ro, rd)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("scene", nargs="?", default="scene.json")
    parser.add_argument("--out", default="orbit")
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--radius", type=float, default=2.5)
    parser.add_argument("--height", type=float, default=0.5)
    parser.add_argument("--fov", type=float, default=50.0)
    parser.add_argument("--model", choices=("viewer", "train"),
                        default="viewer")
    parser.add_argument("--video", default=None,
                        help="also write an MP4 (requires imageio/ffmpeg)")
    args = parser.parse_args(argv)

    from burn_raymarching.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()

    from burn_raymarching.data.image_io import save_array_as_image
    from burn_raymarching.data.scene_io import load_scene_json

    scene = load_scene_json(args.scene)
    print(f"Loaded {scene['num_spheres']} spheres from {args.scene}")
    os.makedirs(args.out, exist_ok=True)
    frames = []
    for i in range(args.frames):
        angle = i * 2.0 * math.pi / args.frames
        eye = [args.radius * math.cos(angle), args.height,
               args.radius * math.sin(angle)]
        img = render_pose(scene, eye, [0.0, 0.0, 0.0], args.size,
                          model=args.model, fov=args.fov)
        path = os.path.join(args.out, f"frame_{i:04d}.png")
        save_array_as_image(img, args.size, args.size, path)
        frames.append(path)
    print(f"Wrote {len(frames)} frames to {args.out}/")

    if args.video:
        import imageio.v3 as iio

        stack = np.stack([iio.imread(f) for f in frames])
        iio.imwrite(args.video, stack, fps=30)
        print(f"Wrote {args.video}")


if __name__ == "__main__":
    main()
