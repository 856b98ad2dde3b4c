"""Derivative-free geometry refinement prototype (round-4 lever test).

The round-3 error decomposition pins 69-84% of residual error to the
silhouette band, and every first-order lever (lr, schedules, loss
weighting, capacity) measured dead or tenths-of-a-dB: pathology 3 says
sub-pixel geometry is effectively invisible to Adam. This prototypes the
obvious derivative-FREE move: stochastic hill-climbing on (centers, radii)
— perturb a random subset, keep the proposal iff the weighted-L1 loss on a
fixed large fg-boosted ray batch AND a disjoint held-out batch improve
(train/refine.py — chunked lax.scan device programs); the final scene is
kept only if full train-view PSNR improves (greedy at both levels).

Usage:
  python scripts/exp_geom_jiggle.py [--run runs/c4_hybrid_deep]
          [--data runs/c4_r2/data] [--props 512] [--frac 0.05]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run", default="runs/c4_hybrid_deep")
    p.add_argument("--data", default="runs/c4_r2/data")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--views", type=int, default=30)
    p.add_argument("--props", type=int, default=512,
                   help="proposals per phase (one scan program)")
    p.add_argument("--phases", type=int, default=3,
                   help="phases with sigma decayed 1, 1/2, 1/4, ...")
    p.add_argument("--frac", type=float, default=0.05,
                   help="fraction of live primitives perturbed per proposal")
    p.add_argument("--sigma-c", dest="sigma_c", type=float, default=0.3,
                   help="center noise in units of each primitive's radius")
    p.add_argument("--sigma-r", dest="sigma_r", type=float, default=0.15,
                   help="raw-radius noise (softplus domain)")
    p.add_argument("--rays-tiles", dest="rays_tiles", type=int, default=128,
                   help="fixed fg tiles (x512 rays) for the proposal loss")
    p.add_argument("--budget", type=int, default=2048)
    p.add_argument("--mask-sharp", dest="mask_sharp", type=float,
                   default=40.0)
    p.add_argument("--coverage", default="gaussian")
    p.add_argument("--bias", default="uniform",
                   choices=["uniform", "residual"],
                   help="proposal selection: residual-attribution-weighted "
                   "(round 4) vs uniform Bernoulli")
    p.add_argument("--out-json", dest="out_json", default="geom_jiggle.json")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    from burn_raymarching.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax

    from burn_raymarching.config import TrainConfig
    from burn_raymarching.data.image_io import load_image_as_array
    from burn_raymarching.data.scene_io import (
        load_cameras,
        load_scene_json,
    )
    from burn_raymarching.models.scene import (
        pad_params,
        raw_from_physical,
    )
    from burn_raymarching.train.evaluate import evaluate_views
    from burn_raymarching.train.loop import build_dataset
    from burn_raymarching.utils.padding import bucket_size

    scene = load_scene_json(os.path.join(args.run, "scene_c5.json"))
    raw = raw_from_physical(scene["centers"], scene["colors"],
                            scene["radii"] + 0.01,
                            light_dir=scene["light_dir"],
                            ambient=float(scene["ambient_intensity"][0]))
    padded, mask = pad_params(raw, bucket_size(scene["num_spheres"]))

    from burn_raymarching.config import RenderConfig
    from burn_raymarching.train.refine import (
        geometry_refine,
        sample_fg_tile_batches,
    )

    cfg = TrainConfig(width=args.size, height=args.size,
                      use_culling=True, cull_budget=args.budget,
                      dataset_order="morton", sample_mode="tile",
                      min_smooth_k=128.0, max_smooth_k=128.0, seed=args.seed,
                      render=RenderConfig(softmax_sharpness=40.0,
                                          mask_sharpness=args.mask_sharp,
                                          coverage_mode=args.coverage),
                      cameras_json=os.path.join(args.data, "cameras.json"))
    ds = build_dataset(cfg)
    batches = sample_fg_tile_batches(ds, tiles=args.rays_tiles,
                                     seed=args.seed, tile=512)

    from burn_raymarching.ops.kernels import select_kernels

    kern = select_kernels(True).culled_march_normal_fn

    cams = load_cameras(cfg.cameras_json)
    tgts = [load_image_as_array(c["file"]) for c in cams]

    def full_psnr(pp):
        from burn_raymarching.render.preview import CullRender

        return evaluate_views(
            pp, cams, tgts, args.size, args.size, mask=mask,
            smooth_k=128.0, softmax_sharpness=40.0,
            mask_sharpness=args.mask_sharp, coverage_mode=args.coverage,
            cull=CullRender(tile=512, k_budget=args.budget,
                            march_normal_fn=kern))["mean"]

    psnr0 = full_psnr(padded)
    print(f"baseline PSNR {psnr0:.3f}", flush=True)
    select_probs = None
    if args.bias == "residual":
        import jax.numpy as jnp

        from burn_raymarching.train.residual import (
            primitive_residual_scores,
        )

        select_probs = jnp.asarray(primitive_residual_scores(
            padded, mask, ds, cfg, cfg.max_smooth_k, kern=kern))
    t0 = time.perf_counter()
    cur, stats = geometry_refine(
        padded, mask, batches, cfg, kern=kern, proposals=args.props,
        phases=args.phases, frac=args.frac, sigma_c=args.sigma_c,
        sigma_r=args.sigma_r, select_probs=select_probs,
        key=jax.random.PRNGKey(args.seed))
    print(f"refine: loss {stats.loss_before:.5f} -> {stats.loss_after:.5f},"
          f" accepted {stats.accepted}/{stats.proposals} "
          f"[{time.perf_counter() - t0:.0f}s]", flush=True)
    psnr1 = full_psnr(cur)
    kept = psnr1 > psnr0
    print(f"jiggled PSNR {psnr1:.3f} ({'KEPT' if kept else 'reverted'})",
          flush=True)
    out = {"run": args.run, "baseline_psnr": round(psnr0, 3),
           "jiggled_psnr": round(psnr1, 3), "kept": bool(kept),
           "props": args.props, "phases": args.phases, "frac": args.frac,
           "sigma_c": args.sigma_c, "sigma_r": args.sigma_r,
           "bias": args.bias,
           "rays": int(batches[0][0].shape[0])}
    with open(os.path.join(args.run, args.out_json), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
