"""BASELINE config 5 at its stated shape, data side, on one GPU.

Config 5 is "COLMAP-style 100-view capture, ~50k primitives, sharded
primitives". This script runs it at the stated shape: a 100-view 256^2
procedural capture (6.55M training pixels), 51,200 prior-seeded spheres, the
large-scene recipe (decoupled decay, per-group LRs, k=128 / sharp 40,60,
cluster repulsion, turbo warm-start) — with the two fixes that turned the
flat first runs into actual learning:

  * sample_mode="tile" — batches are whole Morton pixel blocks, so every
    cull tile is a compact single-view block (i.i.d. pixel samples sorted
    across 100 views put ~3 cameras into each tile, degenerating its cone
    and making top-K selection arbitrary among all 51k primitives);
  * cull_budget=4096 with flat selection — covers the stacked init's
    qualifying sets (mean ~3.8k/tile), so train and eval share one honest
    forward instead of two differently-truncated ones (tile batches have
    only 32 cones, so flat top-K over all M is cheap).

``--distributed`` runs the sharded driver (DistributedTrainer); the
four-card sharded path itself is exercised by ``chip_smoke.py --four-cards``.

Prints ceiling / init / trained PSNR (the same three-row methodology as the
config-4 run in docs/SCALING.md) plus wall-clock and step rate.

Usage:
  python scripts/run_c5.py [--steps 1000] [--init-n 51200] [--out runs/c5]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="runs/c5")
    p.add_argument("--views", type=int, default=100)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--gt-n", dest="gt_n", type=int, default=2000)
    p.add_argument("--init-n", dest="init_n", type=int, default=51200)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--stages", type=int, default=1)
    p.add_argument("--merge-cell", dest="merge_cell", type=float, default=0.0,
                   help="stage-boundary overlap merge (DensityConfig."
                   "merge_cell): collapse co-located stacked primitives")
    p.add_argument("--lr-radii", dest="lr_radii", type=float, default=0.1)
    p.add_argument("--lr-light", dest="lr_light", type=float, default=0.5)
    p.add_argument("--base-lr", dest="base_lr", type=float, default=0.02)
    p.add_argument("--batch", type=int, default=16384)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--far-field", dest="far_field", default="member",
                   choices=["member", "monopole"])
    p.add_argument("--fringe-weight", dest="fringe_weight", type=float,
                   default=1.0,
                   help="extra loss multiplier on the dim silhouette "
                   "fringe (object pixels with target sum < "
                   "--fringe-threshold) — the band carrying 69-84%% of "
                   "residual error (docs/SCALING.md round 3)")
    p.add_argument("--fringe-threshold", dest="fringe_threshold",
                   type=float, default=0.3)
    p.add_argument("--skip-ceiling", action="store_true")
    p.add_argument("--data", default=None,
                   help="reuse an existing dataset dir instead of generating")
    p.add_argument("--no-repulsion", action="store_true")
    p.add_argument("--cull-budget", dest="cull_budget", type=int,
                   default=4096,
                   help="per-tile top-K budget; must cover the qualifying "
                   "sets (mean ~3.8k on the stacked 51k init) or the "
                   "train/eval forwards truncate differently and appearance "
                   "fits do not transfer (round-1 flatline)")
    p.add_argument("--sample-mode", dest="sample_mode", default="tile",
                   choices=["tile", "pixel"],
                   help="'tile' keeps every cull tile a single-view Morton "
                   "block (pixel-i.i.d. batches degenerate the tile cones)")
    p.add_argument("--hier", action="store_true",
                   help="hierarchical selection (tile batches have only 32 "
                   "cones, flat top-K over all M is cheap and exact)")
    p.add_argument("--jitter", type=float, default=0.02)
    p.add_argument("--lr-centers", dest="lr_centers", type=float,
                   default=0.001)
    p.add_argument("--prior", default="points", choices=["points", "dense"],
                   help="'points': the dataset's 2k-point cloud (sparse-SfM "
                   "analog); 'dense': resample the GT curve at init_n "
                   "(dense-SfM analog)")
    p.add_argument("--mask-px", dest="mask_px", type=float, default=0.0,
                   help="pixel-footprint-adaptive coverage multiplier "
                   "(RenderConfig.mask_pixel_mult; 0 = reference fixed "
                   "sigmoid). pixel_angle is derived from the dataset "
                   "fov/height")
    p.add_argument("--mask-sharp", dest="mask_sharp", type=float,
                   default=60.0, help="coverage mask sharpness "
                   "(world-space lower bound when --mask-px is set; the "
                   "Gaussian s when --coverage gaussian)")
    p.add_argument("--mask-sharp-stages", dest="mask_sharp_stages",
                   default="", help="per-stage mask sharpness, comma list "
                   "(coarse-to-fine annealing: soft early stages widen the "
                   "pathology-3 geometry basins; last entry clamps and "
                   "should equal --mask-sharp, which eval uses)")
    p.add_argument("--ss-stages", dest="ss_stages", default="",
                   help="per-stage pixel-footprint supersample factor, "
                   "comma list ending in 1 (e.g. 1,4,4,4,1): middle "
                   "stages train against the footprint-averaged forward "
                   "(batch/ss unique pixels x ss sub-rays), the last "
                   "stage(s) anneal back to the point-sampled evaluator")
    p.add_argument("--mask-px-stages", dest="mask_px_stages", default="",
                   help="per-stage mask_pixel_mult, comma list ending at "
                   "--mask-px (analytic pixel-area coverage arm; pair "
                   "with --mask-sharp-stages so the pixel term binds)")
    p.add_argument("--coverage-stages", dest="coverage_stages", default="",
                   help="per-stage coverage family, comma list (e.g. "
                   "sigmoid,gaussian = sigmoid on the stacked stage 0, "
                   "GT-matched Gaussian after the merge; last entry "
                   "clamps). Eval/export use --coverage")
    p.add_argument("--coverage", default="sigmoid",
                   choices=["sigmoid", "gaussian"],
                   help="trainable coverage family "
                   "(RenderConfig.coverage_mode): 'gaussian' matches the "
                   "GT mask exp(-s*d^2) (renderer.rs:77) instead of the "
                   "reference's sigmoid silhouette")
    p.add_argument("--split-mode", dest="split_mode", default="reference",
                   choices=["reference", "residual"],
                   help="'residual': scale-aware split driven by "
                   "compositor-weight residual attribution "
                   "(train/residual.py) — the reference's absolute radius "
                   "threshold never fires on compact clouds")
    p.add_argument("--split-budget", dest="split_budget", type=int,
                   default=0, help="max residual splits per boundary "
                   "(0 = split_frac of kept rows)")
    p.add_argument("--split-frac", dest="split_frac", type=float,
                   default=0.25)
    p.add_argument("--lr-centers-stages", dest="lr_centers_stages",
                   default="", help="comma list overriding lr_scale_centers "
                   "per stage (post-merge lr re-tune), e.g. 0.001,0.01,0.01")
    p.add_argument("--from-scene", dest="from_scene", default="",
                   help="skip training: load this exported scene json and "
                   "run only the post-training composition "
                   "(--polish/--refine/--alternate) — stack more gated "
                   "rounds on a finished run without re-training")
    p.add_argument("--ceiling-only", dest="ceiling_only",
                   action="store_true",
                   help="measure the representational ceiling with the "
                   "committed evaluator and exit (results hygiene)")
    p.add_argument("--polish", type=int, default=0, metavar="R",
                   help="greedy post-final refinement rounds "
                   "(Trainer.polish; kept only if train-view PSNR "
                   "improves)")
    p.add_argument("--refine", type=int, default=0, metavar="R",
                   help="after polish: R rounds of derivative-free "
                   "geometry refinement (Trainer.refine_geometry, "
                   "PSNR-gated)")
    p.add_argument("--refine-proposals", dest="refine_proposals", type=int,
                   default=768)
    p.add_argument("--refine-phases", dest="refine_phases", type=int,
                   default=3, help="noise-anneal phases per refine round "
                   "(each halves the proposal sigma; acceptance rates rise "
                   "at the finer scales)")
    p.add_argument("--refine-sigma-c", dest="refine_sigma_c", type=float,
                   default=0.3, help="phase-0 center noise in units of "
                   "each primitive's radius (stacked rounds on a refined "
                   "scene want finer starting scales)")
    p.add_argument("--refine-sigma-r", dest="refine_sigma_r", type=float,
                   default=0.15, help="phase-0 raw (softplus-domain) "
                   "radius noise")
    p.add_argument("--refine-frac", dest="refine_frac", type=float,
                   default=0.05,
                   help="fraction of live primitives perturbed per refine "
                   "proposal (smaller = finer, higher-acceptance steps)")
    p.add_argument("--refine-bias", dest="refine_bias", default="uniform",
                   choices=["uniform", "residual"],
                   help="proposal selection: 'residual' concentrates "
                   "perturbations on primitives carrying reconstruction "
                   "error (train/residual.py attribution)")
    p.add_argument("--refine-colors", dest="refine_colors", type=float,
                   default=0.0, metavar="SIGMA",
                   help="joint color-logit proposal noise (0 = geometry "
                   "only; the silhouette band's residual is a "
                   "color x coverage product)")
    p.add_argument("--refine-temp", dest="refine_temp", type=float,
                   default=0.0,
                   help="Metropolis chain temperature as a fraction of "
                   "the baseline acceptance loss (0 = greedy; the "
                   "returned params are always the best-seen snapshot)")
    p.add_argument("--refine-fringe", dest="refine_fringe", type=float,
                   default=1.0, metavar="W",
                   help="band-weighted ACCEPTANCE loss: extra multiplier "
                   "on dim-silhouette-fringe pixels (where 74%% of the "
                   "residual lives) in refine's two-batch gate")
    p.add_argument("--refine-light", dest="refine_light", type=int,
                   default=0, metavar="N",
                   help="after each geometry-refine round: N gated "
                   "proposals over the global (light_dir, ambient) pair")
    p.add_argument("--refine-max-budget", dest="refine_max_budget",
                   type=int, default=2048,
                   help="TrainConfig.refine_max_budget: proposal-loss "
                   "cull budget cap (see config.py)")
    p.add_argument("--alternate", type=int, default=0, metavar="R",
                   help="after --polish/--refine: R more rounds of "
                   "(polish 1, refine 1) alternation — every round is "
                   "greedily PSNR-gated, so the composition is a "
                   "monotone climb on the train views; rounds that "
                   "revert cost only their own compute")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend")
    p.add_argument("--distributed", action="store_true",
                   help="run the SHARDED driver (DistributedTrainer on a "
                   "(data=1, model=1) mesh) instead of Trainer — the "
                   "on-hardware driver-parity check (VERDICT r2 item 3)")
    args = p.parse_args(argv)
    from burn_raymarching.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    data_dir = args.data or os.path.join(args.out, "data")
    os.makedirs(args.out, exist_ok=True)

    from burn_raymarching.tools import generate

    if not os.path.exists(os.path.join(data_dir, "cameras.json")):
        print(f"--- generating {args.views}-view {args.size}px dataset ---")
        generate.main(["--out", data_dir, "--size", str(args.size),
                       "--scene", "knot", "--knot-n", str(args.gt_n),
                       "--views", str(args.views),
                       "--gt-k", "128", "--gt-sharp", "40"])

    from burn_raymarching.config import (
        DensityConfig,
        LossConfig,
        RenderConfig,
        TrainConfig,
    )
    from burn_raymarching.data.image_io import load_image_as_array
    from burn_raymarching.data.scene_io import load_cameras
    from burn_raymarching.models.scene import (
        init_scene_params_cloud,
        pad_params,
        raw_from_physical,
    )
    from burn_raymarching.train.evaluate import evaluate_views
    from burn_raymarching.train.loop import Trainer, build_dataset
    from burn_raymarching.utils.padding import bucket_size

    init_points_path = os.path.join(data_dir, "points.json")
    if args.prior == "dense":
        # Dense-SfM analog: resample the same GT curve at init_n points so
        # primitives seed along the tube instead of stacking ~25-deep on the
        # 2k sparse points. A real capture gets this from dense COLMAP.
        import numpy as np

        dense_c, _, _ = generate.knot_scene(args.init_n)
        init_points_path = os.path.join(args.out, "points_dense.json")
        with open(init_points_path, "w") as f:
            json.dump({"points": np.asarray(dense_c).reshape(-1).tolist()},
                      f)

    # Load the rig FIRST: pixel_angle derives from the dataset's own fov
    # (ADVICE r2 — a non-default-fov capture must not inherit the
    # generator's 50°).
    cameras_json = os.path.join(data_dir, "cameras.json")
    cams = load_cameras(cameras_json)
    fov = float(cams[0]["fov"])
    lr_centers_stages = (tuple(float(x) for x in
                               args.lr_centers_stages.split(","))
                         if args.lr_centers_stages else ())

    cfg = TrainConfig(
        batch_size=args.batch,
        width=args.size, height=args.size,
        stages=args.stages, steps_per_stage=args.steps,
        base_lr=args.base_lr, seed=args.seed,
        init_n=args.init_n, init_layout="cloud",
        init_points=init_points_path,
        warm_start=True,
        use_culling=True, cull_budget=args.cull_budget,
        dataset_order="morton", sample_mode=args.sample_mode,
        cull_hierarchical=args.hier, cull_cluster_budget=32,
        cluster_repulsion=not args.no_repulsion,
        init_points_jitter=args.jitter,
        weight_decay_mode="decoupled",
        min_smooth_k=128.0, max_smooth_k=128.0,
        lr_scale_centers=args.lr_centers, lr_scale_colors=1.0,
        lr_scale_radii=args.lr_radii, lr_scale_light=args.lr_light,
        lr_scale_centers_stages=lr_centers_stages,
        coverage_mode_stages=(tuple(args.coverage_stages.split(","))
                              if args.coverage_stages else ()),
        mask_sharpness_stages=(tuple(float(x) for x in
                                     args.mask_sharp_stages.split(","))
                               if args.mask_sharp_stages else ()),
        supersample_stages=(tuple(int(x) for x in args.ss_stages.split(","))
                            if args.ss_stages else ()),
        mask_px_stages=(tuple(float(x) for x in
                              args.mask_px_stages.split(","))
                        if args.mask_px_stages else ()),
        render=RenderConfig(
            softmax_sharpness=40.0, mask_sharpness=args.mask_sharp,
            mask_pixel_mult=args.mask_px,
            coverage_mode=args.coverage,
            # Vertical per-pixel view angle of the dataset's rig (all its
            # cameras share one fov). Any footprint-aware mode needs it.
            pixel_angle=(2.0 * math.tan(math.radians(fov / 2))
                         / args.size)
            if (args.mask_px > 0 or args.ss_stages or args.mask_px_stages)
            else 0.0),
        loss=LossConfig(repulsion_far_field=args.far_field,
                        fringe_weight=args.fringe_weight,
                        fringe_threshold=args.fringe_threshold),
        refine_max_budget=args.refine_max_budget,
        density=DensityConfig(merge_cell=args.merge_cell,
                              split_mode=args.split_mode,
                              split_budget=args.split_budget,
                              split_frac=args.split_frac),
        cameras_json=cameras_json,
        scene_json=os.path.join(args.out, "scene_c5.json"),
        steps_dir=os.path.join(args.out, "steps"),
    )
    tgts = [load_image_as_array(c["file"]) for c in cams]
    dataset = build_dataset(cfg)
    print(f"Total training pixels: {dataset.num_total_pixels} "
          f"(fg {dataset.num_fg})")
    if args.distributed:
        from burn_raymarching.parallel.distributed import (
            DistributedTrainer,
        )

        trainer = DistributedTrainer(cfg, dataset, data=1, model=1)
    else:
        trainer = Trainer(cfg, dataset)

    def psnr(padded, mask, cull):
        return evaluate_views(
            padded, cams, tgts, cfg.width, cfg.height, mask=mask,
            smooth_k=cfg.max_smooth_k,
            march_normal_fn=trainer.march_normal_fn,
            softmax_sharpness=cfg.render.softmax_sharpness,
            mask_sharpness=cfg.render.mask_sharpness,
            mask_pixel_mult=cfg.render.mask_pixel_mult,
            pixel_angle=cfg.render.pixel_angle,
            coverage_mode=cfg.render.coverage_mode,
            cull=cull)["mean"]

    # Fixed result schema: every run emits the same keys (ceiling stays
    # null when --skip-ceiling) so downstream comparisons never KeyError.
    results = {"ceiling": None}

    if not args.skip_ceiling:
        # GT through the trainable forward = the representational ceiling.
        # GT light/ambient mirror the generator's fixed values
        # (render/gt.py, reference renderer.rs:27,40).
        c, col, r = generate.knot_scene(args.gt_n)
        gt = raw_from_physical(c, col, r, light_dir=(-0.5, 0.5, -1.0),
                               ambient=0.1)
        gt_pad, gt_mask = pad_params(gt, bucket_size(args.gt_n))
        t0 = time.perf_counter()
        results["ceiling"] = psnr(gt_pad, gt_mask, cull=None)
        print(f"ceiling (GT through trainable forward): "
              f"{results['ceiling']:.2f} dB "
              f"[{time.perf_counter() - t0:.0f}s]")

    if args.ceiling_only:
        # Results hygiene: update an existing results.json's ceiling (the
        # one-methodology re-measure) or write a fresh schema-complete one.
        # A null ceiling must never clobber a measured one, and the run's
        # recorded training recipe ('coverage') is provenance this
        # evaluator-only pass must not rewrite.
        if results["ceiling"] is None:
            raise SystemExit("--ceiling-only with --skip-ceiling measures "
                             "nothing; drop --skip-ceiling")
        path = os.path.join(args.out, "results.json")
        prev = {}
        if os.path.exists(path):
            with open(path) as f:
                prev = json.load(f)
        prev.update(ceiling=results["ceiling"],
                    ceiling_coverage=args.coverage,
                    ceiling_evaluator="scripts/run_c5.py --ceiling-only")
        prev.setdefault("coverage", args.coverage)
        with open(path, "w") as f:
            json.dump(prev, f, indent=1)
        print(json.dumps(prev))
        return

    import numpy as np

    if args.from_scene:
        # Post-training-only mode: load an exported scene and run just the
        # greedy composition (polish/refine/alternate) on it — lets later
        # passes stack gated rounds without re-paying the schedule.
        from burn_raymarching.data.scene_io import load_scene_json

        scene = load_scene_json(args.from_scene)
        raw = raw_from_physical(
            scene["centers"], scene["colors"], scene["radii"] + 0.01,
            light_dir=scene["light_dir"],
            ambient=float(scene["ambient_intensity"][0]))
        padded, mask = pad_params(raw, bucket_size(scene["num_spheres"]))
        t0 = time.perf_counter()
        results["init"] = psnr(padded, mask, trainer._cull_render())
        print(f"from-scene {args.from_scene}: {results['init']:.2f} dB "
              f"[{time.perf_counter() - t0:.0f}s]")
    else:
        pts = np.asarray(json.load(open(cfg.init_points))["points"],
                         np.float32).reshape(-1, 3)
        init = init_scene_params_cloud(
            cfg.init_n, seed=cfg.seed, extent=cfg.init_cloud_extent,
            radius=cfg.init_cloud_radius,
            ambient_logit=cfg.init_ambient_logit,
            points=pts, jitter=cfg.init_points_jitter)
        init_pad, init_mask = pad_params(init, bucket_size(cfg.init_n))
        t0 = time.perf_counter()
        results["init"] = psnr(init_pad, init_mask, trainer._cull_render())
        print(f"prior-seeded init: {results['init']:.2f} dB "
              f"[{time.perf_counter() - t0:.0f}s]")

    t0 = time.perf_counter()
    if not args.from_scene:
        padded, mask = trainer.run()
    if args.polish:
        padded, mask = trainer.polish(padded, mask, rounds=args.polish,
                                      cameras=cams, targets=tgts,
                                      export=True)
    refine_kw = dict(proposals=args.refine_proposals,
                     phases=args.refine_phases,
                     sigma_c=args.refine_sigma_c,
                     sigma_r=args.refine_sigma_r,
                     frac=args.refine_frac,
                     proposal_bias=args.refine_bias,
                     sigma_col=args.refine_colors,
                     accept_temp=args.refine_temp,
                     fringe_weight=args.refine_fringe,
                     light_proposals=args.refine_light)
    if args.refine:
        padded, mask = trainer.refine_geometry(
            padded, mask, rounds=args.refine,
            cameras=cams, targets=tgts, export=True, **refine_kw)
    for _ in range(args.alternate):
        padded, mask = trainer.polish(padded, mask, rounds=1,
                                      cameras=cams, targets=tgts,
                                      export=True)
        padded, mask = trainer.refine_geometry(
            padded, mask, rounds=1,
            cameras=cams, targets=tgts, export=True, **refine_kw)
    results["train_wall_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    results["trained"] = psnr(padded, mask, trainer._cull_render())
    print(f"trained ({args.steps} steps, far_field={args.far_field}): "
          f"{results['trained']:.2f} dB  "
          f"[train {results['train_wall_s']}s, "
          f"eval {time.perf_counter() - t0:.0f}s]")

    results.update(views=args.views, size=args.size, init_n=args.init_n,
                   steps=args.steps, stages=args.stages,
                   merge_cell=args.merge_cell,
                   lr_radii=args.lr_radii, base_lr=args.base_lr, far_field=args.far_field,
                   seed=args.seed, repulsion=not args.no_repulsion,
                   jitter=args.jitter, lr_centers=args.lr_centers,
                   prior=args.prior, cull_budget=args.cull_budget,
                   sample_mode=args.sample_mode, hier=args.hier,
                   mask_px=args.mask_px, mask_sharp=args.mask_sharp,
                   polish=args.polish, refine=args.refine,
                   alternate=args.alternate, refine_bias=args.refine_bias,
                   refine_colors=args.refine_colors,
                   refine_temp=args.refine_temp,
                   refine_fringe=args.refine_fringe,
                   refine_light=args.refine_light,
                   from_scene=args.from_scene,
                   coverage=args.coverage,
                   coverage_stages=args.coverage_stages,
                   mask_sharp_stages=args.mask_sharp_stages,
                   ss_stages=args.ss_stages,
                   mask_px_stages=args.mask_px_stages,
                   fringe_weight=args.fringe_weight,
                   fringe_threshold=args.fringe_threshold,
                   split_mode=args.split_mode,
                   split_budget=args.split_budget,
                   split_frac=args.split_frac,
                   lr_centers_stages=list(lr_centers_stages),
                   n_final=int(np.asarray(mask).sum()))
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
