"""Training CLI — the reference's train binary as a configurable command.

Equivalent of src/bin/train.rs but with every hardcoded hyperparameter
exposed (the reference has no flag system at all, SURVEY §5), plus resume
and the GPU march kernels (ops/kernels.py; --no-pallas selects the plain
XLA march).

Usage:
  python -m burn_raymarching.tools.train_cli [--cameras data/cameras.json]
      [--stages 5] [--steps 700] [--batch 16384] [--resume] [--no-pallas] ...
"""

from __future__ import annotations

import argparse
import dataclasses


def build_config(args) -> "TrainConfig":
    from burn_raymarching.config import TrainConfig

    overrides = {}
    for field in ("batch_size", "width", "height", "stages", "steps_per_stage",
                  "base_lr", "seed", "init_n", "init_layout", "init_points"):
        v = getattr(args, field, None)
        if v is not None:
            overrides[field] = v
    if args.cameras:
        overrides["cameras_json"] = args.cameras
    if args.scene_out:
        overrides["scene_json"] = args.scene_out
    if args.steps_dir:
        overrides["steps_dir"] = args.steps_dir
    if args.checkpoint_dir is not None:
        overrides["checkpoint_dir"] = args.checkpoint_dir or None
    if args.no_pallas:
        overrides["use_pallas"] = False
    if args.turbo:
        overrides["warm_start"] = True
    if getattr(args, "stage_guard", False):
        overrides["stage_guard"] = True
        overrides["stage_guard_retries"] = args.stage_guard_retries
    if args.warm_steps:
        overrides["warm_steps"] = args.warm_steps
    if args.cull:
        overrides["use_culling"] = True
        overrides["cull_budget"] = args.cull
        overrides["dataset_order"] = "morton"
    if getattr(args, "sample_mode", None):
        overrides["sample_mode"] = args.sample_mode
    if args.cull_hier:
        overrides["cull_hierarchical"] = True
        overrides["cull_cluster_budget"] = args.cull_hier
    if args.cluster_repulsion:
        overrides["cluster_repulsion"] = True
    if args.rep_far_field:
        from burn_raymarching.config import LossConfig

        overrides["loss"] = LossConfig(
            repulsion_far_field=args.rep_far_field)
    if args.wd_mode:
        overrides["weight_decay_mode"] = args.wd_mode
    if args.smooth_k:
        overrides["min_smooth_k"] = args.smooth_k
        overrides["max_smooth_k"] = args.smooth_k
    render_kw = {}
    if args.sharp:
        soft, mask = (float(v) for v in args.sharp.split(","))
        render_kw.update(softmax_sharpness=soft, mask_sharpness=mask)
    if getattr(args, "coverage", None):
        render_kw["coverage_mode"] = args.coverage
    if getattr(args, "mask_px", 0.0):
        if getattr(args, "pixel_angle", 0.0) <= 0.0:
            raise SystemExit(
                "--mask-px needs --pixel-angle (2*tan(fov/2)/height); "
                "without it the adaptive mask is a silent no-op")
        render_kw.update(mask_pixel_mult=args.mask_px,
                         pixel_angle=args.pixel_angle)
    if getattr(args, "ss_stages", "") or getattr(args, "mask_px_stages", ""):
        if getattr(args, "pixel_angle", 0.0) <= 0.0:
            raise SystemExit(
                "--ss-stages/--mask-px-stages need --pixel-angle "
                "(2*tan(fov/2)/height) to define the pixel footprint")
        render_kw["pixel_angle"] = args.pixel_angle
        if args.ss_stages:
            overrides["supersample_stages"] = tuple(
                int(v) for v in args.ss_stages.split(","))
        if args.mask_px_stages:
            overrides["mask_px_stages"] = tuple(
                float(v) for v in args.mask_px_stages.split(","))
    if render_kw:
        from burn_raymarching.config import RenderConfig

        overrides["render"] = RenderConfig(**render_kw)
    density_kw = {}
    if getattr(args, "merge_cell", 0.0):
        density_kw["merge_cell"] = args.merge_cell
    if getattr(args, "split_mode", None):
        density_kw.update(split_mode=args.split_mode,
                          split_budget=args.split_budget)
    if density_kw:
        from burn_raymarching.config import DensityConfig

        overrides["density"] = DensityConfig(**density_kw)
    if args.lr_scales:
        c, col, r, l = (float(v) for v in args.lr_scales.split(","))
        overrides.update(lr_scale_centers=c, lr_scale_colors=col,
                         lr_scale_radii=r, lr_scale_light=l)
    if getattr(args, "lr_centers_stages", ""):
        overrides["lr_scale_centers_stages"] = tuple(
            float(v) for v in args.lr_centers_stages.split(","))
    if getattr(args, "coverage_stages", ""):
        overrides["coverage_mode_stages"] = tuple(
            args.coverage_stages.split(","))
    if getattr(args, "mask_sharp_stages", ""):
        overrides["mask_sharpness_stages"] = tuple(
            float(v) for v in args.mask_sharp_stages.split(","))
    return TrainConfig(**overrides)


def main(argv=None):
    """Parse ``argv`` and train. Returns (trainer, padded params, mask) of
    the exported scene."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--cameras", default="data/cameras.json")
    parser.add_argument("--scene-out", dest="scene_out", default="scene.json")
    parser.add_argument("--steps-dir", dest="steps_dir", default="steps")
    parser.add_argument("--checkpoint-dir", dest="checkpoint_dir",
                        default="checkpoints")
    parser.add_argument("--batch", dest="batch_size", type=int, default=None)
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--stages", type=int, default=None)
    parser.add_argument("--steps", dest="steps_per_stage", type=int,
                        default=None)
    parser.add_argument("--lr", dest="base_lr", type=float, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--init-n", dest="init_n", type=int, default=None)
    parser.add_argument("--init-layout", dest="init_layout", default=None,
                        choices=["reference", "cloud"],
                        help="cloud: uniform random small-sphere init for "
                             "large --init-n (configs 4-5)")
    parser.add_argument("--init-points", dest="init_points", default=None,
                        help="geometry prior for --init-layout cloud: JSON "
                             "{\"points\": [x,y,z,...]} (COLMAP sparse points "
                             "via colmap_to_json --points-out, or the "
                             "generator's points.json)")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--no-pallas", action="store_true")
    parser.add_argument("--turbo", action="store_true",
                        help="warm-started march: a per-pixel t cache, "
                             "--warm-steps march steps per training step "
                             "instead of 40 (validated at reference "
                             "quality)")
    parser.add_argument("--warm-steps", dest="warm_steps", type=int,
                        default=0,
                        help="march steps per warm-started (--turbo) step "
                             "(default 16 — measured load-bearing: 8 costs "
                             "2.2 dB on the bundled scene)")
    parser.add_argument("--cull", type=int, default=0, metavar="K",
                        help="coherent-tile culling with a top-K primitive "
                             "budget (for large scenes; implies Morton "
                             "dataset order)")
    parser.add_argument("--sample-mode", dest="sample_mode", default=None,
                        choices=["pixel", "tile"],
                        help="batch construction: 'tile' samples whole "
                             "Morton pixel blocks (fg-boosted per tile) so "
                             "every cull tile is a single-view block — "
                             "required for effective culling on many-view "
                             "datasets (pixel-i.i.d. batches degenerate the "
                             "tile cones); requires --cull")
    parser.add_argument("--cull-hier", dest="cull_hier", type=int, default=0,
                        metavar="CB",
                        help="two-level culling: cluster bounding spheres "
                             "first (budget CB clusters/tile), per-primitive "
                             "top-K only over their members (requires --cull)")
    parser.add_argument("--stage-guard", dest="stage_guard",
                        action="store_true",
                        help="in-run collapse guard: re-run a stage (fresh "
                             "restart key, up to --stage-guard-retries) "
                             "when it fails to improve train-view PSNR — "
                             "catches the runaway-split collapse ~2/10 "
                             "turbo seeds hit, without --best-of's N-full-"
                             "run cost")
    parser.add_argument("--stage-guard-retries", dest="stage_guard_retries",
                        type=int, default=2)
    parser.add_argument("--best-of", dest="best_of", type=int, default=1,
                        metavar="N",
                        help="train N seeds and export the best by PSNR on "
                             "the training views (the prune/split pipeline "
                             "is stochastic; the reference's committed "
                             "scene is itself one selected run)")
    parser.add_argument("--wd-mode", dest="wd_mode", default=None,
                        choices=["folded", "decoupled"],
                        help="weight-decay placement: folded = Burn parity "
                             "(dissolves scenes with hundreds+ primitives — "
                             "Adam turns it into a full-lr drift on any "
                             "coordinate without data gradient); decoupled = "
                             "AdamW, required for large-M configs")
    parser.add_argument("--smooth-k", dest="smooth_k", type=float,
                        default=0.0,
                        help="pin the soft-min k (disables the 5→32 anneal; "
                             "fine structures want 128+)")
    parser.add_argument("--sharp", default="",
                        metavar="SOFTMAX,MASK",
                        help="compositor/mask sharpness override (reference "
                             "10,15; fine structures want 40,60 — features "
                             "below ~2/MASK units cannot be represented)")
    parser.add_argument("--lr-scales", dest="lr_scales", default="",
                        metavar="CENTERS,COLORS,RADII,LIGHT",
                        help="per-group LR multipliers (default 1,1,1,1). "
                             "Prior-seeded large scenes: 0.01,1,0.1,1 — "
                             "geometry rates far below appearance (see "
                             "config.TrainConfig)")
    parser.add_argument("--cluster-repulsion", dest="cluster_repulsion",
                        action="store_true",
                        help="Barnes-Hut-style two-level repulsion term "
                             "(exact near clusters + centroid far field) — "
                             "required at M ≳ 20k where the exact O(M²) "
                             "pairwise term dominates the step")
    parser.add_argument("--rep-far-field", dest="rep_far_field", default="",
                        choices=["", "member", "monopole"],
                        help="far-field order of --cluster-repulsion: "
                             "member (default, member→centroid) or monopole "
                             "(centroid↔centroid — ~G× fewer far pairs, one "
                             "more approximation order)")
    parser.add_argument("--coverage", default="",
                        choices=["", "sigmoid", "gaussian"],
                        help="trainable coverage family: gaussian = the GT "
                             "mask exp(-s*d^2) (renderer.rs:77) — lifts the "
                             "representational ceiling ~19 dB at configs "
                             "4-5 and trains +1.2 dB at config 4 "
                             "(docs/SCALING.md round 3)")
    parser.add_argument("--coverage-stages", dest="coverage_stages",
                        default="",
                        help="per-stage coverage family, comma list "
                             "(sigmoid,gaussian = sigmoid on the stacked "
                             "init stage, Gaussian after the merge; last "
                             "entry clamps; eval/export use --coverage)")
    parser.add_argument("--mask-sharp-stages", dest="mask_sharp_stages",
                        default="",
                        help="per-stage mask sharpness, comma list (coarse-"
                             "to-fine annealing; last entry clamps and "
                             "should equal the --sharp mask value eval "
                             "uses)")
    parser.add_argument("--ss-stages", dest="ss_stages", default="",
                        help="per-stage pixel-footprint supersample "
                             "factor, comma list ending in 1 (e.g. "
                             "1,4,4,4,1): middle stages train the "
                             "footprint-averaged forward, the last "
                             "stage(s) return to the point-sampled "
                             "evaluator; requires --pixel-angle")
    parser.add_argument("--mask-px-stages", dest="mask_px_stages",
                        default="",
                        help="per-stage mask_pixel_mult, comma list "
                             "ending at --mask-px (analytic pixel-area "
                             "coverage stages; requires --pixel-angle)")
    parser.add_argument("--mask-px", dest="mask_px", type=float, default=0.0,
                        help="pixel-footprint-adaptive coverage multiplier "
                             "(opt-in; two committed negative A/Bs on "
                             "synthetic targets — see docs/SCALING.md)")
    parser.add_argument("--pixel-angle", dest="pixel_angle", type=float,
                        default=0.0,
                        help="per-pixel view angle for --mask-px "
                             "(2*tan(fov/2)/height)")
    parser.add_argument("--merge-cell", dest="merge_cell", type=float,
                        default=0.0,
                        help="stage-boundary overlap merge cell size "
                             "(0.04 = the committed config 4-5 recipe; "
                             "collapses stacked prior-seeded primitives)")
    parser.add_argument("--split-mode", dest="split_mode", default="",
                        choices=["", "reference", "residual"],
                        help="residual: scale-aware split by compositor-"
                             "weight error attribution (grows compact "
                             "clouds; the reference's absolute threshold "
                             "never fires below radius ~0.25)")
    parser.add_argument("--split-budget", dest="split_budget", type=int,
                        default=0,
                        help="max residual splits per boundary (0 = 25% of "
                             "kept)")
    parser.add_argument("--lr-centers-stages", dest="lr_centers_stages",
                        default="",
                        help="per-stage lr_scale_centers override, comma "
                             "list (e.g. 0.001,0.01,0.01)")
    parser.add_argument("--polish", type=int, default=0, metavar="R",
                        help="after the final stage (for --best-of: on the "
                             "winning seed), run R extra last-stage rounds "
                             "on the frozen primitive set; 2 rounds lift "
                             "turbo runs ~+0.25 dB past the reference's "
                             "committed scene")
    parser.add_argument("--refine", type=int, default=0, metavar="R",
                        help="after polish, run R rounds of derivative-free "
                             "geometry refinement (stochastic hill-climbing "
                             "on centers/radii, PSNR-gated — "
                             "Trainer.refine_geometry; +0.1..+0.3 dB on the "
                             "committed c4/c5 scenes). Requires --cull + a "
                             "Morton dataset")
    parser.add_argument("--refine-proposals", dest="refine_proposals",
                        type=int, default=768,
                        help="proposals per refine phase (3 phases/round)")
    parser.add_argument("--refine-frac", dest="refine_frac", type=float,
                        default=0.05,
                        help="fraction of live primitives perturbed per "
                             "refine proposal")
    parser.add_argument("--refine-bias", dest="refine_bias",
                        default="uniform", choices=["uniform", "residual"],
                        help="'residual': concentrate proposals on "
                             "primitives carrying reconstruction error")
    parser.add_argument("--refine-colors", dest="refine_colors", type=float,
                        default=0.0, metavar="SIGMA",
                        help="joint color-logit proposal noise (0 = "
                             "geometry only)")
    parser.add_argument("--refine-temp", dest="refine_temp", type=float,
                        default=0.0,
                        help="annealed Metropolis chain temperature (x "
                             "baseline acceptance loss; 0 = greedy)")
    parser.add_argument("--refine-fringe", dest="refine_fringe", type=float,
                        default=1.0, metavar="W",
                        help="band-weighted acceptance: extra loss weight "
                             "on dim-silhouette-fringe pixels")
    parser.add_argument("--refine-light", dest="refine_light", type=int,
                        default=0, metavar="N",
                        help="gated light_dir/ambient micro-search "
                             "proposals per refine round")
    args = parser.parse_args(argv)

    import dataclasses

    cfg = build_config(args)
    from burn_raymarching.train.loop import Trainer, build_dataset
    from burn_raymarching.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()

    dataset = build_dataset(cfg)
    print(f"Total training pixels: {dataset.num_total_pixels}")
    print(f"Foreground pixels: {dataset.num_fg}, "
          f"Background pixels: {dataset.num_bg}")

    if args.best_of <= 1:
        trainer = Trainer(cfg, dataset)
        padded, mask = trainer.run(resume=args.resume)
        if args.polish:
            padded, mask = trainer.polish(padded, mask, rounds=args.polish)
        if args.refine:
            trainer.refine_geometry(padded, mask, rounds=args.refine,
                                    proposals=args.refine_proposals,
                                    frac=args.refine_frac,
                                    proposal_bias=args.refine_bias,
                                    sigma_col=args.refine_colors,
                                    accept_temp=args.refine_temp,
                                    fringe_weight=args.refine_fringe,
                                    light_proposals=args.refine_light)
        return trainer, padded, mask

    # Best-of-N: the density-control trajectory is stochastic; train N seeds
    # and keep the best by PSNR against the training views.
    from burn_raymarching.data.image_io import load_image_as_array
    from burn_raymarching.data.scene_io import (
        export_scene_json,
        load_cameras,
    )
    from burn_raymarching.train.evaluate import evaluate_views

    cams = load_cameras(cfg.cameras_json)
    tgts = [load_image_as_array(c["file"]) for c in cams]
    best = None
    for s in range(args.best_of):
        run_cfg = dataclasses.replace(
            cfg, seed=cfg.seed + s,
            scene_json=f"{cfg.scene_json}.seed{s}",
            steps_dir=f"{cfg.steps_dir}_seed{s}",
            checkpoint_dir=None,
        )
        print(f"--- best-of run {s + 1}/{args.best_of} "
              f"(seed {run_cfg.seed}) ---")
        trainer = Trainer(run_cfg, dataset)
        padded, mask = trainer.run()
        res = evaluate_views(
            padded, cams, tgts, cfg.width, cfg.height, mask=mask,
            smooth_k=cfg.max_smooth_k,
            march_normal_fn=trainer.march_normal_fn,
            softmax_sharpness=cfg.render.softmax_sharpness,
            mask_sharpness=cfg.render.mask_sharpness,
            cull=trainer._cull_render())
        print(f"    seed {run_cfg.seed}: PSNR mean {res['mean']:.2f}")
        if best is None or res["mean"] > best[0]:
            best = (res["mean"], padded, mask, run_cfg.seed, trainer)
    psnr, padded, mask, seed, trainer = best
    import numpy as np

    if args.polish:
        padded, mask = trainer.polish(padded, mask, rounds=args.polish,
                                      export=False, cameras=cams,
                                      targets=tgts)
        res = evaluate_views(
            padded, cams, tgts, cfg.width, cfg.height, mask=mask,
            smooth_k=cfg.max_smooth_k,
            march_normal_fn=trainer.march_normal_fn,
            softmax_sharpness=cfg.render.softmax_sharpness,
            mask_sharpness=cfg.render.mask_sharpness,
            cull=trainer._cull_render())
        print(f"    polished: PSNR mean {res['mean']:.2f}")
        psnr = res["mean"]
    if args.refine:
        padded, mask = trainer.refine_geometry(
            padded, mask, rounds=args.refine,
            proposals=args.refine_proposals, frac=args.refine_frac,
            proposal_bias=args.refine_bias, export=False,
            sigma_col=args.refine_colors, accept_temp=args.refine_temp,
            fringe_weight=args.refine_fringe,
            light_proposals=args.refine_light,
            cameras=cams, targets=tgts)
    export_scene_json(padded, cfg.scene_json, mask=np.asarray(mask))
    print(f"🏆 Best seed {seed}: PSNR {psnr:.2f} → {cfg.scene_json}")
    return trainer, padded, mask


if __name__ == "__main__":
    main()
