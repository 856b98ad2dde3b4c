"""Exact-semantics seed distribution (VERDICT r1 next-round #4).

Runs the reference pipeline (5 stages x 700 steps, folded decay, anneals,
density control — no turbo/warm-start, no polish, no culling) for N seeds
on the bundled 10-view dataset and reports the PSNR distribution next to
the reference's committed scene (33.05 dB — itself ONE sample of the same
stochastic pipeline). Also commits a full stage-progression artifact set
(steps/stage_0..3.png + final_1.png, reference preview rig train.rs:33-60)
for the first seed.

Usage:
  python scripts/exp_seeds.py [--seeds 10] [--out runs/exact_seeds]
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
    p.add_argument("--seeds", type=int, default=10)
    p.add_argument("--first-seed", dest="first_seed", type=int, default=0)
    p.add_argument("--out", default="runs/exact_seeds")
    p.add_argument("--data", default="/root/reference/data")
    p.add_argument("--progression-dir", dest="prog_dir",
                   default="docs/artifacts/stage_progression")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    from burn_raymarching.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from burn_raymarching.config import TrainConfig
    from burn_raymarching.data.image_io import load_image_as_array
    from burn_raymarching.data.scene_io import load_cameras
    from burn_raymarching.train.evaluate import evaluate_views
    from burn_raymarching.train.loop import Trainer, build_dataset

    os.makedirs(args.out, exist_ok=True)
    base = TrainConfig(
        cameras_json=os.path.join(args.data, "cameras.json"),
        checkpoint_dir=None,
    )
    cams = load_cameras(base.cameras_json)
    tgts = [load_image_as_array(c["file"]) for c in cams]
    dataset = build_dataset(base)

    results = {"psnr": [], "final_n": [], "seeds": [], "wall_s": []}
    for i in range(args.seeds):
        seed = args.first_seed + i
        steps_dir = (args.prog_dir if i == 0
                     else os.path.join(args.out, f"steps_{seed}"))
        import dataclasses

        cfg = dataclasses.replace(
            base, seed=seed, steps_dir=steps_dir,
            scene_json=os.path.join(args.out, f"scene_{seed}.json"))
        os.makedirs(steps_dir, exist_ok=True)
        tr = Trainer(cfg, dataset, log=(print if i == 0 else lambda s: None))
        t0 = time.perf_counter()
        padded, mask = tr.run()
        wall = time.perf_counter() - t0
        psnr = evaluate_views(
            padded, cams, tgts, cfg.width, cfg.height, mask=mask,
            smooth_k=cfg.max_smooth_k,
            march_normal_fn=tr.march_normal_fn)["mean"]
        n = int(np.asarray(mask).sum())
        results["psnr"].append(round(psnr, 2))
        results["final_n"].append(n)
        results["seeds"].append(seed)
        results["wall_s"].append(round(wall, 1))
        print(f"seed {seed}: PSNR {psnr:.2f} dB, N={n}, {wall:.0f}s")

    arr = np.asarray(results["psnr"])
    results["mean"] = round(float(arr.mean()), 2)
    results["std"] = round(float(arr.std()), 2)
    results["min"] = float(arr.min())
    results["max"] = float(arr.max())
    results["reference_committed"] = 33.05
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
