"""Large-scene (config 4-5 style) train-step benchmark on one GPU.

Times the FULL culled training step (selection + march + normals + shade/
composite + 5-term loss with cluster repulsion + backward + Adam update)
through the Trainer's own jitted scan chunk. The march comes from
ops/kernels.select_kernels; the variants (xla, kernel, warm, warm_xla) are
those of burn_raymarching/utils/benchmark.py.

Fails when JAX finds no GPU. Usage:
  python scripts/bench_large.py --m 51200 --variants xla,kernel,warm,warm_xla
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from burn_raymarching.utils.benchmark import (  # noqa: E402
    build_variant,
    make_dataset,
    make_params,
    require_gpu,
    time_runs,
)


def large_config(batch: int = 16384, budget: int = 256, hier: bool = True,
                 warm_steps: int = 16, far_field: str = "member"):
    from burn_raymarching.config import LossConfig, TrainConfig

    return TrainConfig(
        loss=LossConfig(repulsion_far_field=far_field),
        batch_size=batch, use_culling=True, cull_budget=budget,
        cull_tile=512, cull_hierarchical=hier, cull_cluster_group=64,
        cull_cluster_budget=32, cluster_repulsion=True,
        weight_decay_mode="decoupled", warm_steps=warm_steps,
        checkpoint_dir=None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--m", type=int, default=51200)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--budget", type=int, default=256)
    ap.add_argument("--no-hier", dest="hier", action="store_false")
    ap.add_argument("--warm-steps", type=int, default=16)
    ap.add_argument("--variants", default="xla,kernel,warm,warm_xla")
    ap.add_argument("--rep-far-field", dest="rep_far", default="member",
                    choices=["member", "monopole"])
    args = ap.parse_args(argv)

    from burn_raymarching.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()
    print(require_gpu(), flush=True)
    cfg = large_config(args.batch, args.budget, args.hier, args.warm_steps,
                       args.rep_far)
    ds = make_dataset(10 * 256 * 256)
    padded, mask = make_params(args.m)
    print(f"M={args.m} batch={args.batch} budget={args.budget} "
          f"hier={args.hier} far_field={args.rep_far}", flush=True)
    for variant in args.variants.split(","):
        run, prefill_s = build_variant(cfg, ds, padded, mask,
                                       variant.strip(), args.steps)
        times = time_runs(run, args.steps, args.reps)
        extra = f" (prefill {prefill_s:.2f}s)" if prefill_s else ""
        print(f"{variant:>8}: median {np.median(times) * 1e3:.3f} ms/step "
              f"(runs {[round(t * 1e3, 3) for t in times]}) "
              f"{args.batch / np.median(times) / 1e6:.3f} Mrays/s{extra}",
              flush=True)


if __name__ == "__main__":
    main()
