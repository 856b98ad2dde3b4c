"""Benchmark: the full training step on one GPU, kernel against XLA.

Times the Trainer's own jitted scan chunk (on-device batch sampling +
march + reattach + normals + shade/composite + 5-term loss + backward +
Adam + t-cache update) at the reference workload shape: batch 16,384 rays
(reference src/bin/train.rs:30), 100 live primitives in a 128-slot bucket,
a 10-view 256x256 dataset. The march comes from ops/kernels.select_kernels;
the variants (burn_raymarching/utils/benchmark.py) are the XLA twin and
the Triton kernel, each cold (40 steps) and warm-started from the t cache
(--turbo).

It also times two layers in isolation, each as a scan of forward+backward
passes: the shade/composite/loss tail of the dense --turbo step, and the
cluster repulsion term at M = 51,200 (both far fields).

Fails when JAX finds no GPU. Prints the device line first and one JSON
line last. Usage:
  python bench.py [--steps 100] [--reps 5]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from burn_raymarching.utils import benchmark as bl  # noqa: E402


def _scan_time(f, carry, iters=100, reps=5):
    """Median seconds per iteration of ``carry = f(carry)`` scanned."""
    run = jax.jit(lambda c: jax.lax.scan(lambda c, _: (f(c), None), c,
                                         None, length=iters)[0])
    jax.block_until_ready(run(carry))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(carry))
        times.append((time.perf_counter() - t0) / iters)
    return float(np.median(times))


def shade_tail_time(batch=16384):
    """Forward+backward of the dense --turbo step's differentiable tail:
    reattach + shade + composite + coverage + loss, given a detached
    (t, normal) from the march."""
    from burn_raymarching.config import TrainConfig
    from burn_raymarching.data.camera import create_camera_rays
    from burn_raymarching.models.scene import activate, scene_forward
    from burn_raymarching.ops.kernels import select_kernels
    from burn_raymarching.train.loss import compute_loss

    cfg = TrainConfig()
    padded, mask = bl.make_params(100, radius_logit=-2.0, extent=0.5,
                                  m_pad=128)
    side = int(batch ** 0.5)
    ro, rd = create_camera_rays(side, side, [0.0, 0.5, -2.5], [0, 0, 0],
                                50.0)
    tgt = jnp.clip(jnp.abs(rd), 0, 1)
    k = jnp.float32(18.5)
    c, _, r, _, _ = activate(padded)
    t, normal = select_kernels(True).march_normal_fn(
        ro, rd, c, r, k, mask=mask, num_steps=cfg.render.march_steps)

    def step(p):
        def loss_fn(p):
            out = scene_forward(p, ro, rd, k, mask=mask,
                                march_normal_fn=lambda *a, **kw: (t, normal))
            return compute_loss(p, out, tgt, jnp.float32(0.5), mask=mask,
                                cfg=cfg.loss)

        g = jax.grad(loss_fn)(p)
        return jax.tree.map(lambda a, b: a - 1e-6 * b, p, g)

    return _scan_time(step, padded)


def repulsion_time(m=51200, far_field="member"):
    """Forward+backward of the cluster repulsion term with chunk-frozen
    static tables, as in the M = 51,200 culled step."""
    from burn_raymarching.ops.culling import build_clusters
    from burn_raymarching.train.loss import (
        build_repulsion_static,
        cluster_repulsion,
    )

    padded, mask = bl.make_params(m)
    cl = build_clusters(np.asarray(padded.centers), mask=np.asarray(mask),
                        group=64)
    static = build_repulsion_static(padded.centers, cl, mask)
    n_valid = jnp.sum(mask.astype(jnp.float32))

    def step(c):
        g = jax.grad(lambda c: cluster_repulsion(
            c, cl, mask, n_valid, far_field=far_field, static=static))(c)
        return c - 1e-9 * g

    return _scan_time(step, padded.centers)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", default="kernel,xla,warm,warm_xla")
    ap.add_argument("--no-layers", dest="layers", action="store_false")
    args = ap.parse_args(argv)

    from burn_raymarching.config import TrainConfig
    from burn_raymarching.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()
    print(bl.require_gpu(), flush=True)
    cfg = TrainConfig(batch_size=16384)
    padded, mask = bl.make_params(100, radius_logit=-2.0, extent=0.5,
                                  m_pad=128)
    ds = bl.make_dataset(10 * 256 * 256)
    rays = {}
    for variant in args.variants.split(","):
        run, prefill_s = bl.build_variant(cfg, ds, padded, mask, variant,
                                          args.steps)
        times = bl.time_runs(run, args.steps, args.reps)
        med = float(np.median(times))
        rays[variant] = cfg.batch_size / med
        print(f"dense {variant:>8}: median {med * 1e3:.4f} ms/step (runs "
              f"{[round(t * 1e3, 4) for t in times]}) "
              f"{rays[variant] / 1e6:.3f} Mrays/s", flush=True)
    if args.layers:
        print(f"layer shade tail (dense, fwd+bwd): "
              f"{shade_tail_time() * 1e3:.4f} ms", flush=True)
        for ff in ("member", "monopole"):
            print(f"layer repulsion M=51200 {ff} (fwd+bwd): "
                  f"{repulsion_time(far_field=ff) * 1e3:.4f} ms", flush=True)
    best = max(rays, key=rays.get)
    d = jax.devices()[0]
    print(json.dumps({
        "metric": "train_step_rays_per_s",
        "value": round(rays[best], 1),
        "unit": "rays/s",
        "variant": best,
        "vs_baseline": (round(rays[best] / rays["xla"], 3)
                        if "xla" in rays else None),
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
