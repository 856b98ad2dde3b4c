"""Shared pieces of the train-step benchmarks (bench.py,
scripts/bench_large.py): the device line, synthetic scenes and datasets,
and one timed Trainer scan chunk per march variant:

  * xla      — the XLA march twin, cold (cfg.render.march_steps);
  * kernel   — the Triton march kernel, cold;
  * warm     — the kernel warm-started from the per-pixel t cache
               (cfg.warm_steps);
  * warm_xla — the XLA twin warm-started.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

VARIANTS = ("xla", "kernel", "warm", "warm_xla")


def require_gpu() -> str:
    """The device line every benchmark prints first; exits without a GPU."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit(f"no GPU: JAX runs on {d.platform!r}; the benchmark "
                 "measures the GPU only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return (f"device: platform={d.platform} kind={d.device_kind} "
            f"count={len(jax.devices())} nvidia-smi: {smi}")


def make_dataset(n_pixels: int, seed: int = 0):
    from burn_raymarching.data.camera import create_camera_rays
    from burn_raymarching.data.dataset import RayDataset

    side = 256
    ro, rd = create_camera_rays(side, side, [0.0, 0.5, -2.5], [0, 0, 0], 50.0)
    reps = max(1, n_pixels // (side * side))
    ro = jnp.tile(ro, (reps, 1))
    rd = jnp.tile(rd, (reps, 1))
    tgt = jnp.clip(jnp.abs(rd), 0, 1)
    return RayDataset(ro, rd, tgt)


def make_params(m: int, seed: int = 0, radius_logit: float = -4.0,
                extent: float = 0.8, m_pad: int = 0):
    from burn_raymarching.models.scene import init_scene_params, pad_params

    rng = np.random.default_rng(seed)
    params = init_scene_params(m)
    params.centers = jnp.asarray(rng.uniform(-extent, extent, (m, 3)),
                                 jnp.float32)
    params.radii = jnp.asarray(rng.normal(radius_logit, 0.3, (m, 1)),
                               jnp.float32)
    params.colors = jnp.asarray(rng.normal(0, 0.5, (m, 3)), jnp.float32)
    return pad_params(params, m_pad or m)


def build_variant(cfg, ds, padded, mask, variant: str, steps: int):
    """(run(key) -> step outputs, prefill seconds) for one variant."""
    from burn_raymarching.train.loop import Trainer

    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    cfg = dataclasses.replace(
        cfg, use_pallas=variant in ("kernel", "warm"),
        warm_start=variant.startswith("warm"), steps_per_stage=steps,
        steps_per_call=steps)
    tr = Trainer(cfg, ds, log=lambda s: None)
    cl_idx, cl_valid = tr._build_cluster_table(padded, mask)
    prefill_s = 0.0
    if tr.warm:
        t0 = time.perf_counter()
        tr.prefill_t_cache(padded, mask, cfg.max_smooth_k)
        jax.block_until_ready(tr.t_cache)
        prefill_s = time.perf_counter() - t0
    t_cache = (tr.t_cache if tr.warm else jnp.zeros((0,), jnp.float32))
    opt_state = tr.tx.init(padded)
    stage = jnp.asarray(cfg.stages - 1, jnp.int32)

    def run(key):
        return tr._step_fn(padded, opt_state, key, mask, ds.packed,
                           tr._sample_fg[0], tr._sample_fg[1], t_cache,
                           stage, jnp.asarray(0, jnp.int32), cl_idx,
                           cl_valid)

    return run, prefill_s


def time_runs(run, steps: int, reps: int) -> list[float]:
    """Per-step seconds of ``reps`` timed chunks (after one compile run)."""
    np.asarray(run(jax.random.PRNGKey(0))[3])
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        out = run(jax.random.PRNGKey(r + 1))
        losses = np.asarray(out[3])
        times.append((time.perf_counter() - t0) / steps)
    if not np.isfinite(losses).all():
        raise RuntimeError("non-finite loss")
    return times
