"""Smoke test of the training and render path on one NVIDIA GPU.

Drives the system once through the entry points a user calls, at real sizes,
in one process, and fails loudly (non-zero exit, no result line) when any
phase fails or when JAX finds no GPU:

  0. the device: platform, kind, count, and the card's name and power limit
     as nvidia-smi reports them;
  1. kernel parity at real widths: each Triton march kernel against its XLA
     twin, cold (40 steps) and warm (16 steps from t_init) — dense at
     16,384 rays x 128 slots (100 live), culled at 32 tiles x 512 rays x
     K = 256 and K = 1024;
  2. the reference schedule: tools.generate builds the 10-view 256^2 scene,
     tools.train_cli trains it at batch 16,384 for 2 stages x 100 steps, once
     on the default path and once with --turbo;
  3. the large culled shape: a 100-view 256^2 knot capture (6.55 M rays) and
     a Trainer with 51,200 cloud-initialised spheres, hierarchical culling at
     K = 256, cluster repulsion, warm start and tile sampling — one stage
     boundary (the t-cache prefill) plus 20 steps;
  4. the tests marked ``gpu`` (pytest -m gpu), in this process.

``--four-cards`` runs only the sharded DistributedTrainer path on four
cards: (data=4) on the phase-2 shape, (data=2, model=2) on the phase-3
shape (the all_to_all union-table kernel march), and (data=1, model=4)
against the one-card step on the phase-2 shape's first-step loss.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Usage:
  python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Phase-1 tolerances, each Triton kernel against its XLA twin (the two
# compute the same float32 field, direct-form distances, up to the order of
# the logsumexp sums; see _compare):
T_RTOL = 1e-4     # |dt| <= T_RTOL * max(1, t) on rays with t < 40 ...
T_EXCEPT = 1e-3   # ... except at most this share of them (and of hit
#                   disagreements): rays still marching past a surface at
#                   the last step amplify rounding step by step
N_ATOL = 1e-4     # |dn| on every ray converged onto a surface in both
CONVERGED = 1e-3  # |field| at the final t below which a ray has converged

# Sizes (the reference's batch and image size; the large culled shape).
BATCH = 16384
IMAGE = 256
RAY_SIDE = 128         # phase-1 rays: RAY_SIDE^2 = 16,384 = 32 tiles x 512
CLOUD_M = 16384        # phase-1 culled scene
STAGE_STEPS = 100
KNOT_VIEWS = 100
C5_INIT_N = 51200
C5_STEPS = 20


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# --------------------------------------------------------------------------
# Phase 0


def phase_device(count: int):
    import jax

    devs = jax.devices()
    d = devs[0]
    log(f"[0] device: platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    check(d.platform == "gpu", f"no GPU: JAX runs on {d.platform!r}")
    check(len(devs) >= count, f"need {count} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        log(f"[0] nvidia-smi: {line.strip()}")
    return d


# --------------------------------------------------------------------------
# Phase 1


def _compare(name, rays, table, k, kernel_out, xla_out):
    """Kernel against XLA twin: rays (ro, rd) [B, T, 3], table (cs [B, K, 3],
    rs [B, K], qs [B, K]; qs 1e30 marks an invalid slot). On every ray with
    t < 40 in either: t within T_RTOL relative, at most a T_EXCEPT share
    outside it or hit (t < 40) in only one of the two. On every ray
    converged onto a surface in both (t < 40, |field| < CONVERGED):
    normals within N_ATOL. Prints the readings before checking them."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from burn_raymarching.render.culled import _tile_soft_min

    ro, rd = rays
    cs, rs, qs = table
    shape = ro.shape[:2]
    field = jax.jit(lambda t: jnp.abs(_tile_soft_min(
        ro + rd * t, cs, rs, qs, k, direct=True))[..., 0])
    out = {}
    for label, (t, n) in (("kernel", kernel_out), ("xla", xla_out)):
        t = jnp.reshape(t, shape + (1,))
        out[label] = (np.asarray(t)[..., 0],
                      np.asarray(n).reshape(shape + (3,)),
                      np.asarray(field(t)))
    (t_k, n_k, res_k), (t_x, n_x, res_x) = out["kernel"], out["xla"]
    check(np.isfinite(t_k).all() and np.isfinite(n_k).all(),
          f"{name}: non-finite kernel output")
    near = (t_x < 40.0) | (t_k < 40.0)
    one_hit = int(((t_x < 40.0) != (t_k < 40.0)).sum())
    conv = (t_x < 40.0) & (t_k < 40.0) & (res_x < CONVERGED) & (
        res_k < CONVERGED)
    dt = np.abs(t_k - t_x) / np.maximum(1.0, t_x)
    t_out = int((dt[near] > T_RTOL).sum())
    dn = np.abs(n_k - n_x).max(-1)
    limit = int(T_EXCEPT * near.sum())
    log(f"[1] {name}: rays={t_x.size} t<40={int(near.sum())} "
        f"hit in one only={one_hit} converged={int(conv.sum())} | "
        f"max|dt|/max(1,t): converged {dt[conv].max():.3e}, t<40 "
        f"{dt[near].max():.3e} ({t_out} > {T_RTOL:g}; p99.9 "
        f"{np.quantile(dt[near], 0.999):.3e}) | max|dn| converged "
        f"{dn[conv].max():.3e} (p99.9 {np.quantile(dn[conv], 0.999):.3e}), "
        f"t<40 {dn[near].max():.3e} | exceptions allowed {limit}")
    check(conv.sum() > 0.3 * near.sum(), f"{name}: too few converged rays")
    check(one_hit <= limit, f"{name}: kernel and twin disagree on hits")
    check(t_out <= limit, f"{name}: t differs from the XLA twin")
    check(dn[conv].max() <= N_ATOL, f"{name}: normals differ from the twin")


def _timed(fn, *args, reps=20):
    import jax

    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return out, (time.perf_counter() - t0) / reps * 1e3


def phase_kernel_parity():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from burn_raymarching.data.camera import create_camera_rays
    from burn_raymarching.models.scene import init_scene_params, pad_params
    from burn_raymarching.ops.culling import (
        select_tile_primitives,
        tile_cones,
    )
    from burn_raymarching.ops.kernels import select_kernels
    from burn_raymarching.utils.morton import morton_permutation

    gpu = select_kernels(True)
    xla = select_kernels(False)
    check(gpu.march_normal_fn is not xla.march_normal_fn,
          "the registry gave no kernel on the GPU")
    k = jnp.float32(18.5)

    # Dense: the bench's 100-sphere scene in a 128-slot bucket.
    rng = np.random.default_rng(0)
    params = init_scene_params(100)
    params.centers = jnp.asarray(rng.normal(0, 0.3, (100, 3)), jnp.float32)
    params.radii = jnp.asarray(rng.normal(-2.0, 0.3, (100, 1)), jnp.float32)
    padded, mask = pad_params(params, 128)
    centers = padded.centers
    radii = jax.nn.softplus(padded.radii) + 0.01
    ro, rd = create_camera_rays(RAY_SIDE, RAY_SIDE, [0.0, 0.5, -2.5],
                                [0, 0, 0], 50.0)
    dense = {}
    for name, fns in (("kernel", gpu), ("xla", xla)):
        f = jax.jit(lambda ro, rd, c, r, fn=fns.march_normal_fn:
                    fn(ro, rd, c, r, k, mask=mask))
        dense[name], ms = _timed(f, ro, rd, centers, radii)
        log(f"[1] dense cold {name}: {ms:.3f} ms")
    dense_rays = (ro[None], rd[None])
    dense_table = (centers[None], radii.reshape(1, -1),
                   jnp.where(mask, jnp.sum(centers * centers, 1), 1e30)[None])
    _compare(f"dense cold N={ro.shape[0]} M=128", dense_rays, dense_table,
             k, dense["kernel"], dense["xla"])
    t0 = 0.8 * dense["xla"][0]
    warm = {}
    for name, fns in (("kernel", gpu), ("xla", xla)):
        f = jax.jit(lambda ro, rd, c, r, t0, fn=fns.march_normal_fn:
                    fn(ro, rd, c, r, k, mask=mask, num_steps=16, t_init=t0))
        warm[name], ms = _timed(f, ro, rd, centers, radii, t0)
        log(f"[1] dense warm {name}: {ms:.3f} ms")
    _compare("dense warm-16", dense_rays, dense_table, k, warm["kernel"],
             warm["xla"])

    # Culled: Morton tiles of 512 rays (32 at full size) against a
    # CLOUD_M-sphere cloud, tables selected by the production top-K culling.
    c_cloud = jnp.asarray(rng.uniform(-0.8, 0.8, (CLOUD_M, 3)), jnp.float32)
    r_cloud = jnp.asarray(rng.uniform(0.01, 0.04, (CLOUD_M, 1)),
                          jnp.float32)
    perm = morton_permutation(RAY_SIDE, RAY_SIDE)
    ro_m, rd_m = ro[perm], rd[perm]
    cones = tile_cones(ro_m, rd_m, 512)
    n_tiles = ro.shape[0] // 512
    ro3, rd3 = ro_m.reshape(n_tiles, 512, 3), rd_m.reshape(n_tiles, 512, 3)
    kc = jnp.float32(128.0)
    for budget in (256, 1024):
        idx, valid = select_tile_primitives(cones, c_cloud, r_cloud, kc,
                                            budget)
        cs = jnp.take(c_cloud, idx, axis=0)
        rs = jnp.take(r_cloud.reshape(-1), idx, axis=0)
        qs = jnp.where(valid, jnp.sum(cs * cs, axis=2), 1e30)
        for steps, t_init, label in ((40, None, "cold"),
                                     (16, "warm", "warm-16")):
            res = {}
            for name, fns in (("kernel", gpu), ("xla", xla)):
                f = jax.jit(lambda *a, fn=fns.culled_march_normal_fn,
                            n=steps: fn(*a[:5], kc, num_steps=n,
                                        t_init=a[5] if len(a) > 5 else None))
                args = (ro3, rd3, cs, rs, qs)
                if t_init is not None:
                    args = args + (0.8 * cold_t,)
                res[name], ms = _timed(f, *args)
                log(f"[1] culled K={budget} {label} {name}: {ms:.3f} ms")
            if t_init is None:
                cold_t = res["xla"][0]
            _compare(f"culled {n_tiles}x512 K={budget} {label}",
                     (ro3, rd3), (cs, rs, qs), kc, res["kernel"],
                     res["xla"])


# --------------------------------------------------------------------------
# Phases 2 and 3


def _step_memory(tr, padded, mask, label):
    """compiled.memory_analysis() of the trainer's scan-chunk program."""
    import jax
    import jax.numpy as jnp

    opt_state = tr.tx.init(padded)
    cl_idx, cl_valid = tr._build_cluster_table(padded, mask)
    t_cache = (tr.t_cache if tr.t_cache is not None
               else jnp.zeros((0,), jnp.float32))
    ds = tr.dataset
    compiled = tr._step_fn.lower(
        padded, opt_state, jax.random.PRNGKey(0), mask, ds.packed,
        tr._sample_fg[0], tr._sample_fg[1], t_cache,
        jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32), cl_idx,
        cl_valid).compile()
    log(f"[mem] {label}: {compiled.memory_analysis()}")


def _batch_loss(params, mask, ds, cfg, n=BATCH):
    """Training loss of ``params`` on a fixed batch (first n fg-boosted
    pixels, progress 1) — comparable across parameter sets."""
    import jax.numpy as jnp
    import numpy as np

    from burn_raymarching.models.scene import scene_forward
    from burn_raymarching.train.loss import compute_loss

    idx = np.asarray(ds.fg_indices)[:n]
    ro, rd = ds.rays_o[idx], ds.rays_d[idx]
    tgt = jnp.asarray(np.asarray(ds.targets)[idx])
    out = scene_forward(params, ro, rd, jnp.float32(cfg.max_smooth_k),
                        mask=mask)
    return float(compute_loss(params, out, tgt, jnp.float32(1.0), mask=mask,
                              cfg=cfg.loss))


def _generate(out, extra=()):
    from burn_raymarching.tools import generate

    generate.main(["--out", out, "--size", str(IMAGE), *extra])
    return os.path.join(out, "cameras.json")


def phase_reference_schedule(work):
    import jax.numpy as jnp
    import numpy as np

    from burn_raymarching.data.image_io import load_image_as_array
    from burn_raymarching.data.scene_io import load_cameras
    from burn_raymarching.models.scene import init_scene_params, pad_params
    from burn_raymarching.tools import train_cli
    from burn_raymarching.train.evaluate import evaluate_views

    cams_json = _generate(os.path.join(work, "dango"))
    cams = load_cameras(cams_json)
    tgts = [load_image_as_array(c["file"]) for c in cams]
    for variant in ([], ["--turbo"]):
        label = "turbo" if variant else "default"
        out = os.path.join(work, f"run_{label}")
        t0 = time.perf_counter()
        tr, padded, mask = train_cli.main([
            "--cameras", cams_json, "--batch", str(BATCH), "--stages", "2",
            "--steps", str(STAGE_STEPS), "--width", str(IMAGE),
            "--height", str(IMAGE),
            "--scene-out", os.path.join(out, "scene.json"),
            "--steps-dir", os.path.join(out, "steps"), "--checkpoint-dir", "",
            *variant])
        wall = time.perf_counter() - t0
        cfg = tr.cfg
        check(tr.warm == bool(variant), f"{label}: warm start is {tr.warm}")
        init, init_mask = pad_params(
            init_scene_params(cfg.init_n, cfg.init_offset,
                              cfg.init_ambient_logit), 8)
        l0 = _batch_loss(init, init_mask, tr.dataset, cfg)
        l1 = _batch_loss(padded, mask, tr.dataset, cfg)
        psnr = evaluate_views(
            padded, cams, tgts, cfg.width, cfg.height, mask=mask,
            smooth_k=cfg.max_smooth_k,
            march_normal_fn=tr.march_normal_fn)["mean"]
        n_live = int(np.asarray(mask).sum())
        log(f"[2] {label}: loss {l0:.5f} -> {l1:.5f}, PSNR {psnr:.2f} dB, "
            f"N={n_live}, {wall / (2 * STAGE_STEPS) * 1e3:.1f} ms/step wall "
            f"incl. "
            f"compile and stage boundaries (information only)")
        check(l1 < l0, f"{label}: loss did not fall ({l0} -> {l1})")
        check(np.isfinite(psnr), f"{label}: PSNR is not finite")
        for f in ("scene.json", "steps/stage_0.png", "steps/final_1.png"):
            check(os.path.getsize(os.path.join(out, f)) > 0,
                  f"{label}: {f} not written")
        _step_memory(tr, padded, mask, f"dense step ({label})")
        check(bool(jnp.isfinite(padded.centers).all()),
              f"{label}: non-finite params")
    return cams_json


def c5_config(cams_json, **kw):
    from burn_raymarching.config import LossConfig, RenderConfig, TrainConfig

    base = dict(
        batch_size=BATCH, width=IMAGE, height=IMAGE, stages=1,
        steps_per_stage=C5_STEPS, steps_per_call=C5_STEPS, base_lr=0.02,
        init_n=C5_INIT_N, init_layout="cloud",
        init_points=os.path.join(os.path.dirname(cams_json), "points.json"),
        use_culling=True, cull_budget=256, cull_hierarchical=True,
        cull_cluster_budget=32, cluster_repulsion=True,
        warm_start=True, warm_steps=16, sample_mode="tile",
        dataset_order="morton", weight_decay_mode="decoupled",
        min_smooth_k=128.0, max_smooth_k=128.0,
        lr_scale_centers=0.001, lr_scale_radii=0.1, lr_scale_light=0.5,
        render=RenderConfig(softmax_sharpness=40.0, mask_sharpness=60.0),
        loss=LossConfig(), cameras_json=cams_json, checkpoint_dir=None)
    base.update(kw)
    return TrainConfig(**base)


def knot_capture(work):
    return _generate(os.path.join(work, "knot"), [
        "--scene", "knot", "--knot-n", "2000", "--views", str(KNOT_VIEWS),
        "--gt-k", "128", "--gt-sharp", "40"])


def _init_params(cfg):
    import json

    import numpy as np

    from burn_raymarching.models.scene import init_scene_params_cloud

    with open(cfg.init_points) as f:
        pts = np.asarray(json.load(f)["points"], np.float32).reshape(-1, 3)
    return init_scene_params_cloud(
        cfg.init_n, seed=cfg.seed, extent=cfg.init_cloud_extent,
        radius=cfg.init_cloud_radius, ambient_logit=cfg.init_ambient_logit,
        points=pts, jitter=cfg.init_points_jitter)


def phase_large_culled(work):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from burn_raymarching.models.scene import pad_params
    from burn_raymarching.train.loop import Trainer, build_dataset

    cams_json = knot_capture(work)
    cfg = c5_config(cams_json)
    ds = build_dataset(cfg)
    log(f"[3] knot capture: {ds.num_total_pixels} rays, fg {ds.num_fg}")
    check(ds.num_total_pixels == KNOT_VIEWS * IMAGE * IMAGE, "capture size")
    tr = Trainer(cfg, ds, log=log)
    params = _init_params(cfg)
    t0 = time.perf_counter()
    padded, mask, loss = tr.run_stage(params, 0, jax.random.PRNGKey(0))
    jax.block_until_ready(padded)
    wall = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[3] prefill + {C5_STEPS} steps: {wall:.1f} s wall incl. compile, "
        f"loss {float(loss):.5f}, peak_bytes_in_use "
        f"{stats.get('peak_bytes_in_use')}")
    check(np.isfinite(float(loss)), "c5: non-finite loss")
    for leaf in jax.tree.leaves(padded):
        check(bool(jnp.isfinite(leaf).all()), "c5: non-finite params")
    tc = np.asarray(tr.t_cache)
    check(np.isfinite(tc).all() and tc.max() > 0, "c5: t cache not filled")
    pad, m = pad_params(params, tr._bucket(params.n))
    _step_memory(tr, pad, m, "c5 step")
    return cams_json


# --------------------------------------------------------------------------
# Phase 4


def phase_gpu_tests():
    import pytest

    class Outcomes:
        def __init__(self):
            self.passed = self.other = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed or report.skipped:
                self.other += 1

    seen = Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(REPO, "tests")],
                     plugins=[seen])
    log(f"[4] pytest -m gpu: exit {int(rc)}, {seen.passed} passed, "
        f"{seen.other} failed or skipped")
    check(int(rc) == 0 and seen.passed > 0 and seen.other == 0,
          "GPU-marked tests did not all pass")


# --------------------------------------------------------------------------
# --four-cards


def phase_four_cards(work):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from burn_raymarching.config import TrainConfig
    from burn_raymarching.parallel.distributed import DistributedTrainer
    from burn_raymarching.train.loop import Trainer, build_dataset

    def finite(tree, what):
        for leaf in jax.tree.leaves(tree):
            check(bool(jnp.isfinite(leaf).all()), f"{what}: non-finite")

    dango = _generate(os.path.join(work, "dango"))
    cfg = TrainConfig(batch_size=BATCH, stages=2,
                      steps_per_stage=STAGE_STEPS, width=IMAGE, height=IMAGE,
                      cameras_json=dango, checkpoint_dir=None,
                      steps_dir=os.path.join(work, "steps4"),
                      scene_json=os.path.join(work, "scene4.json"))
    tr = DistributedTrainer(cfg, build_dataset(cfg), data=4, model=1,
                            log=log)
    t0 = time.perf_counter()
    padded, mask = tr.run()
    log(f"[4c] data=4 reference schedule: {time.perf_counter() - t0:.1f} s "
        f"wall incl. compile, losses {tr.loss_history}")
    finite(padded, "data=4")

    knot = knot_capture(work)
    cfg5 = c5_config(knot)
    ds5 = build_dataset(cfg5)
    params = _init_params(cfg5)
    tr = DistributedTrainer(cfg5, ds5, data=2, model=2, log=log)
    t0 = time.perf_counter()
    padded, mask, loss = tr.run_stage(tr._prepare_stage_params(params), 0,
                                      jax.random.PRNGKey(0))
    jax.block_until_ready(padded)
    log(f"[4c] data=2 model=2 c5 prefill + {C5_STEPS} steps: "
        f"{time.perf_counter() - t0:.1f} s wall incl. compile, loss "
        f"{float(loss):.5f}")
    finite(padded, "data=2 model=2")

    # Exact-equivalence hook: a 1-wide data axis samples like one card, so
    # the (data=1, model=4) step on the phase-2 shape must reproduce the
    # one-card first-step loss up to the reduction order of the sharded
    # soft-min. (On the culled shape each shard selects its own top-K, a
    # different approximation whenever the budget binds.)
    from burn_raymarching.models.scene import init_scene_params

    cfg1 = dataclasses.replace(cfg, stages=1, steps_per_stage=1,
                               steps_per_call=1)
    ds1 = build_dataset(cfg1)
    init = init_scene_params(cfg1.init_n, cfg1.init_offset,
                             cfg1.init_ambient_logit)
    first = {}
    for label, make in (
            ("one card", lambda: Trainer(cfg1, ds1, log=lambda s: None)),
            ("data=1 model=4", lambda: DistributedTrainer(
                cfg1, ds1, data=1, model=4, log=lambda s: None))):
        tr = make()
        _, _, loss = tr.run_stage(tr._prepare_stage_params(init), 0,
                                  jax.random.PRNGKey(0))
        first[label] = float(loss)
    rel = abs(first["one card"] - first["data=1 model=4"]) / abs(
        first["one card"])
    log(f"[4c] first-step loss: one card {first['one card']:.8f}, "
        f"data=1 model=4 {first['data=1 model=4']:.8f}, rel diff {rel:.2e}")
    check(rel <= 1e-5, "model-sharded first step differs from one card")


# --------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "burn_raymarching")):
        log("FAIL: the burn_raymarching package is not next to this "
            "script")
        return 1
    sys.path.insert(0, REPO)
    from burn_raymarching.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()
    work = tempfile.mkdtemp(prefix=".smoke_", dir=REPO)
    try:
        dev = phase_device(4 if args.four_cards else 1)
        if args.four_cards:
            phase_four_cards(work)
        else:
            phase_kernel_parity()
            phase_reference_schedule(work)
            phase_large_culled(work)
            phase_gpu_tests()
    except (SmokeFailure, subprocess.SubprocessError, OSError) as e:
        log(f"FAIL: {type(e).__name__}: {e}")
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
