"""Culled march+normals kernel (ops/pallas/march_kernel.py, Triton route, in
interpret mode on the CPU) against the XLA culled path."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from burn_raymarching.data.camera import create_camera_rays
from burn_raymarching.ops.culling import (
    gather_tile_tables,
    select_tile_primitives,
    tile_cones,
)
from burn_raymarching.ops.pallas.march_kernel import (
    culled_march_normals_triton,
)
from burn_raymarching.render.culled import render_diff_culled

TILE = 64
K_BUDGET = 4


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(7)
    m = 9
    centers = jnp.asarray(rng.normal(0, 0.35, (m, 3)), jnp.float32)
    radii = jnp.asarray(0.05 + 0.15 * rng.random((m, 1)), jnp.float32)
    colors = jnp.asarray(rng.random((m, 3)), jnp.float32)
    light = jnp.asarray([0.3, 1.0, -0.4], jnp.float32)
    ambient = jnp.asarray([0.2], jnp.float32)
    ro, rd = create_camera_rays(16, 16, [0.0, 0.5, -2.5], [0.0, 0.0, 0.0],
                                50.0)
    return ro, rd, centers, colors, radii, light, ambient


def _kernel(**kw):
    return functools.partial(culled_march_normals_triton, interpret=True,
                             block_rays=16, **kw)


def _render(scene, **kw):
    ro, rd, c, col, r, light, amb = scene
    return render_diff_culled(ro, rd, c, col, r, light, amb, 18.5,
                              tile=TILE, k_budget=K_BUDGET, **kw)


def test_kernel_render_matches_xla(scene):
    # atol 2e-4: on missed/near-miss rays the 6 normal taps difference
    # ~1e-4-scale field values — below f32 ulp at those magnitudes — so
    # the (detached, coverage-suppressed) normals are rounding-noise
    # directions in BOTH paths; tiny op-order differences surface as
    # ~1e-4 output wiggle on low-coverage silhouette pixels (same
    # sensitivity the golden-image tests budget for).
    out_ref = np.asarray(_render(scene))
    out_pl = np.asarray(_render(scene, march_normal_fn=_kernel()))
    np.testing.assert_allclose(out_pl, out_ref, rtol=1e-3, atol=2e-4)


def test_kernel_t_normal_match_xla_internals(scene):
    """Direct t/normal comparison against a hand-run XLA culled march."""
    from burn_raymarching.ops.march import T_MAX
    from burn_raymarching.render.culled import (
        _tile_normals,
        _tile_soft_min,
    )

    ro, rd, centers, colors, radii, _, _ = scene
    k = jnp.float32(18.5)
    cones = tile_cones(ro, rd, TILE)
    idx, valid = select_tile_primitives(cones, centers, radii, k, K_BUDGET)
    cs, _, rs, qs = gather_tile_tables(centers, colors, radii, idx, valid)
    b = ro.shape[0] // TILE
    ro3 = ro.reshape(b, TILE, 3)
    rd3 = rd.reshape(b, TILE, 3)

    def sdf(t):
        return _tile_soft_min(ro3 + rd3 * t, cs, rs, qs, k, direct=True)

    t_ref = jax.lax.fori_loop(
        0, 40, lambda _, t: jnp.minimum(t + sdf(t), T_MAX),
        jnp.zeros((b, TILE, 1)))
    p_final = ro3 + rd3 * (t_ref + sdf(t_ref))
    n_ref = _tile_normals(p_final, cs, rs, qs, k)

    t_pl, n_pl = _kernel()(ro3, rd3, cs, rs, qs, k)
    np.testing.assert_allclose(np.asarray(t_pl), np.asarray(t_ref),
                               rtol=1e-5, atol=1e-5)
    # Normals are only meaningful where the ray converged inside the scene
    # bound; on missed rays (t ~ T_MAX) the taps difference rounding noise.
    # On hits both paths take the same direct-form field, so the normals
    # agree to the phase-1 tolerance of chip_smoke.py.
    hit = np.asarray(t_ref)[..., 0] < 20.0
    assert hit.any()
    np.testing.assert_allclose(np.asarray(n_pl)[hit], np.asarray(n_ref)[hit],
                               atol=1e-4)


def test_kernel_warm_start_matches_xla(scene):
    """t_init + reduced steps equals the XLA march from the same roots."""
    from burn_raymarching.ops.march import T_MAX
    from burn_raymarching.render.culled import _tile_soft_min

    ro, rd, centers, colors, radii, _, _ = scene
    k = jnp.float32(32.0)
    cones = tile_cones(ro, rd, TILE)
    idx, valid = select_tile_primitives(cones, centers, radii, k, K_BUDGET)
    cs, _, rs, qs = gather_tile_tables(centers, colors, radii, idx, valid)
    b = ro.shape[0] // TILE
    ro3 = ro.reshape(b, TILE, 3)
    rd3 = rd.reshape(b, TILE, 3)
    t0 = jnp.full((b, TILE, 1), 0.7, jnp.float32)

    def body(_, t):
        return jnp.minimum(
            t + _tile_soft_min(ro3 + rd3 * t, cs, rs, qs, k, direct=True),
            T_MAX)

    t_ref = jax.lax.fori_loop(0, 8, body, t0)
    t_pl, _ = _kernel()(ro3, rd3, cs, rs, qs, k, num_steps=8, t_init=t0)
    np.testing.assert_allclose(np.asarray(t_pl), np.asarray(t_ref),
                               rtol=1e-5, atol=1e-5)


def test_precomputed_path_matches_and_grads_flow(scene):
    """The trainer's detached-precompute route: same output, same gradients
    as the in-renderer XLA march (the gradient topology is unchanged — the
    march never carried gradients, reference renderer_diff.rs:25). The
    precompute is the XLA twin, so both routes share their arithmetic; the
    kernel's own parity with the twin is pinned by the tests above."""
    from burn_raymarching.render.culled import culled_march_normals_xla

    ro, rd, centers, colors, radii, light, amb = scene
    k = jnp.float32(18.5)
    cones = tile_cones(ro, rd, TILE)
    idx, valid = select_tile_primitives(cones, centers, radii, k, K_BUDGET)
    cs = jnp.take(centers, idx, axis=0)
    rs = jnp.take(radii.reshape(-1), idx, axis=0)
    qs = jnp.where(valid, jnp.sum(cs * cs, axis=2), 1e30)
    b = ro.shape[0] // TILE
    t, normal = culled_march_normals_xla(ro.reshape(b, TILE, 3),
                                         rd.reshape(b, TILE, 3), cs, rs, qs,
                                         k)

    def loss_pre(c, col, r, ld, a):
        out = render_diff_culled(ro, rd, c, col, r, ld, a, k, tile=TILE,
                                 k_budget=K_BUDGET,
                                 precomputed=(idx, valid, t, normal))
        return jnp.sum(out ** 2), out

    def loss_ref(c, col, r, ld, a):
        out = render_diff_culled(ro, rd, c, col, r, ld, a, k, tile=TILE,
                                 k_budget=K_BUDGET)
        return jnp.sum(out ** 2), out

    (lv_p, out_p), g_p = jax.value_and_grad(loss_pre, argnums=(0, 1, 2, 3, 4),
                                            has_aux=True)(
        centers, colors, radii, light, amb)
    (lv_r, out_r), g_r = jax.value_and_grad(loss_ref, argnums=(0, 1, 2, 3, 4),
                                            has_aux=True)(
        centers, colors, radii, light, amb)
    np.testing.assert_allclose(np.asarray(out_p), np.asarray(out_r),
                               rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(float(lv_p), float(lv_r), rtol=1e-4)
    # Tolerances budget the detached-normal tap noise (see
    # test_kernel_t_normal_match_xla_internals) flowing through lighting.
    for a, b_ in zip(g_p, g_r):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                   rtol=5e-3, atol=1e-4)


def test_ragged_tile_t_padding(scene):
    """T not a multiple of the ray block: masked loads and stores."""
    ro, rd, centers, colors, radii, _, _ = scene
    k = jnp.float32(18.5)
    cones = tile_cones(ro, rd, TILE)
    idx, valid = select_tile_primitives(cones, centers, radii, k, K_BUDGET)
    cs, _, rs, qs = gather_tile_tables(centers, colors, radii, idx, valid)
    b = ro.shape[0] // TILE
    ro3 = ro.reshape(b, TILE, 3)[:, :40]
    rd3 = rd.reshape(b, TILE, 3)[:, :40]
    t_full, n_full = _kernel()(ro.reshape(b, TILE, 3),
                               rd.reshape(b, TILE, 3), cs, rs, qs, k)
    t_r, n_r = _kernel()(ro3, rd3, cs, rs, qs, k)
    assert t_r.shape == (b, 40, 1) and n_r.shape == (b, 40, 3)
    np.testing.assert_allclose(np.asarray(t_r), np.asarray(t_full[:, :40]),
                               rtol=1e-5, atol=1e-5)


def test_trainer_culled_kernel_path(scene_root, tmp_path, monkeypatch):
    """End-to-end: the trainer's culled precompute branch (kernel in
    interpret mode) trains finitely, warm-start cache included."""
    from burn_raymarching.config import TrainConfig
    from burn_raymarching.train.loop import Trainer, build_dataset

    cfg = TrainConfig(
        batch_size=512, stages=1, steps_per_stage=4, steps_per_call=4,
        use_pallas=False, use_culling=True, cull_budget=8, cull_tile=128,
        warm_start=True, warm_steps=6, dataset_order="morton",
        checkpoint_dir=None,
        cameras_json=os.path.join(scene_root, "data/cameras.json"),
    )
    cwd = os.getcwd()
    os.chdir(scene_root)
    try:
        ds = build_dataset(cfg)
    finally:
        os.chdir(cwd)
    monkeypatch.chdir(tmp_path)
    tr = Trainer(cfg, ds, log=lambda s: None)
    # Inject the interpret-mode kernel (on the GPU ops/kernels wires the
    # compiled one); rebuild the jitted step around it.
    tr.culled_march_normal_fn = _kernel()
    tr.warm = True
    tr.t_cache = jnp.zeros((ds.num_total_pixels,), jnp.float32)
    tr._step_fn = tr._build_step()
    padded, mask = tr.run()
    for leaf in [padded.centers, padded.colors, padded.radii,
                 padded.light_dir, padded.ambient]:
        assert np.isfinite(np.asarray(leaf)).all()
    assert np.isfinite(np.asarray(tr.t_cache)).all()
    assert float(jnp.max(tr.t_cache)) > 0.0


def test_trainer_culled_kernel_cold_path(scene_root, tmp_path,
                                         monkeypatch):
    """Cold (non-warm) culled kernel branch: full march_steps per step."""
    from burn_raymarching.config import TrainConfig
    from burn_raymarching.train.loop import Trainer, build_dataset

    cfg = TrainConfig(
        batch_size=512, stages=1, steps_per_stage=2, steps_per_call=2,
        use_pallas=False, use_culling=True, cull_budget=8, cull_tile=128,
        dataset_order="morton", checkpoint_dir=None,
        cameras_json=os.path.join(scene_root, "data/cameras.json"),
    )
    cfg = dataclasses.replace(cfg)
    cwd = os.getcwd()
    os.chdir(scene_root)
    try:
        ds = build_dataset(cfg)
    finally:
        os.chdir(cwd)
    monkeypatch.chdir(tmp_path)
    tr = Trainer(cfg, ds, log=lambda s: None)
    tr.culled_march_normal_fn = _kernel()
    tr._step_fn = tr._build_step()
    padded, mask = tr.run()
    for leaf in [padded.centers, padded.colors, padded.radii]:
        assert np.isfinite(np.asarray(leaf)).all()


def test_xla_twin_matches_kernel(scene):
    """render/culled.culled_march_normals_xla (the CPU's culled march and
    the sharded step's fallback) == the kernel on identical tables."""
    from burn_raymarching.render.culled import culled_march_normals_xla

    ro, rd, centers, colors, radii, _, _ = scene
    k = jnp.float32(18.5)
    cones = tile_cones(ro, rd, TILE)
    idx, valid = select_tile_primitives(cones, centers, radii, k, K_BUDGET)
    cs, _, rs, qs = gather_tile_tables(centers, colors, radii, idx, valid)
    b = ro.shape[0] // TILE
    ro3 = ro.reshape(b, TILE, 3)
    rd3 = rd.reshape(b, TILE, 3)

    t_x, n_x = culled_march_normals_xla(ro3, rd3, cs, rs, qs, k)
    t_pl, n_pl = _kernel()(ro3, rd3, cs, rs, qs, k)
    np.testing.assert_allclose(np.asarray(t_x), np.asarray(t_pl),
                               rtol=1e-5, atol=1e-5)
    hit = np.asarray(t_x)[..., 0] < 20.0
    assert hit.any()
    np.testing.assert_allclose(np.asarray(n_x)[hit], np.asarray(n_pl)[hit],
                               atol=1e-4)

    # Warm start: both paths from the same nonzero t_init and fewer steps.
    t0 = t_x * 0.8
    t_xw, _ = culled_march_normals_xla(ro3, rd3, cs, rs, qs, k,
                                       num_steps=8, t_init=t0)
    t_plw, _ = _kernel()(ro3, rd3, cs, rs, qs, k, num_steps=8, t_init=t0)
    np.testing.assert_allclose(np.asarray(t_xw), np.asarray(t_plw),
                               rtol=1e-5, atol=1e-5)


def test_kernel_multi_chunk_table_and_masked_slots(scene):
    """K wider than one table chunk (online logsumexp over chunks, ragged
    last chunk) with invalid slots: equals the XLA twin."""
    from burn_raymarching.render.culled import culled_march_normals_xla

    ro, rd, centers, colors, radii, _, _ = scene
    k = jnp.float32(18.5)
    cones = tile_cones(ro, rd, TILE)
    idx, valid = select_tile_primitives(cones, centers, radii, k, 7)
    valid = valid.at[:, 5:].set(False)
    cs, _, rs, qs = gather_tile_tables(centers, colors, radii, idx, valid)
    b = ro.shape[0] // TILE
    ro3 = ro.reshape(b, TILE, 3)
    rd3 = rd.reshape(b, TILE, 3)
    t_x, _ = culled_march_normals_xla(ro3, rd3, cs, rs, qs, k)
    t_k, _ = _kernel(block_prims=2)(ro3, rd3, cs, rs, qs, k)
    np.testing.assert_allclose(np.asarray(t_k), np.asarray(t_x),
                               rtol=1e-5, atol=1e-5)
