"""Optimizer semantics vs a NumPy oracle of Burn's Adam.

Burn AdamConfig.with_weight_decay (reference train.rs:161-163): classic Adam
(b1=0.9, b2=0.999, eps=1e-5) with L2-style decay folded into the gradient
BEFORE the moment updates (burn-optim WeightDecay), bias-corrected moments,
update = lr * m_hat / (sqrt(v_hat) + eps).
"""

import jax
import jax.numpy as jnp
import numpy as np

from burn_raymarching.config import TrainConfig
from burn_raymarching.train.optimizer import (
    anneal_for_step,
    lr_for_step,
    make_optimizer,
)


def _oracle_adam_steps(param, grads, lr, wd=1e-5, b1=0.9, b2=0.999, eps=1e-5):
    m = np.zeros_like(param)
    v = np.zeros_like(param)
    p = param.copy()
    for t, g in enumerate(grads, start=1):
        g = g + wd * p                      # L2-into-grad (Burn WeightDecay)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        m_hat = m / (1 - b1 ** t)
        v_hat = v / (1 - b2 ** t)
        p = p - lr * m_hat / (np.sqrt(v_hat) + eps)
    return p


def test_adam_matches_burn_oracle():
    rng = np.random.default_rng(0)
    param = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(7)]
    lr = 0.05

    cfg = TrainConfig()
    tx = make_optimizer(cfg)
    p = jnp.asarray(param)
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, p)
        p = p - lr * updates
    want = _oracle_adam_steps(param, grads, lr)
    np.testing.assert_allclose(np.asarray(p), want, rtol=1e-5, atol=1e-6)


def test_lr_schedule_matches_reference():
    cfg = TrainConfig()
    # base 0.05 * 0.6^stage; x0.2 after the midpoint (step > 350).
    assert lr_for_step(cfg, 0, 1) == 0.05
    assert lr_for_step(cfg, 0, 350) == 0.05
    np.testing.assert_allclose(lr_for_step(cfg, 0, 351), 0.01)
    np.testing.assert_allclose(lr_for_step(cfg, 2, 100), 0.05 * 0.36)
    np.testing.assert_allclose(lr_for_step(cfg, 2, 700), 0.05 * 0.36 * 0.2)


def test_anneal_schedule_matches_reference():
    cfg = TrainConfig()
    # global_step = stage*700 + step (1-based); progress over 3500.
    p, k, u = anneal_for_step(cfg, 0, 1)
    np.testing.assert_allclose(p, 1 / 3500)
    np.testing.assert_allclose(k, 5.0 + 27.0 / 3500)
    np.testing.assert_allclose(u, 0.8 - 0.4 / 3500)
    p, k, u = anneal_for_step(cfg, 4, 700)
    np.testing.assert_allclose(p, 1.0)
    np.testing.assert_allclose(k, 32.0)
    np.testing.assert_allclose(u, 0.4, rtol=1e-6)


def test_scan_chunk_anneals_match_python_path():
    """The in-graph anneal/LR computation inside the scan chunk must equal
    the python-side anneal_for_step/lr_for_step used for logging."""
    cfg = TrainConfig()
    half = cfg.steps_per_stage // 2
    for stage in (0, 3):
        for step0, i in ((0, 0), (100, 57), (600, 99)):
            step = step0 + i + 1
            gs = float(stage * cfg.steps_per_stage + step)
            progress = gs / cfg.total_steps
            smooth_k = cfg.min_smooth_k + (
                cfg.max_smooth_k - cfg.min_smooth_k) * progress
            base_lr = cfg.base_lr * cfg.lr_stage_decay ** stage
            lr = base_lr * cfg.lr_midstage_factor if step > half else base_lr
            p_ref, k_ref, _ = anneal_for_step(cfg, stage, step)
            np.testing.assert_allclose(progress, p_ref, rtol=1e-6)
            np.testing.assert_allclose(smooth_k, k_ref, rtol=1e-6)
            np.testing.assert_allclose(lr, lr_for_step(cfg, stage, step),
                                       rtol=1e-6)


def test_folded_decay_drifts_at_full_lr_without_data_gradient():
    """The large-M pathology: under folded (Burn) decay, a coordinate with
    ZERO data gradient moves by ~lr per step (Adam normalizes the decay
    gradient to sign(p)); under decoupled (AdamW) decay it moves by
    lr*wd*|p| — 5 orders of magnitude less at the reference's wd=1e-5."""
    import dataclasses

    import jax.numpy as jnp

    from burn_raymarching.config import TrainConfig
    from burn_raymarching.models.scene import SceneParams

    params = SceneParams(
        centers=jnp.full((4, 3), 0.8),
        colors=jnp.full((4, 3), 1.0),
        radii=jnp.full((4, 1), -3.0),
        light_dir=jnp.asarray([0.0, 1.0, 0.0]),
        ambient=jnp.asarray([-1.4]),
    )
    zero_g = jax.tree.map(jnp.zeros_like, params)
    lr = 0.005

    def drift(mode, steps=50):
        cfg = dataclasses.replace(TrainConfig(), weight_decay_mode=mode)
        tx = make_optimizer(cfg)
        opt = tx.init(params)
        p = params
        for _ in range(steps):
            upd, opt = tx.update(zero_g, opt, p)
            p = jax.tree.map(lambda a, u: a - lr * u, p, upd)
        return float(jnp.abs(p.centers - params.centers).max())

    d_folded = drift("folded")
    d_decoupled = drift("decoupled")
    # folded: ~lr * steps (full-rate drift); decoupled: ~lr * wd * |p| * steps
    assert d_folded > 0.1, d_folded
    assert d_decoupled < 1e-5, d_decoupled


def test_lr_scale_zero_freezes_group(scene_root):
    """lr_scale_centers=0 must leave centers bit-identical over a stage."""
    import dataclasses
    import os

    import jax.numpy as jnp
    import numpy as np

    from burn_raymarching.config import TrainConfig
    from burn_raymarching.train.loop import Trainer, build_dataset

    cfg = TrainConfig(
        batch_size=256, stages=1, steps_per_stage=10, steps_per_call=10,
        use_pallas=False, checkpoint_dir=None, lr_scale_centers=0.0,
        cameras_json=os.path.join(scene_root, "data/cameras.json"),
    )
    cwd = os.getcwd()
    os.chdir(scene_root)
    try:
        ds = build_dataset(cfg)
    finally:
        os.chdir(cwd)
    tr = Trainer(cfg, ds, log=lambda s: None)
    from burn_raymarching.models.scene import init_scene_params, pad_params
    params = init_scene_params(cfg.init_n)
    import jax

    padded0, mask = pad_params(params, 8)
    padded, mask, _ = tr.run_stage(params, 0, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(np.asarray(padded.centers),
                                  np.asarray(padded0.centers))
    # Other groups did move.
    assert np.abs(np.asarray(padded.colors)
                  - np.asarray(padded0.colors)).max() > 1e-5


def test_lr_scale_centers_stage_schedule(scene_root):
    """lr_scale_centers_stages indexes by stage in-graph: a (1.0, 0.0)
    schedule moves centers in stage 0 and freezes them in stage 1 (and the
    clamp holds past the end)."""
    import os

    import jax
    import numpy as np

    from burn_raymarching.config import TrainConfig
    from burn_raymarching.models.scene import init_scene_params
    from burn_raymarching.train.loop import Trainer, build_dataset
    from burn_raymarching.train.step_body import lr_scale_tree

    cfg = TrainConfig(
        batch_size=256, stages=2, steps_per_stage=10, steps_per_call=10,
        use_pallas=False, checkpoint_dir=None,
        lr_scale_centers=123.0,     # must be ignored once the schedule is set
        lr_scale_centers_stages=(1.0, 0.0),
        cameras_json=os.path.join(scene_root, "data/cameras.json"),
    )
    # In-graph values, incl. the past-the-end clamp polish relies on.
    import jax.numpy as jnp

    for stage, want in [(0, 1.0), (1, 0.0), (5, 0.0)]:
        tree = lr_scale_tree(cfg, jnp.asarray(stage, jnp.int32))
        assert float(tree.centers) == want
    assert lr_scale_tree(cfg, None).centers == 123.0

    cwd = os.getcwd()
    os.chdir(scene_root)
    try:
        ds = build_dataset(cfg)
    finally:
        os.chdir(cwd)
    tr = Trainer(cfg, ds, log=lambda s: None)
    params = init_scene_params(cfg.init_n)
    p0 = np.asarray(params.centers)
    padded, mask, _ = tr.run_stage(params, 0, jax.random.PRNGKey(0))
    moved = np.asarray(padded.centers)[: cfg.init_n]
    assert np.abs(moved - p0).max() > 1e-6
    padded2, mask2, _ = tr.run_stage(
        tr._unpad(padded, cfg.init_n), 1, jax.random.PRNGKey(1))
    np.testing.assert_array_equal(np.asarray(padded2.centers)[: cfg.init_n],
                                  moved)
