"""In-run stage collapse guard (config.stage_guard, VERDICT r3 item 2).

The guard re-runs a stage with a fresh restart key when it fails to
improve train-view PSNR — the in-run replacement for --best-of N against
the runaway-split collapse (runs/r3_hw:turbo_seeds). These tests inject a
deterministic bad first attempt to exercise detection, retry, and the
keep-best fallback without hardware-scale runs.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from burn_raymarching.config import TrainConfig
from burn_raymarching.models.scene import SceneParams
from burn_raymarching.train.loop import Trainer, build_dataset


@pytest.fixture(scope="module")
def dataset(scene_root):
    cfg = TrainConfig(
        cameras_json=os.path.join(scene_root, "data/cameras.json"))
    cwd = os.getcwd()
    os.chdir(scene_root)
    try:
        return build_dataset(cfg)
    finally:
        os.chdir(cwd)


def _cfg(scene_root, **kw):
    return TrainConfig(
        batch_size=512, stages=1, steps_per_stage=20, steps_per_call=20,
        use_pallas=False, checkpoint_dir=None,
        cameras_json=os.path.join(scene_root, "data/cameras.json"),
        stage_guard=True, **kw)


def _collapse(padded: SceneParams) -> SceneParams:
    """A collapsed candidate: huge bright spheres filling the screen
    (radii raw 1.0 → physical ~1.3; colors saturated white)."""
    return SceneParams(
        centers=padded.centers,
        colors=jnp.full_like(padded.colors, 30.0),
        radii=jnp.full_like(padded.radii, 1.0),
        light_dir=padded.light_dir,
        ambient=padded.ambient)


def test_guard_retries_bad_stage_and_recovers(scene_root, dataset,
                                              tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(scene_root, stage_guard_retries=2)
    logs = []
    tr = Trainer(cfg, dataset, log=logs.append)
    real = Trainer.run_stage
    calls = {"n": 0}

    def flaky(self, params, stage, key, **kw):
        calls["n"] += 1
        padded, mask, loss = real(self, params, stage, key, **kw)
        if calls["n"] == 1:   # first attempt collapses
            return _collapse(padded), mask, loss
        return padded, mask, loss

    monkeypatch.setattr(Trainer, "run_stage", flaky)
    padded, mask = tr.run()
    assert calls["n"] == 2          # one retry, then the bar is met
    assert any("stage guard" in l and "retrying" in l for l in logs)
    assert any("recovered" in l for l in logs)
    # The kept result is the good attempt, not the collapsed one.
    assert float(np.asarray(padded.colors).max()) < 29.0


def test_guard_keeps_best_when_all_attempts_fail(scene_root, dataset,
                                                 tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(scene_root, stage_guard_retries=1,
               stage_guard_min_gain_db=100.0)   # unreachable bar
    logs = []
    tr = Trainer(cfg, dataset, log=logs.append)
    real = Trainer.run_stage
    seen = []

    def tracking(self, params, stage, key, **kw):
        seen.append(int(jax.random.key_data(key)[-1]))
        return real(self, params, stage, key, **kw)

    monkeypatch.setattr(Trainer, "run_stage", tracking)
    padded, mask = tr.run()
    # retries exhausted: 2 attempts with distinct keys, best kept, run
    # completes (export happened).
    assert len(seen) == 2 and seen[0] != seen[1]
    assert sum("keeping best attempt" in l for l in logs) == 1
    assert os.path.exists("scene.json")
    for leaf in jax.tree.leaves(padded):
        assert np.isfinite(np.asarray(leaf)).all()


def test_boundary_guard_rerolls_bad_density_draw(scene_root, dataset,
                                                 tmp_path, monkeypatch):
    """A density-control draw that tanks PSNR by more than
    stage_guard_boundary_db is re-rolled with a fresh rng (the measured
    collapse mechanism: a bad stochastic split before the stage runs)."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(scene_root, stage_guard_retries=2)
    cfg = dataclasses.replace(cfg, stages=2)
    logs = []
    tr = Trainer(cfg, dataset, log=logs.append)
    real = Trainer._density_control
    calls = {"n": 0}

    def flaky_density(self, padded, mask, n_live, init_centers, stage, rng):
        calls["n"] += 1
        out = real(self, padded, mask, n_live, init_centers, stage, rng)
        if calls["n"] == 1:   # first draw "collapses" (giant white blob)
            return _collapse(out)
        return out

    monkeypatch.setattr(Trainer, "_density_control", flaky_density)
    padded, mask = tr.run()
    assert calls["n"] >= 2
    assert any("re-rolling density control" in l for l in logs)
    for leaf in jax.tree.leaves(padded):
        assert np.isfinite(np.asarray(leaf)).all()
    # The final kept scene is not the collapsed draw's descendant run
    # gone wrong: export completed.
    assert os.path.exists("scene.json")


def test_guard_off_never_evaluates(scene_root, dataset, tmp_path,
                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = dataclasses.replace(_cfg(scene_root), stage_guard=False)
    tr = Trainer(cfg, dataset, log=lambda s: None)

    def boom(*a, **kw):
        raise AssertionError("guard evaluated with stage_guard=False")

    monkeypatch.setattr(Trainer, "_guard_psnr", boom)
    tr.run()   # completes without touching the guard evaluator
