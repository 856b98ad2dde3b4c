"""Scale-aware (residual-driven) split — DensityConfig.split_mode="residual".

density-control extension (VERDICT r2 item 1): the reference's
absolute split threshold (0.25*0.65^stage, training.rs:187) never fires on
prior-seeded compact clouds, so large scenes can only shrink. These tests
pin (a) the boundary rule mechanics (prune → merge-with-score-sum → split
top scorers, budget, last-stage no-split), (b) the residual scorer itself
(a wrong-colored primitive out-scores a correct one), and (c) end-to-end:
a short culled training run where N GROWS across a stage boundary.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest

from burn_raymarching.config import DensityConfig, TrainConfig
from burn_raymarching.train.density import merge_redundant, prune_and_split


def _softplus_inv(y):
    return np.log(np.maximum(np.expm1(y), 1e-6))


def _cloud(n, radius=0.03, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    colors = np.zeros((n, 3), np.float32)
    radii = np.full((n, 1), _softplus_inv(radius - 0.01), np.float32)
    return centers, colors, radii


def test_reference_mode_unchanged_without_scores():
    """Passing split_scores=None in reference mode is the committed path."""
    c, col, r = _cloud(64)
    rng = np.random.default_rng(0)
    a = prune_and_split(c, col, r, c.copy(), 0, 3, rng, DensityConfig())
    rng = np.random.default_rng(0)
    b = prune_and_split(c, col, r, c.copy(), 0, 3, rng, DensityConfig(),
                        split_scores=None)
    np.testing.assert_array_equal(a[0], b[0])


def test_residual_mode_requires_scores():
    c, col, r = _cloud(8)
    with pytest.raises(ValueError, match="split_scores"):
        prune_and_split(c, col, r, c.copy(), 0, 3,
                        np.random.default_rng(0),
                        DensityConfig(split_mode="residual"))


def test_residual_split_top_scorers_within_budget():
    c, col, r = _cloud(32)
    scores = np.zeros(32, np.float32)
    scores[[3, 10, 20]] = [5.0, 9.0, 7.0]
    cfg = DensityConfig(split_mode="residual", split_budget=2)
    out_c, out_col, out_r, stats = prune_and_split(
        c, col, r, c.copy(), 0, 3, np.random.default_rng(0), cfg,
        split_scores=scores)
    # Top-2 scorers (10, 20) split into 2 children each; 3 stays.
    assert stats.split == 2
    assert out_c.shape[0] == 32 - 2 + 4
    # Parents are gone; children flank them at +- r/2.
    for parent in (c[10], c[20]):
        d = np.linalg.norm(out_c - parent, axis=1)
        assert d.min() > 1e-6          # parent row itself removed
        assert (d < 0.03).sum() == 2   # two children nearby
    assert np.linalg.norm(out_c - c[3], axis=1).min() < 1e-6


def test_residual_split_auto_budget_and_zero_scores():
    c, col, r = _cloud(40)
    cfg = DensityConfig(split_mode="residual", split_frac=0.1)
    # All-zero scores: nothing qualifies, nothing splits.
    out = prune_and_split(c, col, r, c.copy(), 0, 3,
                          np.random.default_rng(0), cfg,
                          split_scores=np.zeros(40, np.float32))
    assert out[3].split == 0 and out[0].shape[0] == 40
    # Uniform positive scores: auto budget = frac * kept.
    out = prune_and_split(c, col, r, c.copy(), 0, 3,
                          np.random.default_rng(0), cfg,
                          split_scores=np.ones(40, np.float32))
    assert out[3].split == 4 and out[0].shape[0] == 40 + 4


def test_residual_no_split_on_last_stage():
    c, col, r = _cloud(16)
    cfg = DensityConfig(split_mode="residual", split_budget=8)
    out = prune_and_split(c, col, r, c.copy(), 2, 3,
                          np.random.default_rng(0), cfg,
                          split_scores=np.ones(16, np.float32))
    assert out[3].split == 0 and out[0].shape[0] == 16


def test_merge_sums_scores_and_runs_before_split():
    """A 25-deep stack with per-member scores merges to ONE row carrying the
    SUM — the stack's error mass survives into the split stage — and the
    merged row can then split (merge-before-split order)."""
    base = np.asarray([[0.101, 0.102, 0.103]], np.float32)
    stack = np.repeat(base, 25, axis=0) + np.random.default_rng(1).normal(
        0, 1e-4, (25, 3)).astype(np.float32)
    lone = np.asarray([[0.5, 0.5, 0.5]], np.float32)  # inside the 1.2 bound
    c = np.concatenate([stack, lone])
    col = np.zeros((26, 3), np.float32)
    r = np.full((26, 1), _softplus_inv(0.02), np.float32)
    scores = np.concatenate([np.full(25, 1.0), [0.5]]).astype(np.float32)

    # Direct merge check: score is member-summed.
    _, _, _, merged, s_out = merge_redundant(c, col, r, 0.04, scores=scores)
    assert merged == 24
    assert {round(float(x), 4) for x in s_out} == {25.0, 0.5}

    cfg = DensityConfig(split_mode="residual", split_budget=1,
                        merge_cell=0.04)
    out_c, _, _, stats = prune_and_split(
        c, col, r, c.copy(), 0, 3, np.random.default_rng(0), cfg,
        split_scores=scores)
    assert stats.merged == 24
    assert stats.split == 1               # the merged stack splits
    assert out_c.shape[0] == 2 - 1 + 2    # lone + 2 children
    # Children are near the stack centroid, not near the lone primitive.
    d_stack = np.linalg.norm(out_c - base, axis=1)
    assert (d_stack < 0.02).sum() == 2


@pytest.fixture(scope="module")
def knot_ds(scene_root):
    """Small culled config + dataset on the bundled 10-view scene."""
    cfg = TrainConfig(
        batch_size=1024, stages=2, steps_per_stage=10, steps_per_call=10,
        use_pallas=False, use_culling=True, cull_budget=16, cull_tile=256,
        dataset_order="morton", checkpoint_dir=None,
        cameras_json=os.path.join(scene_root, "data/cameras.json"),
        density=DensityConfig(split_mode="residual", split_budget=4),
    )
    from burn_raymarching.train.loop import build_dataset

    cwd = os.getcwd()
    os.chdir(scene_root)
    try:
        ds = build_dataset(cfg)
    finally:
        os.chdir(cwd)
    return cfg, ds


def test_scorer_blames_the_wrong_colored_primitive(knot_ds):
    """Two visible primitives; the trainable params flip one color. The
    flipped one must collect (much) more residual mass."""
    from burn_raymarching.models.scene import (
        SceneParams,
        pad_params,
        raw_from_physical,
    )
    from burn_raymarching.train.residual import primitive_residual_scores

    cfg, _ = knot_ds
    centers = np.asarray([[-0.3, 0.0, 0.0], [0.3, 0.0, 0.0]], np.float32)
    radii = np.full((2, 1), 0.2, np.float32)
    good = raw_from_physical(centers, [[0.9, 0.1, 0.1], [0.1, 0.1, 0.9]],
                             radii)
    bad = raw_from_physical(centers, [[0.9, 0.1, 0.1], [0.9, 0.9, 0.1]],
                            radii)
    # Targets = the trainable forward of the GOOD params (so residual is
    # exactly the color flip).
    from burn_raymarching.data.camera import create_camera_rays
    from burn_raymarching.models.scene import scene_forward

    ro, rd = create_camera_rays(32, 32, [0.0, 0.3, -2.5], [0, 0, 0], 50.0)
    tgt = scene_forward(good, ro, rd, 32.0)
    from burn_raymarching.data.dataset import RayDataset

    ds = RayDataset(ro, rd, tgt)
    cfg2 = dataclasses.replace(cfg, batch_size=1024, cull_tile=256,
                               cull_budget=4)
    padded, mask = pad_params(bad, 4)
    scores = primitive_residual_scores(padded, mask, ds, cfg2, 32.0)
    assert scores.shape == (4,)
    assert scores[2:].sum() == 0.0            # padded slots untouched
    assert scores[1] > 5.0 * max(scores[0], 1e-9)


def test_training_grows_n_across_boundary(knot_ds, tmp_path, monkeypatch):
    """End-to-end: residual mode fires splits at a stage boundary of a
    short culled run — N RISES (the VERDICT r2 "grow at scale" ask) —
    and training stays finite."""
    from burn_raymarching.train.loop import Trainer

    cfg, ds = knot_ds
    monkeypatch.chdir(tmp_path)
    tr = Trainer(cfg, ds, log=lambda s: None)
    padded, mask = tr.run()
    n_final = int(np.asarray(mask).sum())
    assert n_final > 7                     # init 7, splits fired
    for leaf in [padded.centers, padded.colors, padded.radii]:
        assert np.isfinite(np.asarray(leaf)).all()
