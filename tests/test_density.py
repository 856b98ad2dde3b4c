"""Prune/split rules (reference src/training.rs:87-238)."""

import numpy as np

from burn_raymarching.train.density import (
    _softplus,
    _softplus_inv,
    prune_and_split,
)


def _raw_radius_for(r_eval):
    """Raw value whose softplus equals r_eval."""
    return _softplus_inv(np.asarray(r_eval, np.float64)).astype(np.float32)


def test_softplus_inverse_roundtrip():
    for r in (0.01, 0.1, 0.5, 2.0):
        np.testing.assert_allclose(_softplus(_softplus_inv(r)), r, rtol=1e-5)


def _mk(centers, r_evals, color_logits=None):
    m = len(centers)
    centers = np.asarray(centers, np.float32)
    radii = _raw_radius_for(r_evals).reshape(m, 1)
    colors = (np.zeros((m, 3), np.float32) if color_logits is None
              else np.asarray(color_logits, np.float32))
    return centers, colors, radii


def test_prune_too_small_and_too_large():
    c, col, r = _mk([[0, 0, 0], [0.5, 0, 0], [0, 0.5, 0]],
                    [0.004, 0.97, 0.2])
    # stage=1 → max radius 0.96 culls the 0.97; 0.004 < 0.005 culled.
    out_c, _, out_r, stats = prune_and_split(
        c, col, r, c, stage=1, stages=5, rng=np.random.default_rng(0))
    assert out_c.shape[0] == 1
    np.testing.assert_allclose(out_c[0], [0, 0.5, 0])
    assert stats.pruned_size == 2


def test_prune_flyaway():
    c, col, r = _mk([[1.3, 0, 0], [0.5, 0, 0]], [0.2, 0.2])
    out_c, _, _, stats = prune_and_split(
        c, col, r, c, stage=0, stages=5, rng=np.random.default_rng(0))
    assert out_c.shape[0] == 1 and stats.pruned_flyaway == 1


def test_prune_black():
    c, col, r = _mk([[0.1, 0, 0], [0.2, 0, 0]], [0.2, 0.2])
    col[0] = -10.0  # sigmoid ≈ 0 on all channels → sum < 0.05
    out_c, _, _, stats = prune_and_split(
        c, col, r, c, stage=0, stages=5, rng=np.random.default_rng(0))
    assert out_c.shape[0] == 1 and stats.pruned_black == 1


def test_split_geometry():
    # One big sphere that moved: stage-0 threshold 0.25, move > 0.05.
    c, col, r = _mk([[0.3, 0.0, 0.0]], [0.4])
    init = np.array([[0.0, 0.0, 0.0]], np.float32)
    out_c, out_col, out_r, stats = prune_and_split(
        c, col, r, init, stage=0, stages=5, rng=np.random.default_rng(1))
    assert stats.split == 1 and out_c.shape[0] == 2
    # Children sit at c ± dir*(r/2): midpoint is the parent, separation r.
    np.testing.assert_allclose((out_c[0] + out_c[1]) / 2, c[0], atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(out_c[0] - out_c[1]), 0.4,
                               rtol=1e-5)
    # Child radius re-encoded via softplus⁻¹ of 0.8*r.
    np.testing.assert_allclose(_softplus(out_r[:, 0]), 0.8 * 0.4, rtol=1e-5)
    np.testing.assert_allclose(out_col, np.tile(col, (2, 1)))


def test_no_split_on_last_stage():
    c, col, r = _mk([[0.3, 0.0, 0.0]], [0.4])
    init = np.zeros_like(c)
    out_c, _, out_r, stats = prune_and_split(
        c, col, r, init, stage=4, stages=5, rng=np.random.default_rng(1))
    assert stats.split == 0 and out_c.shape[0] == 1
    np.testing.assert_allclose(out_r, r)


def test_no_split_without_movement():
    c, col, r = _mk([[0.3, 0.0, 0.0]], [0.4])
    out_c, _, _, stats = prune_and_split(
        c, col, r, c, stage=0, stages=5, rng=np.random.default_rng(1))
    assert stats.split == 0 and out_c.shape[0] == 1


def test_split_threshold_decays_with_stage():
    # r_eval = 0.2: below stage-0 threshold 0.25, above stage-2 threshold
    # 0.25*0.65^2 ≈ 0.106.
    c, col, r = _mk([[0.3, 0.0, 0.0]], [0.2])
    init = np.zeros_like(c)
    _, _, _, s0 = prune_and_split(c, col, r, init, 0, 5,
                                  np.random.default_rng(0))
    _, _, _, s2 = prune_and_split(c, col, r, init, 2, 5,
                                  np.random.default_rng(0))
    assert s0.split == 0 and s2.split == 1


def test_split_directions_uniformish():
    rng = np.random.default_rng(0)
    c, col, r = _mk([[0.3, 0.0, 0.0]] * 200, [0.4] * 200)
    init = np.zeros_like(c)
    out_c, _, _, stats = prune_and_split(c, col, r, init, 0, 5, rng)
    assert stats.split == 200
    d = out_c[:200] - c  # first-child offsets
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    assert np.abs(d.mean(axis=0)).max() < 0.15  # roughly isotropic


def test_merge_redundant_stacks():
    """merge_cell (extension): a 10-deep stack in one grid cell
    collapses to one primitive with mean center/color and MAX radius; a
    far-away primitive is untouched."""
    from burn_raymarching.config import DensityConfig
    from burn_raymarching.train.density import (
        merge_redundant,
        prune_and_split,
    )

    rng = np.random.default_rng(0)
    # Keep the stack strictly inside one 0.05-cell ([0, 0.05)^3).
    stack = (0.025 + np.clip(0.005 * rng.normal(size=(10, 3)), -0.02, 0.02)
             ).astype(np.float32)
    lone = np.asarray([[0.5, 0.5, 0.5]], np.float32)
    centers = np.concatenate([stack, lone])
    colors = rng.normal(size=(11, 3)).astype(np.float32)
    radii = rng.normal(-3.0, 0.2, size=(11, 1)).astype(np.float32)

    c2, col2, r2, n_merged = merge_redundant(centers, colors, radii, 0.05)
    assert n_merged == 9 and c2.shape == (2, 3)
    i_lone = int(np.argmin(np.linalg.norm(c2 - lone, axis=1)))
    i_stack = 1 - i_lone
    np.testing.assert_allclose(c2[i_lone], lone[0], atol=1e-6)
    np.testing.assert_allclose(c2[i_stack], stack.mean(axis=0), atol=1e-5)
    np.testing.assert_allclose(col2[i_stack], colors[:10].mean(axis=0),
                               atol=1e-5)
    assert r2[i_stack, 0] == radii[:10].max()

    # Wired through prune_and_split via DensityConfig.merge_cell.
    init = np.zeros_like(centers)
    _, _, _, stats = prune_and_split(
        centers, colors, radii, init, 4, 5, rng,
        DensityConfig(merge_cell=0.05))
    assert stats.merged == 9

    # Default OFF: exact reference behavior.
    _, _, _, stats0 = prune_and_split(centers, colors, radii, init, 4, 5,
                                      rng)
    assert stats0.merged == 0
