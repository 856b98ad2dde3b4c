"""Derivative-free geometry refinement (train/refine.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from burn_raymarching.config import TrainConfig
from burn_raymarching.models.scene import (
    init_scene_params,
    pad_params,
)
from burn_raymarching.train.loop import build_dataset
from burn_raymarching.train.refine import (
    geometry_refine,
    sample_fg_tile_batches,
)


@pytest.fixture(scope="module")
def setup(scene_root):
    cfg = TrainConfig(
        batch_size=1024, use_pallas=False, checkpoint_dir=None,
        use_culling=True, cull_budget=16, cull_tile=256,
        dataset_order="morton",
        cameras_json=os.path.join(scene_root, "data/cameras.json"),
    )
    cwd = os.getcwd()
    os.chdir(scene_root)
    try:
        ds = build_dataset(cfg)
    finally:
        os.chdir(cwd)
    return cfg, ds


def test_batches_disjoint_fg(setup):
    cfg, ds = setup
    a, b = sample_fg_tile_batches(ds, tiles=4, tile=cfg.cull_tile)
    assert a[0].shape == (1024, 3) and b[0].shape == (1024, 3)
    # Disjoint: no shared rays (compare origins+dirs rows).
    ra = np.asarray(a[0]) + 7.0 * np.asarray(a[1])
    rb = np.asarray(b[0]) + 7.0 * np.asarray(b[1])
    sa = {tuple(np.round(r, 5)) for r in ra[:: 64]}
    sb = {tuple(np.round(r, 5)) for r in rb[:: 64]}
    assert not (sa & sb)
    # fg tiles: each batch contains foreground pixels.
    assert float(np.asarray(a[2]).sum()) > 0
    assert float(np.asarray(b[2]).sum()) > 0


def test_refine_descends_and_touches_only_live_geometry(setup):
    cfg, ds = setup
    params = init_scene_params(7)
    padded, mask = pad_params(params, 8)
    batches = sample_fg_tile_batches(ds, tiles=4, tile=cfg.cull_tile)
    refined, stats = geometry_refine(
        padded, mask, batches, cfg, proposals=64, phases=1,
        key=jax.random.PRNGKey(0), log=lambda s: None)
    assert stats.loss_after <= stats.loss_before
    assert stats.accepted >= 1          # tiny scene: some proposal wins
    assert stats.proposals == 64
    # Only live centers/radii move; colors/light/padded slots untouched.
    np.testing.assert_array_equal(np.asarray(refined.colors),
                                  np.asarray(padded.colors))
    np.testing.assert_array_equal(np.asarray(refined.light_dir),
                                  np.asarray(padded.light_dir))
    assert np.array_equal(np.asarray(refined.centers)[7:],
                          np.asarray(padded.centers)[7:])
    assert np.abs(np.asarray(refined.centers)[:7]
                  - np.asarray(padded.centers)[:7]).max() > 0
    for leaf in jax.tree.leaves(refined):
        assert np.isfinite(np.asarray(leaf)).all()


def test_trainer_refine_geometry_production_path(setup, tmp_path,
                                                 monkeypatch):
    """The CLI-reachable composition (VERDICT r3 item 4): train a short
    culled run, then Trainer.refine_geometry — PSNR-gated, mask frozen,
    scene re-exported."""
    import json

    from burn_raymarching.data.image_io import load_image_as_array
    from burn_raymarching.data.scene_io import load_cameras
    from burn_raymarching.train.loop import Trainer

    cfg, ds = setup
    import dataclasses

    cams = load_cameras(cfg.cameras_json)[:2]
    tgts = [load_image_as_array(c["file"]) for c in cams]
    monkeypatch.chdir(tmp_path)
    cfg = dataclasses.replace(
        cfg, stages=1, steps_per_stage=50, steps_per_call=50,
        use_pallas=False, checkpoint_dir=None,
        scene_json="scene.json", steps_dir="steps")
    tr = Trainer(cfg, ds, log=lambda s: None)
    padded, mask = tr.run()
    n = int(np.asarray(mask).sum())
    padded2, mask2 = tr.refine_geometry(
        padded, mask, rounds=1, proposals=64, tiles=2,
        cameras=cams, targets=tgts)
    assert int(np.asarray(mask2).sum()) == n
    for leaf in jax.tree.leaves(padded2):
        assert np.isfinite(np.asarray(leaf)).all()
    scene = json.load(open("scene.json"))
    assert scene["num_spheres"] == n


def test_trainer_refine_requires_culled_config(setup):
    from burn_raymarching.train.loop import Trainer

    cfg, ds = setup
    import dataclasses

    dense = dataclasses.replace(cfg, use_culling=False,
                                dataset_order="raster", use_pallas=False,
                                checkpoint_dir=None)
    tr = Trainer(dense, ds, log=lambda s: None)
    from burn_raymarching.models.scene import init_scene_params

    padded, mask = pad_params(init_scene_params(7), 8)
    with pytest.raises(ValueError, match="use_culling"):
        tr.refine_geometry(padded, mask, rounds=1)


def test_refine_cli_e2e(tmp_path, monkeypatch, scene_root):
    """The production entry point: train_cli --refine runs the full
    train → refine → export chain (VERDICT r3 item 4 'Done' bar)."""
    import json

    from burn_raymarching.tools import train_cli

    monkeypatch.chdir(tmp_path)
    train_cli.main([
        "--cameras", os.path.join(scene_root, "data/cameras.json"),
        "--stages", "1", "--steps", "40", "--batch", "512",
        "--no-pallas", "--cull", "16", "--checkpoint-dir", "",
        "--scene-out", "scene.json", "--steps-dir", "steps",
        "--refine", "1", "--refine-proposals", "64",
    ])
    scene = json.load(open("scene.json"))
    assert scene["num_spheres"] >= 1
    assert all(np.isfinite(scene["centers"]))


def test_refine_biased_selection_targets_scored_primitives(setup):
    """select_probs concentrates proposals: a delta weight on one
    primitive must leave every other primitive untouched."""
    cfg, ds = setup
    params = init_scene_params(7)
    padded, mask = pad_params(params, 8)
    batches = sample_fg_tile_batches(ds, tiles=2, tile=cfg.cull_tile)
    probs = jnp.zeros(8).at[3].set(1.0)
    refined, stats = geometry_refine(
        padded, mask, batches, cfg, proposals=64, phases=1,
        frac=1.0 / 7, select_probs=probs,
        key=jax.random.PRNGKey(0), log=lambda s: None)
    moved = (np.abs(np.asarray(refined.centers)
                    - np.asarray(padded.centers)).sum(axis=1) > 0)
    assert not moved[np.arange(8) != 3].any()
    # The targeted primitive is selected in every proposal (p=1), so at
    # least one accept moves it on this tiny scene.
    assert stats.accepted >= 1
    assert moved[3]


def test_trainer_refine_residual_bias_smoke(setup, tmp_path, monkeypatch):
    """proposal_bias='residual' scores and runs end-to-end."""
    import dataclasses

    from burn_raymarching.config import DensityConfig
    from burn_raymarching.data.image_io import load_image_as_array
    from burn_raymarching.data.scene_io import load_cameras
    from burn_raymarching.train.loop import Trainer

    cfg, ds = setup
    cams = load_cameras(cfg.cameras_json)[:1]
    tgts = [load_image_as_array(c["file"]) for c in cams]
    monkeypatch.chdir(tmp_path)
    cfg = dataclasses.replace(
        cfg, stages=1, steps_per_stage=20, steps_per_call=20,
        use_pallas=False, checkpoint_dir=None,
        scene_json="scene.json", steps_dir="steps",
        density=DensityConfig(split_score_pixels=4096))
    tr = Trainer(cfg, ds, log=lambda s: None)
    padded, mask = tr.run()
    padded2, mask2 = tr.refine_geometry(
        padded, mask, rounds=1, proposals=64, tiles=2,
        proposal_bias="residual", cameras=cams, targets=tgts)
    for leaf in jax.tree.leaves(padded2):
        assert np.isfinite(np.asarray(leaf)).all()


def test_refine_noop_when_nothing_accepted(setup):
    """With zero noise every proposal equals the current params (strict <
    comparisons reject them) — params come back bit-identical."""
    cfg, ds = setup
    params = init_scene_params(7)
    padded, mask = pad_params(params, 8)
    batches = sample_fg_tile_batches(ds, tiles=2, tile=cfg.cull_tile)
    refined, stats = geometry_refine(
        padded, mask, batches, cfg, proposals=64, phases=1,
        sigma_c=0.0, sigma_r=0.0,
        key=jax.random.PRNGKey(0), log=lambda s: None)
    assert stats.accepted == 0
    np.testing.assert_array_equal(np.asarray(refined.centers),
                                  np.asarray(padded.centers))
    np.testing.assert_array_equal(np.asarray(refined.radii),
                                  np.asarray(padded.radii))


def test_refine_color_proposals_move_colors(setup):
    """sigma_col > 0: accepted proposals may move the selected live
    primitives' color logits; light and padded slots stay fixed."""
    cfg, ds = setup
    params = init_scene_params(7)
    padded, mask = pad_params(params, 8)
    batches = sample_fg_tile_batches(ds, tiles=4, tile=cfg.cull_tile)
    refined, stats = geometry_refine(
        padded, mask, batches, cfg, proposals=64, phases=1,
        sigma_col=0.5, key=jax.random.PRNGKey(0), log=lambda s: None)
    assert stats.accepted >= 1
    assert np.abs(np.asarray(refined.colors)[:7]
                  - np.asarray(padded.colors)[:7]).max() > 0
    np.testing.assert_array_equal(np.asarray(refined.colors)[7:],
                                  np.asarray(padded.colors)[7:])
    np.testing.assert_array_equal(np.asarray(refined.light_dir),
                                  np.asarray(padded.light_dir))


def test_refine_annealed_returns_best_snapshot(setup):
    """accept_temp > 0: the Metropolis chain may wander uphill, but the
    returned params are the strict-improvement best snapshot — loss_after
    never exceeds loss_before, and with zero noise nothing changes."""
    cfg, ds = setup
    params = init_scene_params(7)
    padded, mask = pad_params(params, 8)
    batches = sample_fg_tile_batches(ds, tiles=4, tile=cfg.cull_tile)
    refined, stats = geometry_refine(
        padded, mask, batches, cfg, proposals=64, phases=2,
        accept_temp=0.05, key=jax.random.PRNGKey(0), log=lambda s: None)
    assert stats.loss_after <= stats.loss_before
    for leaf in jax.tree.leaves(refined):
        assert np.isfinite(np.asarray(leaf)).all()
    # Zero-noise chain: candidates equal the current params, strict-<
    # best updates reject them, result is bit-identical.
    refined0, stats0 = geometry_refine(
        padded, mask, batches, cfg, proposals=32, phases=1,
        accept_temp=0.5, sigma_c=0.0, sigma_r=0.0,
        key=jax.random.PRNGKey(0), log=lambda s: None)
    assert stats0.accepted == 0
    np.testing.assert_array_equal(np.asarray(refined0.centers),
                                  np.asarray(padded.centers))


def test_refine_fringe_weighted_acceptance(setup):
    """fringe_weight changes the acceptance loss scale (band upweighted)
    but the procedure still descends and only touches live geometry."""
    cfg, ds = setup
    params = init_scene_params(7)
    padded, mask = pad_params(params, 8)
    batches = sample_fg_tile_batches(ds, tiles=4, tile=cfg.cull_tile)
    refined, stats = geometry_refine(
        padded, mask, batches, cfg, proposals=64, phases=1,
        fringe_weight=10.0, key=jax.random.PRNGKey(0), log=lambda s: None)
    assert stats.loss_after <= stats.loss_before
    assert np.isfinite(stats.loss_before) and stats.loss_before > 0
    np.testing.assert_array_equal(np.asarray(refined.colors),
                                  np.asarray(padded.colors))


def test_light_refine_moves_only_light(setup):
    from burn_raymarching.train.refine import light_refine

    cfg, ds = setup
    params = init_scene_params(7)
    padded, mask = pad_params(params, 8)
    batches = sample_fg_tile_batches(ds, tiles=4, tile=cfg.cull_tile)
    refined, stats = light_refine(
        padded, mask, batches, cfg, proposals=32,
        key=jax.random.PRNGKey(0), log=lambda s: None)
    assert stats.loss_after <= stats.loss_before
    np.testing.assert_array_equal(np.asarray(refined.centers),
                                  np.asarray(padded.centers))
    np.testing.assert_array_equal(np.asarray(refined.colors),
                                  np.asarray(padded.colors))
    np.testing.assert_array_equal(np.asarray(refined.radii),
                                  np.asarray(padded.radii))
    if stats.accepted:
        moved = (np.abs(np.asarray(refined.light_dir)
                        - np.asarray(padded.light_dir)).max() > 0
                 or np.abs(np.asarray(refined.ambient)
                           - np.asarray(padded.ambient)).max() > 0)
        assert moved


def test_refine_budget_cap_is_config_and_logged(setup):
    """refine_max_budget caps the proposal-loss budget (logged when it
    engages) and is CLI-plumbed; invalid chunk values are rejected
    (ADVICE r4)."""
    import dataclasses

    from burn_raymarching.train.refine import _capped_budget

    cfg, ds = setup
    logs = []
    capped = dataclasses.replace(cfg, cull_budget=64, refine_max_budget=16)
    assert _capped_budget(capped, logs.append) == 16
    assert logs and "capped 64 -> 16" in logs[0]
    logs.clear()
    uncapped = dataclasses.replace(cfg, cull_budget=16,
                                   refine_max_budget=4096)
    assert _capped_budget(uncapped, logs.append) == 16
    assert not logs

    params = init_scene_params(7)
    padded, mask = pad_params(params, 8)
    batches = sample_fg_tile_batches(ds, tiles=2, tile=cfg.cull_tile)
    with pytest.raises(ValueError, match="chunk"):
        geometry_refine(padded, mask, batches, cfg, proposals=8,
                        phases=1, chunk=0, key=jax.random.PRNGKey(0),
                        log=lambda s: None)


def test_trainer_refine_widened_composition(setup, tmp_path, monkeypatch):
    """The production composition with every widened family on at once
    (colors + light + fringe acceptance + annealed chain)."""
    import dataclasses

    from burn_raymarching.data.image_io import load_image_as_array
    from burn_raymarching.data.scene_io import load_cameras
    from burn_raymarching.train.loop import Trainer

    cfg, ds = setup
    cams = load_cameras(cfg.cameras_json)[:1]
    tgts = [load_image_as_array(c["file"]) for c in cams]
    monkeypatch.chdir(tmp_path)
    cfg = dataclasses.replace(
        cfg, stages=1, steps_per_stage=20, steps_per_call=20,
        use_pallas=False, checkpoint_dir=None,
        scene_json="scene.json", steps_dir="steps")
    tr = Trainer(cfg, ds, log=lambda s: None)
    padded, mask = tr.run()
    padded2, mask2 = tr.refine_geometry(
        padded, mask, rounds=1, proposals=32, tiles=2,
        sigma_col=0.3, accept_temp=0.05, fringe_weight=4.0,
        light_proposals=16, cameras=cams, targets=tgts)
    for leaf in jax.tree.leaves(padded2):
        assert np.isfinite(np.asarray(leaf)).all()
    assert int(np.asarray(mask2).sum()) == int(np.asarray(mask).sum())


def test_auto_chunk_scales_with_cull_budget(setup):
    """The proposals-per-program envelope (module docstring): 64 at
    k_budget<=2048, halving as the budget doubles, and the proposal-loss
    budget itself capped at REFINE_MAX_BUDGET (budgets above it are not
    yet tested on the H100)."""
    from burn_raymarching.train.refine import (
        REFINE_MAX_BUDGET,
        _auto_chunk,
    )

    assert REFINE_MAX_BUDGET == 2048
    assert _auto_chunk(16) == 64
    assert _auto_chunk(2048) == 64
    assert _auto_chunk(4096) == 32
    assert _auto_chunk(8192) == 16
    assert _auto_chunk(1 << 20) == 8      # floor

    # Explicit chunk override flows through and controls program count.
    cfg, ds = setup
    params = init_scene_params(7)
    padded, mask = pad_params(params, 8)
    batches = sample_fg_tile_batches(ds, tiles=4, tile=cfg.cull_tile)
    logs = []
    _, stats = geometry_refine(
        padded, mask, batches, cfg, proposals=32, phases=1, chunk=16,
        key=jax.random.PRNGKey(0), log=logs.append)
    assert stats.proposals == 32          # 2 programs x 16
    assert "accepted" in logs[-1] and "/32" in logs[-1]
