"""Tile-culled training path (config-4 style) on CPU."""

import numpy as np
import pytest

from burn_raymarching.config import TrainConfig
from burn_raymarching.train.loop import Trainer, build_dataset


@pytest.fixture(scope="module")
def cfg_ds(scene_root):
    import os

    cfg = TrainConfig(
        batch_size=1024, stages=1, steps_per_stage=10, steps_per_call=10,
        use_pallas=False, use_culling=True, cull_budget=16, cull_tile=256,
        dataset_order="morton", checkpoint_dir=None,
        cameras_json=os.path.join(scene_root, "data/cameras.json"),
    )
    cwd = os.getcwd()
    os.chdir(scene_root)
    try:
        ds = build_dataset(cfg)
    finally:
        os.chdir(cwd)
    return cfg, ds


def test_morton_dataset_same_pixel_set(cfg_ds, scene_root):
    import os

    cfg, ds = cfg_ds
    raster_cfg = TrainConfig(
        cameras_json=os.path.join(scene_root, "data/cameras.json"))
    cwd = os.getcwd()
    os.chdir(scene_root)
    try:
        ds_raster = build_dataset(raster_cfg)
    finally:
        os.chdir(cwd)
    assert ds.num_total_pixels == ds_raster.num_total_pixels
    assert ds.num_fg == ds_raster.num_fg  # permutation preserves the fg set
    a = np.sort(np.asarray(ds.targets).sum(1))
    b = np.sort(np.asarray(ds_raster.targets).sum(1))
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_culled_training_runs_and_is_finite(cfg_ds, tmp_path, monkeypatch):
    cfg, ds = cfg_ds
    monkeypatch.chdir(tmp_path)
    tr = Trainer(cfg, ds, log=lambda s: None)
    padded, mask = tr.run()
    for leaf in [padded.centers, padded.colors, padded.radii,
                 padded.light_dir, padded.ambient]:
        assert np.isfinite(np.asarray(leaf)).all()
    assert len(tr.loss_history) >= 1
    assert np.isfinite(tr.loss_history).all() if hasattr(
        np, "isfinite") else True


def test_hier_culled_training_runs_and_is_finite(cfg_ds, tmp_path,
                                                 monkeypatch):
    import dataclasses

    cfg, ds = cfg_ds
    cfg = dataclasses.replace(cfg, cull_hierarchical=True,
                              cull_cluster_group=4, cull_cluster_budget=4)
    monkeypatch.chdir(tmp_path)
    tr = Trainer(cfg, ds, log=lambda s: None)
    padded, mask = tr.run()
    for leaf in [padded.centers, padded.colors, padded.radii,
                 padded.light_dir, padded.ambient]:
        assert np.isfinite(np.asarray(leaf)).all()


def test_tile_sampling_warm_xla_trains(cfg_ds, tmp_path, monkeypatch):
    """sample_mode='tile' + warm start through the XLA culled twin (no
    Pallas on CPU): whole-Morton-block batches, t cache written, finite
    params. The round-2 config-5 recipe's single-chip path."""
    import dataclasses

    import jax.numpy as jnp

    cfg, ds = cfg_ds
    cfg = dataclasses.replace(cfg, sample_mode="tile", warm_start=True,
                              warm_steps=6)
    monkeypatch.chdir(tmp_path)
    tr = Trainer(cfg, ds, log=lambda s: None)
    assert tr.warm    # culled warm works without the fused kernel now
    padded, mask = tr.run()
    for leaf in [padded.centers, padded.colors, padded.radii,
                 padded.light_dir, padded.ambient]:
        assert np.isfinite(np.asarray(leaf)).all()
    assert np.isfinite(np.asarray(tr.t_cache)).all()
    assert float(jnp.max(tr.t_cache)) > 0.0


def test_tile_fg_marks_tiles_with_any_fg_pixel(cfg_ds):
    cfg, ds = cfg_ds
    fg_t, n_t = ds.tile_fg(cfg.cull_tile)
    assert 0 < n_t <= ds.num_total_pixels // cfg.cull_tile
    # Every flagged tile really contains a foreground pixel.
    px = np.asarray(ds.targets).reshape(-1, 3).sum(axis=1)
    per_tile = (px > ds.fg_threshold).reshape(-1, cfg.cull_tile).any(axis=1)
    flagged = np.asarray(fg_t)[:n_t]
    assert per_tile[flagged].all()
    assert per_tile.sum() == n_t
