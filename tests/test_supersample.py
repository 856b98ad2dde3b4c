"""Pixel-footprint supersampling (RenderConfig.supersample, round 4).

The silhouette-band mechanism: each training pixel is rendered as ss
sub-pixel-jittered rays whose predictions average before the loss. These
tests pin the quadrature pattern, the ray expansion geometry, the
edge-band-only effect on rendered images, the training-step integration
(dense + culled tile mode), and the schedule validation.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from burn_raymarching.config import RenderConfig, TrainConfig
from burn_raymarching.data.camera import create_camera_rays
from burn_raymarching.render.diff import render_diff
from burn_raymarching.train.step_body import (
    expand_subpixel,
    subpixel_offsets,
)


def test_offsets_square_grid_and_lattice():
    off4 = subpixel_offsets(4)
    assert off4.shape == (4, 2)
    np.testing.assert_allclose(sorted(off4[:, 0]), [-0.25, -0.25, 0.25, 0.25])
    np.testing.assert_allclose(off4.mean(axis=0), 0.0, atol=1e-12)
    off3 = subpixel_offsets(3)   # lattice fallback
    assert off3.shape == (3, 2)
    assert (np.abs(off3) <= 0.5).all()
    np.testing.assert_allclose(off3[:, 0].mean(), 0.0, atol=1e-12)


def test_expand_subpixel_geometry():
    ro, rd = create_camera_rays(8, 8, [0.0, 0.5, -2.5], [0, 0, 0], 50.0)
    px = 2.0 * np.tan(np.radians(25.0)) / 8.0
    ro2, rd2 = expand_subpixel(ro, rd, 4, px)
    assert ro2.shape == (64 * 4, 3) and rd2.shape == (64 * 4, 3)
    rd2 = np.asarray(rd2).reshape(64, 4, 3)
    # Unit directions, pixel-major adjacency: rows [i*4:(i+1)*4] belong to
    # ray i and stay inside its pixel footprint cone.
    np.testing.assert_allclose(np.linalg.norm(rd2, axis=2), 1.0, rtol=1e-6)
    cos = np.einsum("nkd,nd->nk", rd2, np.asarray(rd))
    ang = np.arccos(np.clip(cos, -1, 1))
    assert (ang <= px * 0.75).all()          # within ~sqrt(2)/2 px
    assert (ang >= px * 0.1).all()           # actually jittered
    # The quadrature is centered: mean sub-ray direction ~ the original.
    mean_dir = rd2.mean(axis=1)
    mean_dir /= np.linalg.norm(mean_dir, axis=1, keepdims=True)
    np.testing.assert_allclose(
        np.einsum("nd,nd->n", mean_dir, np.asarray(rd)), 1.0, atol=1e-6)
    # Origins replicate.
    np.testing.assert_array_equal(
        np.asarray(ro2).reshape(64, 4, 3)[:, 0], np.asarray(ro))


def test_supersampled_render_differs_only_in_silhouette_band():
    """Averaging the footprint must leave interiors/background untouched
    and produce intermediate coverage exactly at the silhouette."""
    c = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    col = jnp.asarray([[0.9, 0.9, 0.9]], jnp.float32)
    r = jnp.asarray([[0.4]], jnp.float32)
    ld = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)
    amb = jnp.asarray([0.2], jnp.float32)
    n = 48
    ro, rd = create_camera_rays(n, n, [0.0, 0.0, -2.5], [0, 0, 0], 50.0)
    px = 2.0 * np.tan(np.radians(25.0)) / n

    def render(ss):
        if ss == 1:
            ro2, rd2 = ro, rd
        else:
            ro2, rd2 = expand_subpixel(ro, rd, ss, px)
        out = render_diff(ro2, rd2, c, col, r, ld, amb, 128.0,
                          softmax_sharpness=40.0, mask_sharpness=40.0,
                          coverage_mode="gaussian")
        if ss > 1:
            out = jnp.mean(out.reshape(-1, ss, 3), axis=1)
        return np.asarray(out).reshape(n, n, 3)

    point, area = render(1), render(4)
    diff = np.abs(area - point).sum(axis=2)
    assert diff.max() > 1e-3                  # the edge band moved
    # Band-limited: pixels whose 3x3 neighborhood is uniformly in/out of
    # the object see (almost) no change.
    lum = point.sum(axis=2)
    obj = lum > 0.05
    interior = obj.copy()
    background = ~obj
    for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
        interior &= np.roll(obj, sh, axis=ax)
        background &= np.roll(~obj, sh, axis=ax)
    band = ~(interior | background)
    assert diff[band].sum() > 20.0 * max(diff[interior | background].mean(),
                                         1e-9)


@pytest.fixture(scope="module")
def dataset(scene_root):
    from burn_raymarching.train.loop import build_dataset

    cfg = TrainConfig(
        cameras_json=os.path.join(scene_root, "data/cameras.json"),
        dataset_order="morton")
    cwd = os.getcwd()
    os.chdir(scene_root)
    try:
        return build_dataset(cfg)
    finally:
        os.chdir(cwd)


PX = 2.0 * float(np.tan(np.radians(25.0))) / 256.0


def _run_short(cfg, dataset):
    from burn_raymarching.train.loop import Trainer

    tr = Trainer(cfg, dataset, log=lambda s: None)
    padded, mask = tr.run()
    for leaf in jax.tree.leaves(padded):
        assert np.isfinite(np.asarray(leaf)).all()
    return tr


def test_trainer_supersample_schedule_dense(dataset, tmp_path, monkeypatch,
                                            scene_root):
    monkeypatch.chdir(tmp_path)
    cfg = TrainConfig(
        batch_size=512, stages=2, steps_per_stage=20, steps_per_call=20,
        use_pallas=False, checkpoint_dir=None, dataset_order="morton",
        cameras_json=os.path.join(scene_root, "data/cameras.json"),
        supersample_stages=(4, 1),
        render=RenderConfig(pixel_angle=PX))
    tr = _run_short(cfg, dataset)
    # One extra step program for the ss=4 override; the final stage reuses
    # the prebuilt base program.
    assert len(tr._step_fns) == 1


def test_trainer_supersample_culled_tile_mode(dataset, tmp_path, monkeypatch,
                                              scene_root):
    monkeypatch.chdir(tmp_path)
    cfg = TrainConfig(
        batch_size=1024, stages=1, steps_per_stage=10, steps_per_call=10,
        use_pallas=False, checkpoint_dir=None,
        use_culling=True, cull_budget=16, cull_tile=256,
        dataset_order="morton", sample_mode="tile",
        cameras_json=os.path.join(scene_root, "data/cameras.json"),
        supersample_stages=(2, 1),
        render=RenderConfig(pixel_angle=PX))
    _run_short(cfg, dataset)


def test_supersample_validation(scene_root, dataset):
    from burn_raymarching.train.loop import Trainer

    base = TrainConfig(
        cameras_json=os.path.join(scene_root, "data/cameras.json"),
        use_pallas=False, checkpoint_dir=None, dataset_order="morton")
    with pytest.raises(ValueError, match="supersample_stages ends"):
        Trainer(dataclasses.replace(
            base, supersample_stages=(4, 4),
            render=RenderConfig(pixel_angle=PX)), dataset)
    with pytest.raises(ValueError, match="pixel_angle"):
        Trainer(dataclasses.replace(base, supersample_stages=(4, 1)),
                dataset)
    with pytest.raises(ValueError, match="mask_px_stages ends"):
        Trainer(dataclasses.replace(
            base, mask_px_stages=(2.0, 1.0),
            render=RenderConfig(pixel_angle=PX)), dataset)
