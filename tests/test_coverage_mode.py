"""Gaussian coverage mode (RenderConfig.coverage_mode="gaussian").

extension, default off. The reference trains a sigmoid
silhouette (renderer_diff.rs:86-90) against targets masked with a Gaussian
exp(-s*d^2) (renderer.rs:77); the family mismatch is baked into the
measured representational ceilings (docs/SCALING.md). These tests pin
(a) exact equality with the reference sigmoid when off, (b) the Gaussian
formula (incl. the pixel-footprint floor composition), (c) dense/culled
agreement, (d) unchanged gradient topology, and (e) the motivating
property: GT params through the Gaussian-coverage trainable forward land
closer to the GT renderer's output than through the sigmoid one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from burn_raymarching.data.camera import create_camera_rays
from burn_raymarching.ops.march import march_xla
from burn_raymarching.ops.sdf import scene_sdf
from burn_raymarching.render.diff import adaptive_coverage, render_diff


@pytest.fixture(scope="module")
def scene():
    centers = jnp.asarray([[0.0, 0.0, 0.0], [0.25, 0.1, 0.2]], jnp.float32)
    colors = jnp.asarray([[0.9, 0.2, 0.2], [0.2, 0.8, 0.3]], jnp.float32)
    radii = jnp.asarray([[0.2], [0.12]], jnp.float32)
    light = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)
    ambient = jnp.asarray([0.2], jnp.float32)
    return centers, colors, radii, light, ambient


def test_default_is_reference_sigmoid(scene):
    c, col, r, ld, amb = scene
    ro, rd = create_camera_rays(16, 16, [0.0, 0.0, -2.5], [0, 0, 0], 50.0)
    base = render_diff(ro, rd, c, col, r, ld, amb, 32.0)
    explicit = render_diff(ro, rd, c, col, r, ld, amb, 32.0,
                           coverage_mode="sigmoid")
    np.testing.assert_array_equal(np.asarray(base), np.asarray(explicit))


def test_gaussian_formula():
    d = jnp.asarray([[0.01], [0.1], [-0.05]], jnp.float32)
    t = jnp.asarray([[1.0], [10.0], [2.0]], jnp.float32)
    got = adaptive_coverage(d, t, 40.0, coverage_mode="gaussian")
    want = np.exp(-40.0 * np.asarray(d) ** 2)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)
    # Pixel floor composes on the Gaussian width 1/sqrt(s).
    sharp, mult, px = 40.0, 1.0, 0.02
    got = adaptive_coverage(d, t, sharp, mult, px, coverage_mode="gaussian")
    w = np.maximum(1.0 / np.sqrt(sharp), mult * px * np.asarray(t))
    want = np.exp(-(np.asarray(d) / w) ** 2)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5)
    # Footprint stays detached.
    g = jax.grad(lambda tt: adaptive_coverage(
        d, tt, sharp, mult, px, coverage_mode="gaussian").sum())(t)
    np.testing.assert_array_equal(np.asarray(g), 0.0)
    with pytest.raises(ValueError):
        adaptive_coverage(d, t, 40.0, coverage_mode="nope")


def test_gaussian_render_is_sigmoid_render_recovered(scene):
    """Coverage is a pure scalar factor of the reattached scene distance:
    out_gauss == out_sigmoid / sigmoid_cov * gauss_cov, re-deriving the
    distance through the same march + reattachment."""
    c, col, r, ld, amb = scene
    ro, rd = create_camera_rays(16, 16, [0.0, 0.0, -2.5], [0, 0, 0], 50.0)
    sharp = 40.0
    out_s = render_diff(ro, rd, c, col, r, ld, amb, 32.0,
                        mask_sharpness=sharp)
    out_g = render_diff(ro, rd, c, col, r, ld, amb, 32.0,
                        mask_sharpness=sharp, coverage_mode="gaussian")
    t = march_xla(ro, rd, c, r, 32.0)
    dist_last = scene_sdf(ro + rd * t, c, r, 32.0)
    d = scene_sdf(ro + rd * (t + dist_last), c, r, 32.0)
    cov_s = np.asarray(jax.nn.sigmoid(-sharp * d))
    cov_g = np.asarray(jnp.exp(-sharp * d * d))
    # Far-miss rays have cov_s == 0 in fp32 — recover only where the
    # division is well-conditioned; for the rest both outputs must be ~0.
    ok = (cov_s > 1e-4)[:, 0]
    np.testing.assert_allclose(np.asarray(out_g)[ok],
                               (np.asarray(out_s) / cov_s * cov_g)[ok],
                               atol=1e-5)
    assert np.abs(np.asarray(out_g)[~ok]).max() < 1e-4


def test_culled_matches_dense_gaussian(scene):
    c, col, r, ld, amb = scene
    from burn_raymarching.render.culled import render_diff_culled

    ro, rd = create_camera_rays(16, 16, [0.0, 0.0, -2.5], [0, 0, 0], 50.0)
    dense = render_diff(ro, rd, c, col, r, ld, amb, 32.0,
                        mask_sharpness=40.0, coverage_mode="gaussian")
    culled = render_diff_culled(ro, rd, c, col, r, ld, amb, 32.0,
                                tile=64, k_budget=2, mask_sharpness=40.0,
                                coverage_mode="gaussian")
    np.testing.assert_allclose(np.asarray(dense), np.asarray(culled),
                               atol=1e-5)


def test_gradients_finite_padded_zero(scene):
    c, col, r, ld, amb = scene
    from burn_raymarching.models.scene import (
        SceneParams,
        pad_params,
        scene_forward,
    )

    raw = SceneParams(
        centers=c, colors=jnp.zeros_like(col),
        radii=jnp.full_like(r, -2.0),
        light_dir=ld, ambient=jnp.zeros_like(amb))
    padded, mask = pad_params(raw, 4)
    ro, rd = create_camera_rays(8, 8, [0.0, 0.0, -2.5], [0, 0, 0], 50.0)

    def loss(p):
        out = scene_forward(p, ro, rd, 32.0, mask=mask, mask_sharpness=40.0,
                            coverage_mode="gaussian")
        return jnp.sum(out ** 2)

    g = jax.grad(loss)(padded)
    for leaf in jax.tree.leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()
    assert np.abs(np.asarray(g.centers)[2:]).sum() == 0.0
    assert np.abs(np.asarray(g.centers)[:2]).sum() > 0.0


def test_gaussian_mode_closes_gap_to_gt_forward(scene):
    """The motivating property (VERDICT round-2 item 2): with the GT's own
    mask family and sharpness, the trainable forward of the GT params is
    much closer to the GT renderer's target than with the sigmoid mask —
    i.e. the family mismatch really was a ceiling term."""
    from burn_raymarching.render.gt import render_gt

    c, col, r, ld, amb = scene
    ro, rd = create_camera_rays(32, 32, [0.0, 0.0, -2.5], [0, 0, 0], 50.0)
    gt_light, gt_amb = (-0.5, 0.5, -1.0), 0.1
    target = render_gt(ro, rd, c, col, r, smooth_k=32.0,
                       light_dir=gt_light, ambient=gt_amb,
                       weight_sharpness=10.0, mask_sharpness=10.0)
    ldg = jnp.asarray(gt_light, jnp.float32)
    ambg = jnp.asarray([gt_amb], jnp.float32)

    def err(mode, sharp):
        out = render_diff(ro, rd, c, col, r, ldg, ambg, 32.0,
                          softmax_sharpness=10.0, mask_sharpness=sharp,
                          coverage_mode=mode)
        return float(jnp.mean((out - target) ** 2))

    # Reference-shaped trainable forward (sigmoid 15) vs the GT-family one
    # (gaussian at the GT's own sharpness 10).
    assert err("gaussian", 10.0) < 0.5 * err("sigmoid", 15.0)


def test_coverage_mode_stage_schedule(tmp_path, monkeypatch, scene_root):
    """coverage_mode_stages builds one step program per family and the
    trained output matches the FINAL mode's forward: a ("sigmoid",
    "gaussian") schedule must end with params whose last-stage trajectory
    equals an all-gaussian run seeded with the same stage-1 inputs."""
    import os

    from burn_raymarching.config import TrainConfig
    from burn_raymarching.train.loop import Trainer, build_dataset

    from burn_raymarching.config import RenderConfig

    cfg = TrainConfig(
        batch_size=256, stages=2, steps_per_stage=8, steps_per_call=8,
        use_pallas=False, checkpoint_dir=None,
        coverage_mode_stages=("sigmoid", "gaussian"),
        render=RenderConfig(coverage_mode="gaussian"),
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
    assert tr._coverage_for_stage(0) == "sigmoid"
    assert tr._coverage_for_stage(1) == "gaussian"
    assert tr._coverage_for_stage(7) == "gaussian"   # clamped (polish)
    padded, mask = tr.run()
    # Stage 0 (sigmoid) got its own program; stage 1 equals the base
    # render config and reuses the prebuilt step (no duplicate compile).
    assert len(tr._step_fns) == 1
    assert tr._step_for_stage(0) is not tr._step_for_stage(1)
    assert tr._step_for_stage(1) is tr._step_fn
    for leaf in [padded.centers, padded.colors, padded.radii]:
        assert np.isfinite(np.asarray(leaf)).all()


def test_coverage_schedule_stage_program_differs(scene_root):
    """The two stage programs really compute different coverages: one
    step under each mode from identical inputs produces different params."""
    import os

    import jax

    from burn_raymarching.config import TrainConfig
    from burn_raymarching.models.scene import init_scene_params, pad_params
    from burn_raymarching.train.loop import Trainer, build_dataset

    from burn_raymarching.config import RenderConfig

    cfg = TrainConfig(
        batch_size=256, stages=2, steps_per_stage=4, steps_per_call=4,
        use_pallas=False, checkpoint_dir=None,
        coverage_mode_stages=("sigmoid", "gaussian"),
        render=RenderConfig(coverage_mode="gaussian"),
        cameras_json=os.path.join(scene_root, "data/cameras.json"),
    )
    cwd = os.getcwd()
    os.chdir(scene_root)
    try:
        ds = build_dataset(cfg)
    finally:
        os.chdir(cwd)
    tr = Trainer(cfg, ds, log=lambda s: None)
    params = init_scene_params(cfg.init_n)
    p0, m = pad_params(params, 8)
    outs = []
    for stage in (0, 1):
        fn = tr._step_for_stage(stage)
        opt = tr.tx.init(p0)
        import jax.numpy as jnp

        p1, *_ = fn(p0, opt, jax.random.PRNGKey(0), m, ds.packed,
                    tr._sample_fg[0], tr._sample_fg[1],
                    jnp.zeros((0,), jnp.float32),
                    jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
                    jnp.zeros((0, 0), jnp.int32), jnp.zeros((0, 0), bool))
        outs.append(np.asarray(p1.colors))
    assert np.abs(outs[0] - outs[1]).max() > 1e-7


def test_mask_sharpness_stage_schedule(scene_root):
    """mask_sharpness_stages composes with coverage_mode_stages: one step
    program per distinct override pair, overrides visible in the stage
    cfg, and the no-schedule path returns the prebuilt step fn."""
    import os

    from burn_raymarching.config import TrainConfig
    from burn_raymarching.train.loop import Trainer, build_dataset

    from burn_raymarching.config import RenderConfig

    cfg = TrainConfig(
        batch_size=256, stages=3, steps_per_stage=4, steps_per_call=4,
        use_pallas=False, checkpoint_dir=None,
        coverage_mode_stages=("sigmoid", "gaussian"),
        mask_sharpness_stages=(15.0, 10.0, 40.0),
        render=RenderConfig(coverage_mode="gaussian", mask_sharpness=40.0),
        cameras_json=os.path.join(scene_root, "data/cameras.json"),
    )
    cwd = os.getcwd()
    os.chdir(scene_root)
    try:
        ds = build_dataset(cfg)
    finally:
        os.chdir(cwd)
    tr = Trainer(cfg, ds, log=lambda s: None)
    assert tr._render_overrides_for_stage(0) == {
        "coverage_mode": "sigmoid", "mask_sharpness": 15.0}
    assert tr._render_overrides_for_stage(1) == {
        "coverage_mode": "gaussian", "mask_sharpness": 10.0}
    assert tr._render_overrides_for_stage(9) == {
        "coverage_mode": "gaussian", "mask_sharpness": 40.0}   # clamped
    c1 = tr._stage_cfg(tr._render_overrides_for_stage(1))
    assert c1.render.coverage_mode == "gaussian"
    assert c1.render.mask_sharpness == 10.0
    # Distinct programs per stage; same overrides share one.
    f0, f1, f2 = (tr._step_for_stage(s) for s in (0, 1, 2))
    assert f0 is not f1 and f1 is not f2
    assert tr._step_for_stage(2) is f2

    # No schedule → the prebuilt step fn (kernel-swap compatibility).
    import dataclasses

    tr2 = Trainer(dataclasses.replace(cfg, coverage_mode_stages=(),
                                      mask_sharpness_stages=()),
                  ds, log=lambda s: None)
    assert tr2._step_for_stage(0) is tr2._step_fn


def test_schedule_final_mode_must_match_eval_forward(scene_root):
    """Review r3: a schedule whose last entry differs from the base render
    config would make polish/eval measure a different forward than the one
    trained — Trainer must refuse at construction."""
    import os

    import pytest as pt

    from burn_raymarching.config import DensityConfig, TrainConfig
    from burn_raymarching.train.loop import Trainer, build_dataset

    cfg0 = TrainConfig(batch_size=256, use_pallas=False,
                       checkpoint_dir=None,
                       cameras_json=os.path.join(scene_root, "data/cameras.json"))
    cwd = os.getcwd()
    os.chdir(scene_root)
    try:
        ds = build_dataset(cfg0)
    finally:
        os.chdir(cwd)
    import dataclasses

    with pt.raises(ValueError, match="coverage_mode_stages"):
        Trainer(dataclasses.replace(
            cfg0, coverage_mode_stages=("sigmoid", "gaussian")), ds)
    with pt.raises(ValueError, match="mask_sharpness_stages"):
        Trainer(dataclasses.replace(
            cfg0, mask_sharpness_stages=(10.0, 40.0)), ds)
    # Residual split without culling fails at construction, not at the
    # first stage boundary.
    with pt.raises(ValueError, match="use_culling"):
        Trainer(dataclasses.replace(
            cfg0, density=DensityConfig(split_mode="residual")), ds)


def test_load_cameras_resolves_json_relative_paths(tmp_path):
    """Review r3: entries like 'images_nobg/f.png' relative to the json's
    own directory (the colmap_to_json --prefix layout) must resolve from
    any cwd."""
    import json
    import os

    from burn_raymarching.data.scene_io import load_cameras

    d = tmp_path / "cap"
    (d / "images_nobg").mkdir(parents=True)
    (d / "images_nobg" / "f.png").write_bytes(b"x")
    cams = [{"file": "images_nobg/f.png", "origin": [0, 0, -2],
             "target": [0, 0, 0], "fov": 50.0}]
    with open(d / "cameras.json", "w") as f:
        json.dump(cams, f)
    cwd = os.getcwd()
    os.chdir("/")                      # anywhere but the capture dir
    try:
        out = load_cameras(str(d / "cameras.json"))
    finally:
        os.chdir(cwd)
    assert out[0]["file"] == str(d / "images_nobg" / "f.png")
    # Missing entries fail at load time with the candidate list.
    import pytest as pt

    cams[0]["file"] = "nope/missing.png"
    with open(d / "cameras.json", "w") as f:
        json.dump(cams, f)
    with pt.raises(FileNotFoundError, match="missing.png"):
        load_cameras(str(d / "cameras.json"))
