"""CLI tools: generate, chromakey, COLMAP parsing, camera processing,
perfect-orbit fabrication, offline viewer."""

import json
import os

import numpy as np
import pytest

from burn_raymarching.data.image_io import read_png, write_png
from burn_raymarching.tools.colmap_to_json import (
    parse_cameras_txt,
    parse_images_txt,
    qvec2rotmat,
)
from burn_raymarching.tools.generate import default_cameras
from burn_raymarching.tools.generate_perfect_cameras import perfect_orbit
from burn_raymarching.tools.process_cameras import process_cameras


def test_default_cameras_match_reference(reference_dir):
    """Our generate rig == the committed data/cameras.json."""
    with open(os.path.join(reference_dir, "data/cameras.json")) as f:
        ref = json.load(f)
    ours = default_cameras("data")
    assert len(ours) == len(ref) == 10
    for a, b in zip(ours, ref):
        assert a["file"] == b["file"]
        np.testing.assert_allclose(a["origin"], b["origin"], atol=1e-6)
        np.testing.assert_allclose(a["target"], b["target"], atol=1e-6)
        assert a["fov"] == b["fov"]


def test_generate_cli_small(tmp_path, monkeypatch):
    from burn_raymarching.tools.generate import main

    monkeypatch.chdir(tmp_path)
    main(["--out", "data", "--size", "32"])
    cams = json.load(open("data/cameras.json"))
    assert len(cams) == 10
    img = read_png("data/target_0.png")
    assert img.shape == (32, 32, 3)
    assert img.max() > 0  # spheres visible


def test_chromakey_keeps_center_red_blobs():
    a = np.zeros((512, 512, 3), np.uint8)
    a[200:300, 200:300] = [220, 40, 30]    # bright red center blob
    a[:40, :40] = [220, 40, 30]            # red but at the border
    a[350:400, 350:400] = [20, 20, 200]    # bright blue (not reddish)
    Image = pytest.importorskip("PIL.Image")
    from burn_raymarching.tools.chromakey import chromakey_image

    out = chromakey_image(Image.fromarray(a))
    assert out.shape == (256, 256, 3)
    center = out[100:150, 100:150]
    assert center[:, :, 0].max() > 150     # red blob kept
    assert out[:20, :20].max() == 0        # border removed
    assert out[175:200, 175:200].max() == 0  # blue removed


def test_qvec_identity():
    np.testing.assert_allclose(qvec2rotmat(1, 0, 0, 0), np.eye(3), atol=1e-12)


def test_colmap_parse_roundtrip():
    cameras_txt = "# comment\n1 SIMPLE_PINHOLE 1024 1024 800 512 512\n"
    fov = parse_cameras_txt(cameras_txt)
    assert set(fov) == {1}
    np.testing.assert_allclose(fov[1], np.degrees(2 * np.arctan(1024 / 1600)))

    # Identity rotation, camera at -t.
    images_txt = (
        "# comment\n"
        "1 1 0 0 0 0.5 -0.25 2.0 1 img_0001.jpg\n"
        "0.0 0.0 1\n"
    )
    cfgs = parse_images_txt(images_txt, fov, "pre/")
    assert len(cfgs) == 1
    c = cfgs[0]
    assert c["file"] == "pre/img_0001.jpg"
    np.testing.assert_allclose(c["origin"], [-0.5, 0.25, -2.0], atol=1e-12)
    np.testing.assert_allclose(c["target"], [-0.5, 0.25, -1.0], atol=1e-12)


def test_process_cameras_thins_rejects_recenters():
    cams = []
    for i in range(32):
        cams.append({"file": f"f{i}.jpg", "fov": 50.0,
                     "origin": [2.0, 0.5, float(i)],
                     "target": [1.0, 0.0, 0.0]})
    cams[8]["target"] = [50.0, 0.0, 0.0]  # outlier (picked by ::8 thinning)
    out = process_cameras(cams, interval=8, threshold=1.5)
    assert len(out) == 3  # 4 thinned - 1 outlier
    # Recentred: mean target of inliers is origin.
    tgts = np.array([c["target"] for c in out])
    np.testing.assert_allclose(tgts.mean(axis=0), 0.0, atol=1e-9)


def test_perfect_orbit_geometry():
    cams = perfect_orbit([f"i{i}.jpg" for i in range(8)], "p/", radius=2.0,
                         height=0.5)
    assert len(cams) == 8
    for c in cams:
        o = np.asarray(c["origin"])
        np.testing.assert_allclose(np.hypot(o[0], o[2]), 2.0, atol=1e-9)
        assert o[1] == 0.5
        # target is unit length along -origin from origin.
        d = np.asarray(c["target"]) - o
        np.testing.assert_allclose(np.linalg.norm(d), 1.0, atol=1e-9)


def test_viewer_offline_renders(tmp_path, monkeypatch):
    from burn_raymarching.tools.viewer_offline import main

    scene = os.path.join(os.path.dirname(os.path.dirname(__file__)), "docs",
                         "artifacts", "scene_polished.json")
    monkeypatch.chdir(tmp_path)
    main([scene, "--out", "orbit", "--frames", "2", "--size", "32"])
    assert len(os.listdir("orbit")) == 2
    img = read_png("orbit/frame_0000.png")
    assert img.shape == (32, 32, 3)

    main([scene, "--out", "orbit_train", "--frames", "1", "--size", "32",
          "--model", "train"])
    img2 = read_png("orbit_train/frame_0000.png")
    assert img2.max() > 0


def test_knot_scene_and_ring_cameras():
    from burn_raymarching.tools.generate import knot_scene, ring_cameras

    c, col, r = knot_scene(128)
    assert c.shape == (128, 3) and col.shape == (128, 3)
    assert np.abs(c).max() <= 0.85 + 1e-5
    assert (col >= 0).all() and (col <= 1).all()
    assert (r > 0).all()

    cams = ring_cameras(100)
    assert len(cams) == 100
    # All cameras look at the origin from outside the scene bound.
    for cam in cams:
        assert np.linalg.norm(cam["origin"]) > 1.5
        assert cam["target"] == [0.0, 0.0, 0.0]
    # Distinct positions (no duplicate ring slots).
    origins = {tuple(np.round(c["origin"], 5)) for c in cams}
    assert len(origins) == 100


def test_cloud_init_with_point_prior():
    import jax.numpy as jnp

    from burn_raymarching.models.scene import init_scene_params_cloud

    pts = np.asarray([[0.5, 0.0, 0.0], [-0.5, 0.0, 0.0]], np.float32)
    p = init_scene_params_cloud(64, seed=1, radius=0.03, points=pts,
                                jitter=0.01)
    assert p.centers.shape == (64, 3)
    # Every center is near one of the prior points.
    d = np.linalg.norm(
        np.asarray(p.centers)[:, None, :] - pts[None, :, :], axis=2).min(1)
    assert d.max() < 0.1
    # Radius activation maps back to the requested physical size.
    phys = np.asarray(jnp.log1p(jnp.exp(p.radii)) + 0.01)
    np.testing.assert_allclose(phys, 0.03, atol=1e-4)


def test_train_cli_config_flags(tmp_path):
    """CLI flags map onto TrainConfig — the large-scene recipe's flags and
    the repulsion far-field knob in particular."""
    import argparse

    from burn_raymarching.tools.train_cli import build_config

    args = argparse.Namespace(
        batch_size=2048, width=None, height=None, stages=None,
        steps_per_stage=None, base_lr=None, seed=None,
        init_n=512, init_layout="cloud",
        init_points=str(tmp_path / "pts.json"),
        cameras="", scene_out="", steps_dir="",
        checkpoint_dir=None, no_pallas=False, turbo=True, warm_steps=0,
        cull=64, cull_hier=0, cluster_repulsion=True,
        rep_far_field="monopole", wd_mode="decoupled",
        smooth_k=128.0, sharp="40,60",
        lr_scales="0.001,1,0.1,0.5")
    cfg = build_config(args)
    assert cfg.batch_size == 2048
    assert cfg.init_n == 512 and cfg.init_layout == "cloud"
    assert cfg.init_points == str(tmp_path / "pts.json")
    assert cfg.use_culling and cfg.cull_budget == 64
    assert cfg.dataset_order == "morton"
    assert cfg.cluster_repulsion
    assert cfg.loss.repulsion_far_field == "monopole"
    assert cfg.weight_decay_mode == "decoupled"
    assert cfg.min_smooth_k == cfg.max_smooth_k == 128.0
    assert cfg.render.softmax_sharpness == 40.0
    assert cfg.render.mask_sharpness == 60.0
    assert cfg.lr_scale_centers == 0.001 and cfg.lr_scale_radii == 0.1
    assert cfg.warm_start


def test_colmap_points3d_parse(tmp_path):
    from burn_raymarching.tools.colmap_to_json import parse_points3d_txt

    txt = ("# comment\n"
           "1 0.5 -0.25 2.0 255 0 0 0.5 1 2\n"
           "\n"
           "7 -1.0 0.0 3.5 0 255 0 0.1 3 4\n")
    pts = parse_points3d_txt(txt)
    np.testing.assert_allclose(
        pts, [[0.5, -0.25, 2.0], [-1.0, 0.0, 3.5]])


def test_load_cameras_resolves_relative_paths(tmp_path, monkeypatch):
    """cameras.json entries like "data/target_0.png" (crate-root-relative,
    reference train.rs:66-68) resolve against the json's location when they
    don't exist from the cwd."""
    from burn_raymarching.data.scene_io import load_cameras

    data = tmp_path / "data"
    data.mkdir()
    write_png(str(data / "target_0.png"), np.zeros((2, 2, 3), np.uint8))
    cams = [{"file": "data/target_0.png", "origin": [0, 0, -2.5],
             "target": [0, 0, 0], "fov": 50.0}]
    with open(data / "cameras.json", "w") as f:
        json.dump(cams, f)
    monkeypatch.chdir(tmp_path)  # cwd-relative works (reference behavior)
    assert load_cameras(str(data / "cameras.json"))[0]["file"] == \
        "data/target_0.png"
    monkeypatch.chdir("/")       # elsewhere: resolved against json location
    out = load_cameras(str(data / "cameras.json"))[0]["file"]
    assert out == str(data / "target_0.png") and os.path.exists(out)


def test_train_cli_round3_flags():
    """Round-3 knobs reach the config: Gaussian coverage, overlap merge,
    residual split, per-stage centers lr, adaptive mask."""
    from burn_raymarching.tools.train_cli import main

    import burn_raymarching.tools.train_cli as cli

    captured = {}

    def fake_build_dataset(cfg):
        captured["cfg"] = cfg
        raise SystemExit(0)     # stop before any training

    import burn_raymarching.train.loop as loop
    orig = loop.build_dataset
    loop.build_dataset = fake_build_dataset
    try:
        try:
            main(["--coverage", "gaussian", "--merge-cell", "0.04",
                  "--split-mode", "residual", "--split-budget", "8",
                  "--lr-centers-stages", "0.001,0.01",
                  "--mask-px", "1.0", "--pixel-angle", "0.004",
                  "--sharp", "40,40"])
        except SystemExit:
            pass
    finally:
        loop.build_dataset = orig
    cfg = captured["cfg"]
    assert cfg.render.coverage_mode == "gaussian"
    assert cfg.render.softmax_sharpness == 40.0
    assert cfg.render.mask_pixel_mult == 1.0
    assert cfg.render.pixel_angle == 0.004
    assert cfg.density.merge_cell == 0.04
    assert cfg.density.split_mode == "residual"
    assert cfg.density.split_budget == 8
    assert cfg.lr_scale_centers_stages == (0.001, 0.01)
