"""End-to-end trainer tests on the bundled reference dataset (CPU, small)."""

import json
import os

import numpy as np
import pytest

from burn_raymarching.config import TrainConfig
from burn_raymarching.train.loop import Trainer, build_dataset


@pytest.fixture(scope="module")
def dataset(scene_root):
    cfg = TrainConfig(
        cameras_json=os.path.join(scene_root, "data/cameras.json"),
    )
    # The cameras.json 'file' paths are relative to the reference root.
    cwd = os.getcwd()
    os.chdir(scene_root)
    try:
        ds = build_dataset(cfg)
    finally:
        os.chdir(cwd)
    return ds


def test_dataset_stats_match_reference_scale(dataset):
    assert dataset.num_total_pixels == 655360  # 10 views x 256^2
    # ~5% of pixels are foreground in the bundled 3-sphere scene.
    assert 20000 < dataset.num_fg < 60000


def test_two_stage_run_produces_artifacts(tmp_path, dataset, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = TrainConfig(
        batch_size=512, stages=2, steps_per_stage=100, use_pallas=False,
        scene_json="scene.json", steps_dir="steps",
        checkpoint_dir="checkpoints",
    )
    tr = Trainer(cfg, dataset, log=lambda s: None)
    padded, mask = tr.run()

    # Loss decreased from stage 1 to stage 2 logs.
    assert len(tr.loss_history) == 2
    assert all(np.isfinite(tr.loss_history))

    scene = json.load(open("scene.json"))
    assert set(scene) == {"num_spheres", "centers", "colors", "radii",
                          "light_dir", "ambient_intensity"}
    assert scene["num_spheres"] >= 1
    assert os.path.exists("steps/stage_0.png")
    assert os.path.exists("steps/final_1.png")
    assert os.path.exists("checkpoints/stage_1.npz")

    # Resume path: a fresh trainer resumes from the stage-1 checkpoint.
    logs = []
    tr2 = Trainer(cfg, dataset, log=logs.append)
    tr2.run(resume=True)
    assert any("Resuming" in l for l in logs)


def test_polish_refines_final_scene(tmp_path, dataset, monkeypatch,
                                    scene_root):
    from burn_raymarching.data.image_io import load_image_as_array
    from burn_raymarching.data.scene_io import load_cameras

    cams = load_cameras(os.path.join(scene_root, "data/cameras.json"))
    tgts = [load_image_as_array(os.path.join(scene_root, c["file"]))
            for c in cams]
    monkeypatch.chdir(tmp_path)
    cfg = TrainConfig(
        batch_size=512, stages=1, steps_per_stage=100, use_pallas=False,
        scene_json="scene.json", steps_dir="steps", checkpoint_dir=None,
    )
    tr = Trainer(cfg, dataset, log=lambda s: None)
    padded, mask = tr.run()
    n_before = int(np.asarray(mask).sum())
    padded2, mask2 = tr.polish(padded, mask, rounds=1, cameras=cams,
                               targets=tgts)
    # Primitive set is frozen: same live count, finite params, re-export.
    assert int(np.asarray(mask2).sum()) == n_before
    for leaf in [padded2.centers, padded2.colors, padded2.radii,
                 padded2.light_dir, padded2.ambient]:
        assert np.isfinite(np.asarray(leaf)).all()
    assert os.path.exists("steps/final_polished.png")
    scene = json.load(open("scene.json"))
    assert scene["num_spheres"] == n_before
