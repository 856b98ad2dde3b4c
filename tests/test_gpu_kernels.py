"""The Triton march kernels compiled for the card, against their XLA twins
and through one training step. Marked ``gpu``: they skip without a GPU and
``python chip_smoke.py`` runs them (pytest -m gpu)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from burn_raymarching.data.camera import create_camera_rays
from burn_raymarching.ops.kernels import select_kernels

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    m = 37                                   # not a power of two
    centers = jnp.asarray(rng.normal(0, 0.3, (m, 3)), jnp.float32)
    radii = jnp.asarray(0.05 + 0.1 * rng.random((m, 1)), jnp.float32)
    mask = jnp.arange(m) < 33                # masked slots
    ro, rd = create_camera_rays(30, 30, [0.0, 0.4, -2.0], [0, 0, 0], 50.0)
    return ro, rd, centers, radii, mask      # N = 900: ragged blocks


def _near(t):
    return np.asarray(t).reshape(-1) < 10.0


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_dense_kernel_matches_xla_on_gpu(gpu, scene, warm):
    ro, rd, c, r, mask = scene
    kern, xla = select_kernels(True), select_kernels(False)
    assert kern.march_normal_fn is not xla.march_normal_fn
    kw = dict(mask=mask)
    if warm:
        t0, _ = xla.march_normal_fn(ro, rd, c, r, 18.5, **kw)
        kw.update(num_steps=16, t_init=0.8 * t0)
    t_k, n_k = jax.jit(lambda ro, rd: kern.march_normal_fn(
        ro, rd, c, r, 18.5, **kw))(ro, rd)
    t_x, n_x = xla.march_normal_fn(ro, rd, c, r, 18.5, **kw)
    near = _near(t_x)
    assert near.sum() > 100
    np.testing.assert_allclose(np.asarray(t_k)[near], np.asarray(t_x)[near],
                               rtol=1e-4, atol=1e-4)
    assert np.isfinite(np.asarray(n_k)).all()


@pytest.mark.parametrize("budget", [8, 300])   # one chunk / streamed chunks
def test_culled_kernel_matches_xla_on_gpu(gpu, scene, budget):
    from burn_raymarching.ops.culling import (
        gather_tile_tables,
        select_tile_primitives,
        tile_cones,
    )

    ro, rd, c, r, mask = scene
    ro, rd = ro[:896], rd[:896]                # 7 tiles of 128
    k = jnp.float32(32.0)
    cones = tile_cones(ro, rd, 128)
    c_big = jnp.tile(c, (10, 1)) + 0.01 * jnp.arange(370)[:, None] / 370
    r_big = jnp.tile(r, (10, 1))
    idx, valid = select_tile_primitives(cones, c_big, r_big, k,
                                        min(budget, 370))
    cs, _, rs, qs = gather_tile_tables(c_big, c_big, r_big, idx, valid)
    ro3, rd3 = ro.reshape(7, 128, 3), rd.reshape(7, 128, 3)
    kern, xla = select_kernels(True), select_kernels(False)
    t_k, _ = kern.culled_march_normal_fn(ro3, rd3, cs, rs, qs, k)
    t_x, _ = xla.culled_march_normal_fn(ro3, rd3, cs, rs, qs, k)
    near = _near(t_x)
    assert near.any()
    np.testing.assert_allclose(np.asarray(t_k).reshape(-1)[near],
                               np.asarray(t_x).reshape(-1)[near],
                               rtol=1e-4, atol=1e-4)


def test_trainer_step_with_kernels_on_gpu(gpu, scene_root, tmp_path,
                                          monkeypatch):
    """One warm culled stage through the Trainer: the registry wires the
    compiled kernels and the step stays finite."""
    from burn_raymarching.config import TrainConfig
    from burn_raymarching.models.scene import init_scene_params_cloud
    from burn_raymarching.train.loop import Trainer, build_dataset

    monkeypatch.chdir(tmp_path)
    cfg = TrainConfig(
        batch_size=1024, stages=1, steps_per_stage=4, steps_per_call=4,
        use_culling=True, cull_budget=32, cull_tile=256, warm_start=True,
        dataset_order="morton", init_n=64, init_layout="cloud",
        checkpoint_dir=None,
        cameras_json=os.path.join(scene_root, "data/cameras.json"))
    tr = Trainer(cfg, build_dataset(cfg), log=lambda s: None)
    assert tr.culled_march_normal_fn is select_kernels(True).culled_march_normal_fn
    padded, _, loss = tr.run_stage(init_scene_params_cloud(64), 0,
                                   jax.random.PRNGKey(0))
    assert np.isfinite(float(loss))
    for leaf in jax.tree.leaves(padded):
        assert np.isfinite(np.asarray(leaf)).all()
