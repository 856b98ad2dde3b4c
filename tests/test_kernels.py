"""The platform kernel registry (ops/kernels.py), the --turbo warm start on
every platform, and an HLO audit that no matrix product in the training
steps may run in reduced (TF32) precision."""

import os
import re

import jax
import jax.numpy as jnp
import pytest

from burn_raymarching.ops.kernels import MarchKernels, select_kernels
from burn_raymarching.ops.march import march_normals_xla
from burn_raymarching.ops.pallas.march_kernel import (
    culled_march_normals_triton,
    march_normals_triton,
)
from burn_raymarching.render.culled import culled_march_normals_xla

XLA = MarchKernels(march_normals_xla, culled_march_normals_xla)
TRITON = MarchKernels(march_normals_triton, culled_march_normals_triton)


@pytest.mark.parametrize("backend,use_pallas,want", [
    ("gpu", True, TRITON),
    ("gpu", False, XLA),
    ("cpu", True, XLA),
    ("cpu", False, XLA),
])
def test_registry_choice(backend, use_pallas, want):
    assert select_kernels(use_pallas, backend) == want


@pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
def test_registry_rejects_unknown_platform(backend):
    with pytest.raises(ValueError, match="unsupported JAX backend"):
        select_kernels(True, backend)


def test_registry_defaults_to_running_backend():
    assert select_kernels(True) == select_kernels(True,
                                                  jax.default_backend())


def _trainer(scene_root, **kw):
    from burn_raymarching.config import TrainConfig
    from burn_raymarching.train.loop import Trainer, build_dataset

    cfg = TrainConfig(batch_size=512, stages=1, steps_per_stage=4,
                      steps_per_call=4, checkpoint_dir=None,
                      cameras_json=os.path.join(scene_root,
                                                "data/cameras.json"), **kw)
    return Trainer(cfg, build_dataset(cfg), log=lambda s: None)


def test_turbo_warm_start_runs_on_cpu(scene_root, tmp_path, monkeypatch):
    """--turbo turns the dense warm start on on every platform: the cache
    is prefilled and rewritten by the steps, not silently dropped."""
    import argparse

    import numpy as np

    from burn_raymarching.models.scene import init_scene_params
    from burn_raymarching.tools.train_cli import build_config

    args = argparse.Namespace(
        cameras=None, scene_out=None, steps_dir=None, checkpoint_dir=None,
        no_pallas=False, turbo=True, warm_steps=0, cull=0, cull_hier=0,
        cluster_repulsion=False, rep_far_field="", wd_mode=None,
        smooth_k=0.0, sharp="", lr_scales="")
    assert build_config(args).warm_start
    monkeypatch.chdir(tmp_path)
    tr = _trainer(scene_root, warm_start=True)
    assert tr.warm and tr.t_cache is not None
    tr.run_stage(init_scene_params(tr.cfg.init_n), 0, jax.random.PRNGKey(0))
    tc = np.asarray(tr.t_cache)
    assert np.isfinite(tc).all() and tc.max() > 0.0


def _step_args(tr):
    from burn_raymarching.models.scene import init_scene_params, pad_params

    padded, mask = pad_params(init_scene_params(tr.cfg.init_n), 16)
    cl_idx, cl_valid = tr._build_cluster_table(padded, mask)
    t_cache = (jnp.zeros((tr.dataset.num_total_pixels,), jnp.float32)
               if tr.warm else jnp.zeros((0,), jnp.float32))
    return (padded, tr.tx.init(padded), jax.random.PRNGKey(0), mask,
            tr.dataset.packed, tr._sample_fg[0], tr._sample_fg[1], t_cache,
            jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32), cl_idx,
            cl_valid)


def _dot_precisions(hlo: str):
    dots = [ln for ln in hlo.splitlines() if "dot_general" in ln]
    return dots, [ln for ln in dots if not re.search(
        r"precision\s*=\s*\[HIGHEST,\s*HIGHEST\]", ln)]


@pytest.mark.parametrize("culled", [False, True], ids=["dense", "culled"])
@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_step_matmuls_are_full_precision(scene_root, culled, platform):
    """Lower the dense (--turbo) and the culled (hierarchical, cluster
    repulsion, warm) training steps — for the CPU and, with the Triton
    kernels, for the GPU — and require HIGHEST on every dot_general: the
    default float32 precision on the card may use TF32, which corrupts
    the expanded-form distances."""
    kw = dict(warm_start=True)
    if culled:
        kw.update(use_culling=True, cull_budget=16, cull_tile=128,
                  cull_hierarchical=True, cull_cluster_group=4,
                  cluster_repulsion=True, dataset_order="morton",
                  sample_mode="tile", init_n=16, init_layout="cloud")
    tr = _trainer(scene_root, **kw)
    if platform == "cuda":
        tr.march_normal_fn = TRITON.march_normal_fn
        tr.culled_march_normal_fn = TRITON.culled_march_normal_fn
        tr._step_fn = tr._build_step()
    hlo = tr._step_fn.trace(*_step_args(tr)).lower(
        lowering_platforms=(platform,)).as_text()
    dots, bad = _dot_precisions(hlo)
    assert dots, "the step has no matrix products to audit"
    assert not bad, "\n".join(bad[:5])
    if platform == "cuda":
        assert "triton" in hlo.lower()
