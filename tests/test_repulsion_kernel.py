"""Two-level cluster repulsion (train/loss.cluster_repulsion): against the
exact pairwise term of the reference (training.rs:73-83), its gradient, the
chunk-frozen static prep, and the compute_loss wiring."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from burn_raymarching.ops.culling import build_clusters
from burn_raymarching.train.loss import cluster_repulsion


def make_cloud(m, seed=0, group=8):
    rng = np.random.default_rng(seed)
    centers = jnp.asarray(rng.uniform(-0.8, 0.8, (m, 3)), jnp.float32)
    mask = jnp.asarray(rng.random(m) > 0.1)
    cl = build_clusters(np.asarray(centers), mask=np.asarray(mask),
                        group=group)
    n_valid = jnp.sum(mask.astype(jnp.float32))
    return centers, mask, cl, n_valid


def exact_repulsion(centers, mask):
    """The reference's O(M^2) masked pairwise mean, in float64."""
    c = np.asarray(centers, np.float64)
    w = np.asarray(mask, np.float64)
    d = np.sqrt(np.maximum(((c[:, None] - c[None]) ** 2).sum(-1), 1e-6))
    inv = 1.0 / (d + 100.0 * np.eye(len(c)) + 1e-6)
    return float((inv * w[:, None] * w[None]).sum() / w.sum() ** 2)


@pytest.mark.parametrize("m,group", [(64, 8), (200, 8), (96, 4)])
def test_value_matches_xla(m, group):
    """Member far field vs the exact pairwise sum: exact when every
    cluster is a near cluster (C <= 8), within 2% otherwise."""
    centers, mask, cl, n_valid = make_cloud(m, seed=m, group=group)
    got = float(cluster_repulsion(centers, cl, mask, n_valid))
    exact = exact_repulsion(centers, mask)
    rtol = 1e-5 if m // group <= 8 else 2e-2
    np.testing.assert_allclose(got, exact, rtol=rtol)


def test_gradient_matches_xla():
    """With every cluster near (C = 8), the gradient equals the exact
    pairwise term's gradient."""
    centers, mask, cl, n_valid = make_cloud(64, seed=3)
    w = mask.astype(jnp.float32)

    def exact(c):
        d = jnp.sqrt(jnp.maximum(
            jnp.sum((c[:, None] - c[None]) ** 2, axis=-1), 1e-6))
        inv = 1.0 / (d + 100.0 * jnp.eye(c.shape[0]) + 1e-6)
        return jnp.sum(inv * w[:, None] * w[None]) / n_valid ** 2

    g_ref = jax.grad(exact)(centers)
    g = jax.grad(lambda c: cluster_repulsion(c, cl, mask, n_valid))(centers)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-4, atol=1e-5 * float(
                                   jnp.max(jnp.abs(g_ref))))


def test_gradient_finite_differences():
    """Directional finite-difference check of the repulsion gradient."""
    centers, mask, cl, n_valid = make_cloud(64, seed=5)
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=centers.shape), jnp.float32)
    v = v / jnp.sqrt(jnp.sum(v * v))

    def f(c):
        return cluster_repulsion(c, cl, mask, n_valid)

    g = jax.grad(f)(centers)
    slope = float(jnp.sum(g * v))
    # eps 1e-2: at smaller steps the f32 rounding noise of the summed 1/d
    # terms dominates the difference (3.9% at 1e-3, 0.15% at 1e-2).
    eps = 1e-2
    fd = (float(f(centers + eps * v)) - float(f(centers - eps * v))) / (
        2 * eps)
    np.testing.assert_allclose(slope, fd, rtol=1e-2, atol=1e-4)


def test_no_mask_and_ragged_c():
    """No mask equals an all-true mask; 9 clusters of 8 (C not a power of
    two)."""
    rng = np.random.default_rng(11)
    m = 72
    centers = jnp.asarray(rng.uniform(-0.5, 0.5, (m, 3)), jnp.float32)
    cl = build_clusters(np.asarray(centers), group=8)
    n_valid = jnp.asarray(float(m))
    ref = float(cluster_repulsion(centers, cl, jnp.ones((m,), bool),
                                  n_valid))
    got = float(cluster_repulsion(centers, cl, None, n_valid))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("m,group", [(64, 8), (200, 8)])
def test_monopole_value_matches_xla(m, group):
    """far_field="monopole" vs the exact pairwise sum: exact with every
    cluster near, within 3% otherwise; finite gradients."""
    centers, mask, cl, n_valid = make_cloud(m, seed=m + 1, group=group)
    got, g = jax.value_and_grad(
        lambda c: cluster_repulsion(c, cl, mask, n_valid,
                                    far_field="monopole"))(centers)
    rtol = 1e-5 if m // group <= 8 else 3e-2
    np.testing.assert_allclose(float(got), exact_repulsion(centers, mask),
                               rtol=rtol)
    assert np.isfinite(np.asarray(g)).all()


def test_monopole_approximates_member():
    """The monopole far field is a coarser approximation of the same sum:
    values within ~2% and gradients strongly aligned with member mode."""
    centers, mask, cl, n_valid = make_cloud(256, seed=42, group=8)
    v_mem, g_mem = jax.value_and_grad(
        lambda c: cluster_repulsion(c, cl, mask, n_valid))(centers)
    v_mono, g_mono = jax.value_and_grad(
        lambda c: cluster_repulsion(c, cl, mask, n_valid,
                                    far_field="monopole"))(centers)
    np.testing.assert_allclose(float(v_mono), float(v_mem), rtol=2e-2)
    a = np.asarray(g_mem).ravel()
    b = np.asarray(g_mono).ravel()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos > 0.95, cos


def test_compute_loss_routes_fused():
    """compute_loss(repulsion_clusters=...) adds the cluster term in place
    of the exact pairwise one."""
    from burn_raymarching.config import LossConfig
    from burn_raymarching.models.scene import init_scene_params, pad_params
    from burn_raymarching.train.loss import compute_loss

    centers, mask, cl, n_valid = make_cloud(200, seed=9)
    params = init_scene_params(200)
    params.centers = centers
    padded, pmask = pad_params(params, 200)
    pmask = pmask & mask
    out = jnp.abs(jnp.sin(jnp.arange(256 * 3, dtype=jnp.float32))
                  ).reshape(256, 3)
    tgt = jnp.roll(out, 1, axis=0)
    no_rep = LossConfig(repulsion_coeff=0.0)

    def loss(p, clusters, cfg=LossConfig()):
        return compute_loss(p, out, tgt, jnp.float32(0.5), mask=pmask,
                            cfg=cfg, repulsion_clusters=clusters)

    base = float(loss(padded, None, no_rep))
    got = float(loss(padded, cl))
    rep = float(cluster_repulsion(centers, cl, pmask, n_valid))
    np.testing.assert_allclose(got, base + LossConfig().repulsion_coeff * rep,
                               rtol=1e-6)
    g = jax.grad(lambda p: loss(p, cl))(padded)
    assert np.isfinite(np.asarray(g.centers)).all()


# --------------------------------------------------------------------- #
# Chunk-frozen static prep (train/loss.RepulsionStatic, round 5)
# --------------------------------------------------------------------- #

def test_static_prep_matches_live_prep_exactly():
    """With tables built from the SAME centers, the static path must
    reproduce the on-the-fly path bit-for-bit (value and gradient), both
    far-field modes."""
    from burn_raymarching.train.loss import build_repulsion_static

    centers, mask, cl, n_valid = make_cloud(200, seed=7)
    static = build_repulsion_static(centers, cl, mask)
    for ff in ("member", "monopole"):
        v0, g0 = jax.value_and_grad(
            lambda c: cluster_repulsion(c, cl, mask, n_valid,
                                        far_field=ff))(centers)
        v1, g1 = jax.value_and_grad(
            lambda c: cluster_repulsion(c, cl, mask, n_valid,
                                        far_field=ff,
                                        static=static))(centers)
        np.testing.assert_allclose(float(v1), float(v0), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(g1), np.asarray(g0),
                                   rtol=1e-5, atol=1e-7 * float(
                                       jnp.max(jnp.abs(g0))))


def test_static_prep_carries_no_center_gradient():
    """The frozen tables are non-differentiable by construction: moving
    the centers the tables were built from must not change the gradient
    path (tables are constants under AD)."""
    from burn_raymarching.train.loss import build_repulsion_static

    centers, mask, cl, n_valid = make_cloud(96, seed=13)
    static = build_repulsion_static(centers, cl, mask)
    moved = centers + 0.01  # stale tables, live geometry

    def f(c):
        return cluster_repulsion(c, cl, mask, n_valid, static=static)

    v, g = jax.value_and_grad(f)(moved)
    assert np.isfinite(float(v)) and np.isfinite(np.asarray(g)).all()
    # Stale near-set is an approximation-order change only: the value
    # stays within a few percent of the fresh-prep evaluation.
    v_fresh = float(cluster_repulsion(moved, cl, mask, n_valid))
    np.testing.assert_allclose(float(v), v_fresh, rtol=5e-2)


def test_trainer_chunk_uses_static_tables(scene_root):
    """End-to-end: a culled cluster_repulsion training chunk runs (and
    descends) with the per-chunk static tables wired through run_chunk."""
    import dataclasses
    import os

    from burn_raymarching.config import TrainConfig
    from burn_raymarching.train.loop import Trainer, build_dataset

    cfg = TrainConfig(
        batch_size=1024, stages=1, steps_per_stage=10, steps_per_call=10,
        use_pallas=False, checkpoint_dir=None,
        use_culling=True, cull_budget=16, cull_tile=256,
        dataset_order="morton", cluster_repulsion=True,
        cull_cluster_group=4, init_n=12,
        cameras_json=os.path.join(scene_root, "data/cameras.json"),
    )
    cwd = os.getcwd()
    os.chdir(scene_root)
    try:
        ds = build_dataset(cfg)
    finally:
        os.chdir(cwd)
    tr = Trainer(dataclasses.replace(cfg), ds, log=lambda s: None)
    tr._io = False
    padded, mask = tr.run()
    for leaf in jax.tree.leaves(padded):
        assert np.isfinite(np.asarray(leaf)).all()
