"""Multi-device sharding tests on the 8-device CPU mesh (conftest forces
XLA_FLAGS=--xla_force_host_platform_device_count=8).

Checks: DP train step == single-device step; M-sharded render == replicated
render; sharded loss == unsharded loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from burn_raymarching.config import TrainConfig
from burn_raymarching.data.camera import create_camera_rays
from burn_raymarching.models.scene import SceneParams, pad_params, scene_forward
from burn_raymarching.parallel.mesh import make_mesh
from burn_raymarching.parallel.train_step import (
    make_sharded_train_step,
    shard_params,
)
from burn_raymarching.train.loss import compute_loss
from burn_raymarching.train.optimizer import make_optimizer


@pytest.fixture(scope="module")
def scene():
    params = SceneParams(
        centers=jnp.asarray(
            np.random.default_rng(0).normal(0, 0.3, (8, 3)), jnp.float32
        ),
        colors=jnp.asarray(
            np.random.default_rng(1).normal(0, 1, (8, 3)), jnp.float32
        ),
        radii=jnp.asarray(
            np.random.default_rng(2).normal(-1, 0.3, (8, 1)), jnp.float32
        ),
        light_dir=jnp.asarray([0.1, 1.0, -0.2], jnp.float32),
        ambient=jnp.asarray([-1.4], jnp.float32),
    )
    ro, rd = create_camera_rays(16, 16, [0.0, 0.5, -2.5], [0.0, 0.0, 0.0], 50.0)
    return params, ro, rd


def test_msharded_render_matches_replicated(scene):
    params, ro, rd = scene
    mesh = make_mesh(data=1, model=4)
    mask = jnp.arange(8) < 7  # one padded slot, not divisible evenly → 2/shard

    want = np.asarray(jax.jit(scene_forward, static_argnames=())(params, ro, rd, jnp.float32(32.0), mask))

    def fwd(p, mask_l, ro_l, rd_l):
        return scene_forward(p, ro_l, rd_l, 32.0, mask=mask_l,
                             model_axis="model")

    from burn_raymarching.parallel.train_step import param_specs

    sharded = jax.shard_map(
        fwd, mesh=mesh,
        in_specs=(param_specs(True), P("model"), P(None, None), P(None, None)),
        out_specs=P(None, None),
        check_vma=False,
    )
    got = np.asarray(sharded(params, mask, ro, rd))
    # psum reassociates the exp-sums → few-ulp differences amplified through
    # the 40-step march on grazing rays.
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)


def test_msharded_loss_matches_replicated(scene):
    params, ro, rd = scene
    mesh = make_mesh(data=1, model=4)
    mask = jnp.arange(8) < 7
    out = jnp.zeros((32, 3))
    tgt = jnp.ones((32, 3)) * 0.2

    want = float(jax.jit(compute_loss)(params, out, tgt, jnp.float32(0.4), mask))

    def loss_fn(p, mask_l):
        return compute_loss(p, out, tgt, jnp.float32(0.4), mask=mask_l,
                            model_axis="model")

    from burn_raymarching.parallel.train_step import param_specs

    sharded = jax.shard_map(
        loss_fn, mesh=mesh,
        in_specs=(param_specs(True), P("model")),
        out_specs=P(),
        check_vma=False,
    )
    got = float(sharded(params, mask))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2)])
def test_sharded_step_matches_single_device(scene, data, model):
    params, ro, rd = scene
    cfg = TrainConfig(batch_size=64)
    tx = make_optimizer(cfg)
    mesh = make_mesh(data=data, model=model)

    padded, mask = pad_params(
        SceneParams(params.centers[:7], params.colors[:7], params.radii[:7],
                    params.light_dir, params.ambient),
        8,
    )
    tgt = jnp.clip(
        jnp.asarray(np.random.default_rng(5).uniform(0, 1, (256, 3)),
                    jnp.float32), 0, 1)
    fg_idx = jnp.zeros((256,), jnp.int32)
    n_fg = jnp.asarray(0, jnp.int32)

    step = make_sharded_train_step(cfg, mesh, tx)
    p_sh = shard_params(padded, mesh, model > 1)
    opt = tx.init(p_sh)
    key = jax.random.PRNGKey(0)
    new_p, new_opt, loss = step(
        p_sh, opt, key, mask, ro, rd, tgt, fg_idx, n_fg,
        jnp.float32(0.1), jnp.float32(10.0), jnp.float32(0.8),
        jnp.float32(0.01),
    )
    assert np.isfinite(float(loss))
    # One more step to make sure opt state threading works.
    new_p, new_opt, loss2 = step(
        new_p, new_opt, jax.random.PRNGKey(1), mask, ro, rd, tgt, fg_idx,
        n_fg, jnp.float32(0.1), jnp.float32(10.0), jnp.float32(0.8),
        jnp.float32(0.01),
    )
    assert np.isfinite(float(loss2))
    for leaf in jax.tree.leaves(new_p):
        assert np.isfinite(np.asarray(leaf)).all()


def test_dp_gradients_match_replicated(scene):
    """pmean'd DP gradients == single-device gradients on the same batch."""
    params, ro, rd = scene
    mesh = make_mesh(data=8, model=1)
    tgt = jnp.clip(jnp.abs(jnp.sin(jnp.arange(256 * 3))).reshape(256, 3), 0, 1)

    def loss_of(p, ro_l, rd_l, tgt_l):
        out = scene_forward(p, ro_l, rd_l, 32.0)
        return compute_loss(p, out, tgt_l, jnp.float32(0.5))

    g_ref = jax.jit(jax.grad(loss_of))(params, ro, rd, tgt)

    def device_fn(p, ro_l, rd_l, tgt_l):
        g = jax.grad(loss_of)(p, ro_l, rd_l, tgt_l)
        return jax.lax.pmean(g, "data")

    from burn_raymarching.parallel.train_step import param_specs

    sharded = jax.shard_map(
        device_fn, mesh=mesh,
        in_specs=(param_specs(False), P("data", None), P("data", None),
                  P("data", None)),
        out_specs=param_specs(False),
        check_vma=False,
    )
    g_dp = sharded(params, ro, rd, tgt)
    for name in ("centers", "colors", "radii", "light_dir", "ambient"):
        np.testing.assert_allclose(
            np.asarray(getattr(g_dp, name)),
            np.asarray(getattr(g_ref, name)),
            rtol=5e-3, atol=1e-6,
        )


def test_msharded_culled_render_matches_dense(scene):
    """Config-5 path: per-shard top-K culling + pmax/psum compositing."""
    from burn_raymarching.parallel.train_step import param_specs
    from burn_raymarching.render.culled import render_diff_culled
    from burn_raymarching.render.diff import render_diff

    params, ro, rd = scene
    mesh = make_mesh(data=1, model=4)
    mask = jnp.arange(8) < 7
    centers = params.centers
    colors = jax.nn.sigmoid(params.colors)
    radii = jax.nn.softplus(params.radii) + 0.01
    light = params.light_dir
    ambient = jax.nn.sigmoid(params.ambient)

    want = np.asarray(jax.jit(render_diff)(
        ro, rd, centers, colors, radii, light, ambient, jnp.float32(32.0),
        mask))

    def fwd(c_l, col_l, r_l, mask_l, ro_l, rd_l):
        # k_budget == shard size: culling keeps every shard primitive, so
        # the only difference vs dense is the sharded reduction order.
        return render_diff_culled(
            ro_l, rd_l, c_l, col_l, r_l, light, ambient, jnp.float32(32.0),
            mask=mask_l, tile=64, k_budget=2, model_axis="model")

    m2 = P("model", None)
    sharded = jax.shard_map(
        fwd, mesh=mesh,
        in_specs=(m2, m2, m2, P("model"), P(None, None), P(None, None)),
        out_specs=P(None, None),
        check_vma=False,
    )
    got = np.asarray(sharded(centers, colors, radii, mask, ro, rd))
    np.testing.assert_allclose(got, want, rtol=8e-3, atol=1e-3)


def test_sharded_culled_step_runs_finite(scene):
    params, ro, rd = scene
    cfg = TrainConfig(batch_size=64, use_culling=True, cull_tile=16,
                      cull_budget=2)
    tx = make_optimizer(cfg)
    mesh = make_mesh(data=2, model=4)

    padded, mask = pad_params(
        SceneParams(params.centers[:7], params.colors[:7], params.radii[:7],
                    params.light_dir, params.ambient),
        8,
    )
    tgt = jnp.clip(
        jnp.asarray(np.random.default_rng(5).uniform(0, 1, (256, 3)),
                    jnp.float32), 0, 1)
    fg_idx = jnp.zeros((256,), jnp.int32)
    n_fg = jnp.asarray(0, jnp.int32)

    step = make_sharded_train_step(cfg, mesh, tx)
    p_sh = shard_params(padded, mesh, True)
    opt = tx.init(p_sh)
    new_p, new_opt, loss = step(
        p_sh, opt, jax.random.PRNGKey(0), mask, ro, rd, tgt, fg_idx, n_fg,
        jnp.float32(0.1), jnp.float32(10.0), jnp.float32(0.8),
        jnp.float32(0.01))
    assert np.isfinite(float(loss))
    for leaf in jax.tree.leaves(new_p):
        assert np.isfinite(np.asarray(leaf)).all()


def test_msharded_cluster_repulsion_matches_local(scene):
    """Sharded (implicit-cluster) repulsion == unsharded on a Morton-ordered
    buffer when every cluster fits a shard."""
    from burn_raymarching.ops.culling import PrimitiveClusters, morton_order
    from burn_raymarching.train.loss import cluster_repulsion

    params, _, _ = scene
    order = morton_order(np.asarray(params.centers))
    centers = params.centers[order]                   # [8, 3] Morton-ordered
    mask = jnp.arange(8) < 7
    g = 2
    cl_full = PrimitiveClusters(
        jnp.arange(8, dtype=jnp.int32).reshape(-1, g),
        jnp.ones((4, g), bool))
    want = float(cluster_repulsion(centers, cl_full, mask, jnp.float32(7.0),
                                   near_clusters=2))

    mesh = make_mesh(data=1, model=4)

    def fn(c_l, mask_l):
        cl = PrimitiveClusters(
            jnp.arange(2, dtype=jnp.int32).reshape(-1, g),
            jnp.ones((1, g), bool))
        return cluster_repulsion(c_l, cl, mask_l, jnp.float32(7.0),
                                 near_clusters=2, model_axis="model")

    got = float(jax.shard_map(
        fn, mesh=mesh, in_specs=(P("model", None), P("model")),
        out_specs=P(), check_vma=False)(centers, mask))
    # Sharded near-sets differ (each shard holds 1 cluster -> remote
    # clusters are monopoles), so allow the approximation gap.
    np.testing.assert_allclose(got, want, rtol=0.1)
    assert np.isfinite(got)

    # Monopole far field under sharding: same structure, coarser far term.
    def fn_mono(c_l, mask_l):
        cl = PrimitiveClusters(
            jnp.arange(2, dtype=jnp.int32).reshape(-1, g),
            jnp.ones((1, g), bool))
        return cluster_repulsion(c_l, cl, mask_l, jnp.float32(7.0),
                                 near_clusters=2, model_axis="model",
                                 far_field="monopole")

    got_mono = float(jax.shard_map(
        fn_mono, mesh=mesh, in_specs=(P("model", None), P("model")),
        out_specs=P(), check_vma=False)(centers, mask))
    np.testing.assert_allclose(got_mono, want, rtol=0.15)
    assert np.isfinite(got_mono)


def test_sharded_culled_cluster_repulsion_step_runs_finite(scene):
    params, ro, rd = scene
    cfg = TrainConfig(batch_size=64, use_culling=True, cull_tile=16,
                      cull_budget=2, cluster_repulsion=True,
                      cull_cluster_group=2)
    tx = make_optimizer(cfg)
    mesh = make_mesh(data=2, model=4)

    padded, mask = pad_params(
        SceneParams(params.centers[:7], params.colors[:7], params.radii[:7],
                    params.light_dir, params.ambient),
        8,
    )
    tgt = jnp.clip(
        jnp.asarray(np.random.default_rng(5).uniform(0, 1, (256, 3)),
                    jnp.float32), 0, 1)
    fg_idx = jnp.zeros((256,), jnp.int32)
    n_fg = jnp.asarray(0, jnp.int32)

    from burn_raymarching.parallel.train_step import make_sharded_train_step

    step = make_sharded_train_step(cfg, mesh, tx)
    p_sh = shard_params(padded, mesh, True)
    opt = tx.init(p_sh)
    new_p, new_opt, loss = step(
        p_sh, opt, jax.random.PRNGKey(0), mask, ro, rd, tgt, fg_idx, n_fg,
        jnp.float32(0.1), jnp.float32(10.0), jnp.float32(0.8),
        jnp.float32(0.01))
    assert np.isfinite(float(loss))
    for leaf in jax.tree.leaves(new_p):
        assert np.isfinite(np.asarray(leaf)).all()


def test_sharded_kernel_march_matches_xla_twin(scene):
    """The all_to_all union-table kernel march (train/step_body.
    sharded_culled_kernel_march) must equal the per-iteration pmax/psum
    XLA twin: same table entries, different reduction structure only."""
    from functools import partial

    from burn_raymarching.ops.culling import (
        select_tile_primitives,
        tile_cones,
    )
    from burn_raymarching.ops.pallas.march_kernel import (
        culled_march_normals_triton,
    )
    from burn_raymarching.render.culled import culled_march_normals_xla
    from burn_raymarching.train.step_body import (
        sharded_culled_kernel_march,
    )

    params, ro, rd = scene
    mesh = make_mesh(data=1, model=4)
    mask = jnp.arange(8) < 7
    centers = params.centers
    radii = jax.nn.softplus(params.radii) + 0.01
    tile = 16
    b = ro.shape[0] // tile            # 16 tiles, 4 per model column
    kern = partial(culled_march_normals_triton, interpret=True,
                   block_rays=8)

    def dev(c_l, r_l, mask_l):
        cones = tile_cones(ro, rd, tile)
        idx, valid = select_tile_primitives(
            cones, c_l, r_l, jnp.float32(32.0), 2, mask=mask_l)
        cs = jnp.take(c_l, idx, axis=0)
        rs = jnp.take(r_l.reshape(-1), idx, axis=0)
        qs = jnp.where(valid, jnp.sum(cs * cs, axis=2), 1e30)
        ro3 = ro.reshape(b, tile, 3)
        rd3 = rd.reshape(b, tile, 3)
        t_x, n_x = culled_march_normals_xla(
            ro3, rd3, cs, rs, qs, jnp.float32(32.0), model_axis="model")
        t_k, n_k = sharded_culled_kernel_march(
            kern, "model", 4, ro3, rd3, cs, rs, qs, jnp.float32(32.0),
            num_steps=40, normal_eps=1e-4)
        return t_x, n_x, t_k, n_k

    m2 = P("model", None)
    r3 = P(None, None, None)
    out = jax.shard_map(
        dev, mesh=mesh,
        in_specs=(m2, m2, P("model")),
        out_specs=(r3, r3, r3, r3),
        check_vma=False,
    )(centers, radii, mask)
    t_x, n_x, t_k, n_k = (np.asarray(x) for x in out)
    np.testing.assert_allclose(t_k, t_x, rtol=2e-5, atol=2e-5)
    # Normals compare on HIT rays only: on misses the 6 taps difference
    # rounding noise and the (coverage-suppressed, detached) direction is
    # arbitrary in both paths (same budget as test_culled_kernel.py).
    hit = (t_x[..., 0] < 5.0)
    assert hit.any()
    # atol 1e-3 on unit-normal components: the union-table single-sum vs
    # two-pass pmax/psum soft-min round the 6 taps differently; the
    # resulting direction wiggle is ~1e-3 (detached, shading-only input).
    np.testing.assert_allclose(n_k[hit], n_x[hit], atol=1e-3)


def test_sharded_kernel_march_warm_start(scene):
    """Warm-start t_init threads through the union-table wrapper (each
    column slices its tile range)."""
    from functools import partial

    from burn_raymarching.ops.culling import (
        select_tile_primitives,
        tile_cones,
    )
    from burn_raymarching.ops.pallas.march_kernel import (
        culled_march_normals_triton,
    )
    from burn_raymarching.render.culled import culled_march_normals_xla
    from burn_raymarching.train.step_body import (
        sharded_culled_kernel_march,
    )

    params, ro, rd = scene
    mesh = make_mesh(data=1, model=4)
    mask = jnp.arange(8) < 7
    centers = params.centers
    radii = jax.nn.softplus(params.radii) + 0.01
    tile = 16
    b = ro.shape[0] // tile
    kern = partial(culled_march_normals_triton, interpret=True,
                   block_rays=8)
    t_init = jnp.full((b, tile, 1), 0.5, jnp.float32)

    def dev(c_l, r_l, mask_l):
        cones = tile_cones(ro, rd, tile)
        idx, valid = select_tile_primitives(
            cones, c_l, r_l, jnp.float32(32.0), 2, mask=mask_l)
        cs = jnp.take(c_l, idx, axis=0)
        rs = jnp.take(r_l.reshape(-1), idx, axis=0)
        qs = jnp.where(valid, jnp.sum(cs * cs, axis=2), 1e30)
        ro3 = ro.reshape(b, tile, 3)
        rd3 = rd.reshape(b, tile, 3)
        t_x, _ = culled_march_normals_xla(
            ro3, rd3, cs, rs, qs, jnp.float32(32.0), num_steps=16,
            t_init=t_init, model_axis="model")
        t_k, _ = sharded_culled_kernel_march(
            kern, "model", 4, ro3, rd3, cs, rs, qs, jnp.float32(32.0),
            num_steps=16, normal_eps=1e-4, t_init=t_init)
        return t_x, t_k

    out = jax.shard_map(
        dev, mesh=mesh,
        in_specs=(P("model", None), P("model", None), P("model")),
        out_specs=(P(None, None, None), P(None, None, None)),
        check_vma=False,
    )(centers, radii, mask)
    t_x, t_k = (np.asarray(x) for x in out)
    np.testing.assert_allclose(t_k, t_x, rtol=2e-5, atol=2e-5)
