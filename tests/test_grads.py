"""Gradient topology tests — the heart of the reference's design.

The reference's truncated-graph sphere tracing (src/renderer_diff.rs:20-46)
dictates exactly which paths carry gradients:
  * NO gradient through the 40-step march;
  * gradient to centers/radii through ONE reattached SDF eval (t_final);
  * NO gradient through the normals (detached point + detached params);
  * gradients to light_dir/ambient through shading;
  * gradients to colors through the softmax compositor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from burn_raymarching.data.camera import create_camera_rays
from burn_raymarching.models.scene import SceneParams, scene_forward
from burn_raymarching.ops.march import march_xla
from burn_raymarching.ops.sdf import scene_sdf


@pytest.fixture(scope="module")
def scene():
    params = SceneParams(
        centers=jnp.asarray([[-0.3, 0.0, 0.0], [0.3, 0.0, 0.0]], jnp.float32),
        colors=jnp.asarray([[2.0, -2.0, -2.0], [-2.0, -2.0, 2.0]], jnp.float32),
        radii=jnp.asarray([[-0.5], [-0.5]], jnp.float32),
        light_dir=jnp.asarray([0.0, 1.0, 0.0], jnp.float32),
        ambient=jnp.asarray([-1.4], jnp.float32),
    )
    ro, rd = create_camera_rays(16, 16, [0.0, 0.0, -2.5], [0.0, 0.0, 0.0], 50.0)
    return params, ro, rd


def test_march_carries_no_gradient(scene):
    params, ro, rd = scene

    def t_sum(centers):
        return march_xla(ro, rd, centers, jax.nn.softplus(params.radii) + 0.01,
                         32.0).sum()

    g = jax.grad(t_sum)(params.centers)
    np.testing.assert_array_equal(np.asarray(g), 0.0)


def test_all_params_receive_gradients(scene):
    params, ro, rd = scene

    def loss(p):
        return scene_forward(p, ro, rd, 32.0).sum()

    g = jax.grad(loss)(params)
    for name in ("centers", "colors", "radii", "light_dir", "ambient"):
        arr = np.asarray(getattr(g, name))
        assert np.isfinite(arr).all(), name
        assert np.abs(arr).max() > 0, f"no gradient reached {name}"


def test_truncated_graph_gradient_semantics(scene):
    """Autodiff of the full render == FD of the render with the march FROZEN.

    The reference's gradient is deliberately the truncated-graph one: the
    march contributes nothing (renderer_diff.rs:25) and t_final differentiates
    only through the single reattached SDF eval. So the correct oracle is a
    finite difference of the forward where t from the march is held constant —
    NOT an FD of the re-converging forward (which is ≈0 for covered pixels by
    implicit-function cancellation).
    """
    params, ro, rd = scene
    idx = jnp.asarray([16 * 8 + 4, 16 * 8 + 12, 16 * 4 + 8])
    ro_s, rd_s = ro[idx], rd[idx]

    t_fixed = march_xla(
        ro_s, rd_s,
        jax.lax.stop_gradient(params.centers),
        jax.nn.softplus(params.radii) + 0.01,
        32.0,
    )

    def frozen_march(*args, **kwargs):
        return t_fixed

    @jax.jit
    def out_full(raw_radii):
        p = SceneParams(params.centers, params.colors, raw_radii,
                        params.light_dir, params.ambient)
        return scene_forward(p, ro_s, rd_s, 32.0).sum()

    @jax.jit
    def out_frozen(raw_radii):
        p = SceneParams(params.centers, params.colors, raw_radii,
                        params.light_dir, params.ambient)
        return scene_forward(p, ro_s, rd_s, 32.0, march_fn=frozen_march).sum()

    g_full = np.asarray(jax.jit(jax.grad(out_full))(params.radii))
    g_frozen = np.asarray(jax.jit(jax.grad(out_frozen))(params.radii))
    # 1. The march carries no gradient: full == frozen-march autodiff.
    np.testing.assert_allclose(g_full, g_frozen, rtol=1e-5, atol=1e-7)

    # 2. The frozen-march autodiff matches its finite difference.
    eps = 1e-3
    for i in range(2):
        fd = (float(out_frozen(params.radii.at[i, 0].add(eps)))
              - float(out_frozen(params.radii.at[i, 0].add(-eps)))) / (2 * eps)
        np.testing.assert_allclose(g_frozen[i, 0], fd, rtol=0.05, atol=1e-4)


def test_soft_min_grad_check():
    d = jnp.asarray(np.random.default_rng(3).normal(size=(8, 5)),
                    jnp.float32)
    from jax.test_util import check_grads

    from burn_raymarching.ops.sdf import soft_min

    check_grads(lambda x: soft_min(x, 10.0).sum(), (d,), order=1,
                modes=("rev",), atol=1e-2, rtol=1e-2)


def test_scene_sdf_grad_is_finite_on_surface(scene):
    params, ro, rd = scene
    # Points exactly on the sphere surface (worst case for sqrt clamps).
    p = jnp.asarray([[-0.1, 0.0, 0.0], [0.3, 0.0, 0.2]], jnp.float32)

    def f(centers):
        return scene_sdf(p, centers, jax.nn.softplus(params.radii) + 0.01,
                         32.0).sum()

    g = np.asarray(jax.grad(f)(params.centers))
    assert np.isfinite(g).all()


def test_masked_grads_match_unpadded(scene):
    params, ro, rd = scene
    pad = 6
    padded = SceneParams(
        centers=jnp.pad(params.centers, ((0, pad), (0, 0))),
        colors=jnp.pad(params.colors, ((0, pad), (0, 0))),
        radii=jnp.pad(params.radii, ((0, pad), (0, 0))),
        light_dir=params.light_dir,
        ambient=params.ambient,
    )
    mask = jnp.arange(2 + pad) < 2

    g_ref = jax.grad(lambda p: scene_forward(p, ro, rd, 32.0).sum())(params)
    g_pad = jax.grad(
        lambda p: scene_forward(p, ro, rd, 32.0, mask=mask).sum()
    )(padded)
    np.testing.assert_allclose(np.asarray(g_pad.centers)[:2],
                               np.asarray(g_ref.centers), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g_pad.colors)[:2],
                               np.asarray(g_ref.colors), rtol=1e-4, atol=1e-6)
    # Padded slots receive exactly zero gradient.
    np.testing.assert_array_equal(np.asarray(g_pad.centers)[2:], 0.0)
    np.testing.assert_array_equal(np.asarray(g_pad.colors)[2:], 0.0)
    np.testing.assert_array_equal(np.asarray(g_pad.radii)[2:], 0.0)
