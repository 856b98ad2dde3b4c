"""Pixel-footprint-adaptive coverage (RenderConfig.mask_pixel_mult).

extension, default off — these tests pin (a) exact equality
with the reference's fixed sigmoid when disabled, (b) the adaptive
formula itself, (c) the anti-aliasing behavior (distant silhouettes keep
partial-coverage edge pixels instead of collapsing to near-binary), and
(d) dense/culled path agreement with the flag on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from burn_raymarching.data.camera import create_camera_rays
from burn_raymarching.render.diff import adaptive_coverage, render_diff


@pytest.fixture(scope="module")
def scene():
    centers = jnp.asarray([[0.0, 0.0, 0.0], [0.25, 0.1, 0.2]], jnp.float32)
    colors = jnp.asarray([[0.9, 0.2, 0.2], [0.2, 0.8, 0.3]], jnp.float32)
    radii = jnp.asarray([[0.2], [0.12]], jnp.float32)
    light = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)
    ambient = jnp.asarray([0.2], jnp.float32)
    return centers, colors, radii, light, ambient


def test_disabled_matches_reference_sigmoid_exactly(scene):
    c, col, r, ld, amb = scene
    ro, rd = create_camera_rays(16, 16, [0.0, 0.0, -2.5], [0, 0, 0], 50.0)
    base = render_diff(ro, rd, c, col, r, ld, amb, 32.0,
                       mask_sharpness=60.0)
    off = render_diff(ro, rd, c, col, r, ld, amb, 32.0,
                      mask_sharpness=60.0, mask_pixel_mult=0.0,
                      pixel_angle=0.123)
    np.testing.assert_array_equal(np.asarray(base), np.asarray(off))


def test_adaptive_formula():
    d = jnp.asarray([[0.01], [0.1]], jnp.float32)
    t = jnp.asarray([[1.0], [10.0]], jnp.float32)
    sharp, mult, px = 60.0, 1.0, 0.004
    got = adaptive_coverage(d, t, sharp, mult, px)
    w = np.maximum(1.0 / sharp, mult * px * np.asarray(t))
    want = 1.0 / (1.0 + np.exp(np.asarray(d) / w))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)
    # Footprint is detached: no gradient flows through t.
    g = jax.grad(lambda tt: adaptive_coverage(d, tt, sharp, mult, px).sum())(t)
    np.testing.assert_array_equal(np.asarray(g), 0.0)


def test_subpixel_primitive_gets_usable_center_gradient():
    """The pathology-3 mechanism (docs/SCALING.md): a primitive smaller
    than a pixel sits outside the fixed mask's ~1/sharpness world-space
    transition band for (almost) every ray, so its center gradient
    vanishes. The pixel-matched band keeps a ~mask_pixel_mult-pixel-wide
    basin at any depth — the center gradient must come out much larger."""
    c = jnp.asarray([[0.05, 0.03, 0.0]], jnp.float32)   # off-axis
    col = jnp.asarray([[0.9, 0.9, 0.9]], jnp.float32)
    r = jnp.asarray([[0.05]], jnp.float32)              # ~0.3 px at t=10
    ld = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)
    amb = jnp.asarray([0.2], jnp.float32)
    ro, rd = create_camera_rays(32, 32, [0.0, 0.0, -10.0], [0, 0, 0], 50.0)
    px_angle = 2.0 * np.tan(np.radians(25.0)) / 32.0

    def center_grad(mult):
        def f(cc):
            out = render_diff(ro, rd, cc, col, r, ld, amb, 128.0,
                              mask_sharpness=60.0, softmax_sharpness=40.0,
                              mask_pixel_mult=mult, pixel_angle=px_angle)
            return jnp.sum(out)

        return float(np.abs(np.asarray(jax.grad(f)(c))).sum())

    g_fixed, g_adaptive = center_grad(0.0), center_grad(2.0)
    assert np.isfinite(g_adaptive) and np.isfinite(g_fixed)
    assert g_adaptive > 3.0 * max(g_fixed, 1e-12)


def test_culled_matches_dense_with_adaptive_mask(scene):
    c, col, r, ld, amb = scene
    from burn_raymarching.render.culled import render_diff_culled

    ro, rd = create_camera_rays(16, 16, [0.0, 0.0, -2.5], [0, 0, 0], 50.0)
    px_angle = 2.0 * np.tan(np.radians(25.0)) / 16.0
    dense = render_diff(ro, rd, c, col, r, ld, amb, 32.0,
                        mask_sharpness=60.0, mask_pixel_mult=1.0,
                        pixel_angle=px_angle)
    culled = render_diff_culled(ro, rd, c, col, r, ld, amb, 32.0,
                                tile=64, k_budget=2,
                                mask_sharpness=60.0, mask_pixel_mult=1.0,
                                pixel_angle=px_angle)
    np.testing.assert_allclose(np.asarray(dense), np.asarray(culled),
                               atol=1e-5)


def test_gradients_finite_and_padded_slots_zero(scene):
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
    px_angle = 2.0 * np.tan(np.radians(25.0)) / 8.0

    def loss(p):
        out = scene_forward(p, ro, rd, 32.0, mask=mask,
                            mask_sharpness=60.0, mask_pixel_mult=1.0,
                            pixel_angle=px_angle)
        return jnp.sum(out ** 2)

    g = jax.grad(loss)(padded)
    for leaf in jax.tree.leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()
    assert np.abs(np.asarray(g.centers)[2:]).sum() == 0.0
    assert np.abs(np.asarray(g.centers)[:2]).sum() > 0.0
