"""Unit tests for SDF primitives against dense NumPy oracles.

Oracle semantics from reference src/model/sdf.rs and src/model/scene.rs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from burn_raymarching.ops import (
    direct_sphere_dists,
    pairwise_sphere_dists,
    scene_normal,
    scene_sdf,
    smooth_min,
    soft_min,
    sphere_sdf,
)


def _np_soft_min(d, k):
    val = -k * d
    mx = val.max(axis=1, keepdims=True)
    s = np.exp(val - mx).sum(axis=1, keepdims=True)
    return (np.log(np.maximum(s, 1e-8)) + mx) / (-k)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def test_sphere_sdf_matches_oracle(rng):
    p = rng.normal(size=(64, 3)).astype(np.float32)
    c = np.array([0.3, -0.2, 0.5], np.float32)
    r = np.float32(0.4)
    got = np.asarray(sphere_sdf(jnp.asarray(p), jnp.asarray(c), r))
    want = np.sqrt(((p - c) ** 2).sum(1, keepdims=True) + 1e-6) - r
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_smooth_min_polynomial(rng):
    a = rng.normal(size=(32, 1)).astype(np.float32)
    b = rng.normal(size=(32, 1)).astype(np.float32)
    k = 0.3
    got = np.asarray(smooth_min(jnp.asarray(a), jnp.asarray(b), k))
    h = np.maximum(k - np.abs(a - b), 0.0) / k
    want = np.minimum(a, b) - h * h * k * 0.25
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_soft_min_matches_logsumexp_oracle(rng):
    d = rng.normal(size=(128, 17)).astype(np.float32)
    for k in (5.0, 32.0):
        got = np.asarray(soft_min(jnp.asarray(d), k))
        np.testing.assert_allclose(got, _np_soft_min(d, k), rtol=1e-5, atol=1e-6)


def test_soft_min_approaches_hard_min():
    d = np.array([[0.5, 0.1, 2.0]], np.float32)
    out = float(soft_min(jnp.asarray(d), 1000.0)[0, 0])
    assert abs(out - 0.1) < 1e-3


def test_soft_min_masked_equals_unpadded(rng):
    d = rng.normal(size=(64, 7)).astype(np.float32)
    d_pad = np.concatenate([d, rng.normal(size=(64, 9)).astype(np.float32)], 1)
    mask = np.arange(16) < 7
    got = np.asarray(soft_min(jnp.asarray(d_pad), 32.0, mask=jnp.asarray(mask)))
    want = np.asarray(soft_min(jnp.asarray(d), 32.0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pairwise_dists_expanded_form(rng):
    p = rng.normal(size=(50, 3)).astype(np.float32)
    c = rng.normal(size=(9, 3)).astype(np.float32)
    r = rng.uniform(0.05, 0.5, size=(9, 1)).astype(np.float32)
    got = np.asarray(pairwise_sphere_dists(jnp.asarray(p), jnp.asarray(c), jnp.asarray(r)))
    # Oracle uses the same expanded form as the reference (scene.rs:66-78) —
    # the expansion's cancellation behavior is part of the semantics.
    p_sq = (p.astype(np.float64) ** 2).sum(1, keepdims=True)
    c_sq = (c.astype(np.float64) ** 2).sum(1)[None, :]
    d2 = p_sq + c_sq - 2.0 * (p.astype(np.float64) @ c.astype(np.float64).T)
    want = np.sqrt(np.maximum(d2, 1e-6)) - r.T
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
    # And against the direct form, with expansion-cancellation tolerance.
    d2_direct = ((p[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    want_direct = np.sqrt(np.maximum(d2_direct, 1e-6)) - r.T
    np.testing.assert_allclose(got, want_direct, rtol=1e-3, atol=1e-3)


def test_direct_dists_match_float64(rng):
    """The direct form (detached march and normals) is the same function
    as the expanded form, without its cancellation: float32 close to a
    float64 evaluation even for points near a small sphere."""
    c = rng.normal(size=(9, 3)).astype(np.float32)
    r = rng.uniform(0.01, 0.05, size=(9, 1)).astype(np.float32)
    p = (c[rng.integers(0, 9, 64)]
         + rng.normal(0, 0.03, (64, 3))).astype(np.float32)
    got = np.asarray(direct_sphere_dists(jnp.asarray(p), jnp.asarray(c),
                                         jnp.asarray(r)))
    p64, c64 = p.astype(np.float64), c.astype(np.float64)
    d2 = ((p64[:, None, :] - c64[None, :, :]) ** 2).sum(-1)
    want = np.sqrt(np.maximum(d2, 1e-6)) - r.T
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    expanded = np.asarray(pairwise_sphere_dists(
        jnp.asarray(p), jnp.asarray(c), jnp.asarray(r)))
    np.testing.assert_allclose(got, expanded, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("direct,tol", [(False, 1e-3), (True, 2.5e-4)])
def test_scene_normal_direct_flag_single_sphere(rng, direct, tol):
    """Both distance forms give the radial normal of one sphere; the
    direct form's float32 tap differences are the less noisy (the unit
    normal here is the output renormalized, ~5x its raw error)."""
    c = np.array([[0.2, -0.1, 0.3]], np.float32)
    r = np.array([[0.3]], np.float32)
    u = rng.normal(size=(32, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    p = (c + 0.3 * u).astype(np.float32)
    got = np.asarray(scene_normal(jnp.asarray(p), jnp.asarray(c),
                                  jnp.asarray(r), 32.0, direct=direct))
    got = got / np.linalg.norm(got, axis=1, keepdims=True)
    np.testing.assert_allclose(got, u, atol=tol)


def test_scene_sdf_masked_equals_unpadded(rng):
    p = rng.normal(size=(40, 3)).astype(np.float32)
    c = rng.normal(size=(5, 3)).astype(np.float32)
    r = rng.uniform(0.1, 0.4, size=(5, 1)).astype(np.float32)
    c_pad = np.concatenate([c, np.zeros((3, 3), np.float32)])
    r_pad = np.concatenate([r, np.zeros((3, 1), np.float32)])
    mask = np.arange(8) < 5
    got = np.asarray(scene_sdf(jnp.asarray(p), jnp.asarray(c_pad),
                               jnp.asarray(r_pad), 32.0, mask=jnp.asarray(mask)))
    want = np.asarray(scene_sdf(jnp.asarray(p), jnp.asarray(c), jnp.asarray(r), 32.0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_scene_normal_single_sphere_is_radial(rng):
    # Normals on a single sphere point away from its center.
    c = jnp.asarray([[0.2, -0.1, 0.3]], dtype=jnp.float32)
    r = jnp.asarray([[0.5]], dtype=jnp.float32)
    theta = rng.uniform(0, 2 * np.pi, size=16)
    phi = rng.uniform(0.2, np.pi - 0.2, size=16)
    dirs = np.stack([np.sin(phi) * np.cos(theta),
                     np.cos(phi),
                     np.sin(phi) * np.sin(theta)], 1).astype(np.float32)
    p = np.asarray(c)[0] + 0.5 * dirs
    n = np.asarray(scene_normal(jnp.asarray(p), c, r, 32.0))
    # Direction is radial...
    unit = n / np.linalg.norm(n, axis=1, keepdims=True)
    cos = (unit * dirs).sum(1)
    assert (cos > 0.999).all()


def test_scene_normal_length_semantics(rng):
    # Reference quirk (scene.rs:124-127): the normalization adds 1e-6 INSIDE
    # the sqrt, and the unnormalized central difference has magnitude
    # ~2*eps*|grad| ≈ 2e-4, so (2e-4)^2 << 1e-6 and the "normals" come out
    # with norm ≈ |delta| / sqrt(|delta|^2 + 1e-6) ≈ 0.2 — far from unit.
    # The learnable lighting absorbs the scale. Verified against the
    # committed golden PNGs: this is the semantics that reproduces them.
    p = rng.normal(size=(32, 3)).astype(np.float32) * 2
    c = rng.normal(size=(4, 3)).astype(np.float32) * 0.3
    r = rng.uniform(0.1, 0.4, size=(4, 1)).astype(np.float32)
    n = np.asarray(scene_normal(jnp.asarray(p), jnp.asarray(c), jnp.asarray(r), 32.0))
    lens = np.linalg.norm(n, axis=1)
    assert (lens < 0.5).all() and (lens > 0.05).all()


def test_soft_min_max_is_detached():
    # The row max inside soft_min is stop_gradient'ed (reference sdf.rs:37):
    # gradients should still be the softmax weights of -k*d, finite everywhere.
    d = jnp.asarray([[0.3, 0.1, 0.7]], dtype=jnp.float32)
    g = jax.grad(lambda x: soft_min(x, 32.0).sum())(d)
    w = np.asarray(jax.nn.softmax(-32.0 * d, axis=1))
    np.testing.assert_allclose(np.asarray(g), w, rtol=1e-5, atol=1e-6)
    assert np.isfinite(np.asarray(g)).all()
