"""ops/static_gather: scatter-free custom VJPs for chunk-frozen gathers.

The wrapped forward must be the identical block-structured gather; the
one-hot-matmul backward must reproduce jnp.take's scatter-add transpose
(duplicated neighbor ids included) to f32 reassociation tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from burn_raymarching.ops.static_gather import neighbor_hot_t, take_blocks


@pytest.mark.parametrize("c,g,w,seed", [(7, 4, 3, 0), (1, 2, 1, 1),
                                        (16, 8, 8, 2)])
def test_take_blocks_matches_autodiff_take(c, g, w, seed):
    rng = np.random.default_rng(seed)
    cs = jnp.asarray(rng.normal(size=(c, g, 3)).astype(np.float32))
    # Duplicates on purpose: every cluster neighbors several others.
    nb = jnp.asarray(rng.integers(0, c, size=(c, w)).astype(np.int32))
    hot_t = neighbor_hot_t(nb, c)
    # A non-linear, position-dependent downstream so the cotangent is
    # dense and asymmetric.
    coeff = jnp.asarray(
        rng.normal(size=(c, w * g, 3)).astype(np.float32))

    def f_ref(x):
        return jnp.sum(jnp.sin(
            jnp.take(x, nb, axis=0).reshape(c, w * g, 3)) * coeff)

    def f_new(x):
        return jnp.sum(jnp.sin(take_blocks(x, nb, hot_t)) * coeff)

    v0, g0 = jax.value_and_grad(f_ref)(cs)
    v1, g1 = jax.value_and_grad(f_new)(cs)
    np.testing.assert_allclose(float(v1), float(v0), rtol=1e-6)
    scale = float(jnp.max(jnp.abs(g0))) + 1e-12
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g0),
                               rtol=1e-5, atol=1e-6 * scale)


def test_hot_t_is_exact_transpose():
    """hot_t @ g literally equals the scatter-add transpose of take."""
    rng = np.random.default_rng(3)
    c, g, w = 5, 2, 4
    nb = jnp.asarray(rng.integers(0, c, size=(c, w)).astype(np.int32))
    hot_t = neighbor_hot_t(nb, c)
    gbar = rng.normal(size=(c, w, g, 3)).astype(np.float32)
    want = np.zeros((c, g, 3), np.float32)
    for ci in range(c):
        for wi in range(w):
            want[int(nb[ci, wi])] += gbar[ci, wi]
    got = np.asarray(hot_t @ jnp.asarray(gbar).reshape(c * w, g * 3)
                     ).reshape(c, g, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
