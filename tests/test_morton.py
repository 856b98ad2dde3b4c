"""Morton ordering utilities and their effect on tile cones."""

import numpy as np

from burn_raymarching.data.camera import create_camera_rays
from burn_raymarching.ops.culling import tile_cones
from burn_raymarching.utils.morton import (
    morton2,
    morton_permutation,
    multi_view_morton_permutation,
)


def test_morton_codes_basic():
    x = np.array([0, 1, 0, 1, 2])
    y = np.array([0, 0, 1, 1, 0])
    np.testing.assert_array_equal(morton2(x, y), [0, 1, 2, 3, 4])


def test_permutation_is_bijection():
    perm = morton_permutation(16, 8)
    assert sorted(perm.tolist()) == list(range(128))
    inv = np.argsort(perm)
    np.testing.assert_array_equal(perm[inv], np.arange(128))


def test_first_tile_is_square_block():
    perm = morton_permutation(32, 32)
    # First 64 morton entries cover exactly the 8x8 top-left block.
    ys, xs = np.divmod(perm[:64], 32)
    assert xs.max() < 8 and ys.max() < 8


def test_multi_view_offsets():
    perm = multi_view_morton_permutation(4, 4, 3)
    assert perm.shape == (48,)
    assert sorted(perm.tolist()) == list(range(48))
    assert (perm[:16] < 16).all() and (perm[16:32] >= 16).all()


def test_morton_tiles_have_narrow_cones():
    import jax.numpy as jnp

    ro, rd = create_camera_rays(64, 64, [0.0, 0.5, -2.5], [0, 0, 0], 50.0)
    perm = morton_permutation(64, 64)
    raster = tile_cones(ro, rd, 256)
    morton = tile_cones(jnp.asarray(np.asarray(ro)[perm]),
                        jnp.asarray(np.asarray(rd)[perm]), 256)
    ang_r = np.degrees(np.arccos(np.asarray(raster.cos_half))).mean()
    ang_m = np.degrees(np.arccos(np.asarray(morton.cos_half))).mean()
    assert ang_m < ang_r / 2  # dramatically tighter cones
