"""Native C++ components vs the NumPy/JAX implementations."""

import numpy as np
import pytest

from burn_raymarching.native import (
    camera_rays_native,
    is_available,
    prune_and_split_native,
)
from burn_raymarching.train.density import prune_and_split

pytestmark = pytest.mark.skipif(not is_available(),
                                reason="native toolchain unavailable")


def _scene(m=24, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 0.6, (m, 3)).astype(np.float32)
    colors = rng.normal(0, 3, (m, 3)).astype(np.float32)
    radii = rng.normal(-1, 1.5, (m, 1)).astype(np.float32)
    init = centers + rng.normal(0, 0.2, (m, 3)).astype(np.float32)
    return centers, colors, radii, init


def test_density_native_matches_numpy_with_injected_dirs():
    centers, colors, radii, init = _scene()
    m = centers.shape[0]
    rng = np.random.default_rng(7)
    z = rng.uniform(-1, 1, m).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
    rxy = np.sqrt(np.maximum(1 - z * z, 0))
    dirs = np.stack([rxy * np.cos(th), rxy * np.sin(th), z], 1)

    for stage in (0, 2, 4):
        nc, ncol, nr, stats = prune_and_split_native(
            centers, colors, radii, init, stage, 5, seed=1, dirs=dirs)
        # NumPy oracle with the same dirs: recompute holds/splits manually.
        from burn_raymarching.train.density import (
            _sigmoid, _softplus, _softplus_inv)

        er = _softplus(radii[:, 0])
        keep = ~(((er > 1.0 - 0.04 * stage) | (er < 0.005))
                 | ((centers ** 2).sum(1) > 1.44)
                 | (_sigmoid(colors).sum(1) < 0.05))
        if stage < 4:
            move = ((centers - init) ** 2).sum(1)
            split = keep & (er > 0.25 * 0.65 ** stage) & (move > 0.0025)
        else:
            split = np.zeros_like(keep)
        hold = keep & ~split
        assert stats["split"] == int(split.sum())
        assert stats["kept"] == int(hold.sum())
        assert nc.shape[0] == int(hold.sum()) + 2 * int(split.sum())
        # Native emits interleaved in original order; compare as sets of
        # rows against the expected children/holds.
        expected = []
        for i in range(m):
            if not keep[i]:
                continue
            if split[i]:
                off = er[i] * 0.5
                cr = _softplus_inv(max(er[i] * 0.8, 0.01))
                expected.append((centers[i] + dirs[i] * off, cr))
                expected.append((centers[i] - dirs[i] * off, cr))
            else:
                expected.append((centers[i], radii[i, 0]))
        exp_c = np.array([e[0] for e in expected], np.float32)
        exp_r = np.array([e[1] for e in expected], np.float32)
        got = np.concatenate([nc, nr], axis=1)
        want = np.concatenate([exp_c, exp_r[:, None]], axis=1)
        got_sorted = got[np.lexsort(got.T)]
        want_sorted = want[np.lexsort(want.T)]
        np.testing.assert_allclose(got_sorted, want_sorted, rtol=1e-5,
                                   atol=1e-6)


def test_density_native_stats_match_numpy_path():
    centers, colors, radii, init = _scene(seed=11)
    _, _, _, np_stats = prune_and_split(
        centers, colors, radii, init, 1, 5, np.random.default_rng(0))
    _, _, _, c_stats = prune_and_split_native(
        centers, colors, radii, init, 1, 5, seed=0)
    assert c_stats["pruned_size"] == np_stats.pruned_size
    assert c_stats["pruned_flyaway"] == np_stats.pruned_flyaway
    assert c_stats["pruned_black"] == np_stats.pruned_black
    assert c_stats["split"] == np_stats.split
    assert c_stats["kept"] == np_stats.kept


def test_camera_rays_native_matches_python():
    from burn_raymarching.data.camera import create_camera_rays

    for pose in ([0.0, 0.5, -2.5], [2.5, 0.0, 0.1], [0.0, 2.5, -0.001]):
        ro_j, rd_j = create_camera_rays(64, 48, pose, [0, 0, 0], 50.0)
        ro_c, rd_c = camera_rays_native(64, 48, pose, [0, 0, 0], 50.0)
        np.testing.assert_allclose(ro_c, np.asarray(ro_j), atol=1e-6)
        np.testing.assert_allclose(rd_c, np.asarray(rd_j), atol=1e-5)


def test_camera_rays_native_threaded_consistent():
    a = camera_rays_native(256, 256, [0, 0.5, -2.5], [0, 0, 0], 50.0,
                          num_threads=1)
    b = camera_rays_native(256, 256, [0, 0.5, -2.5], [0, 0, 0], 50.0,
                          num_threads=4)
    np.testing.assert_array_equal(a[1], b[1])
