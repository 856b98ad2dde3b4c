"""Dense march+normals kernel (ops/pallas/march_kernel.py, Triton route, in
interpret mode on the CPU) against its XLA twin ops.march.march_normals_xla,
which is itself pinned to march_xla + scene_normal. Compiled-kernel parity
on the card: tests/test_gpu_kernels.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest

from burn_raymarching.data.camera import create_camera_rays
from burn_raymarching.ops.march import march_normals_xla, march_xla
from burn_raymarching.ops.pallas.march_kernel import march_normals_triton
from burn_raymarching.ops.sdf import scene_normal, scene_sdf


@pytest.fixture(scope="module")
def scene():
    centers = jnp.asarray(
        [[-0.3, 0.0, 0.0], [0.0, 0.0, 0.0], [0.3, 0.0, 0.0]], jnp.float32
    )
    radii = jnp.asarray([[0.2], [0.15], [0.2]], jnp.float32)
    ro, rd = create_camera_rays(16, 8, [0.0, 0.5, -2.5], [0.0, 0.0, 0.0], 50.0)
    return ro, rd, centers, radii


def _kernel(*args, block_rays=16, **kw):
    return march_normals_triton(*args, interpret=True, block_rays=block_rays,
                                **kw)


def test_march_matches_xla(scene):
    ro, rd, centers, radii = scene
    t_ref = np.asarray(march_xla(ro, rd, centers, radii, 32.0))
    t_pl, _ = _kernel(ro, rd, centers, radii, 32.0)
    np.testing.assert_allclose(np.asarray(t_pl), t_ref, rtol=1e-5, atol=1e-5)


def test_march_masked(scene):
    ro, rd, centers, radii = scene
    # Pad with junk primitives that the mask must exclude; M = 5 is not a
    # power of two, so the table load is masked too.
    c_pad = jnp.concatenate([centers, jnp.ones((2, 3)) * 0.1])
    r_pad = jnp.concatenate([radii, jnp.ones((2, 1)) * 0.5])
    mask = jnp.arange(5) < 3
    t_ref = np.asarray(march_xla(ro, rd, centers, radii, 32.0))
    t_pl, _ = _kernel(ro, rd, c_pad, r_pad, 32.0, mask=mask)
    np.testing.assert_allclose(np.asarray(t_pl), t_ref, rtol=1e-5, atol=1e-5)


def test_march_ragged_n(scene):
    # N not a multiple of the ray block: masked loads and stores.
    ro, rd, centers, radii = scene
    ro_r, rd_r = ro[:100], rd[:100]
    t_ref = np.asarray(march_xla(ro_r, rd_r, centers, radii, 32.0))
    t_pl, n_pl = _kernel(ro_r, rd_r, centers, radii, 32.0)
    assert t_pl.shape == (100, 1) and n_pl.shape == (100, 3)
    np.testing.assert_allclose(np.asarray(t_pl), t_ref, rtol=1e-5, atol=1e-5)


def test_march_annealed_k(scene):
    ro, rd, centers, radii = scene
    for k in (5.0, 18.5, 32.0):
        t_ref = np.asarray(march_xla(ro, rd, centers, radii, k))
        t_pl, _ = _kernel(ro, rd, centers, radii, k)
        np.testing.assert_allclose(np.asarray(t_pl), t_ref, rtol=1e-5,
                                   atol=1e-5)


def test_normals_match_xla_six_tap(scene):
    """The kernel's fused normal taps == the XLA 6-tap central differences
    at the kernel's own reattached point (incl. the +1e-6-inside-
    normalization reference quirk, scene.rs:81-128)."""
    _, _, centers, radii = scene
    # Denser rays zoomed on the spheres so plenty of rays actually hit.
    ro, rd = create_camera_rays(24, 24, [0.0, 0.3, -1.2], [0.0, 0.0, 0.0],
                                50.0)
    t_pl, n_pl = _kernel(ro, rd, centers, radii, 32.0)
    t = jnp.asarray(t_pl)
    p = ro + rd * t
    p_final = ro + rd * (t + scene_sdf(p, centers, radii, 32.0, direct=True))
    n_ref = np.asarray(scene_normal(p_final, centers, radii, 32.0,
                                    direct=True))
    # Far-missed rays (t → T_MAX) normalize ~zero finite differences into
    # noise; the renderer multiplies them by ~0 coverage. Compare the rays
    # that matter.
    near = np.asarray(t)[:, 0] < 10.0
    assert near.sum() > 100
    # ~0.19-magnitude normals (the +1e-6 quirk); kernel and XLA take the
    # same direct-form field, so they agree to chip_smoke's phase-1 bound.
    np.testing.assert_allclose(np.asarray(n_pl)[near], n_ref[near],
                               atol=1e-4)


@pytest.mark.parametrize("block_prims", [2, 4])
def test_streamed_table_matches_one_chunk(scene, block_prims):
    """A table wider than one chunk (streamed with the online logsumexp,
    ragged last chunk at block 2) equals the one-chunk kernel."""
    ro, rd, centers, radii = scene
    t1, n1 = _kernel(ro, rd, centers, radii, 18.5)
    t2, n2 = _kernel(ro, rd, centers, radii, 18.5, block_prims=block_prims)
    np.testing.assert_allclose(np.asarray(t2), np.asarray(t1), rtol=1e-5,
                               atol=1e-5)
    hit = np.asarray(t1)[:, 0] < 10.0
    np.testing.assert_allclose(np.asarray(n2)[hit], np.asarray(n1)[hit],
                               atol=1e-4)


def test_warm_start_matches_xla(scene):
    """t_init + reduced steps equals the XLA twin from the same roots."""
    ro, rd, centers, radii = scene
    t0 = jnp.full((ro.shape[0], 1), 0.7, jnp.float32)
    t_x, _ = march_normals_xla(ro, rd, centers, radii, 32.0, num_steps=8,
                               t_init=t0)
    t_k, _ = _kernel(ro, rd, centers, radii, 32.0, num_steps=8, t_init=t0)
    np.testing.assert_allclose(np.asarray(t_k), np.asarray(t_x), rtol=1e-5,
                               atol=1e-5)


def test_march_normals_xla_is_march_plus_scene_normal(scene):
    """The dense XLA twin = march_xla, one detached reattach evaluation,
    and scene_normal at that point — the separate path render_diff takes
    without a fused march."""
    ro, rd, centers, radii = scene
    mask = jnp.asarray([True, True, False])
    t, normal = march_normals_xla(ro, rd, centers, radii, 18.5, mask=mask)
    t_ref = march_xla(ro, rd, centers, radii, 18.5, mask=mask)
    p_final = ro + rd * (t_ref + scene_sdf(ro + rd * t_ref, centers, radii,
                                           18.5, mask=mask, direct=True))
    n_ref = scene_normal(p_final, centers, radii, 18.5, mask=mask,
                         direct=True)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(t_ref))
    np.testing.assert_allclose(np.asarray(normal), np.asarray(n_ref),
                               rtol=1e-6, atol=1e-7)


def test_kernel_block_size_does_not_change_results(scene):
    """Rays are independent: the ray-block size only changes the grid."""
    ro, rd, centers, radii = scene
    t16, n16 = _kernel(ro, rd, centers, radii, 18.5, block_rays=16)
    t64, n64 = _kernel(ro, rd, centers, radii, 18.5, block_rays=64)
    np.testing.assert_array_equal(np.asarray(t16), np.asarray(t64))
    np.testing.assert_array_equal(np.asarray(n16), np.asarray(n64))

