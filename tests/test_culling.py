"""Coherent-tile culling: geometry, selection, and exactness of the culled
renderer vs the dense one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from burn_raymarching.data.camera import create_camera_rays
from burn_raymarching.ops.culling import (
    cone_point_distance,
    select_tile_primitives,
    tile_cones,
)
from burn_raymarching.render.culled import render_diff_culled
from burn_raymarching.render.diff import render_diff


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(5)
    m = 40
    centers = jnp.asarray(rng.normal(0, 0.4, (m, 3)), jnp.float32)
    colors = jnp.asarray(rng.uniform(0.1, 1.0, (m, 3)), jnp.float32)
    radii = jnp.asarray(rng.uniform(0.03, 0.15, (m, 1)), jnp.float32)
    light = jnp.asarray([0.2, 1.0, -0.3], jnp.float32)
    ambient = jnp.asarray([0.2], jnp.float32)
    ro, rd = create_camera_rays(32, 32, [0.0, 0.5, -2.5], [0, 0, 0], 50.0)
    return centers, colors, radii, light, ambient, ro, rd


def test_cones_contain_their_rays(scene):
    _, _, _, _, _, ro, rd = scene
    cones = tile_cones(ro, rd, 128)
    b = ro.shape[0] // 128
    rdt = np.asarray(rd).reshape(b, 128, 3)
    axis = np.asarray(cones.axis)
    cosh = np.asarray(cones.cos_half)
    for i in range(b):
        cos_all = rdt[i] @ axis[i]
        assert (cos_all >= cosh[i] - 1e-6).all()


def test_cone_distance_zero_for_points_on_rays(scene):
    _, _, _, _, _, ro, rd = scene
    cones = tile_cones(ro, rd, 128)
    # Points along the first ray of each tile must be inside its cone.
    b = ro.shape[0] // 128
    rot = np.asarray(ro).reshape(b, 128, 3)[:, 0]
    rdt = np.asarray(rd).reshape(b, 128, 3)[:, 0]
    pts = jnp.asarray(rot + 2.0 * rdt)
    d = np.asarray(cone_point_distance(cones, pts))
    assert (np.diagonal(d) < 1e-5).all()


def test_selection_keeps_all_near_primitives(scene):
    centers, _, radii, _, _, ro, rd = scene
    cones = tile_cones(ro, rd, 128)
    idx, valid = select_tile_primitives(cones, centers, radii,
                                        jnp.float32(32.0), 40)
    # Budget == M: every primitive within the cutoff must be kept; at least
    # the ones the camera actually sees.
    assert bool(valid.any())
    # Indices are valid range.
    assert int(idx.max()) < centers.shape[0]


def test_culled_render_matches_dense(scene):
    centers, colors, radii, light, ambient, ro, rd = scene
    dense = np.asarray(jax.jit(render_diff)(
        ro, rd, centers, colors, radii, light, ambient, jnp.float32(32.0)))
    culled = np.asarray(jax.jit(
        lambda *a: render_diff_culled(*a, tile=128, k_budget=40))(
        ro, rd, centers, colors, radii, light, ambient, jnp.float32(32.0)))
    # Grazing rays amplify reduction-order fp differences through the
    # 40-step march; everything else matches tightly.
    np.testing.assert_allclose(culled, dense, rtol=8e-3, atol=1e-3)


def test_culled_render_matches_dense_with_mask(scene):
    centers, colors, radii, light, ambient, ro, rd = scene
    m = centers.shape[0]
    mask = jnp.arange(m) < (m - 8)
    dense = np.asarray(jax.jit(render_diff)(
        ro, rd, centers, colors, radii, light, ambient, jnp.float32(32.0),
        mask))
    culled = np.asarray(jax.jit(
        lambda *a: render_diff_culled(*a, tile=128, k_budget=40))(
        ro, rd, centers, colors, radii, light, ambient, jnp.float32(32.0),
        mask))
    np.testing.assert_allclose(culled, dense, rtol=2e-3, atol=2e-4)


def test_culled_gradients_match_dense(scene):
    centers, colors, radii, light, ambient, ro, rd = scene

    def loss_dense(c):
        return render_diff(ro, rd, c, colors, radii, light, ambient,
                           jnp.float32(32.0)).sum()

    def loss_culled(c):
        return render_diff_culled(ro, rd, c, colors, radii, light, ambient,
                                  jnp.float32(32.0), tile=128,
                                  k_budget=40).sum()

    g_d = np.asarray(jax.jit(jax.grad(loss_dense))(centers))
    g_c = np.asarray(jax.jit(jax.grad(loss_culled))(centers))
    np.testing.assert_allclose(g_c, g_d, rtol=5e-2, atol=5e-3)


def test_small_budget_keeps_strongest(scene):
    # A tight budget must still produce a finite, plausible image.
    centers, colors, radii, light, ambient, ro, rd = scene
    out = np.asarray(jax.jit(
        lambda *a: render_diff_culled(*a, tile=128, k_budget=8))(
        ro, rd, centers, colors, radii, light, ambient, jnp.float32(32.0)))
    assert np.isfinite(out).all()


# --- Hierarchical (two-level) selection ---

def test_build_clusters_partitions_live_primitives(scene):
    from burn_raymarching.ops.culling import build_clusters

    centers, _, _, _, _, _, _ = scene
    m = centers.shape[0]
    mask = jnp.arange(m) < (m - 8)
    cl = build_clusters(centers, mask=mask, group=8)
    member = np.asarray(cl.member_idx)[np.asarray(cl.member_valid)]
    assert sorted(member.tolist()) == list(range(m - 8))


def test_cluster_bounds_contain_member_spheres(scene):
    from burn_raymarching.ops.culling import build_clusters, cluster_bounds

    centers, _, radii, _, _, _, _ = scene
    cl = build_clusters(centers, group=8)
    bc, br, valid = cluster_bounds(cl, centers, radii)
    mc = np.asarray(jnp.take(centers, cl.member_idx, axis=0))
    mr = np.asarray(jnp.take(radii.reshape(-1), cl.member_idx))
    reach = np.linalg.norm(mc - np.asarray(bc)[:, None, :], axis=2) + mr
    v = np.asarray(valid)
    assert (reach[v] <= np.asarray(br).repeat(v.shape[1]).reshape(v.shape)[v]
            + 1e-5).all()


def test_hier_selection_matches_flat(scene):
    from burn_raymarching.ops.culling import (
        build_clusters, select_tile_primitives_hier)

    centers, _, radii, _, _, ro, rd = scene
    cones = tile_cones(ro, rd, 128)
    k = jnp.float32(32.0)
    idx_f, val_f = select_tile_primitives(cones, centers, radii, k, 40)
    cl = build_clusters(centers, group=8)
    # cluster_budget = C: no coarse overflow -> identical selected SET.
    idx_h, val_h = select_tile_primitives_hier(
        cones, centers, radii, k, 40, cl, cluster_budget=cl.member_idx.shape[0])
    for b in range(idx_f.shape[0]):
        flat = set(np.asarray(idx_f)[b][np.asarray(val_f)[b]].tolist())
        hier = set(np.asarray(idx_h)[b][np.asarray(val_h)[b]].tolist())
        assert hier == flat


def test_hier_culled_render_matches_dense(scene):
    from burn_raymarching.ops.culling import build_clusters
    from burn_raymarching.render.diff import render_diff

    centers, colors, radii, light, ambient, ro, rd = scene
    cl = build_clusters(centers, group=8)
    dense = np.asarray(jax.jit(render_diff)(
        ro, rd, centers, colors, radii, light, ambient, jnp.float32(32.0)))
    hier = np.asarray(jax.jit(
        lambda *a: render_diff_culled(*a, tile=128, k_budget=40,
                                      clusters=cl, cluster_budget=5))(
        ro, rd, centers, colors, radii, light, ambient, jnp.float32(32.0)))
    np.testing.assert_allclose(hier, dense, rtol=8e-3, atol=1e-3)


def test_hier_selection_with_mask_excludes_padded(scene):
    from burn_raymarching.ops.culling import (
        build_clusters, select_tile_primitives_hier)

    centers, _, radii, _, _, ro, rd = scene
    m = centers.shape[0]
    mask = jnp.arange(m) < (m - 8)
    cones = tile_cones(ro, rd, 128)
    # Clusters built WITHOUT the mask; per-step mask must still exclude.
    cl = build_clusters(centers, group=8)
    idx, valid = select_tile_primitives_hier(
        cones, centers, radii, jnp.float32(32.0), 40, cl,
        cluster_budget=cl.member_idx.shape[0], mask=mask)
    picked = np.asarray(idx)[np.asarray(valid)]
    assert (picked < m - 8).all()


def test_cluster_overflow_zero_at_full_budget(scene):
    from burn_raymarching.ops.culling import build_clusters, cluster_overflow

    centers, _, radii, _, _, ro, rd = scene
    cones = tile_cones(ro, rd, 128)
    cl = build_clusters(centers, group=8)
    ov = cluster_overflow(cones, centers, radii, jnp.float32(32.0), cl,
                          cluster_budget=cl.member_idx.shape[0])
    assert int(np.asarray(ov).max()) == 0
