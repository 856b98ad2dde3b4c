"""Differentiable renderer with coherent-tile primitive culling.

Same forward model and gradient topology as render/diff.py, but every field
evaluation runs against per-tile top-K primitive tables (ops/culling.py)
instead of the full [N, M] matrix — O(N·K) for forward AND backward. With
the conservative 22/k cutoff the result is exact in f32 whenever each
tile's qualifying set fits the K budget (overflow drops only the weakest
contributors).

Rays must be tile-coherent: pixel-ordered for rendering, or index-sorted for
training batches (sorting a with-replacement sample changes nothing — the
loss is a batch mean).

Reference semantics citations as in render/diff.py (renderer_diff.rs).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from burn_raymarching.ops.culling import (
    PrimitiveClusters,
    gather_tile_tables,
    select_tile_primitives,
    select_tile_primitives_hier,
    tile_cones,
)
from burn_raymarching.ops.march import T_MAX

_MASKED_NEG = -1e30


def _tile_dists(p, centers_t, radii_t, c_sq_t):
    """[B, T, K] surface distances (expanded form, scene.rs:66-78)."""
    p_sq = jnp.sum(p * p, axis=2, keepdims=True)              # [B, T, 1]
    dot = jnp.einsum("btd,bkd->btk", p, centers_t,
                     precision=jax.lax.Precision.HIGHEST)
    d_sq = p_sq + c_sq_t[:, None, :] - 2.0 * dot
    return jnp.sqrt(jnp.maximum(d_sq, 1e-6)) - radii_t[:, None, :]


def _tile_dists_direct(p, centers_t, radii_t, c_sq_t):
    """[B, T, K] surface distances in the direct form sqrt(|p - c|^2)
    (ops/sdf.direct_sphere_dists); invalid slots sit at 1e15, as in the
    expanded form."""
    ex = p[:, :, None, 0] - centers_t[:, None, :, 0]
    ey = p[:, :, None, 1] - centers_t[:, None, :, 1]
    ez = p[:, :, None, 2] - centers_t[:, None, :, 2]
    d = jnp.sqrt(jnp.maximum(ex * ex + ey * ey + ez * ez, 1e-6))
    d = jnp.where(c_sq_t[:, None, :] < 0.5e30, d, 1e15)
    return d - radii_t[:, None, :]


def _tile_soft_min(p, centers_t, radii_t, c_sq_t, k, model_axis=None,
                   direct=False):
    """[B, T, 1] LogSumExp soft-min (sdf.rs:30-44); invalid slots carry
    c_sq 1e30 → distances ~1e15 → exact zero weight. ``direct`` takes the
    distances in the direct form (the detached march and normals).

    With ``model_axis``, the tables are per-shard top-K selections of an
    M-sharded primitive table: global max via pmax, psum'd exp sum — the
    same two-pass sharded logsumexp as ops/sdf.scene_sdf."""
    d = (_tile_dists_direct if direct else _tile_dists)(
        p, centers_t, radii_t, c_sq_t)
    val = d * (-k)
    mx = jax.lax.stop_gradient(jnp.max(val, axis=2, keepdims=True))
    if model_axis is not None:
        mx = jax.lax.pmax(mx, model_axis)
    s = jnp.sum(jnp.exp(val - mx), axis=2, keepdims=True)
    if model_axis is not None:
        s = jax.lax.psum(s, model_axis)
    return (jnp.log(jnp.maximum(s, 1e-8)) + mx) / (-k)


def _tile_normals(p, centers_t, radii_t, c_sq_t, k, eps=1e-4,
                  model_axis=None):
    """6-tap central differences per tile (scene.rs:81-128), detached, in
    the direct form."""
    def sdf(q):
        return _tile_soft_min(q, centers_t, radii_t, c_sq_t, k,
                              model_axis=model_axis, direct=True)[..., 0]

    taps = []
    for axis in range(3):
        off = jnp.zeros((1, 1, 3), p.dtype).at[0, 0, axis].set(eps)
        taps.append(sdf(p + off) - sdf(p - off))
    normal = jnp.stack(taps, axis=2)                          # [B, T, 3]
    length = jnp.sqrt(jnp.sum(normal * normal, axis=2, keepdims=True) + 1e-6)
    return normal / length


def culled_march_normals_xla(
    ro: jax.Array,            # [B, T, 3]
    rd: jax.Array,            # [B, T, 3]
    cs: jax.Array,            # [B, K, 3] detached tile centers
    rs: jax.Array,            # [B, K] detached tile radii
    qs: jax.Array,            # [B, K] ||c||^2 (1e30 in invalid slots)
    smooth_k: jax.Array | float,
    num_steps: int = 40,
    normal_eps: float = 1e-4,
    t_init: Optional[jax.Array] = None,
    model_axis: Optional[str] = None,
) -> tuple[jax.Array, jax.Array]:
    """XLA twin of ops/pallas/march_kernel.culled_march_normals_triton:
    detached march + 6-tap normals over per-tile top-K tables → (t [B,T,1],
    normal [B,T,3]).

    The CPU's march (ops/kernels.py), the reference the kernel is tested
    against, and the path for M-sharded tables whose tile batch does not
    split over the model axis (the march then needs the GLOBAL field every
    iteration — a pmax/psum soft-min per step, a collective the kernel
    cannot issue). Same truncated-graph semantics (reference
    renderer_diff.rs:22-26, scene.rs:81-128), distances in the direct form
    as in the kernel; inputs are assumed detached by the caller.
    """
    ks = jax.lax.stop_gradient(smooth_k)

    def body(_, t):
        p = ro + rd * t
        t = t + _tile_soft_min(p, cs, rs, qs, ks, model_axis=model_axis,
                               direct=True)
        return jnp.minimum(t, T_MAX)

    t0 = (jnp.zeros(ro.shape[:2] + (1,), ro.dtype) if t_init is None
          else jax.lax.stop_gradient(t_init).reshape(ro.shape[:2] + (1,)))
    t = jax.lax.stop_gradient(jax.lax.fori_loop(0, num_steps, body, t0))
    # Normal point: one reattachment-style extra evaluation, all detached
    # (renderer_diff.rs:28-46) — the final p the renderer shades at.
    p_final = ro + rd * (t + _tile_soft_min(ro + rd * t, cs, rs, qs, ks,
                                            model_axis=model_axis,
                                            direct=True))
    normal = _tile_normals(jax.lax.stop_gradient(p_final), cs, rs, qs, ks,
                           eps=normal_eps, model_axis=model_axis)
    return t, jax.lax.stop_gradient(normal)


def render_diff_culled(
    ray_org: jax.Array,      # [N, 3] tile-coherent order
    ray_dir: jax.Array,
    centers: jax.Array,      # [M, 3] physical
    colors: jax.Array,       # [M, 3]
    radii: jax.Array,        # [M, 1]
    light_dir: jax.Array,
    ambient: jax.Array,
    smooth_k: jax.Array | float,
    mask: Optional[jax.Array] = None,
    tile: int = 512,
    k_budget: int = 256,
    num_steps: int = 40,
    softmax_sharpness: float = 10.0,
    mask_sharpness: float = 15.0,
    normal_eps: float = 1e-4,
    t_init: Optional[jax.Array] = None,
    clusters: Optional[PrimitiveClusters] = None,
    cluster_budget: int = 32,
    model_axis: Optional[str] = None,
    march_normal_fn=None,
    precomputed=None,
    mask_pixel_mult: float = 0.0,
    pixel_angle: float = 0.0,
    coverage_mode: str = "sigmoid",
) -> jax.Array:
    """Culled differentiable render → [N, 3]. N must divide by ``tile``.

    With ``clusters`` (ops/culling.build_clusters), selection goes two-level:
    cluster bounding spheres first, per-primitive top-K only over surviving
    clusters' members — O(B·M/G + B·Cb·G) instead of O(B·M), the win at
    M ≳ 10k where the flat [B, M] top_k dominates the step.

    With ``model_axis`` (inside shard_map), centers/colors/radii/mask are the
    LOCAL shard of an M-sharded table: each device selects its own top-K
    from its shard and the soft-min / softmax reductions combine shards with
    pmax/psum — culling composes with model parallelism per shard.

    ``march_normal_fn`` (ops/kernels.select_kernels' culled march)
    replaces the in-renderer XLA march + normal taps — on the GPU one fused
    kernel runs all 47 detached field evaluations without [B, T, K]
    round-trips through device memory. Single-device tables only (the
    M-sharded march needs per-step pmax/psum collectives; that path stays
    in XLA).

    ``precomputed`` = (idx [B,K], valid [B,K], t [B,T,1], normal [B,T,3])
    skips selection AND the detached march/normals entirely — the training
    loop runs them OUTSIDE the autodiff trace (t and normals carry no
    gradients by construction, reference renderer_diff.rs:25,41-46) and
    this function computes only the gradient-carrying tail with tables
    re-gathered from the live (grad-carrying) parameters at the same idx.
    """
    n = ray_org.shape[0]
    b = n // tile
    if b * tile != n:
        raise ValueError(f"N={n} not divisible by tile={tile}")

    if precomputed is not None:
        idx, valid, t, normal = precomputed
        t = jax.lax.stop_gradient(t)
        normal = jax.lax.stop_gradient(normal)
    else:
        cones = tile_cones(ray_org, ray_dir, tile)
        if clusters is not None:
            idx, valid = select_tile_primitives_hier(
                cones, jax.lax.stop_gradient(centers),
                jax.lax.stop_gradient(radii), smooth_k, k_budget,
                clusters, cluster_budget, mask=mask)
        else:
            idx, valid = select_tile_primitives(
                cones, jax.lax.stop_gradient(centers),
                jax.lax.stop_gradient(radii), smooth_k, k_budget, mask=mask)
    centers_t, colors_t, radii_t, c_sq_t = gather_tile_tables(
        centers, colors, radii, idx, valid)

    ro = ray_org.reshape(b, tile, 3)
    rd = ray_dir.reshape(b, tile, 3)

    # --- Detached march (renderer_diff.rs:20-26) ---
    cs = jax.lax.stop_gradient(centers_t)
    rs = jax.lax.stop_gradient(radii_t)
    qs = jax.lax.stop_gradient(c_sq_t)
    ks = jax.lax.stop_gradient(smooth_k)

    if precomputed is not None:
        pass                                  # t, normal arrived detached
    elif march_normal_fn is not None and model_axis is None:
        # Fused march + reattach point + normal taps.
        t0 = (jnp.zeros((b, tile, 1), ro.dtype) if t_init is None
              else jax.lax.stop_gradient(t_init).reshape(b, tile, 1))
        t, normal = march_normal_fn(
            ro, rd, cs, rs, qs, ks, num_steps=num_steps,
            normal_eps=normal_eps, t_init=t0)
        t = jax.lax.stop_gradient(t)
        normal = jax.lax.stop_gradient(normal)
    else:
        def body(_, t):
            p = ro + rd * t
            t = t + _tile_soft_min(p, cs, rs, qs, ks, model_axis=model_axis,
                                   direct=True)
            return jnp.minimum(t, T_MAX)

        t0 = (jnp.zeros((b, tile, 1), ro.dtype) if t_init is None
              else jax.lax.stop_gradient(t_init).reshape(b, tile, 1))
        t = jax.lax.stop_gradient(jax.lax.fori_loop(0, num_steps, body, t0))
        normal = None

    # --- Reattachment (renderer_diff.rs:28-38) ---
    p_approx = ro + rd * t
    dist_last = _tile_soft_min(p_approx, centers_t, radii_t, c_sq_t, smooth_k,
                               model_axis=model_axis)
    t_final = t + dist_last
    p_final = ro + rd * t_final

    # --- Detached normals (renderer_diff.rs:41-46) ---
    if normal is None:
        normal = _tile_normals(jax.lax.stop_gradient(p_final), cs, rs, qs,
                               ks, eps=normal_eps, model_axis=model_axis)

    # --- Shading (renderer_diff.rs:48-62) ---
    ld_norm = light_dir / jnp.sqrt(jnp.sum(light_dir * light_dir))
    diffuse = jnp.maximum(
        jnp.sum(normal * ld_norm[None, None, :], axis=2, keepdims=True), 0.0)
    lighting = ambient + diffuse * (1.0 - ambient)

    # --- Softmax compositing (renderer_diff.rs:65-84) ---
    dists = _tile_dists(p_final, centers_t, radii_t, c_sq_t)
    logits = dists * (-softmax_sharpness)
    logits = jnp.where(valid[:, None, :], logits, _MASKED_NEG)
    if model_axis is None:
        weights = jax.nn.softmax(logits, axis=2)
    else:
        # Sharded softmax over per-shard top-K tables (render/diff.py:108).
        mx = jax.lax.pmax(
            jax.lax.stop_gradient(jnp.max(logits, axis=2, keepdims=True)),
            model_axis)
        ex = jnp.exp(logits - mx)
        denom = jax.lax.psum(jnp.sum(ex, axis=2, keepdims=True), model_axis)
        weights = ex / denom
    mixed = jnp.einsum("btk,bkc->btc", weights, colors_t,
                       precision=jax.lax.Precision.HIGHEST)
    if model_axis is not None:
        mixed = jax.lax.psum(mixed, model_axis)
    object_color = mixed * lighting

    # --- Coverage (renderer_diff.rs:86-90; optionally adaptive) ---
    from burn_raymarching.render.diff import adaptive_coverage

    dist_scene = _tile_soft_min(p_final, centers_t, radii_t, c_sq_t, smooth_k,
                                model_axis=model_axis)
    coverage = adaptive_coverage(dist_scene, t_final, mask_sharpness,
                                 mask_pixel_mult, pixel_angle,
                                 coverage_mode=coverage_mode)

    return (object_color * coverage).reshape(n, 3)
