"""Sphere-tracing march loops.

The training march is fully detached (truncated-graph sphere tracing): the
reference detaches t after every step (src/renderer_diff.rs:22-26), so no
gradient flows through the 40 iterations — gradients re-enter via one extra
SDF evaluation at the converged point. That lets us run the march under
``stop_gradient`` as a ``lax.fori_loop`` (compile-friendly, no unrolled graph)
and, on the GPU, swap in a fused Pallas kernel that keeps the whole
40-iteration loop on chip (see ops/pallas/march_kernel.py).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from burn_raymarching.ops.sdf import scene_normal, scene_sdf

# Signature shared by XLA and Pallas march implementations.
MarchFn = Callable[..., jax.Array]

# Cap on the march parameter t. The reference lets missed rays diverge
# geometrically (t ~ 2.5 * 2^40 ≈ 1e12 after 40 doublings); every visible
# ray in a bounded scene (primitives inside ||c|| <= 1.2 + r, cameras a few
# units out) converges at t < ~10, so capping far beyond that changes no
# covered pixel. Missed rays saturate coverage to exactly 0 (sigmoid(-15e4)
# underflows) with exactly zero gradients either way — but the ~1e12
# magnitudes provoke NaNs in XLA's fused compositor backward, so we keep t
# in sane fp32 range.
T_MAX = 1e4


def march_xla(
    ray_org: jax.Array,
    ray_dir: jax.Array,
    centers: jax.Array,
    radii: jax.Array,
    smooth_k: jax.Array | float,
    mask: Optional[jax.Array] = None,
    num_steps: int = 40,
    model_axis: Optional[str] = None,
    t_init: Optional[jax.Array] = None,
) -> jax.Array:
    """Detached sphere-tracing march → final t [N, 1].

    Reference: src/renderer_diff.rs:20-26 — t starts at 0, 40 iterations of
    t <- t + sdf(ro + rd*t), each detached. ``t_init`` warm-starts the march
    (per-pixel t cache across training steps) — t is detached so any
    converged root of the *current* field is equivalent; callers pair a
    nonzero t_init with a reduced num_steps. Distances in the direct form
    (ops/sdf.direct_sphere_dists), as in the GPU kernel.
    """
    ray_org = jax.lax.stop_gradient(ray_org)
    ray_dir = jax.lax.stop_gradient(ray_dir)
    centers = jax.lax.stop_gradient(centers)
    radii = jax.lax.stop_gradient(radii)
    smooth_k = jax.lax.stop_gradient(smooth_k)

    def body(_, t):
        p = ray_org + ray_dir * t
        t = t + scene_sdf(p, centers, radii, smooth_k, mask=mask,
                          model_axis=model_axis, direct=True)
        return jnp.minimum(t, T_MAX)

    if t_init is None:
        t0 = jnp.zeros((ray_org.shape[0], 1), dtype=ray_org.dtype)
    else:
        t0 = jax.lax.stop_gradient(t_init)
    t = jax.lax.fori_loop(0, num_steps, body, t0)
    return jax.lax.stop_gradient(t)


def march_normals_xla(
    ray_org: jax.Array,
    ray_dir: jax.Array,
    centers: jax.Array,
    radii: jax.Array,
    smooth_k: jax.Array | float,
    mask: Optional[jax.Array] = None,
    num_steps: int = 40,
    normal_eps: float = 1e-4,
    t_init: Optional[jax.Array] = None,
    model_axis: Optional[str] = None,
) -> tuple[jax.Array, jax.Array]:
    """Detached march + normals → (t [N, 1], normal [N, 3]).

    The plain twin of ops/pallas/march_kernel.march_normals_triton, and the
    dense counterpart of render/culled.culled_march_normals_xla: the march,
    one detached reattach evaluation giving the point the renderer shades at
    (renderer_diff.rs:28-38), and the 6-tap normals there with detached
    parameters (renderer_diff.rs:41-46), all in the direct form. No output
    carries a gradient.
    """
    centers = jax.lax.stop_gradient(centers)
    radii = jax.lax.stop_gradient(radii)
    smooth_k = jax.lax.stop_gradient(smooth_k)
    t = march_xla(ray_org, ray_dir, centers, radii, smooth_k, mask=mask,
                  num_steps=num_steps, model_axis=model_axis, t_init=t_init)
    ray_org = jax.lax.stop_gradient(ray_org)
    ray_dir = jax.lax.stop_gradient(ray_dir)
    dist_last = scene_sdf(ray_org + ray_dir * t, centers, radii, smooth_k,
                          mask=mask, model_axis=model_axis, direct=True)
    p_final = ray_org + ray_dir * (t + dist_last)
    normal = scene_normal(p_final, centers, radii, smooth_k, mask=mask,
                          eps=normal_eps, model_axis=model_axis, direct=True)
    return t, jax.lax.stop_gradient(normal)


def march_gt(
    ray_org: jax.Array,
    ray_dir: jax.Array,
    centers: jax.Array,
    radii: jax.Array,
    smooth_k: jax.Array | float,
    mask: Optional[jax.Array] = None,
    num_steps: int = 40,
    model_axis: Optional[str] = None,
) -> jax.Array:
    """Ground-truth renderer march (no detach semantics needed — the GT
    renderer is never differentiated). Reference: src/renderer.rs:14-21."""

    def body(_, t):
        p = ray_org + ray_dir * t
        t = t + scene_sdf(p, centers, radii, smooth_k, mask=mask,
                          model_axis=model_axis)
        return jnp.minimum(t, T_MAX)

    t0 = jnp.zeros((ray_org.shape[0], 1), dtype=ray_org.dtype)
    return jax.lax.fori_loop(0, num_steps, body, t0)
