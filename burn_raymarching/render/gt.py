"""Ground-truth (dataset synthesis) renderer.

A deliberately different forward model from the trainable renderer — the
reference generates targets with this one so training must *recover* the
scene under a slightly mismatched model (fixed light, exp weights instead of
softmax, Gaussian mask instead of sigmoid). Reference: src/renderer.rs:4-80.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from burn_raymarching.ops.march import march_gt
from burn_raymarching.ops.sdf import pairwise_sphere_dists, scene_normal, scene_sdf


def render_gt(
    ray_org: jax.Array,   # [N, 3]
    ray_dir: jax.Array,   # [N, 3]
    centers: jax.Array,   # [M, 3]
    colors: jax.Array,    # [M, 3]
    radii: jax.Array,     # [M, 1]
    mask: Optional[jax.Array] = None,
    smooth_k: float = 32.0,
    num_steps: int = 40,
    light_dir: tuple = (-0.5, 0.5, -1.0),
    ambient: float = 0.1,
    weight_sharpness: float = 10.0,
    mask_sharpness: float = 10.0,
    hard_mask: bool = False,
) -> jax.Array:
    """Non-differentiable raymarcher → [N, 3] linear RGB.

    Fixed light [-0.5, 0.5, -1.0] normalized (renderer.rs:26-33), lighting =
    diffuse + 0.1 (renderer.rs:40), weights exp(-10*d) normalized by
    sum + 1e-5 (renderer.rs:52-71), mask exp(-10*d_scene^2) (renderer.rs:77).
    """
    t = march_gt(ray_org, ray_dir, centers, radii, smooth_k, mask=mask,
                 num_steps=num_steps)
    p_final = ray_org + ray_dir * t

    normal = scene_normal(p_final, centers, radii, smooth_k, mask=mask)

    ld = jnp.asarray(light_dir, dtype=p_final.dtype)
    ld = ld / jnp.sqrt(jnp.sum(ld * ld))
    diffuse = jnp.maximum(
        jnp.sum(normal * ld[None, :], axis=1, keepdims=True), 0.0
    )
    lighting = diffuse + ambient                               # [N, 1]

    dists = pairwise_sphere_dists(p_final, centers, radii)     # [N, M]
    weights = jnp.exp(dists * (-weight_sharpness))
    if mask is not None:
        weights = weights * mask[None, :].astype(weights.dtype)
    color_sum = jnp.dot(weights, colors,
                        preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)   # [N, 3]
    weight_sum = jnp.sum(weights, axis=1, keepdims=True) + 1e-5
    mixed_color = color_sum / weight_sum
    object_color = mixed_color * lighting

    dist_scene = scene_sdf(p_final, centers, radii, smooth_k, mask=mask)
    coverage = jnp.exp(dist_scene * dist_scene * (-mask_sharpness))
    if hard_mask:
        # Binary silhouette (extension): thresholds the Gaussian
        # at 1/2, i.e. covered iff |d| < sqrt(ln 2 / s). Real-photo
        # captures (chromakeyed frames, chromakey.rs) have exactly this
        # hard-edge statistic — the intended domain of the
        # pixel-footprint-adaptive trainable mask (mask_pixel_mult).
        coverage = (coverage > 0.5).astype(coverage.dtype)

    return object_color * coverage
