"""Differentiable renderer (training forward model).

Gradient topology matches the reference exactly (src/renderer_diff.rs):
  * 40-step march entirely detached;
  * ONE reattached SDF evaluation at the converged point — t_final =
    stop_gradient(t) + sdf(p_approx) carries d t / d (centers, radii) of a
    single implicit-function step (renderer_diff.rs:28-38);
  * normals at a detached point with detached params — no second-order terms
    (renderer_diff.rs:41-46);
  * Lambertian shading with learnable light_dir + ambient
    (renderer_diff.rs:48-62);
  * softmax(-10*d) color compositing over primitives (renderer_diff.rs:65-84);
  * sigmoid(-15*sdf) coverage mask (renderer_diff.rs:86-90).

Notes: the compositor's weighted color sum is a real [N,M]x[M,3] matmul;
padded primitive slots get -1e30 logits so softmax gives them exactly zero
weight; the march can be swapped for the fused march kernel
(``march_normal_fn``, ops/kernels.py).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from burn_raymarching.ops.march import MarchFn, march_xla
from burn_raymarching.ops.sdf import (
    _MASKED_NEG,
    pairwise_sphere_dists,
    scene_normal,
    scene_sdf,
)


def adaptive_coverage(dist_scene, t_final, mask_sharpness,
                      mask_pixel_mult=0.0, pixel_angle=0.0,
                      coverage_mode: str = "sigmoid"):
    """Coverage mask, optionally pixel-footprint-adaptive.

    Default (mask_pixel_mult == 0): the reference's fixed
    sigmoid(-mask_sharpness * d) (renderer_diff.rs:86-90).

    With mask_pixel_mult > 0 (extension, RenderConfig): the
    sigmoid's transition width becomes
        w(t) = max(1 / mask_sharpness, mask_pixel_mult * pixel_angle * t)
    i.e. never narrower than ~mask_pixel_mult PIXELS at the hit depth, so
    silhouette coverage stays an anti-aliased, usefully-differentiable
    function of sub-pixel geometry at any depth, while surfaces keep the
    configured world-space sharpness as a lower bound. t enters detached
    (the footprint is geometry metadata, not a gradient path). Missed rays
    are safe: their scene distance grows ~linearly with t, so d/w tends to
    the constant 1/(mask_pixel_mult*pixel_angle) >> 1 and coverage -> 0.

    ``coverage_mode="gaussian"`` (extension, RenderConfig)
    replaces the sigmoid FAMILY with the GT renderer's Gaussian
    exp(-mask_sharpness * d^2) (reference renderer.rs:77) — the reference
    trains a sigmoid silhouette against Gaussian-masked targets
    (renderer_diff.rs:86-90 vs renderer.rs:77), and that family mismatch is
    baked into the measured representational ceilings (docs/SCALING.md).
    In Gaussian mode ``mask_sharpness`` is the Gaussian's s (width
    1/sqrt(s)); the pixel floor composes as
        w(t) = max(1/sqrt(s), mask_pixel_mult * pixel_angle * t),
        coverage = exp(-(d/w)^2).
    """
    if coverage_mode == "gaussian":
        if mask_pixel_mult <= 0.0 or pixel_angle <= 0.0:
            return jnp.exp(dist_scene * dist_scene * (-mask_sharpness))
        rho = jax.lax.stop_gradient(t_final) * pixel_angle
        w = jnp.maximum(jax.lax.rsqrt(jnp.float32(mask_sharpness)),
                        mask_pixel_mult * rho)
        z = dist_scene / w
        return jnp.exp(-(z * z))
    if coverage_mode != "sigmoid":
        raise ValueError(f"unknown coverage_mode: {coverage_mode!r}")
    if mask_pixel_mult <= 0.0 or pixel_angle <= 0.0:
        return jax.nn.sigmoid(dist_scene * (-mask_sharpness))
    rho = jax.lax.stop_gradient(t_final) * pixel_angle
    w = jnp.maximum(1.0 / mask_sharpness, mask_pixel_mult * rho)
    return jax.nn.sigmoid(-dist_scene / w)


def render_diff(
    ray_org: jax.Array,      # [N, 3]
    ray_dir: jax.Array,      # [N, 3]
    centers: jax.Array,      # [M, 3] physical
    colors: jax.Array,       # [M, 3] physical (0..1)
    radii: jax.Array,        # [M, 1] physical (positive)
    light_dir: jax.Array,    # [3] unnormalized
    ambient: jax.Array,      # [1] in (0, 1)
    smooth_k: jax.Array | float,
    mask: Optional[jax.Array] = None,   # [M] validity of padded slots
    march_fn: MarchFn = march_xla,
    num_steps: int = 40,
    softmax_sharpness: float = 10.0,
    mask_sharpness: float = 15.0,
    normal_eps: float = 1e-4,
    model_axis: Optional[str] = None,
    march_normal_fn=None,
    mask_pixel_mult: float = 0.0,
    pixel_angle: float = 0.0,
    coverage_mode: str = "sigmoid",
) -> jax.Array:
    """Render a batch of rays → [N, 3] linear RGB.

    With ``model_axis`` set, centers/colors/radii/mask are the local shard of
    an M-sharded primitive table inside shard_map; soft-min and the softmax
    compositor combine shards with pmax/psum collectives.

    ``march_normal_fn`` (e.g. the fused Pallas march+shade kernel) returns
    (t, normal) in one call, replacing the separate march + scene_normal —
    both are fully detached so the gradient topology is unchanged.
    """
    if march_normal_fn is not None:
        # --- Fused detached march + normals (Pallas fast path) ---
        t, normal = march_normal_fn(ray_org, ray_dir, centers, radii,
                                    smooth_k, mask=mask, num_steps=num_steps,
                                    normal_eps=normal_eps)
        p_approx = ray_org + ray_dir * t
        dist_last = scene_sdf(p_approx, centers, radii, smooth_k, mask=mask,
                              model_axis=model_axis)
        t_final = t + dist_last
        p_final = ray_org + ray_dir * t_final
    else:
        # --- Phase 1: detached march (renderer_diff.rs:20-26) ---
        t = march_fn(ray_org, ray_dir, centers, radii, smooth_k, mask=mask,
                     num_steps=num_steps, model_axis=model_axis)

        # --- Phase 2: gradient reattachment (renderer_diff.rs:28-38) ---
        p_approx = ray_org + ray_dir * t                 # detached point
        dist_last = scene_sdf(p_approx, centers, radii, smooth_k, mask=mask,
                              model_axis=model_axis)
        t_final = t + dist_last
        p_final = ray_org + ray_dir * t_final

        # --- Normals: detached point + params (renderer_diff.rs:41-46) ---
        normal = scene_normal(
            jax.lax.stop_gradient(p_final),
            jax.lax.stop_gradient(centers),
            jax.lax.stop_gradient(radii),
            smooth_k,
            mask=mask,
            eps=normal_eps,
            model_axis=model_axis,
            direct=True,
        )

    # --- Lambertian shading (renderer_diff.rs:48-62) ---
    ld_norm = light_dir / jnp.sqrt(jnp.sum(light_dir * light_dir))
    dot = jnp.sum(normal * ld_norm[None, :], axis=1, keepdims=True)  # [N,1]
    diffuse = jnp.maximum(dot, 0.0)
    lighting = ambient + diffuse * (1.0 - ambient)                    # [N,1]

    # --- Softmax depth compositing (renderer_diff.rs:65-84) ---
    dists = pairwise_sphere_dists(p_final, centers, radii)            # [N,M]
    logits = dists * (-softmax_sharpness)
    if mask is not None:
        logits = jnp.where(mask[None, :].astype(bool), logits, _MASKED_NEG)
    if model_axis is None:
        weights = jax.nn.softmax(logits, axis=1)                      # [N,M]
    else:
        # Sharded softmax: global max then psum'd denominator — the same
        # two-pass structure as the sharded soft-min.
        mx = jax.lax.pmax(
            jax.lax.stop_gradient(jnp.max(logits, axis=1, keepdims=True)),
            model_axis,
        )
        ex = jnp.exp(logits - mx)
        denom = jax.lax.psum(jnp.sum(ex, axis=1, keepdims=True), model_axis)
        weights = ex / denom
    mixed_color = jnp.dot(weights, colors,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)        # [N,3]
    if model_axis is not None:
        mixed_color = jax.lax.psum(mixed_color, model_axis)
    object_color = mixed_color * lighting

    # --- Coverage mask (renderer_diff.rs:86-90; optionally adaptive) ---
    dist_scene = scene_sdf(p_final, centers, radii, smooth_k, mask=mask,
                           model_axis=model_axis)
    coverage = adaptive_coverage(dist_scene, t_final, mask_sharpness,
                                 mask_pixel_mult, pixel_angle,
                                 coverage_mode=coverage_mode)

    return object_color * coverage
