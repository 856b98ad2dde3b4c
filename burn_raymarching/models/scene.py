"""Scene model: learnable raw parameters + activation mapping + forward.

The reference holds 5 Param tensors in a Burn Module (src/model/scene.rs:10-16)
and maps raw → physical in forward (scene.rs:41-45): sigmoid(colors),
softplus(radius)+0.01, sigmoid(ambient), centers/light raw. Here the params
are a plain pytree dataclass (idiomatic JAX: pure functions over pytrees, no
Module machinery), with a separate validity mask so M can be padded to a
static bucket size across density-control stages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from burn_raymarching.ops.march import MarchFn, march_xla
from burn_raymarching.render.diff import render_diff


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SceneParams:
    """Raw (pre-activation) learnable parameters.

    centers: [M, 3]   — world positions (no activation)
    colors:  [M, 3]   — logits; physical = sigmoid(colors)
    radii:   [M, 1]   — raw; physical = softplus(radii) + 0.01
    light_dir: [3]    — unnormalized direction
    ambient: [1]      — logit; physical = sigmoid(ambient)
    """

    centers: jax.Array
    colors: jax.Array
    radii: jax.Array
    light_dir: jax.Array
    ambient: jax.Array

    @property
    def n(self) -> int:
        return self.centers.shape[0]


def activate(params: SceneParams):
    """Raw → physical mapping (reference: src/model/scene.rs:41-45)."""
    return (
        params.centers,
        jax.nn.sigmoid(params.colors),
        jax.nn.softplus(params.radii) + 0.01,
        params.light_dir,
        jax.nn.sigmoid(params.ambient),
    )


def raw_from_physical(centers, colors, radii, light_dir=(0.0, 1.0, 0.0),
                      ambient: float = 0.2) -> SceneParams:
    """Physical → raw re-encode, the inverse of :func:`activate`.

    Used to inject known scenes (the GT generator's spheres, a scene.json)
    into the trainable parameterization — e.g. the representational-ceiling
    and "hold the reference's optimum" controls in docs/PARITY.md. Mirrors
    the reference's own softplus⁻¹ re-encode at split time
    (src/training.rs:203-204); colors are clipped away from {0,1} so the
    logit stays finite.
    """
    colors = jnp.clip(jnp.asarray(colors, jnp.float32), 1e-6, 1.0 - 1e-6)
    radii = jnp.asarray(radii, jnp.float32)
    return SceneParams(
        centers=jnp.asarray(centers, jnp.float32),
        colors=jnp.log(colors) - jnp.log1p(-colors),
        radii=jnp.log(jnp.expm1(jnp.maximum(radii - 0.01, 1e-4))),
        light_dir=jnp.asarray(light_dir, jnp.float32),
        ambient=jnp.log(jnp.asarray([ambient], jnp.float32))
        - jnp.log1p(-jnp.asarray([ambient], jnp.float32)),
    )


def scene_forward(
    params: SceneParams,
    ray_org: jax.Array,
    ray_dir: jax.Array,
    smooth_k: jax.Array | float,
    mask: Optional[jax.Array] = None,
    march_fn: MarchFn = march_xla,
    model_axis: Optional[str] = None,
    march_normal_fn=None,
    num_steps: int = 40,
    softmax_sharpness: float = 10.0,
    mask_sharpness: float = 15.0,
    normal_eps: float = 1e-4,
    mask_pixel_mult: float = 0.0,
    pixel_angle: float = 0.0,
    coverage_mode: str = "sigmoid",
) -> jax.Array:
    """Full forward: activations + differentiable render → [N, 3].

    Reference: src/model/scene.rs:35-57. The sharpness constants default to
    the reference's; fine-structure scenes (features below ~2/mask_sharpness
    units) need them scaled up or the forward model cannot represent the
    geometry at all (see RenderConfig).
    """
    centers, colors, radii, light_dir, ambient = activate(params)
    return render_diff(
        ray_org, ray_dir, centers, colors, radii, light_dir, ambient,
        smooth_k, mask=mask, march_fn=march_fn, model_axis=model_axis,
        march_normal_fn=march_normal_fn, num_steps=num_steps,
        softmax_sharpness=softmax_sharpness, mask_sharpness=mask_sharpness,
        normal_eps=normal_eps, mask_pixel_mult=mask_pixel_mult,
        pixel_angle=pixel_angle, coverage_mode=coverage_mode,
    )


def init_scene_params_cloud(
    n: int,
    seed: int = 0,
    extent: float = 0.8,
    radius: float = 0.03,
    ambient_logit: float = -1.4,
    dtype=jnp.float32,
    points=None,
    jitter: float = 0.02,
) -> SceneParams:
    """Random-cloud init for large-M from-scratch runs (configs 4-5).

    The reference's 7-primitive layout (init_scene_params) puts every extra
    primitive at the origin with softplus(0)+0.01 ≈ 0.70 radius — thousands
    of coincident unit-scale spheres neither render nor prune sensibly. A
    uniform cloud of small spheres inside the scene bound is the standard
    3DGS-style dense init; raw radii are softplus⁻¹(radius - 0.01).

    ``points`` ([P, 3]) supplies a geometry prior — e.g. COLMAP sparse SfM
    points (tools/colmap_to_json.py --points-out), exactly how 3DGS seeds
    its Gaussians: the n centers are sampled from the points with Gaussian
    ``jitter``. Without a prior, a uniform cloud rarely contracts onto thin
    geometry in a reference-length schedule.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    if points is not None:
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        idx = rng.integers(0, pts.shape[0], n)
        centers = (pts[idx]
                   + rng.normal(0.0, jitter, (n, 3))).astype(np.float32)
    else:
        centers = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    raw_r = float(np.log(np.expm1(max(radius - 0.01, 1e-4))))
    return SceneParams(
        centers=jnp.asarray(centers, dtype),
        colors=jnp.zeros((n, 3), dtype=dtype),
        radii=jnp.full((n, 1), raw_r, dtype=dtype),
        light_dir=jnp.asarray([0.0, 1.0, 0.0], dtype),
        ambient=jnp.asarray([ambient_logit], dtype),
    )


def init_scene_params(
    n: int = 7,
    offset: float = 0.1,
    ambient_logit: float = -1.4,
    dtype=jnp.float32,
) -> SceneParams:
    """Initial 6-directions-plus-center layout.

    Reference: src/bin/train.rs:102-126 — first 6 primitives at +-offset on
    each axis, 7th at the origin, gray color logits 0, raw radius 0
    (softplus(0)+0.01 ≈ 0.70), light [0,1,0], ambient logit -1.4.
    Extra primitives beyond 7 (n > 7) are placed at the origin.
    """
    directions = jnp.array(
        [
            [1.0, 0.0, 0.0],
            [-1.0, 0.0, 0.0],
            [0.0, 1.0, 0.0],
            [0.0, -1.0, 0.0],
            [0.0, 0.0, 1.0],
            [0.0, 0.0, -1.0],
        ],
        dtype=dtype,
    )
    centers = jnp.zeros((n, 3), dtype=dtype)
    k = min(n, 6)
    centers = centers.at[:k].set(directions[:k] * offset)
    return SceneParams(
        centers=centers,
        colors=jnp.zeros((n, 3), dtype=dtype),
        radii=jnp.zeros((n, 1), dtype=dtype),
        light_dir=jnp.array([0.0, 1.0, 0.0], dtype=dtype),
        ambient=jnp.array([ambient_logit], dtype=dtype),
    )


def pad_params(params: SceneParams, m_pad: int) -> tuple[SceneParams, jax.Array]:
    """Pad the primitive axis to ``m_pad`` slots; returns (params, mask[M]).

    Padded slots are zero and masked out of every soft-min / softmax / loss
    term, keeping XLA shapes static while density control changes M.
    """
    m = params.n
    if m_pad < m:
        raise ValueError(f"m_pad={m_pad} < current M={m}")
    pad = m_pad - m

    def _pad(x):
        return jnp.pad(x, ((0, pad), (0, 0)))

    mask = jnp.arange(m_pad) < m
    return (
        SceneParams(
            centers=_pad(params.centers),
            colors=_pad(params.colors),
            radii=_pad(params.radii),
            light_dir=params.light_dir,
            ambient=params.ambient,
        ),
        mask,
    )
