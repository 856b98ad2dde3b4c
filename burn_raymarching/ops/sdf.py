"""SDF primitives and the batched scene field.

Semantics match the reference exactly (including epsilons), batched for an
accelerator: everything is [N, M], and padded primitive slots are handled
with a validity mask so shapes stay static while M changes across
density-control stages. The gradient-carrying evaluations take the
point-to-sphere distances in the reference's expanded form
||p||^2 + ||c||^2 - 2 p.c (a K=3 contraction); the detached march and
normals take the same function in the direct form sqrt(|p - c|^2)
(``direct=True``), which the GPU march kernel computes too.

Reference semantics: src/model/sdf.rs (sphere SDF, polynomial smooth-min,
LogSumExp soft-min) and src/model/scene.rs:60-128 (scene_sdf_value,
calc_normal_scene).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

# Finite stand-in for -inf in masked logits: exp(x - max) underflows to exactly
# 0 without producing inf-inf NaNs in forward or backward.
_MASKED_NEG = -1e30


def sphere_sdf(p: jax.Array, center: jax.Array, radius: jax.Array) -> jax.Array:
    """Signed distance from points ``p`` [N,3] to one sphere.

    Reference: src/model/sdf.rs:4-11 — sqrt(sum(diff^2) + 1e-6) - radius.
    ``center`` is [3], ``radius`` is scalar or [1]. Returns [N, 1].
    """
    diff = p - center[None, :]
    d = jnp.sqrt(jnp.sum(diff * diff, axis=1, keepdims=True) + 1e-6)
    return d - jnp.reshape(radius, (1, 1))


def smooth_min(a: jax.Array, b: jax.Array, k: float) -> jax.Array:
    """Polynomial smooth minimum.

    Reference: src/model/sdf.rs:14-26 (present but unused there; kept for API
    parity): h = max(k - |a-b|, 0)/k; min(a,b) - h^2 * k/4.
    """
    h = jnp.maximum(k - jnp.abs(a - b), 0.0) / k
    return jnp.minimum(a, b) - h * h * (k * 0.25)


def soft_min(
    dists: jax.Array,
    k: jax.Array | float,
    mask: Optional[jax.Array] = None,
    model_axis: Optional[str] = None,
) -> jax.Array:
    """Stable LogSumExp soft-min over the primitive axis.

    Reference: src/model/sdf.rs:30-44 —
      -log(clamp(sum(exp(-k*d - max)), 1e-8)) + max) / k with the row max
    detached (stop_gradient) exactly as the reference detaches it.

    dists: [N, M]; mask: optional [M] bool/float validity of padded slots.
    When ``model_axis`` is set (inside shard_map with the primitive table
    sharded over that mesh axis), the max and sum are combined across shards
    with a two-pass pmax-then-psum logsumexp — the ring-reduction analog of
    blockwise attention over the M axis. Returns [N, 1].
    """
    val = dists * (-k)
    if mask is not None:
        val = jnp.where(mask[None, :].astype(bool), val, _MASKED_NEG)
    # stop_gradient BEFORE pmax: the max is detached anyway (reference
    # sdf.rs:37) and pmax has no differentiation rule.
    local_max = jax.lax.stop_gradient(jnp.max(val, axis=1, keepdims=True))
    if model_axis is not None:
        local_max = jax.lax.pmax(local_max, model_axis)
    max_val = local_max
    sum_exp = jnp.sum(jnp.exp(val - max_val), axis=1, keepdims=True)
    if model_axis is not None:
        sum_exp = jax.lax.psum(sum_exp, model_axis)
    return (jnp.log(jnp.maximum(sum_exp, 1e-8)) + max_val) / (-k)


def pairwise_sphere_dists(
    p: jax.Array, centers: jax.Array, radii: jax.Array
) -> jax.Array:
    """[N, M] surface distances via the expanded form.

    Reference: src/model/scene.rs:66-78 —
      ||p-c||^2 = ||p||^2 + ||c||^2 - 2 p.c, clamped at 1e-6 before sqrt,
      minus the radius row. The p.c term is a [N,3]x[3,M] matmul.
    p: [N,3], centers: [M,3], radii: [M,1] or [M]. Returns [N, M].
    """
    p_sq = jnp.sum(p * p, axis=1, keepdims=True)            # [N, 1]
    c_sq = jnp.sum(centers * centers, axis=1)[None, :]      # [1, M]
    p_dot_c = jax.lax.dot_general(
        p,
        centers,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,  # full f32: the K=3
        # contraction is tiny, but default precision (TF32 on the GPU)
        # visibly corrupts the distance field (~1e-3), breaking march
        # convergence.
    )                                                        # [N, M]
    dists_sq = p_sq + c_sq - 2.0 * p_dot_c
    dists = jnp.sqrt(jnp.maximum(dists_sq, 1e-6))
    return dists - jnp.reshape(radii, (1, -1))


def direct_sphere_dists(
    p: jax.Array, centers: jax.Array, radii: jax.Array
) -> jax.Array:
    """[N, M] surface distances in the direct form sqrt(|p - c|^2).

    The same function as pairwise_sphere_dists (same 1e-6 clamp) without the
    expanded form's cancellation: near a small sphere ||p||^2 + ||c||^2 -
    2 p.c keeps only ~ulp(||p||^2) of precision, which the +-1e-4 normal
    taps turn into ~1e-3 of noise. Elementwise float32, no dot_general.
    The detached march and normals use it, on every platform, in the same
    operation order as ops/pallas/march_kernel.py.
    """
    ex = p[:, None, 0] - centers[None, :, 0]
    ey = p[:, None, 1] - centers[None, :, 1]
    ez = p[:, None, 2] - centers[None, :, 2]
    dists_sq = ex * ex + ey * ey + ez * ez
    dists = jnp.sqrt(jnp.maximum(dists_sq, 1e-6))
    return dists - jnp.reshape(radii, (1, -1))


def scene_sdf(
    p: jax.Array,
    centers: jax.Array,
    radii: jax.Array,
    smooth_k: jax.Array | float,
    mask: Optional[jax.Array] = None,
    model_axis: Optional[str] = None,
    direct: bool = False,
) -> jax.Array:
    """Soft-min SDF of the whole scene at points ``p`` [N,3] → [N,1].

    Reference: src/model/scene.rs:60-79. ``centers``/``radii``/``mask`` may be
    the local shard of an M-sharded primitive table (see soft_min).
    ``direct`` takes the distances in the direct form (direct_sphere_dists).
    """
    dists = (direct_sphere_dists if direct else pairwise_sphere_dists)(
        p, centers, radii)
    return soft_min(dists, smooth_k, mask=mask, model_axis=model_axis)


# 6-tap central-difference offsets (+x, -x, +y, -y, +z, -z);
# reference: src/model/scene.rs:93-99 with eps = 1e-4.
_NORMAL_TAPS = jnp.array(
    [
        [1.0, 0.0, 0.0],
        [-1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, -1.0, 0.0],
        [0.0, 0.0, 1.0],
        [0.0, 0.0, -1.0],
    ],
    dtype=jnp.float32,
)


def scene_normal(
    p: jax.Array,
    centers: jax.Array,
    radii: jax.Array,
    smooth_k: jax.Array | float,
    mask: Optional[jax.Array] = None,
    eps: float = 1e-4,
    model_axis: Optional[str] = None,
    direct: bool = False,
) -> jax.Array:
    """Central-difference surface normals, batched as one [6N, M] SDF eval.

    Reference: src/model/scene.rs:81-128 — offsets of +-eps per axis, one
    batched scene_sdf_value call, finite differences, normalize by
    sqrt(sum(n^2) + 1e-6).
    p: [N,3] → [N,3] unit-ish normals. ``direct`` as in scene_sdf.
    """
    n = p.shape[0]
    offsets = _NORMAL_TAPS.astype(p.dtype) * eps              # [6, 3]
    p_taps = (p[:, None, :] + offsets[None, :, :]).reshape(n * 6, 3)
    d = scene_sdf(p_taps, centers, radii, smooth_k, mask=mask,
                  model_axis=model_axis, direct=direct).reshape(n, 6)
    normal = jnp.stack(
        [d[:, 0] - d[:, 1], d[:, 2] - d[:, 3], d[:, 4] - d[:, 5]], axis=1
    )
    length = jnp.sqrt(jnp.sum(normal * normal, axis=1, keepdims=True) + 1e-6)
    return normal / length
