"""Training loss: weighted L1 reconstruction + 4 geometric penalties.

Semantics match reference src/training.rs:8-85 exactly, with a validity mask
so padded primitive slots contribute nothing and every "mean over primitives"
divides by the number of *valid* primitives.

Terms (reference lines cited inline):
  1. recon: |out - target| weighted 10 on object pixels (target sum > 0.01),
     background weight annealed 1 → 5 with progress (training.rs:15-34).
  2. radius: 0.04 * mean(r^2 where r > 1) + 0.002 * mean(|r|), with
     r = softplus(raw) (NO +0.01 — the penalty path differs from the forward
     activation in the reference, training.rs:40-51).
  3. origin attraction: 0.05 * mean(centers^2) (training.rs:54-55).
  4. camera-proximity barrier: 5.0 * mean((max(0, ||c||+r-1.2))^2 masked to
     violators) (training.rs:58-70).
  5. pairwise repulsion: 1e-5 * mean(1/(dist + 100*I + 1e-6)) (training.rs:73-83).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from burn_raymarching.config import LossConfig
from burn_raymarching.models.scene import SceneParams


class RepulsionStatic(NamedTuple):
    """The NON-DIFFERENTIABLE prep of the two-level repulsion, frozen
    between refreshes (train/loop builds it once per scan chunk).

    Every field is gradient-free by construction in the per-step path:
    neighbor-cluster ids are top_k INDICES, validity/counts depend only on
    the (static) cluster table and mask, and the far-weight rows are a
    pure function of those. Freezing them for a chunk (~100 steps at
    lr_centers ≲ 1e-3·base_lr) only lags WHICH cluster pairs get the
    exact near field vs the monopole far field — an approximation-order
    choice, not a gradient-topology change; the per-step differentiable
    pieces (member positions, centroids, neighbor positions) are always
    recomputed live. The per-step prep (top-k + one-hot + table gathers)
    carries no gradient, so recomputing it every step buys nothing.
    """

    nb: jax.Array        # [C, W] int32 near-cluster ids (own included)
    nbm_idx: jax.Array   # [C, W·G] int32 neighbor-member primitive ids
    nb_w: jax.Array      # [C, W·G] f32 neighbor-member validity
    far_w: jax.Array     # [C, C] f32 (1 - near_hot) * counts row weights
    counts: jax.Array    # [C] f32 live members per cluster
    w: jax.Array         # [C, G] f32 member validity


def build_repulsion_static(
    centers: jax.Array,       # [M, 3] (detached inside)
    clusters,                 # ops.culling.PrimitiveClusters
    mask: Optional[jax.Array],
    near_clusters: int = 8,
) -> RepulsionStatic:
    """Freeze the repulsion prep from the CURRENT centers (jittable; call
    at chunk boundaries). Mirrors cluster_repulsion's own prep exactly —
    with identical centers the static path reproduces the on-the-fly path
    bit-for-bit (tests/test_repulsion_kernel.py)."""
    centers = jax.lax.stop_gradient(centers)
    member_idx = clusters.member_idx
    member_valid = clusters.member_valid
    if mask is not None:
        member_valid = member_valid & jnp.take(mask.astype(bool), member_idx)
    c_count, g = member_idx.shape
    w = member_valid.astype(jnp.float32)
    counts = jnp.sum(w, axis=1)
    cs = jnp.take(centers, member_idx.reshape(-1), axis=0).reshape(
        c_count, g, 3)
    centroids = (jnp.sum(cs * w[..., None], axis=1)
                 / jnp.maximum(counts, 1.0)[:, None])
    w_near = min(near_clusters, c_count)
    cd2 = jnp.sum((centroids[:, None, :] - centroids[None, :, :]) ** 2,
                  axis=2)
    cd2 = jnp.where((counts > 0)[None, :], cd2, jnp.inf)
    _, nb = jax.lax.top_k(-cd2, w_near)
    nbm_idx = jnp.take(member_idx, nb, axis=0).reshape(c_count, w_near * g)
    nb_w = jnp.take(w, nb, axis=0).reshape(c_count, w_near * g)
    near_hot = jnp.sum(jax.nn.one_hot(nb, c_count, dtype=jnp.float32),
                       axis=1)
    far_w = (1.0 - near_hot) * counts[None, :]
    return RepulsionStatic(nb.astype(jnp.int32), nbm_idx.astype(jnp.int32),
                           nb_w, far_w, counts, w)


def _masked_mean(
    x: jax.Array,
    mask: Optional[jax.Array],
    n_valid,
    model_axis: Optional[str] = None,
) -> jax.Array:
    """Mean over valid primitive slots; plain mean when unmasked.

    With ``model_axis``, x/mask are the local M shard: the sum is psum'd and
    n_valid is already the global count.
    """
    if mask is None and model_axis is None:
        return jnp.mean(x)
    if mask is None:
        s = jax.lax.psum(jnp.sum(x), model_axis)
        return s / (n_valid * (x.size // x.shape[0]))
    m = mask.astype(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
    s = jnp.sum(x * m)
    if model_axis is not None:
        s = jax.lax.psum(s, model_axis)
    return s / (n_valid * (x.size // x.shape[0]))


def cluster_repulsion(
    centers: jax.Array,       # [M, 3]
    clusters,                 # ops.culling.PrimitiveClusters
    mask: Optional[jax.Array],
    n_valid,
    near_clusters: int = 8,
    model_axis: Optional[str] = None,
    far_field: str = "member",
    static: Optional[RepulsionStatic] = None,
) -> jax.Array:
    """Barnes-Hut-style approximation of the pairwise repulsion mean for
    large M: exact 1/(d+100·I+1e-6) over pairs whose clusters are among the
    ``near_clusters`` nearest (by centroid, own cluster included), centroid
    monopoles (count/dist) for the far field.

    ``far_field`` picks the far approximation order: "member" evaluates every
    member against every far centroid ([M, C] pairs), "monopole" collapses
    both sides to centroids ([C, C] pairs, counts_i·counts_j/dist — ~G× fewer
    far pairs at one more approximation order; grad cosine vs the exact sum
    ~0.978 instead of ~0.993 on uniform 51k-primitive clouds).

    O(M·W·G + M·C) instead of O(M²) — the exact [M, M] matrix is 10.5 GB of
    f32 at M=51200 and dominates the whole train step. The repulsion
    gradient is dominated by nearest pairs (1/d² forces), so the near field
    must be exact — a monopole-only far field from the adjacent clusters
    misdirects it badly. Relative error of a far pair is
    O((cluster_radius/distance)²). Gradients flow through member positions
    and the (differentiable) centroids.

    With ``model_axis`` (M sharded inside shard_map), ``centers``/``mask``/
    ``clusters`` are the LOCAL shard (member_idx in local row space): near
    field is exact within the shard's own clusters, centroids+counts (tiny,
    C×4 floats) are all-gathered so every remote cluster contributes as a
    monopole, and the partial sums are psum'd. Since the global Morton order
    is contiguous per shard, cross-shard cluster pairs are boundary cases.

    ``static`` (single-device only) supplies the frozen non-differentiable
    prep (see RepulsionStatic); the differentiable pieces are recomputed
    live either way, so with identical centers the two paths agree exactly.
    """
    member_idx = clusters.member_idx
    c_count, g = member_idx.shape
    if static is not None:
        if model_axis is not None:
            raise ValueError("static repulsion tables are single-device "
                             "(the sharded path computes its prep in-step)")
        w = static.w
        counts = static.counts
        w_near = static.nb.shape[1]
        nb = static.nb
        nbm_flat = static.nbm_idx                            # [C, W·G]
        nb_w = static.nb_w
        cd2 = None
    else:
        member_valid = clusters.member_valid
        if mask is not None:
            member_valid = member_valid & jnp.take(mask.astype(bool),
                                                   member_idx)
        w = member_valid.astype(centers.dtype)               # [C, G]
        counts = jnp.sum(w, axis=1)                          # [C]
        w_near = min(near_clusters, c_count)
    cs = jnp.take(centers, member_idx.reshape(-1), axis=0).reshape(
        c_count, g, 3)
    centroids = (jnp.sum(cs * w[..., None], axis=1)
                 / jnp.maximum(counts, 1.0)[:, None])        # [C, 3]

    if static is None:
        # W nearest clusters per cluster (own included — distance 0).
        cd2 = jnp.sum((centroids[:, None, :] - centroids[None, :, :]) ** 2,
                      axis=2)                                # [C, C]
        # Empty clusters pushed to the end so they never displace live ones.
        cd2 = jnp.where((counts > 0)[None, :], cd2, jnp.inf)
        _, nb = jax.lax.top_k(-cd2, w_near)                  # [C, W]
        nbm_flat = jnp.take(member_idx, nb, axis=0).reshape(
            c_count, w_near * g)
        nb_w = jnp.take(w, nb, axis=0).reshape(c_count, w_near * g)

    # Exact near-field pairs: members of each cluster vs members of its W
    # nearest clusters, with the reference's +100 on true self-pairs.
    # The chained take(cs, nb) gathers whole [G, 3] cluster blocks;
    # a direct take(centers, member_idx[nb]) is value/gradient-identical
    # but shreds it into W·G·C tiny row gathers.
    nb_cs = jnp.take(cs, nb, axis=0).reshape(c_count, w_near * g, 3)
    d2 = jnp.sum((cs[:, :, None, :] - nb_cs[:, None, :, :]) ** 2, axis=3)
    dist = jnp.sqrt(jnp.maximum(d2, 1e-6))                   # [C, G, W·G]
    self_pair = (member_idx[:, :, None]
                 == nbm_flat.reshape(c_count, 1, w_near * g))
    inv = 1.0 / (dist + self_pair.astype(dist.dtype) * 100.0 + 1e-6)
    s_near = jnp.sum(inv * w[:, :, None] * nb_w[:, None, :])

    # Far field: monopoles of every cluster, minus those of the W near
    # clusters (their pairs are exact above). With a sharded M, remote
    # shards' centroids arrive via all_gather and are always monopoles.
    if model_axis is None:
        cents_all = centroids                                # [C_all, 3]
        counts_all = counts
        col_offset = 0
    else:
        cents_all = jax.lax.all_gather(centroids, model_axis).reshape(-1, 3)
        counts_all = jax.lax.all_gather(counts, model_axis).reshape(-1)
        col_offset = jax.lax.axis_index(model_axis) * c_count
    c_all_count = cents_all.shape[0]
    if static is not None:
        far_w_rows = static.far_w                            # [C, C_all]
    else:
        near_hot = jnp.sum(
            jax.nn.one_hot(nb + col_offset, c_all_count,
                           dtype=centers.dtype),
            axis=1)                                          # [C, C_all]
        far_w_rows = (1.0 - near_hot) * counts_all[None, :]
    if far_field == "monopole":
        # Centroid↔centroid monopoles: counts_i·counts_j / dist(cent_i,
        # cent_j) for every non-near pair. Empty clusters contribute zero
        # weight on both sides; the local [C, C] distances are the top-k
        # input reused (inf on empty columns → inv 0 → exact zero term —
        # recomputed with the same masking on the static path, where the
        # top-k input is frozen but the distances must stay live).
        if model_axis is None and cd2 is not None:
            ccd2 = cd2
        else:
            ccd2 = jnp.sum(
                (centroids[:, None, :] - cents_all[None, :, :]) ** 2, axis=2)
            if static is not None:
                ccd2 = jnp.where((counts_all > 0)[None, :], ccd2, jnp.inf)
        dist_cc = jnp.sqrt(jnp.maximum(ccd2, 1e-6))          # [C, C_all]
        inv_cc = 1.0 / (dist_cc + 1e-6)
        s_far = jnp.sum(far_w_rows * counts[:, None] * inv_cc)
    else:
        flat_c = cs.reshape(c_count * g, 3)
        flat_w = w.reshape(c_count * g)
        diff = flat_c[:, None, :] - cents_all[None, :, :]    # [M_l, C_all, 3]
        dist_f = jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=2), 1e-6))
        inv_f = 1.0 / (dist_f + 1e-6)
        far_w = far_w_rows[:, None, :]
        far_w = jnp.broadcast_to(far_w, (c_count, g, c_all_count)).reshape(
            c_count * g, c_all_count)
        s_far = jnp.sum(inv_f * flat_w[:, None] * far_w)

    s = s_near + s_far
    if model_axis is not None:
        s = jax.lax.psum(s, model_axis)
    return s / (n_valid * n_valid)


def compute_loss(
    params: SceneParams,
    output: jax.Array,        # [B, 3] rendered
    target: jax.Array,        # [B, 3]
    progress: jax.Array,      # scalar in [0, 1]
    mask: Optional[jax.Array] = None,   # [M] validity
    cfg: LossConfig = LossConfig(),
    model_axis: Optional[str] = None,   # set inside shard_map when M is sharded
    repulsion_clusters=None,  # PrimitiveClusters → two-level repulsion
    repulsion_static=None,    # RepulsionStatic (single-device, per-chunk)
) -> jax.Array:
    # --- 1. Weighted L1 reconstruction (training.rs:15-34) ---
    abs_diff = jnp.abs(output - target)
    target_sum = jnp.sum(target, axis=1, keepdims=True)
    object_mask = target_sum > cfg.fg_mask_threshold
    bg_weight = cfg.bg_weight_start + progress * (
        cfg.bg_weight_end - cfg.bg_weight_start
    )
    weight_map = jnp.where(object_mask, cfg.fg_weight, bg_weight)
    if cfg.fringe_weight != 1.0:
        # Dim-silhouette-fringe boost (LossConfig.fringe_weight): the
        # low-luminance object band carries most of the residual error at
        # convergence (docs/SCALING.md round 3); reference parity when 1.0.
        fringe = object_mask & (target_sum < cfg.fringe_threshold)
        weight_map = jnp.where(fringe, weight_map * cfg.fringe_weight,
                               weight_map)
    loss = jnp.mean(abs_diff * weight_map)

    n_valid = (
        jnp.sum(mask.astype(output.dtype)) if mask is not None
        else jnp.asarray(float(params.centers.shape[0]), output.dtype)
    )
    if model_axis is not None:
        n_valid = jax.lax.psum(n_valid, model_axis)

    # --- 2. Radius penalties (training.rs:44-51) ---
    radii = jax.nn.softplus(params.radii)          # [M, 1], no +0.01 here
    radius_l1 = _masked_mean(jnp.abs(radii), mask, n_valid, model_axis)
    radius_large = _masked_mean(
        jnp.where(radii > 1.0, radii * radii, 0.0), mask, n_valid, model_axis
    )
    loss = loss + radius_large * cfg.radius_large_coeff + radius_l1 * cfg.radius_l1_coeff

    # --- 3. Origin attraction (training.rs:54-55) ---
    center_sq = params.centers * params.centers     # [M, 3]
    loss = loss + _masked_mean(center_sq, mask, n_valid, model_axis) * cfg.center_coeff

    # --- 4. Camera-proximity barrier (training.rs:58-70) ---
    dist_from_origin = jnp.sqrt(
        jnp.sum(center_sq, axis=1, keepdims=True) + 1e-6
    )                                                # [M, 1]
    max_reach = dist_from_origin + radii
    excess = max_reach - cfg.proximity_bound
    proximity = jnp.where(max_reach > cfg.proximity_bound, excess * excess, 0.0)
    loss = loss + _masked_mean(proximity, mask, n_valid, model_axis) * cfg.proximity_coeff

    # --- 5. Pairwise repulsion (training.rs:73-83) ---
    if repulsion_clusters is not None:
        repulsion = cluster_repulsion(params.centers, repulsion_clusters,
                                      mask, n_valid,
                                      model_axis=model_axis,
                                      far_field=cfg.repulsion_far_field,
                                      static=(repulsion_static
                                              if model_axis is None
                                              else None))
        return loss + repulsion * cfg.repulsion_coeff
    # With M sharded, each device holds the [M_local, M_global] row block:
    # centers (tiny) are all-gathered, the row sums psum'd.
    c = params.centers
    if model_axis is None:
        c_all = c
        mask_all = mask
        shard_idx = 0
    else:
        c_all = jax.lax.all_gather(c, model_axis).reshape(-1, 3)
        mask_all = (None if mask is None
                    else jax.lax.all_gather(mask, model_axis).reshape(-1))
        shard_idx = jax.lax.axis_index(model_axis)
    m_local = c.shape[0]
    c_sq = jnp.sum(c * c, axis=1, keepdims=True)         # [M_local, 1]
    ca_sq = jnp.sum(c_all * c_all, axis=1)[None, :]      # [1, M_global]
    c_dot = jnp.dot(c, c_all.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    dist_sq = c_sq + ca_sq - 2.0 * c_dot
    dist = jnp.sqrt(jnp.maximum(dist_sq, 1e-6))
    row = jnp.arange(m_local)[:, None] + shard_idx * m_local
    col = jnp.arange(c_all.shape[0])[None, :]
    m_eye = (row == col).astype(c.dtype)                 # local rows of I
    inv = 1.0 / (dist + m_eye * 100.0 + 1e-6)
    if mask is None and model_axis is None:
        repulsion = jnp.mean(inv)
    else:
        if mask_all is None:
            s = jnp.sum(inv)
        else:
            pair_mask = (mask.astype(c.dtype)[:, None]
                         * mask_all.astype(c.dtype)[None, :])
            s = jnp.sum(inv * pair_mask)
        if model_axis is not None:
            s = jax.lax.psum(s, model_axis)
        repulsion = s / (n_valid * n_valid)
    loss = loss + repulsion * cfg.repulsion_coeff

    return loss
