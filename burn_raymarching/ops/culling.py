"""Coherent-tile primitive culling for large scenes.

Dense soft-min is O(N·M) — fine for the reference's hundreds of primitives,
ruinous at 5k-50k (BASELINE configs 4-5). The fix: rays in a tile
share a bounding cone; any primitive farther than ``cutoff = margin/k`` from
the cone (beyond its radius) contributes less than exp(-margin) ≈ 2.7e-10
relative to the soft-min/softmax sums — *below fp32 resolution*, so culling
it is exact in f32. Each tile then marches against its own top-K primitive
table instead of all M.

Coherence comes for free in rendering (pixel tiles) and from SORTING the
sampled batch indices in training (sampling is with replacement and the
loss is a batch mean, so reordering changes nothing).

Selection runs once per step as cheap dense [n_tiles, M] geometry (no
transcendentals); the 47 per-step field evaluations then cost O(N·K).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

# exp(-22) ≈ 2.7e-10: dropped terms are below f32 resolution of the sums.
CULL_MARGIN = 22.0


class TileCones(NamedTuple):
    apex: jax.Array          # [B, 3] mean ray origin per tile
    axis: jax.Array          # [B, 3] unit mean direction
    cos_half: jax.Array      # [B] cos of the bounding half-angle
    origin_spread: jax.Array  # [B] max |origin - apex| (cutoff inflation)


def tile_cones(ray_org: jax.Array, ray_dir: jax.Array, tile: int) -> TileCones:
    """Bounding cones of consecutive ray tiles. N must divide by ``tile``."""
    n = ray_org.shape[0]
    b = n // tile
    ro = ray_org.reshape(b, tile, 3)
    rd = ray_dir.reshape(b, tile, 3)
    apex = jnp.mean(ro, axis=1)
    axis = jnp.mean(rd, axis=1)
    axis = axis / jnp.maximum(
        jnp.linalg.norm(axis, axis=1, keepdims=True), 1e-12)
    cos_half = jnp.min(jnp.sum(rd * axis[:, None, :], axis=2), axis=1)
    # A near-degenerate tile (rays spanning >90°) gets cos_half <= 0: the
    # cone test below degrades to keep-everything, which is safe.
    spread = jnp.max(jnp.linalg.norm(ro - apex[:, None, :], axis=2), axis=1)
    return TileCones(apex, axis, jnp.clip(cos_half, -1.0, 1.0), spread)


def _cone_distance_core(cones: TileCones, v: jax.Array) -> jax.Array:
    """Point-to-cone distance for per-tile offset vectors v [B, X, 3] → [B, X].

    Standard point-to-cone: with α the angle between v and the axis, θ the
    half-angle: inside (α ≤ θ) → 0; else |v|·sin(min(α-θ, π/2)).

    Computed trig-free (this runs dense [B, M] every step): sin(α-θ) =
    sinα·cosθ − cosα·sinθ with sinα = √(1−cos²α); the min(·, π/2) clamp is
    cos(α−θ) < 0 ⟹ distance |v|. Same math as the arccos/sin form,
    ~3× cheaper on the VPU.
    """
    length = jnp.linalg.norm(v, axis=2)                       # [B, X]
    proj = jnp.sum(v * cones.axis[:, None, :], axis=2)        # [B, X]
    cosa = jnp.clip(proj / jnp.maximum(length, 1e-12), -1.0, 1.0)
    sina = jnp.sqrt(jnp.maximum(1.0 - cosa * cosa, 0.0))
    cost = cones.cos_half[:, None]
    sint = jnp.sqrt(jnp.maximum(1.0 - cost * cost, 0.0))
    sin_out = jnp.maximum(sina * cost - cosa * sint, 0.0)     # sin(α−θ) ∨ 0
    cos_diff = cosa * cost + sina * sint                      # cos(α−θ)
    d = jnp.where(cos_diff < 0.0, length, length * sin_out)
    return jnp.where(length < 1e-9, 0.0, d)


def cone_point_distance(cones: TileCones, points: jax.Array) -> jax.Array:
    """Distance from each (shared) point to each tile's cone → [B, M].

    The origin spread is subtracted by the caller via the cutoff.
    """
    return _cone_distance_core(
        cones, points[None, :, :] - cones.apex[:, None, :])


def select_tile_primitives(
    cones: TileCones,
    centers: jax.Array,       # [M, 3]
    radii: jax.Array,         # [M, 1] physical
    smooth_k: jax.Array | float,
    k_budget: int,
    mask: Optional[jax.Array] = None,
) -> tuple[jax.Array, jax.Array]:
    """Top-K primitive indices per tile → (idx [B, K], valid [B, K]).

    Keeps primitives whose cone distance (minus radius and origin spread) is
    within CULL_MARGIN/k; when more than K qualify, the K nearest are kept
    (the overflow terms are the weakest contributors).
    """
    d = cone_point_distance(cones, centers)                   # [B, M]
    cutoff = CULL_MARGIN / smooth_k + cones.origin_spread[:, None]
    score = d - radii.reshape(1, -1)
    keep = score <= cutoff
    if mask is not None:
        keep = keep & mask[None, :].astype(bool)
    # Rank by score with culled entries pushed to +inf.
    ranked = jnp.where(keep, score, jnp.inf)
    k_budget = min(k_budget, centers.shape[0])
    neg_top, idx = jax.lax.top_k(-ranked, k_budget)           # [B, K]
    valid = jnp.isfinite(-neg_top)
    return idx.astype(jnp.int32), valid


def selection_overflow(
    cones: TileCones,
    centers: jax.Array,
    radii: jax.Array,
    smooth_k: jax.Array | float,
    k_budget: int,
    mask: Optional[jax.Array] = None,
) -> jax.Array:
    """Per-tile count of qualifying primitives dropped by the K budget.

    Nonzero overflow means the render is no longer f32-exact: the dropped
    terms are the weakest qualifiers, with relative contribution up to
    exp(-k * (their score - best score)). Diffuse clouds (many primitives at
    comparable distance) need larger budgets than surface-structured scenes.
    """
    d = cone_point_distance(cones, centers)
    cutoff = CULL_MARGIN / smooth_k + cones.origin_spread[:, None]
    keep = (d - radii.reshape(1, -1)) <= cutoff
    if mask is not None:
        keep = keep & mask[None, :].astype(bool)
    counts = jnp.sum(keep.astype(jnp.int32), axis=1)
    return jnp.maximum(counts - k_budget, 0)


class PrimitiveClusters(NamedTuple):
    """Fixed cluster membership for hierarchical selection.

    Membership (which primitive belongs to which cluster) is rebuilt only
    occasionally — at stage boundaries, or every ``refresh`` steps — while
    the cluster BOUNDS are recomputed from the live centers every step, so
    the coarse cull stays conservative (exact) no matter how far centers
    have drifted; drift only loosens the bounds (more clusters survive).
    """

    member_idx: jax.Array    # [C, G] int32 primitive ids (pad: slot 0)
    member_valid: jax.Array  # [C, G] bool


def morton3(q: "np.ndarray", bits: int = 10) -> "np.ndarray":
    """Interleave 3×``bits`` quantized coords → Z-order code (uint64)."""
    import numpy as np

    code = np.zeros(q.shape[0], dtype=np.uint64)
    q = q.astype(np.uint64)
    for b in range(bits):
        for axis in range(3):
            code |= (((q[:, axis] >> np.uint64(b)) & np.uint64(1))
                     << np.uint64(3 * b + axis))
    return code


def morton_order(centers) -> "np.ndarray":
    """Host-side Z-order permutation of points (argsort of morton3 codes)."""
    import numpy as np

    c = np.asarray(centers)
    lo, hi = c.min(axis=0), c.max(axis=0)
    scale = np.maximum(hi - lo, 1e-9)
    q = np.clip(((c - lo) / scale * 1023.0), 0, 1023).astype(np.uint64)
    return np.argsort(morton3(q), kind="stable")


def build_clusters(centers, mask=None, group: int = 64) -> PrimitiveClusters:
    """Morton-sort primitive centers and chunk into clusters of ``group``.

    Host-side (NumPy): runs at stage boundaries / every ``refresh`` steps,
    like the reference's own host-side density control (training.rs:87-238).
    Padded (masked-out) primitives are excluded; clusters are padded to a
    multiple of ``group`` with invalid slots pointing at primitive 0.
    """
    import numpy as np

    centers = np.asarray(centers)
    m = centers.shape[0]
    live = (np.ones(m, bool) if mask is None
            else np.asarray(mask).astype(bool))
    ids = np.nonzero(live)[0]
    if ids.size == 0:
        ids = np.zeros(1, np.int64)
    sorted_ids = ids[morton_order(centers[ids])]
    n = sorted_ids.size
    c_count = max(1, -(-n // group))
    pad = c_count * group - n
    member = np.concatenate([sorted_ids, np.zeros(pad, np.int64)])
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return PrimitiveClusters(
        jnp.asarray(member.reshape(c_count, group), jnp.int32),
        jnp.asarray(valid.reshape(c_count, group)))


def cluster_bounds(
    clusters: PrimitiveClusters,
    centers: jax.Array,   # [M, 3] physical (live values — recompute per step)
    radii: jax.Array,     # [M, 1] physical
    mask: Optional[jax.Array] = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Per-cluster bounding spheres → (center [C,3], radius [C], valid [C,G]).

    Bound = mean of member centers, radius = max(‖cᵢ−bc‖ + rᵢ) over valid
    members, so each member SPHERE is fully contained: with the 1-Lipschitz
    cone distance, coarse score (cone_dist(bc) − br) lower-bounds every
    member's fine score (cone_dist(cᵢ) − rᵢ) — the coarse cull is exact.
    """
    valid = clusters.member_valid
    if mask is not None:
        valid = valid & jnp.take(mask.astype(bool), clusters.member_idx)
    mc = jnp.take(centers, clusters.member_idx, axis=0)       # [C, G, 3]
    mr = jnp.take(radii.reshape(-1), clusters.member_idx)     # [C, G]
    w = valid.astype(centers.dtype)[..., None]
    count = jnp.maximum(jnp.sum(w, axis=1), 1.0)              # [C, 1]
    bc = jnp.sum(mc * w, axis=1) / count                      # [C, 3]
    reach = jnp.linalg.norm(mc - bc[:, None, :], axis=2) + mr
    br = jnp.max(jnp.where(valid, reach, -jnp.inf), axis=1)   # [C]
    return bc, br, valid


def select_tile_primitives_hier(
    cones: TileCones,
    centers: jax.Array,       # [M, 3] physical
    radii: jax.Array,         # [M, 1] physical
    smooth_k: jax.Array | float,
    k_budget: int,
    clusters: PrimitiveClusters,
    cluster_budget: int,
    mask: Optional[jax.Array] = None,
) -> tuple[jax.Array, jax.Array]:
    """Two-level top-K selection → (idx [B, K], valid [B, K]).

    Stage 1 tests cluster bounding spheres ([B, C] — C = M/G rows instead of
    M) and keeps the ``cluster_budget`` nearest qualifying clusters; stage 2
    scores only their members ([B, Cb·G]) and runs the exact per-primitive
    rule of select_tile_primitives on that candidate set. Identical result
    whenever the qualifying clusters fit the budget (the coarse score
    lower-bounds member fine scores, see cluster_bounds); overflow drops
    whole clusters weakest-first.
    """
    # Cluster-sorted copies of the param tables, built ONCE per step
    # (one [M]-sized gather). Per-tile candidate fetches below are then
    # whole-row gathers of [G·3]-contiguous cluster blocks instead of
    # B·Cb·G random scalar gathers from the unsorted tables.
    member_valid = clusters.member_valid
    if mask is not None:
        member_valid = member_valid & jnp.take(
            mask.astype(bool), clusters.member_idx)
    c_count, g = clusters.member_idx.shape
    centers_s = jnp.take(centers, clusters.member_idx.reshape(-1),
                         axis=0).reshape(c_count, g, 3)
    radii_s = jnp.take(radii.reshape(-1),
                       clusters.member_idx.reshape(-1)).reshape(c_count, g)

    # Bounding spheres from the sorted tables (cluster_bounds semantics).
    w = member_valid.astype(centers.dtype)[..., None]
    count = jnp.maximum(jnp.sum(w, axis=1), 1.0)
    bc = jnp.sum(centers_s * w, axis=1) / count               # [C, 3]
    reach = jnp.linalg.norm(centers_s - bc[:, None, :], axis=2) + radii_s
    br = jnp.max(jnp.where(member_valid, reach, -jnp.inf), axis=1)

    cutoff = CULL_MARGIN / smooth_k + cones.origin_spread[:, None]
    coarse = cone_point_distance(cones, bc) - br[None, :]     # [B, C]
    keep_c = (coarse <= cutoff) & jnp.any(member_valid, axis=1)[None, :]
    ranked_c = jnp.where(keep_c, coarse, jnp.inf)
    cluster_budget = min(cluster_budget, c_count)
    neg_c, cidx = jax.lax.top_k(-ranked_c, cluster_budget)    # [B, Cb]
    c_alive = jnp.isfinite(-neg_c)                            # [B, Cb]

    b = cidx.shape[0]
    cand_idx = jnp.take(clusters.member_idx, cidx,
                        axis=0).reshape(b, -1)                # [B, Q]
    cand_valid = (jnp.take(member_valid, cidx, axis=0)
                  & c_alive[..., None]).reshape(b, -1)
    pts = jnp.take(centers_s, cidx, axis=0).reshape(b, -1, 3)  # row gather
    cand_r = jnp.take(radii_s, cidx, axis=0).reshape(b, -1)

    d = _cone_distance_core(cones, pts - cones.apex[:, None, :])
    score = d - cand_r
    keep = (score <= cutoff) & cand_valid
    ranked = jnp.where(keep, score, jnp.inf)
    k_budget = min(k_budget, cand_idx.shape[1])
    neg_top, qidx = jax.lax.top_k(-ranked, k_budget)          # [B, K]
    idx = jnp.take_along_axis(cand_idx, qidx, axis=1)
    valid = jnp.isfinite(-neg_top)
    return idx.astype(jnp.int32), valid


def cluster_overflow(
    cones: TileCones,
    centers: jax.Array,
    radii: jax.Array,
    smooth_k: jax.Array | float,
    clusters: PrimitiveClusters,
    cluster_budget: int,
    mask: Optional[jax.Array] = None,
) -> jax.Array:
    """Per-tile count of qualifying CLUSTERS dropped by the cluster budget.

    Zero ⟹ hierarchical selection sees every primitive flat selection
    would (remaining differences are only the shared K-budget overflow,
    reported by selection_overflow)."""
    bc, br, member_valid = cluster_bounds(clusters, centers, radii, mask)
    cutoff = CULL_MARGIN / smooth_k + cones.origin_spread[:, None]
    coarse = cone_point_distance(cones, bc) - br[None, :]
    keep = (coarse <= cutoff) & jnp.any(member_valid, axis=1)[None, :]
    counts = jnp.sum(keep.astype(jnp.int32), axis=1)
    return jnp.maximum(counts - cluster_budget, 0)


def gather_tile_tables(
    centers: jax.Array,   # [M, 3]
    colors: jax.Array,    # [M, 3]
    radii: jax.Array,     # [M, 1]
    idx: jax.Array,       # [B, K]
    valid: jax.Array,     # [B, K]
):
    """Per-tile primitive tables.

    Returns (centers_t [B,K,3], colors_t [B,K,3], radii_t [B,K],
    c_sq_t [B,K] with 1e30 in invalid slots).
    """
    centers_t = jnp.take(centers, idx, axis=0)                # [B, K, 3]
    colors_t = jnp.take(colors, idx, axis=0)
    radii_t = jnp.take(radii.reshape(-1), idx, axis=0)        # [B, K]
    c_sq = jnp.sum(centers_t * centers_t, axis=2)
    c_sq = jnp.where(valid, c_sq, 1e30)
    return centers_t, colors_t, radii_t, c_sq
