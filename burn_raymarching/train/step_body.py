"""The per-step training computation, shared by every driver.

One function builds the (sample → forward → loss → grad) device step that
both the single-chip Trainer (train/loop.py) and the multi-chip
DistributedTrainer (parallel/distributed.py) scan over. The reference has
exactly one driver (src/bin/train.rs:169-207); keeping ours to one step
body guarantees the sharded path is never a reduced second implementation
of the training semantics (anneals, warm start, culling, fused kernels,
loss) — the axes are the only difference:

  * ``data_axis`` — rays (and the warm-start t cache) are sharded: every
    device samples from its LOCAL pixel shard (the PRNG key is folded with
    the axis index), computes a local loss/grads, and the step pmean's
    them. Dataset shards are equal-sized, so the mean of shard means equals
    the global batch mean.
  * ``model_axis`` — the primitive table is sharded: soft-min / softmax
    compositing combine shards with the two-pass pmax+psum logsumexp
    (render/culled.py, ops/sdf.py), replicated leaves (light, ambient) get
    their partial grads psum'd, and cluster tables arrive in GLOBAL row ids
    (converted to shard-local here). The single-device march kernels cannot
    issue per-iteration collectives: the culled march gathers union tables
    first (sharded_culled_kernel_march), the dense march runs in XLA.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from burn_raymarching.config import TrainConfig
from burn_raymarching.data.dataset import gather_batch, sample_batch_indices
from burn_raymarching.models.scene import (
    SceneParams,
    activate,
    scene_forward,
)
from burn_raymarching.train.loss import compute_loss


def lr_scale_tree(cfg: TrainConfig, stage=None) -> SceneParams:
    """Per-parameter-group LR multipliers as a params-shaped pytree.

    With ``stage`` (a traced int32) and a non-empty
    cfg.lr_scale_centers_stages, the centers multiplier is stage-indexed
    in-graph (clamped to the last entry, so polish's past-the-end stage
    keeps the final value) — the post-merge lr re-tune lever.
    """
    centers = cfg.lr_scale_centers
    if stage is not None and cfg.lr_scale_centers_stages:
        sched = jnp.asarray(cfg.lr_scale_centers_stages, jnp.float32)
        centers = sched[jnp.minimum(stage, len(cfg.lr_scale_centers_stages)
                                    - 1)]
    return SceneParams(
        centers=centers, colors=cfg.lr_scale_colors,
        radii=cfg.lr_scale_radii, light_dir=cfg.lr_scale_light,
        ambient=cfg.lr_scale_light)


def schedule_for_step(cfg: TrainConfig, stage, step):
    """In-graph anneals for a 1-based step (reference train.rs:166-197):
    (progress, smooth_k, uniform_ratio, lr), all traced scalars.

    progress caps at 1 so post-schedule steps (Trainer.polish runs with a
    step offset past the stage end) hold the final annealed values."""
    total_steps = float(cfg.total_steps)
    half_stage = cfg.steps_per_stage // 2
    global_step = (stage * cfg.steps_per_stage + step).astype(jnp.float32)
    progress = jnp.minimum(global_step / total_steps, 1.0)
    smooth_k = cfg.min_smooth_k + (
        cfg.max_smooth_k - cfg.min_smooth_k) * progress
    uniform_ratio = cfg.uniform_ratio_start - (
        (cfg.uniform_ratio_start - cfg.uniform_ratio_end) * progress)
    base_lr = cfg.base_lr * jnp.power(
        jnp.float32(cfg.lr_stage_decay), stage.astype(jnp.float32))
    lr = jnp.where(step > half_stage, base_lr * cfg.lr_midstage_factor,
                   base_lr)
    return progress, smooth_k, uniform_ratio, lr


def subpixel_offsets(ss: int) -> np.ndarray:
    """[ss, 2] fixed sub-pixel sample offsets in [-0.5, 0.5) pixel units.

    Cell-centered regular grid for perfect squares (the variance-optimal
    pattern for an area integral), golden-ratio lattice otherwise — both
    deterministic, so the supersampled forward is a fixed quadrature of
    the pixel footprint rather than per-step noise.
    """
    g = int(round(ss ** 0.5))
    if g * g == ss:
        xs = (np.arange(g) + 0.5) / g - 0.5
        u, v = np.meshgrid(xs, xs)
        return np.stack([u.reshape(-1), v.reshape(-1)], axis=1)
    i = np.arange(ss, dtype=np.float64) + 0.5
    return np.stack([i / ss - 0.5, (i * 0.6180339887498949) % 1.0 - 0.5],
                    axis=1)


def expand_subpixel(ro: jax.Array, rd: jax.Array, ss: int,
                    pixel_angle: float) -> tuple[jax.Array, jax.Array]:
    """[N,3] rays → [N*ss,3]: each ray becomes ``ss`` copies jittered over
    its pixel footprint (``pixel_angle`` radians square), pixel-major so
    sub-rays of one pixel stay adjacent (cull tiles keep their cones).

    The offsets are applied along an orthonormal basis perpendicular to
    the ray itself rather than the camera's exact image axes — the rays in
    the packed dataset carry no camera id, and for the area integral only
    the footprint's size matters, not its in-plane orientation (≤cos(fov/2)
    scale error off-axis). Sub-ray directions are re-normalized.
    """
    off = jnp.asarray(subpixel_offsets(ss) * pixel_angle, rd.dtype)  # [ss,2]
    up = jnp.where(jnp.abs(rd[:, 1:2]) < 0.9,
                   jnp.asarray([0.0, 1.0, 0.0], rd.dtype)[None, :],
                   jnp.asarray([1.0, 0.0, 0.0], rd.dtype)[None, :])
    e1 = jnp.cross(rd, up)
    e1 = e1 / jnp.sqrt(jnp.sum(e1 * e1, axis=1, keepdims=True))
    e2 = jnp.cross(rd, e1)      # unit: rd, e1 orthonormal
    rdj = (rd[:, None, :]
           + off[None, :, 0, None] * e1[:, None, :]
           + off[None, :, 1, None] * e2[:, None, :])    # [N, ss, 3]
    rdj = rdj / jnp.sqrt(jnp.sum(rdj * rdj, axis=2, keepdims=True))
    roj = jnp.broadcast_to(ro[:, None, :], rdj.shape)
    return roj.reshape(-1, 3), rdj.reshape(-1, 3)


def sharded_culled_kernel_march(
    kern: Callable,
    model_axis: str,
    model_size: int,
    ro3: jax.Array,          # [B, T, 3] local tile batch (replicated over
    rd3: jax.Array,          #           the model axis)
    cs: jax.Array,           # [B, K, 3] THIS shard's per-tile top-K table
    rs: jax.Array,           # [B, K]
    qs: jax.Array,           # [B, K] (1e30 in invalid slots)
    smooth_k,
    *,
    num_steps: int,
    normal_eps: float,
    t_init: Optional[jax.Array] = None,
) -> tuple[jax.Array, jax.Array]:
    """Fused-kernel march under an M-SHARDED primitive table.

    The per-iteration sharded march needs the GLOBAL soft-min every step
    (pmax/psum in the XLA twin — 40 collective pairs plus HBM round-trips
    per march). This
    instead exchanges the tiny detached selection TABLES once: an
    all_to_all turns each device's [B, K] shard-local table into its
    [B/S, S·K] tile-slice of the UNION table (the received K-blocks all
    describe the caller's own tile range), each model column marches B/S
    tiles against the union with the single-device fused kernel — zero
    collectives in the loop, per-device march work unchanged at
    (B/S)·(S·K) — and one all_gather redistributes the detached
    (t, normal). The union soft-min is exactly the pmax/psum soft-min
    (same table entries; invalid slots carry zero weight), so semantics
    match the XLA twin up to reduction order.
    """
    b = ro3.shape[0]
    bs = b // model_size

    def to_cols(x):
        return jax.lax.all_to_all(x, model_axis, split_axis=0,
                                  concat_axis=1, tiled=True)

    cs_u, rs_u, qs_u = to_cols(cs), to_cols(rs), to_cols(qs)
    midx = jax.lax.axis_index(model_axis)

    def sl(x):
        return jax.lax.dynamic_slice_in_dim(x, midx * bs, bs, axis=0)

    t0 = None if t_init is None else sl(t_init)
    t_loc, n_loc = kern(sl(ro3), sl(rd3), cs_u, rs_u, qs_u, smooth_k,
                        num_steps=num_steps, normal_eps=normal_eps,
                        t_init=t0)
    t = jax.lax.all_gather(t_loc, model_axis, axis=0, tiled=True)
    normal = jax.lax.all_gather(n_loc, model_axis, axis=0, tiled=True)
    return t, normal


def make_device_step(
    cfg: TrainConfig,
    *,
    march_normal_fn: Callable,
    culled_march_fn: Callable,
    batch: int,
    warm: bool,
    data_axis: Optional[str] = None,
    model_axis: Optional[str] = None,
    model_size: int = 1,
    fold_data_index: bool = True,
) -> Callable:
    """Build device_step(params, key, i, stage, step0, mask, packed,
    fg_indices, n_fg, t_cache, cl_idx, cl_valid) → (loss, grads,
    t_cache_new, lr).

    ``batch`` is the PER-DEVICE batch (cfg.batch_size / data-axis size).
    All array arguments are the device-local shards; anneal scalars are
    derived in-graph from (stage, step0, i) so a whole scan chunk compiles
    into one program. Reference step semantics: train.rs:169-207.
    """

    def device_step(params, key, i, stage, step0, mask, packed, fg_indices,
                    n_fg, t_cache, cl_idx, cl_valid, rep_static=None):
        # 1-based step within the stage (reference train.rs:169).
        step = step0 + i + 1
        progress, smooth_k, uniform_ratio, lr = schedule_for_step(
            cfg, stage, step)

        # Hierarchical culling is enabled by a NON-EMPTY cluster table — a
        # static (shape-level) switch, so both variants jit cleanly.
        use_hier = (cfg.use_culling and cfg.cull_hierarchical
                    and cl_idx.shape[0] > 0)
        clusters_arg = None
        if cl_idx.shape[0] > 0:
            from burn_raymarching.ops.culling import PrimitiveClusters

            if model_axis is not None:
                # Cluster tables arrive in GLOBAL row ids sharded so each
                # shard's clusters reference only its own rows (params are
                # Morton-sorted and the bucket is a multiple of
                # model_size * G — DistributedTrainer guarantees both).
                m_local = params.centers.shape[0]
                cl_idx_local = (cl_idx - jax.lax.axis_index(model_axis)
                                * m_local).astype(jnp.int32)
                clusters_arg = PrimitiveClusters(cl_idx_local, cl_valid)
            else:
                clusters_arg = PrimitiveClusters(cl_idx, cl_valid)
        rep_clusters = clusters_arg if cfg.cluster_repulsion else None
        cull_clusters = clusters_arg if use_hier else None

        if data_axis is not None and fold_data_index:
            # Per-device sub-batch from the LOCAL pixel shard. (A 1-wide
            # data axis skips the fold so a (1, model) mesh samples
            # identically to the single-chip driver — the exact-equivalence
            # hook the tests use.)
            key = jax.random.fold_in(key, jax.lax.axis_index(data_axis))
        rc = cfg.render
        # Pixel-footprint supersampling (RenderConfig.supersample): sample
        # batch/ss UNIQUE pixels, expand each into ss sub-pixel-jittered
        # rays (total ray count unchanged), average the prediction per
        # pixel before the loss. ss == 1 is the reference's point-sampled
        # step, bit-for-bit.
        ss = int(rc.supersample)
        if ss > 1 and batch % ss:
            raise ValueError(f"batch ({batch}) must divide by "
                             f"supersample ({ss})")
        n_unique = batch // ss
        if cfg.sample_mode == "tile":
            # Whole-Morton-block sampling: fg_indices/n_fg arrive at TILE
            # granularity (RayDataset.tile_fg); every sampled tile expands
            # to its cull_tile consecutive pixels, so each cull tile is one
            # compact single-view pixel block regardless of view count.
            tile = cfg.cull_tile
            if n_unique % tile:
                raise ValueError(
                    f"unique pixels/step ({n_unique}) must divide by "
                    f"cull_tile ({tile}) — with supersample, batch must be "
                    f"a multiple of supersample * cull_tile")
            tid = sample_batch_indices(
                key, packed.shape[0] // tile, fg_indices, n_fg,
                n_unique // tile, uniform_ratio)
            idx = (tid[:, None] * tile
                   + jnp.arange(tile, dtype=jnp.int32)[None, :]).reshape(-1)
        else:
            idx = sample_batch_indices(
                key, packed.shape[0], fg_indices, n_fg, n_unique,
                uniform_ratio)
        if cfg.use_culling:
            # Sorted indices → tile-coherent rays. A with-replacement
            # sample is order-free, so the loss is unchanged. (Tile-mode
            # indices are disjoint-or-equal 512-aligned runs: sorting keeps
            # every cull_tile window a single block.)
            idx = jnp.sort(idx)
        ro, rd, tgt = gather_batch(packed, idx)
        if ss > 1:
            # Sub-rays are pixel-major-adjacent, so sorted unique pixels
            # stay tile-coherent after expansion; tgt stays per-pixel.
            ro, rd = expand_subpixel(ro, rd, ss, rc.pixel_angle)

        # The dense march kernel sees one whole table: under an M-sharded
        # table the renderer's own XLA march (pmax/psum soft-min) runs.
        mn_fn = march_normal_fn if model_axis is None else None
        culled_pre = None
        if cfg.use_culling:
            # Detached selection + culled march/normals OUTSIDE the autodiff
            # trace (t and normals carry no gradients by construction,
            # reference renderer_diff.rs:25,41-46); the renderer re-gathers
            # tables from the live params at the same idx for the
            # gradient-carrying tail.
            from burn_raymarching.ops.culling import (
                select_tile_primitives,
                select_tile_primitives_hier,
                tile_cones,
            )
            from burn_raymarching.render.culled import (
                culled_march_normals_xla,
            )

            centers_p, _, radii_p, _, _ = activate(
                jax.lax.stop_gradient(params))
            cones = tile_cones(ro, rd, cfg.cull_tile)
            if cull_clusters is not None:
                idx_t, valid_t = select_tile_primitives_hier(
                    cones, centers_p, radii_p, smooth_k,
                    cfg.cull_budget, cull_clusters,
                    cfg.cull_cluster_budget, mask=mask)
            else:
                idx_t, valid_t = select_tile_primitives(
                    cones, centers_p, radii_p, smooth_k,
                    cfg.cull_budget, mask=mask)
            cs_t = jnp.take(centers_p, idx_t, axis=0)
            rs_t = jnp.take(radii_p.reshape(-1), idx_t, axis=0)
            qs_t = jnp.where(valid_t, jnp.sum(cs_t * cs_t, axis=2), 1e30)
            b_t = batch // cfg.cull_tile
            ro3 = ro.reshape(b_t, cfg.cull_tile, 3)
            rd3 = rd.reshape(b_t, cfg.cull_tile, 3)
            # The march on single-device tables directly; under an
            # M-sharded table, the all_to_all union-table wrapper keeps it
            # (and drops the per-iteration pmax/psum) whenever the tile
            # batch splits evenly over the model axis; the XLA twin with
            # per-step collectives otherwise.
            if model_axis is None:
                kern = culled_march_fn
            elif model_size > 1 and b_t % model_size == 0:
                kern = lambda *a, **kw: sharded_culled_kernel_march(  # noqa: E731
                    culled_march_fn, model_axis, model_size, *a, **kw)
            else:
                kern = lambda *a, **kw: culled_march_normals_xla(  # noqa: E731
                    *a, model_axis=model_axis, **kw)
            if warm:
                t0_flat = jnp.take(t_cache, idx) * cfg.warm_backoff
                if ss > 1:
                    # One cached root per PIXEL: sub-rays share the warm
                    # start, the cache takes back their mean root.
                    t0_flat = jnp.repeat(t0_flat, ss)
                t0 = t0_flat.reshape(b_t, cfg.cull_tile, 1)
                t, normal = kern(
                    ro3, rd3, cs_t, rs_t, qs_t, smooth_k,
                    num_steps=cfg.warm_steps,
                    normal_eps=rc.normal_eps, t_init=t0)
                t_new = t.reshape(-1)
                if ss > 1:
                    t_new = jnp.mean(t_new.reshape(-1, ss), axis=1)
                t_cache = t_cache.at[idx].set(t_new)
            else:
                t, normal = kern(
                    ro3, rd3, cs_t, rs_t, qs_t, smooth_k,
                    num_steps=rc.march_steps,
                    normal_eps=rc.normal_eps)
            culled_pre = (idx_t, valid_t, t, normal)
        elif warm and model_axis is None:
            # Detached dense march outside the grad path. The dense march
            # computes the soft-min over its whole table, so it cannot see a
            # sharded M — the warm dense path is single-device-table only
            # (large-M sharded runs use culling anyway).
            centers_p, _, radii_p, _, _ = activate(
                jax.lax.stop_gradient(params))
            t0 = (jnp.take(t_cache, idx)[:, None] * cfg.warm_backoff)
            if ss > 1:
                t0 = jnp.repeat(t0, ss, axis=0)
            t, normal = march_normal_fn(
                ro, rd, centers_p, radii_p, smooth_k, mask=mask,
                num_steps=cfg.warm_steps, t_init=t0)
            t_new = t[:, 0]
            if ss > 1:
                t_new = jnp.mean(t_new.reshape(-1, ss), axis=1)
            t_cache = t_cache.at[idx].set(t_new)
            t_det, n_det = t, normal
            mn_fn = lambda *a, **kw: (t_det, n_det)  # noqa: E731

        def loss_fn(p):
            if cfg.use_culling:
                from burn_raymarching.render.culled import (
                    render_diff_culled,
                )

                c_p, col_p, r_p, ld_p, amb_p = activate(p)
                out = render_diff_culled(
                    ro, rd, c_p, col_p, r_p, ld_p, amb_p, smooth_k,
                    mask=mask, tile=cfg.cull_tile,
                    k_budget=cfg.cull_budget,
                    clusters=cull_clusters,
                    cluster_budget=cfg.cull_cluster_budget,
                    num_steps=rc.march_steps,
                    softmax_sharpness=rc.softmax_sharpness,
                    mask_sharpness=rc.mask_sharpness,
                    normal_eps=rc.normal_eps,
                    model_axis=model_axis,
                    precomputed=culled_pre,
                    mask_pixel_mult=rc.mask_pixel_mult,
                    pixel_angle=rc.pixel_angle,
                    coverage_mode=rc.coverage_mode)
            else:
                out = scene_forward(p, ro, rd, smooth_k, mask=mask,
                                    model_axis=model_axis,
                                    march_normal_fn=mn_fn,
                                    num_steps=rc.march_steps,
                                    softmax_sharpness=rc.softmax_sharpness,
                                    mask_sharpness=rc.mask_sharpness,
                                    normal_eps=rc.normal_eps,
                                    mask_pixel_mult=rc.mask_pixel_mult,
                                    pixel_angle=rc.pixel_angle,
                                    coverage_mode=rc.coverage_mode)
            if ss > 1:
                # Pixel-footprint integral: average the ss sub-ray
                # predictions per pixel; the loss compares the averaged
                # prediction against the per-pixel target.
                out = jnp.mean(out.reshape(n_unique, ss, 3), axis=1)
            return compute_loss(
                p, out, tgt, progress, mask=mask, cfg=cfg.loss,
                model_axis=model_axis,
                repulsion_clusters=rep_clusters,
                # The chunk-frozen static prep tables are single-device
                # only (the sharded path computes its prep in-step).
                repulsion_static=(rep_static if model_axis is None
                                  else None))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        if data_axis is not None:
            # Equal shard sizes → mean of shard means is the batch mean.
            loss = jax.lax.pmean(loss, data_axis)
            grads = jax.lax.pmean(grads, data_axis)
        if model_axis is not None:
            # Replicated leaves accumulated shard-partial contributions.
            grads = SceneParams(
                centers=grads.centers, colors=grads.colors,
                radii=grads.radii,
                light_dir=jax.lax.psum(grads.light_dir, model_axis),
                ambient=jax.lax.psum(grads.ambient, model_axis))
        return loss, grads, t_cache, lr

    return device_step
