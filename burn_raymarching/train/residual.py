"""Per-primitive residual attribution for scale-aware density control.

The reference's split rule is an ABSOLUTE radius threshold
(r > 0.25*0.65^stage, src/training.rs:187) — built for its 6-7 fat unit-scale
spheres. On prior-seeded compact clouds (configs 4-5, radii ~0.02-0.1) that
threshold never fires, so the signature grow-by-splitting dynamic is dead in
exactly the regime where the committed runs sit ~2.5-3 dB below their
representational ceiling (VERDICT r2). This module supplies the
replacement signal: attribute the rendered L1 residual to primitives through
the compositor weights (the same quantity 3DGS reads from its view-space
positional gradients), so density control can split WHERE THE ERROR IS,
independent of absolute scale.

For each scored ray i and primitive m in its per-tile top-K table:

    score[m] += softmax_weight[i, m] * coverage[i] * resid[i],
    resid[i]  = sum_c |render(i) - target(i)|

softmax_weight * coverage is exactly d render / d color_m up to the lighting
factor — a first-order "how much of this ray's error is this primitive's to
fix". Scoring runs over a strided subsample of the training pixels at stage
boundaries, entirely detached (no gradients, no effect on the step).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from burn_raymarching.config import TrainConfig
from burn_raymarching.models.scene import SceneParams, activate
from burn_raymarching.ops.culling import (
    select_tile_primitives,
    tile_cones,
)
from burn_raymarching.render.culled import (
    _MASKED_NEG,
    _tile_dists,
    _tile_soft_min,
    culled_march_normals_xla,
)
from burn_raymarching.render.diff import adaptive_coverage


@partial(jax.jit, static_argnames=("cfg", "kern"))
def _score_chunk_culled(padded, mask, ro, rd, tgt, smooth_k,
                        cfg: TrainConfig, kern=None):
    """One pixel chunk → partial scores [m_pad].

    Mirrors render_diff_culled's forward (render/culled.py, reference
    renderer_diff.rs:20-90) but also exposes the compositor weights and
    coverage for the scatter-added attribution. Everything is detached.
    """
    rc = cfg.render
    tile = cfg.cull_tile
    m_pad = padded.centers.shape[0]
    centers_p, colors_p, radii_p, light_dir, ambient = activate(
        jax.lax.stop_gradient(padded))
    cones = tile_cones(ro, rd, tile)
    idx_t, valid_t = select_tile_primitives(
        cones, centers_p, radii_p, smooth_k, cfg.cull_budget, mask=mask)
    cs = jnp.take(centers_p, idx_t, axis=0)
    cols = jnp.take(colors_p, idx_t, axis=0)
    rs = jnp.take(radii_p.reshape(-1), idx_t, axis=0)
    qs = jnp.where(valid_t, jnp.sum(cs * cs, axis=2), 1e30)
    b = ro.shape[0] // tile
    ro3 = ro.reshape(b, tile, 3)
    rd3 = rd.reshape(b, tile, 3)
    march = kern if kern is not None else culled_march_normals_xla
    t, normal = march(ro3, rd3, cs, rs, qs, smooth_k,
                      num_steps=rc.march_steps, normal_eps=rc.normal_eps)
    # Reattachment point + shade tail (renderer_diff.rs:28-90).
    dist_last = _tile_soft_min(ro3 + rd3 * t, cs, rs, qs, smooth_k)
    t_final = t + dist_last
    p_final = ro3 + rd3 * t_final
    ld = light_dir / jnp.sqrt(jnp.sum(light_dir * light_dir))
    diffuse = jnp.maximum(
        jnp.sum(normal * ld[None, None, :], axis=2, keepdims=True), 0.0)
    lighting = ambient + diffuse * (1.0 - ambient)
    dists = _tile_dists(p_final, cs, rs, qs)
    logits = jnp.where(valid_t[:, None, :],
                       dists * (-rc.softmax_sharpness), _MASKED_NEG)
    weights = jax.nn.softmax(logits, axis=2)                    # [B, T, K]
    mixed = jnp.einsum("btk,bkc->btc", weights, cols,
                       precision=jax.lax.Precision.HIGHEST)
    dist_scene = _tile_soft_min(p_final, cs, rs, qs, smooth_k)
    cov = adaptive_coverage(dist_scene, t_final, rc.mask_sharpness,
                            rc.mask_pixel_mult, rc.pixel_angle,
                            coverage_mode=rc.coverage_mode)     # [B, T, 1]
    out = mixed * lighting * cov
    resid = jnp.sum(jnp.abs(out - tgt.reshape(b, tile, 3)), axis=2)  # [B, T]
    contrib = jnp.einsum("btk,bt->bk", weights * cov, resid,
                         precision=jax.lax.Precision.HIGHEST)   # [B, K]
    contrib = jnp.where(valid_t, contrib, 0.0)
    return jnp.zeros((m_pad,), jnp.float32).at[idx_t].add(contrib)


def primitive_residual_scores(
    padded: SceneParams,
    mask: jax.Array,
    dataset,
    cfg: TrainConfig,
    smooth_k: float,
    kern=None,
    max_pixels: Optional[int] = None,
) -> np.ndarray:
    """Residual-attribution scores for every padded primitive slot → [M_pad].

    Scores a strided subsample (≤ ``max_pixels``, default
    DensityConfig.split_score_pixels) of the dataset's pixels in
    batch-size chunks. Requires a tile-coherent (Morton) dataset + culling
    config — the regime scale-aware splitting exists for.
    """
    ds = getattr(dataset, "base", dataset)   # ShardedRayDataset → base
    if max_pixels is None:
        max_pixels = cfg.density.split_score_pixels
    if cfg.batch_size < cfg.cull_tile:
        raise ValueError(
            f"residual scoring needs batch_size ({cfg.batch_size}) >= "
            f"cull_tile ({cfg.cull_tile})")
    chunk = (cfg.batch_size // cfg.cull_tile) * cfg.cull_tile
    n = ds.num_total_pixels
    # Datasets smaller than one batch (smoke tests): clamp the slice to a
    # whole-tile prefix of the available pixels (ADVICE r3).
    chunk = min(chunk, (n // cfg.cull_tile) * cfg.cull_tile)
    if chunk == 0:
        raise ValueError(
            f"dataset has {n} pixels < one cull tile ({cfg.cull_tile})")
    n_chunks = max(n // chunk, 1)
    want = max(int(np.ceil(max_pixels / chunk)), 1)
    stride = max(n_chunks // want, 1)
    m_pad = padded.centers.shape[0]
    sk = jnp.float32(smooth_k)
    scores = jnp.zeros((m_pad,), jnp.float32)
    for ci in range(0, n_chunks, stride):
        start = ci * chunk
        ro = jax.lax.dynamic_slice_in_dim(ds.rays_o, start, chunk)
        rd = jax.lax.dynamic_slice_in_dim(ds.rays_d, start, chunk)
        tgt = jax.lax.dynamic_slice_in_dim(ds.targets, start, chunk)
        scores = scores + _score_chunk_culled(
            padded, mask, ro, rd, tgt, sk, cfg, kern)
    return np.asarray(scores)
