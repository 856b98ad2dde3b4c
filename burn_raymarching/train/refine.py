"""Derivative-free scene refinement (stochastic hill-climbing / annealing).

The round-3 error decomposition (docs/SCALING.md) shows the trained
large-scene recipes leave 69-84% of their residual error in the silhouette
band while every first-order lever is dead there (pathology 3: sub-pixel
geometry is invisible to Adam — the center-gradient valleys are both
narrow and shallow). This module climbs the loss WITHOUT gradients:
perturb a random subset of primitives, keep the proposal iff the
weighted-L1 loss improves on BOTH of two disjoint fixed ray batches.

Measured on the committed round-3 scenes (scripts/exp_geom_jiggle.py):

  * acceptance batches must be LARGE — two 65k-ray batches overfit at c4
    (proposal loss −20% but full PSNR −0.4 dB); 262k-ray batches
    generalize: c4 27.62 → **27.95**, c5 27.47 → 27.56 (+ the caller's
    full-PSNR gate makes the procedure never-regress);
  * proposals run as chunked lax.scan device programs (64/program);
  * the PROPOSAL-LOSS renders cap their cull budget at
    ``TrainConfig.refine_max_budget`` (default ``REFINE_MAX_BUDGET`` =
    2048, the largest budget with a record of running; budget-4096
    proposal programs are not yet tested on the H100) — legitimate
    because the two-batch loss is only an acceptance *estimator*; the
    caller's full-PSNR greedy gate (at the full configured budget) is
    what protects correctness. A log line is emitted whenever the cap
    engages.

Round-5 widenings (VERDICT r4 items 1/6 — the c5 refine curve was still
accepting when round 4 ended, and refine froze colors/light by design
while the compositor mixes color into the same band pixels,
reference src/renderer_diff.rs:65-84):

  * ``sigma_col`` — proposals jointly perturb the selected primitives'
    raw color logits (the silhouette band's residual is a color×coverage
    product, so geometry-only moves leave the color factor stuck);
  * ``light_refine`` — a separate micro-search over the GLOBAL
    (light_dir, ambient) pair under the same two-batch gate;
  * ``fringe_weight`` — band-weighted acceptance: the two-batch loss
    upweights the dim-silhouette fringe (same definition as
    LossConfig.fringe_weight) so acceptance signal concentrates where
    the error decomposition says the error lives, instead of being
    averaged away by already-solved interior pixels;
  * ``accept_temp`` — Metropolis-style annealed acceptance: the chain
    may move uphill with probability exp(-Δ/T) (T annealed per phase,
    final phase greedy), while a separate BEST-seen snapshot only ever
    updates on strict two-batch improvement — the returned params are
    the best snapshot, so the never-regress contract is untouched.

The reference has no counterpart (its 6-7 fat spheres never hit this
regime); structurally this is the "perturbation escape" arm of 3DGS-MCMC
style refinement, gated greedily (or annealed-then-gated) instead of
sampled.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from burn_raymarching.config import TrainConfig
from burn_raymarching.models.scene import SceneParams, activate
from burn_raymarching.render.culled import render_diff_culled

CHUNK = 64   # proposals per device program
# Default proposal-loss cull budget cap (module docstring); not yet tested
# above it on the H100. TrainConfig.refine_max_budget overrides it.
REFINE_MAX_BUDGET = 2048


def _auto_chunk(k_budget: int) -> int:
    """Proposals per device program, scaled so per-program work stays at
    the (CHUNK=64, k_budget=2048) envelope that has a record of running.
    On the default capped budget this is always CHUNK; raising
    ``refine_max_budget`` past 2048 halves the chunk as the budget
    doubles."""
    return max(8, (CHUNK * 2048) // max(int(k_budget), 2048))


@dataclasses.dataclass
class RefineStats:
    loss_before: float
    loss_after: float
    accepted: int
    proposals: int


def sample_fg_tile_batches(dataset, tiles: int, seed: int = 0,
                           tile: int = 512, n_batches: int = 2):
    """``n_batches`` DISJOINT fg-tile ray batches [(ro, rd, tgt), ...].

    Foreground tiles only (RayDataset.tile_fg) — background-only tiles
    carry no silhouette signal. Batches must be disjoint: the second one
    is the hold-out in the acceptance test.
    """
    rng = np.random.default_rng(seed)
    fg_t, n_t = dataset.tile_fg(tile)
    fg_ids = np.asarray(fg_t)[: int(n_t)]
    if fg_ids.size < n_batches:
        raise ValueError(
            f"dataset has {fg_ids.size} fg tiles < n_batches ({n_batches})")
    # Underfilled pools would leave the hold-out batch short or empty (an
    # empty batch NaNs the acceptance mean → silent no-op, ADVICE r3):
    # divide what is available evenly instead.
    tiles = min(tiles, fg_ids.size // n_batches)
    pick = rng.choice(fg_ids, size=n_batches * tiles, replace=False)
    out = []
    for b in range(n_batches):
        ids = pick[b * tiles:(b + 1) * tiles]
        idx = np.sort((ids[:, None] * tile
                       + np.arange(tile)[None, :]).reshape(-1))
        out.append((jnp.asarray(np.asarray(dataset.rays_o)[idx]),
                    jnp.asarray(np.asarray(dataset.rays_d)[idx]),
                    jnp.asarray(np.asarray(dataset.targets)[idx])))
    return out


def _make_loss_on(cfg: TrainConfig, mask, kern, k_budget: int,
                  fringe_weight: float):
    """The acceptance estimator: weighted-L1 on a fixed ray batch through
    the culled renderer (same weights as the final training progress;
    ``fringe_weight`` > 1 additionally upweights the dim-silhouette band,
    LossConfig.fringe_weight semantics)."""
    rc = cfg.render

    def loss_on(params, ro, rd, tgt):
        c, col, r, ld, amb = activate(params)
        out = render_diff_culled(
            ro, rd, c, col, r, ld, amb, jnp.float32(cfg.max_smooth_k),
            mask=mask, tile=cfg.cull_tile, k_budget=k_budget,
            softmax_sharpness=rc.softmax_sharpness,
            mask_sharpness=rc.mask_sharpness,
            coverage_mode=rc.coverage_mode,
            mask_pixel_mult=rc.mask_pixel_mult,
            pixel_angle=rc.pixel_angle,
            march_normal_fn=kern)
        tsum = jnp.sum(tgt, axis=1, keepdims=True)
        obj = tsum > cfg.loss.fg_mask_threshold
        w = jnp.where(obj, cfg.loss.fg_weight, cfg.loss.bg_weight_end)
        if fringe_weight != 1.0:
            fringe = obj & (tsum < cfg.loss.fringe_threshold)
            w = jnp.where(fringe, w * fringe_weight, w)
        return jnp.mean(jnp.abs(out - tgt) * w)

    return loss_on


def _capped_budget(cfg: TrainConfig, log) -> int:
    cap = int(getattr(cfg, "refine_max_budget", REFINE_MAX_BUDGET))
    k_budget = min(cfg.cull_budget, cap)
    if k_budget < cfg.cull_budget:
        log(f"  refine: proposal-loss cull budget capped "
            f"{cfg.cull_budget} -> {k_budget} (refine_max_budget; "
            f"acceptance is an estimator — the caller's full-PSNR gate "
            f"runs at the full budget)")
    return k_budget


def _resolve_chunk(chunk: Optional[int], k_budget: int) -> int:
    if chunk is None:
        return _auto_chunk(k_budget)
    if int(chunk) < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return int(chunk)


def geometry_refine(
    padded: SceneParams,
    mask: jax.Array,
    batches,                       # [(ro, rd, tgt), (ro, rd, tgt)] disjoint
    cfg: TrainConfig,
    *,
    kern=None,                     # the platform's culled march, or None
    proposals: int = 768,
    phases: int = 3,
    frac: float = 0.05,
    sigma_c: float = 0.3,          # in units of each primitive's radius
    sigma_r: float = 0.15,         # raw (softplus-domain) radius noise
    sigma_col: float = 0.0,        # raw (sigmoid-logit) color noise; 0 = off
    accept_temp: float = 0.0,      # Metropolis temperature (x baseline loss)
    fringe_weight: float = 1.0,    # acceptance-loss band weighting
    select_probs: Optional[jax.Array] = None,   # [M_pad] proposal bias
    key: Optional[jax.Array] = None,
    chunk: Optional[int] = None,   # proposals/program; None = _auto_chunk
    log=print,
) -> tuple[SceneParams, RefineStats]:
    """Hill-climb (centers, radii[, colors]) on the two-batch-gated loss.

    Light stays fixed (see ``light_refine`` for the global pair). Each
    phase halves the noise scale. The caller should gate the returned
    params on a FULL evaluation (Trainer.polish-style greedy keep) —
    with adequate batch sizes the gate passes, but it makes the procedure
    never-regress by construction.

    ``select_probs`` biases WHICH primitives each proposal perturbs:
    per-primitive selection probability ∝ the given weights with the
    expected selected count held at ``frac``·N_live (uniform Bernoulli
    when None). Residual-attribution weights
    (train/residual.primitive_residual_scores) concentrate proposals on
    the primitives actually carrying reconstruction error — the
    silhouette band — instead of spending most draws on settled interior
    geometry.

    ``accept_temp`` > 0 runs the proposal CHAIN with Metropolis
    acceptance on the worst-batch loss delta (T = accept_temp × the
    baseline loss, halved each phase, forced greedy in the final phase)
    while a separate best-seen snapshot updates only on strict two-batch
    improvement; the snapshot is what is returned, so annealing only
    widens exploration, never the result.
    """
    (ro_a, rd_a, tgt_a), (ro_b, rd_b, tgt_b) = batches
    k_budget = _capped_budget(cfg, log)
    live = jnp.asarray(mask, jnp.float32)[:, None]
    if select_probs is not None:
        w = jnp.maximum(jnp.asarray(select_probs, jnp.float32), 0.0)
        w = w * live[:, 0]
        n_live = jnp.maximum(jnp.sum(live), 1.0)
        p_sel = jnp.clip(frac * n_live * w
                         / jnp.maximum(jnp.sum(w), 1e-20), 0.0, 1.0)
        p_sel = p_sel[:, None]
    else:
        p_sel = jnp.full((padded.centers.shape[0], 1), frac, jnp.float32)
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)

    loss_on = _make_loss_on(cfg, mask, kern, k_budget, fringe_weight)
    csize = _resolve_chunk(chunk, k_budget)

    def _perturb(params, i, key, sigma_scale):
        """One proposal: Gaussian noise on the selected live primitives'
        centers (radius-scaled), raw radii and (optionally) raw colors."""
        r_phys = jax.nn.softplus(params.radii) + 0.01
        k1, k2, k3, k4 = jax.random.split(jax.random.fold_in(key, i), 4)
        sel = (jax.random.uniform(k1, (params.centers.shape[0], 1))
               < p_sel).astype(jnp.float32) * live
        colors = params.colors
        if sigma_col > 0.0:
            colors = colors + (jax.random.normal(k4, colors.shape)
                               * sigma_col * sigma_scale * sel)
        return SceneParams(
            centers=params.centers
            + jax.random.normal(k2, params.centers.shape)
            * sigma_c * sigma_scale * r_phys * sel,
            colors=colors,
            radii=params.radii
            + jax.random.normal(k3, params.radii.shape)
            * sigma_r * sigma_scale * sel,
            light_dir=params.light_dir, ambient=params.ambient)

    @jax.jit
    def propose_chunk(best, key, sigma_scale):
        """Greedy chain: current == best (accept_temp == 0)."""
        params, best_a, best_b = best

        def prop(carry, i):
            params, best_a, best_b = carry
            cand = _perturb(params, i, key, sigma_scale)
            l_a = loss_on(cand, ro_a, rd_a, tgt_a)
            l_b = loss_on(cand, ro_b, rd_b, tgt_b)
            acc = (l_a < best_a) & (l_b < best_b)
            params = jax.tree.map(lambda a, b: jnp.where(acc, b, a),
                                  params, cand)
            return (params, jnp.where(acc, l_a, best_a),
                    jnp.where(acc, l_b, best_b)), acc

        (params, best_a, best_b), accs = jax.lax.scan(
            prop, (params, best_a, best_b), jnp.arange(csize))
        return (params, best_a, best_b), jnp.sum(accs)

    @jax.jit
    def propose_chunk_annealed(cur, best, key, sigma_scale, temp):
        """Metropolis chain (worst-batch Δ) + strict-improvement best
        snapshot. ``temp`` <= 0 reduces the chain move to greedy."""
        cur_params, cur_a, cur_b = cur
        best_params, best_a, best_b = best

        def prop(carry, i):
            (cur_params, cur_a, cur_b,
             best_params, best_a, best_b) = carry
            ku = jax.random.fold_in(jax.random.fold_in(key, i), 0x7e39)
            cand = _perturb(cur_params, i, key, sigma_scale)
            l_a = loss_on(cand, ro_a, rd_a, tgt_a)
            l_b = loss_on(cand, ro_b, rd_b, tgt_b)
            delta = jnp.maximum(l_a - cur_a, l_b - cur_b)
            u = jax.random.uniform(ku, ())
            mv = (delta < 0.0) | ((temp > 0.0)
                                  & (u < jnp.exp(-delta
                                                 / jnp.maximum(temp, 1e-20))))
            cur_params = jax.tree.map(lambda a, b: jnp.where(mv, b, a),
                                      cur_params, cand)
            cur_a = jnp.where(mv, l_a, cur_a)
            cur_b = jnp.where(mv, l_b, cur_b)
            imp = (l_a < best_a) & (l_b < best_b)
            best_params = jax.tree.map(lambda a, b: jnp.where(imp, b, a),
                                       best_params, cand)
            return (cur_params, cur_a, cur_b, best_params,
                    jnp.where(imp, l_a, best_a),
                    jnp.where(imp, l_b, best_b)), imp

        carry, accs = jax.lax.scan(
            prop, (cur_params, cur_a, cur_b, best_params, best_a, best_b),
            jnp.arange(csize))
        return carry[:3], carry[3:], jnp.sum(accs)

    best_a = jax.jit(lambda p: loss_on(p, ro_a, rd_a, tgt_a))(padded)
    best_b = jax.jit(lambda p: loss_on(p, ro_b, rd_b, tgt_b))(padded)
    l0 = float(best_a)
    best = (padded, best_a, best_b)
    cur = best
    accepted = 0
    total = 0
    for ph in range(phases):
        scale = jnp.float32(0.5 ** ph)
        # Annealed chain temperature: relative to the baseline loss,
        # halved per phase, forced greedy in the final phase so the chain
        # re-converges before the round gate.
        temp = (jnp.float32(accept_temp * l0 * (0.5 ** ph))
                if (accept_temp > 0.0 and ph < phases - 1)
                else jnp.float32(0.0))
        ph_acc = 0
        for _ in range(max(proposals // csize, 1)):
            key, sub = jax.random.split(key)
            if accept_temp > 0.0:
                cur, best, acc = propose_chunk_annealed(
                    cur, best, sub, scale, temp)
            else:
                best, acc = propose_chunk(best, sub, scale)
                cur = best
            ph_acc += int(acc)
            total += csize
        accepted += ph_acc
        log(f"  refine phase {ph}: loss {float(best[1]):.5f}, "
            f"accepted {ph_acc}/{max(proposals // csize, 1) * csize}")
    padded, best_a, best_b = best
    return padded, RefineStats(loss_before=l0, loss_after=float(best_a),
                               accepted=accepted, proposals=total)


def light_refine(
    padded: SceneParams,
    mask: jax.Array,
    batches,
    cfg: TrainConfig,
    *,
    kern=None,
    proposals: int = 64,
    phases: int = 2,
    sigma_dir: float = 0.1,        # raw light_dir noise
    sigma_amb: float = 0.1,        # raw ambient-logit noise
    fringe_weight: float = 1.0,
    key: Optional[jax.Array] = None,
    log=print,
) -> tuple[SceneParams, RefineStats]:
    """Two-batch-gated micro-search over the GLOBAL (light_dir, ambient).

    The pair is first-order-trainable, but after geometry refinement has
    moved silhouettes the shading optimum shifts and Adam is no longer
    running — this closes that gap with the same greedy two-batch gate
    (a handful of proposals; the search space is 4-dimensional).
    Geometry and colors stay fixed. Reference semantics of the pair:
    src/renderer_diff.rs:48-62 (learnable ambient + diffuse blend).
    """
    (ro_a, rd_a, tgt_a), (ro_b, rd_b, tgt_b) = batches
    k_budget = _capped_budget(cfg, log)
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    loss_on = _make_loss_on(cfg, mask, kern, k_budget, fringe_weight)
    csize = min(_auto_chunk(k_budget), proposals)

    @jax.jit
    def propose_chunk(params, best_a, best_b, key, sigma_scale):
        def prop(carry, i):
            params, best_a, best_b = carry
            k1, k2 = jax.random.split(jax.random.fold_in(key, i))
            cand = SceneParams(
                centers=params.centers, colors=params.colors,
                radii=params.radii,
                light_dir=params.light_dir
                + jax.random.normal(k1, params.light_dir.shape)
                * sigma_dir * sigma_scale,
                ambient=params.ambient
                + jax.random.normal(k2, params.ambient.shape)
                * sigma_amb * sigma_scale)
            l_a = loss_on(cand, ro_a, rd_a, tgt_a)
            l_b = loss_on(cand, ro_b, rd_b, tgt_b)
            acc = (l_a < best_a) & (l_b < best_b)
            params = jax.tree.map(lambda a, b: jnp.where(acc, b, a),
                                  params, cand)
            return (params, jnp.where(acc, l_a, best_a),
                    jnp.where(acc, l_b, best_b)), acc

        (params, best_a, best_b), accs = jax.lax.scan(
            prop, (params, best_a, best_b), jnp.arange(csize))
        return params, best_a, best_b, jnp.sum(accs)

    best_a = jax.jit(lambda p: loss_on(p, ro_a, rd_a, tgt_a))(padded)
    best_b = jax.jit(lambda p: loss_on(p, ro_b, rd_b, tgt_b))(padded)
    l0 = float(best_a)
    accepted = 0
    total = 0
    for ph in range(phases):
        scale = jnp.float32(0.5 ** ph)
        ph_acc = 0
        for _ in range(max(proposals // csize, 1)):
            key, sub = jax.random.split(key)
            padded, best_a, best_b, acc = propose_chunk(
                padded, best_a, best_b, sub, scale)
            ph_acc += int(acc)
            total += csize
        accepted += ph_acc
        log(f"  light-refine phase {ph}: loss {float(best_a):.5f}, "
            f"accepted {ph_acc}")
    return padded, RefineStats(loss_before=l0, loss_after=float(best_a),
                               accepted=accepted, proposals=total)
