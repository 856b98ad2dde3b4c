"""Multi-stage training driver.

Mirrors the reference's train binary (src/bin/train.rs:23-330): 5 stages x
700 Adam steps, per-stage model + optimizer rebuild (momentum reset), smooth_k
5→32 and uniform_ratio 0.8→0.4 anneals, LR 0.05*0.6^stage with a ×0.2
mid-stage drop, per-stage preview PNGs, prune/split between stages, final
scene.json export.

Differences from the reference:
  * one jitted train step (sampling + forward + loss + Adam) — the entire
    step runs on device; anneal scalars are traced arguments so no recompile;
  * M is padded to power-of-two buckets with a validity mask, bounding
    recompiles to one per bucket change;
  * stage-granular checkpoints (npz of raw params) enable resume — the
    reference loses the run on any crash (SURVEY §5);
  * optional sharded step: rays data-parallel over a device mesh, gradients
    psum'd (see parallel/).
"""

from __future__ import annotations

import os
import time
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from burn_raymarching.config import TrainConfig
from burn_raymarching.data.camera import create_camera_rays
from burn_raymarching.data.dataset import RayDataset
from burn_raymarching.data.image_io import load_image_as_array, save_array_as_image
from burn_raymarching.data.scene_io import export_scene_json, load_cameras
from burn_raymarching.models.scene import (
    SceneParams,
    activate,
    init_scene_params,
    pad_params,
)
from burn_raymarching.render.preview import render_tiled
from burn_raymarching.train.density import prune_and_split
from burn_raymarching.train.optimizer import (
    anneal_for_step,
    lr_for_step,
    make_optimizer,
)
from burn_raymarching.utils.metrics import MetricsLogger
from burn_raymarching.utils.padding import bucket_size


def build_dataset(cfg: TrainConfig) -> RayDataset:
    """Load cameras.json + target images → one flat ray dataset
    (reference train.rs:62-98).

    dataset_order="morton" stores each view's rays in Z-order so that SORTED
    batch indices form compact pixel blocks — the coherence the tile-culled
    step (use_culling) needs. Pure reordering: sampling and loss semantics
    are unchanged.
    """
    cams = load_cameras(cfg.cameras_json)
    # Ray generation: the threaded C++ loader when available (100-view
    # captures take milliseconds instead of a device dispatch per view),
    # JAX fallback otherwise — both verified identical (tests/test_native.py).
    try:
        from burn_raymarching.native import camera_rays_native, is_available

        native = is_available()
    except Exception:
        native = False
    ro_list, rd_list, tgt_list = [], [], []
    for cam in cams:
        if native:
            ro, rd = camera_rays_native(
                cfg.width, cfg.height, cam["origin"], cam["target"],
                cam["fov"])
        else:
            ro, rd = create_camera_rays(
                cfg.width, cfg.height, cam["origin"], cam["target"],
                cam["fov"])
        tgt = load_image_as_array(cam["file"])
        ro_list.append(np.asarray(ro))
        rd_list.append(np.asarray(rd))
        tgt_list.append(tgt)
    ro = np.concatenate(ro_list)
    rd = np.concatenate(rd_list)
    tgt = np.concatenate(tgt_list)
    if cfg.dataset_order == "morton":
        from burn_raymarching.utils.morton import (
            multi_view_morton_permutation,
        )

        perm = multi_view_morton_permutation(cfg.width, cfg.height, len(cams))
        ro, rd, tgt = ro[perm], rd[perm], tgt[perm]
    return RayDataset(ro, rd, tgt, fg_threshold=cfg.fg_pixel_threshold)


class Trainer:
    def __init__(
        self,
        cfg: TrainConfig,
        dataset: RayDataset,
        log: Callable[[str], None] = print,
    ):
        self.cfg = cfg
        self.dataset = dataset
        self.log = log
        # Fail at construction, not after a trained stage (review r3):
        if cfg.density.split_mode == "residual" and not cfg.use_culling:
            raise ValueError('split_mode="residual" requires use_culling '
                             '(it exists for the compact-cloud configs)')
        if (cfg.coverage_mode_stages
                and cfg.coverage_mode_stages[-1] != cfg.render.coverage_mode):
            raise ValueError(
                f"coverage_mode_stages ends with "
                f"{cfg.coverage_mode_stages[-1]!r} but render.coverage_mode "
                f"(used by eval/preview/polish/export) is "
                f"{cfg.render.coverage_mode!r} — they must agree or the "
                f"reported PSNR measures a different forward than the one "
                f"trained")
        if (cfg.mask_sharpness_stages
                and float(cfg.mask_sharpness_stages[-1])
                != cfg.render.mask_sharpness):
            raise ValueError(
                f"mask_sharpness_stages ends with "
                f"{cfg.mask_sharpness_stages[-1]} but render.mask_sharpness "
                f"(used by eval/preview/polish/export) is "
                f"{cfg.render.mask_sharpness} — they must agree")
        if (cfg.supersample_stages
                and int(cfg.supersample_stages[-1]) != cfg.render.supersample):
            raise ValueError(
                f"supersample_stages ends with {cfg.supersample_stages[-1]} "
                f"but render.supersample is {cfg.render.supersample} — the "
                f"schedule must end at the forward the point-sampled "
                f"evaluator measures")
        if (cfg.mask_px_stages
                and float(cfg.mask_px_stages[-1])
                != cfg.render.mask_pixel_mult):
            raise ValueError(
                f"mask_px_stages ends with {cfg.mask_px_stages[-1]} but "
                f"render.mask_pixel_mult is {cfg.render.mask_pixel_mult} — "
                f"they must agree")
        _needs_px = (cfg.render.supersample > 1
                     or any(int(s) > 1 for s in cfg.supersample_stages)
                     or any(float(m) > 0 for m in cfg.mask_px_stages))
        if _needs_px and cfg.render.pixel_angle <= 0.0:
            raise ValueError(
                "supersample/mask_px stages need render.pixel_angle "
                "(2*tan(fov/2)/height) — without it the pixel footprint "
                "is undefined")
        self._io = True   # subclasses gate file writes to host 0
        from burn_raymarching.ops.kernels import select_kernels

        kernels = select_kernels(cfg.use_pallas)
        self.march_normal_fn = kernels.march_normal_fn
        self.culled_march_normal_fn = kernels.culled_march_normal_fn
        self.tx = make_optimizer(cfg)
        self.warm = self._warm_gate()
        # fg-boosted sampling pools: pixel-level (the reference's), or
        # tile-level for Morton-block batches (see config.sample_mode).
        if cfg.sample_mode == "tile":
            if not cfg.use_culling or cfg.dataset_order != "morton":
                raise ValueError('sample_mode="tile" requires use_culling '
                                 'and dataset_order="morton"')
            if cfg.batch_size % cfg.cull_tile:
                raise ValueError("batch_size must divide by cull_tile for "
                                 'sample_mode="tile"')
            fg_t, n_t = dataset.tile_fg(cfg.cull_tile)
            self._sample_fg = (fg_t, jnp.asarray(n_t, jnp.int32))
        else:
            self._sample_fg = (dataset.fg_indices, dataset.n_fg)
        self._chunk = self._resolve_chunk()
        self._step_fn = self._build_step()
        # Per-stage step programs (coverage_mode_stages /
        # mask_sharpness_stages): the render family/sharpness are static
        # parts of the traced step, so each distinct override set gets its
        # own jitted runner, built lazily.
        self._step_fns = {}
        self.loss_history: list[float] = []
        # Stage-guard telemetry (config.stage_guard): how often the in-run
        # guard actually fired this run — the at-scale A/B evidence.
        self.guard_retry_count = 0
        self.guard_boundary_redo_count = 0
        self.metrics = MetricsLogger(cfg.metrics_jsonl)
        self.t_cache = None
        if self.warm:
            self.t_cache = self._init_t_cache()

    def _chunk_target(self) -> int:
        """Auto steps_per_call ceiling: the reference's 100-step log
        cadence (train.rs:200). The sharded driver raises it — each of its
        chunk boundaries is a host round trip (see config.steps_per_call)."""
        return 100

    def _resolve_chunk(self) -> int:
        """steps_per_call resolution: explicit values as given (divisor
        of steps_per_stage or fall back to 1, as before); 0 = the largest
        divisor of steps_per_stage up to the driver's target."""
        cfg = self.cfg
        if cfg.steps_per_call:
            return (cfg.steps_per_call
                    if cfg.steps_per_stage % cfg.steps_per_call == 0
                    else 1)
        best = 1
        for d in range(1, min(self._chunk_target(),
                              cfg.steps_per_stage) + 1):
            if cfg.steps_per_stage % d == 0:
                best = d
        return best

    def _warm_gate(self) -> bool:
        """Warm start runs wherever it is asked for: every platform has a
        fused (t, normal) march, dense and culled (ops/kernels.py)."""
        return self.cfg.warm_start

    def _init_t_cache(self) -> jax.Array:
        return jnp.zeros((self.dataset.num_total_pixels,), jnp.float32)

    def _bucket(self, n: int) -> int:
        """Padded primitive-slot count for n live primitives. Subclasses add
        layout quanta (even model shards, whole cluster groups)."""
        return bucket_size(n)

    def _place(self, padded: SceneParams, mask: jax.Array):
        """Device placement of freshly padded stage params (identity on one
        chip; the sharded driver device_puts with mesh shardings)."""
        return padded, mask

    def _prepare_stage_params(self, params: SceneParams) -> SceneParams:
        """Pre-stage primitive-row normalization (identity here; the sharded
        driver Morton-sorts rows so consecutive cluster groups — and the
        model shards — are spatially coherent). A scene is a set, so any
        reordering is semantics-free; run() calls this BEFORE snapshotting
        the stage-start centers density control diffs against."""
        return params

    def _build_cluster_table(self, padded: SceneParams, mask: jax.Array):
        """(member_idx [C, G], member_valid [C, G]) for hierarchical culling
        / cluster repulsion, or empty tables when neither is on."""
        cfg = self.cfg
        if ((cfg.use_culling and cfg.cull_hierarchical)
                or cfg.cluster_repulsion):
            from burn_raymarching.ops.culling import build_clusters

            cl = build_clusters(np.asarray(padded.centers),
                                mask=np.asarray(mask),
                                group=cfg.cull_cluster_group)
            return cl.member_idx, cl.member_valid
        return jnp.zeros((0, 0), jnp.int32), jnp.zeros((0, 0), bool)

    def _coverage_for_stage(self, stage: int) -> str:
        sched = self.cfg.coverage_mode_stages
        if not sched:
            return self.cfg.render.coverage_mode
        return sched[min(stage, len(sched) - 1)]

    def _render_overrides_for_stage(self, stage: int) -> dict:
        """Per-stage RenderConfig overrides (coverage family + mask
        sharpness schedules), {} when neither schedule is set."""
        out = {}
        if self.cfg.coverage_mode_stages:
            out["coverage_mode"] = self._coverage_for_stage(stage)
        sched = self.cfg.mask_sharpness_stages
        if sched:
            out["mask_sharpness"] = float(
                sched[min(stage, len(sched) - 1)])
        sched = self.cfg.supersample_stages
        if sched:
            out["supersample"] = int(sched[min(stage, len(sched) - 1)])
        sched = self.cfg.mask_px_stages
        if sched:
            out["mask_pixel_mult"] = float(sched[min(stage, len(sched) - 1)])
        return out

    def _step_for_stage(self, stage: int):
        """The stage's jitted step runner (one per distinct per-stage
        render override set).

        Without schedules this is exactly ``self._step_fn`` — callers that
        rebuild it in place (kernel swaps in tests/benchmarks) keep
        working."""
        over = self._render_overrides_for_stage(stage)
        # Drop overrides equal to the base config so stages matching it
        # (e.g. the final stage of a schedule that ends at the base values)
        # reuse the prebuilt program instead of re-compiling an identical
        # one (full-step compiles are minutes-scale cold here).
        base = self.cfg.render
        over = {k: v for k, v in over.items() if getattr(base, k) != v}
        if not over:
            return self._step_fn
        key = tuple(sorted(over.items()))
        if key not in self._step_fns:
            self._step_fns[key] = self._build_step(render_overrides=over)
        return self._step_fns[key]

    def _stage_cfg(self, render_overrides: Optional[dict]) -> TrainConfig:
        """cfg with per-stage render fields overridden (step building)."""
        import dataclasses

        if not render_overrides:
            return self.cfg
        return dataclasses.replace(
            self.cfg,
            render=dataclasses.replace(self.cfg.render, **render_overrides))

    def _build_step(self, render_overrides: Optional[dict] = None):
        """Jitted multi-step runner: ``steps_per_call`` training steps chained
        with lax.scan in ONE device program.

        The per-step computation lives in train/step_body.make_device_step
        (shared verbatim with the sharded driver). Anneal scalars (progress,
        smooth_k, uniform_ratio — reference train.rs:170-176) and the
        mid-stage LR drop (train.rs:193-197) are computed in-graph from the
        step index, so a whole chunk needs a single dispatch.
        """
        from burn_raymarching.train.step_body import (
            lr_scale_tree,
            make_device_step,
        )

        cfg = self._stage_cfg(render_overrides)
        device_step = make_device_step(
            cfg, march_normal_fn=self.march_normal_fn,
            culled_march_fn=self.culled_march_normal_fn,
            batch=cfg.batch_size, warm=self.warm)

        @jax.jit
        def run_chunk(params, opt_state, key, mask, packed, fg_indices, n_fg,
                      t_cache, stage, step0, cl_member_idx, cl_member_valid):
            lr_scales = lr_scale_tree(cfg, stage)
            # Freeze the repulsion prep's non-differentiable half ONCE per
            # chunk (top-k neighbors, validity, counts, far weights —
            # train/loss.RepulsionStatic): recomputing it every step costs
            # step time while carrying no gradients;
            # only WHICH cluster pairs are near vs monopole lags by a
            # chunk (~100 steps at lr_centers ≲ 1e-3·base_lr).
            rep_static = None
            if cfg.cluster_repulsion and cl_member_idx.shape[0] > 0:
                from burn_raymarching.ops.culling import (
                    PrimitiveClusters,
                )
                from burn_raymarching.train.loss import (
                    build_repulsion_static,
                )

                rep_static = build_repulsion_static(
                    params.centers,
                    PrimitiveClusters(cl_member_idx, cl_member_valid),
                    mask)

            def one_step(carry, i):
                params, opt_state, t_cache = carry
                k = jax.random.fold_in(key, i)
                loss, grads, t_cache, lr = device_step(
                    params, k, i, stage, step0, mask, packed, fg_indices,
                    n_fg, t_cache, cl_member_idx, cl_member_valid,
                    rep_static=rep_static)
                updates, opt_state = self.tx.update(grads, opt_state, params)
                params = jax.tree.map(lambda p, u, s: p - lr * s * u, params,
                                      updates, lr_scales)
                return (params, opt_state, t_cache), loss

            (params, opt_state, t_cache), losses = jax.lax.scan(
                one_step, (params, opt_state, t_cache),
                jnp.arange(self._chunk), unroll=cfg.scan_unroll)
            return params, opt_state, t_cache, losses

        return run_chunk

    # ------------------------------------------------------------------ #

    def run_stage(
        self,
        params: SceneParams,
        stage: int,
        key: jax.Array,
        num_steps: Optional[int] = None,
        step_offset: int = 0,
    ) -> tuple[SceneParams, jax.Array, jax.Array]:
        """One generation of optimization on padded params.

        Returns (padded params, mask, last loss). Reference train.rs:138-207.
        ``step_offset`` shifts the in-stage step counter (polish() uses it to
        pin the anneals past the schedule end).
        """
        cfg = self.cfg
        m_pad = self._bucket(params.n)
        padded, mask = pad_params(params, m_pad)
        padded, mask = self._place(padded, mask)
        opt_state = self.tx.init(padded)
        ds = self.dataset
        steps = num_steps if num_steps is not None else cfg.steps_per_stage
        chunk = self._chunk if steps % self._chunk == 0 else 1
        if chunk != self._chunk:
            raise ValueError(
                f"steps ({steps}) must be divisible by steps_per_call "
                f"({self._chunk})")
        loss = jnp.zeros(())
        if self.warm:
            self.prefill_t_cache(
                padded, mask,
                anneal_for_step(cfg, stage, 1 + step_offset)[1])
        t_cache = (self.t_cache if self.t_cache is not None
                   else jnp.zeros((0,), jnp.float32))
        # Hierarchical culling: Morton cluster membership refreshed per
        # stage from the stage-start centers (like the reference's own
        # host-side density control); in-step bounds track live centers.
        cl_idx, cl_valid = self._build_cluster_table(padded, mask)
        t0 = time.time()
        stage_arr = jnp.asarray(stage, jnp.int32)
        step_fn = self._step_for_stage(stage)
        for start in range(0, steps, chunk):
            key, sub = jax.random.split(key)
            padded, opt_state, t_cache, losses = step_fn(
                padded, opt_state, sub, mask, ds.packed, self._sample_fg[0],
                self._sample_fg[1], t_cache, stage_arr,
                jnp.asarray(start + step_offset, jnp.int32),
                cl_idx, cl_valid,
            )
            step = start + chunk
            if step % 100 == 0 or step == steps:
                loss = losses[-1]
                lv = float(loss)
                self.loss_history.append(lv)
                _, smooth_k, _ = anneal_for_step(cfg, stage,
                                                 step + step_offset)
                rate = step * cfg.batch_size / (time.time() - t0)
                self.log(
                    f"  Step {step} | Loss: {lv:.5f} | k: {smooth_k:.1f}"
                    f" | {rate:,.0f} rays/s"
                )
                self.metrics.log(stage=stage, step=step, loss=lv,
                                 smooth_k=round(smooth_k, 2),
                                 n_primitives=int(np.asarray(mask).sum()),
                                 rays_per_s=round(rate))
        if self.warm:
            self.t_cache = t_cache
        return padded, mask, loss

    def polish(
        self,
        padded: SceneParams,
        mask: jax.Array,
        rounds: int = 2,
        key: Optional[jax.Array] = None,
        export: bool = True,
        cameras: Optional[list] = None,
        targets: Optional[list] = None,
    ) -> tuple[SceneParams, jax.Array]:
        """Post-final refinement: extra last-stage optimization rounds on the
        final primitive set, no density control, GREEDY by PSNR.

        Each round re-runs ``run_stage`` with the anneals PINNED at their
        final values (smooth_k = max, uniform_ratio = end, post-drop LR —
        via a step offset past the schedule end) and a fresh Adam (a warm
        restart). A round is kept only if it improves mean PSNR on the
        training views, so polish never regresses; round outcomes vary
        ±0.3 dB with the restart key, and the best rounds measured on the
        bundled dataset lift turbo runs past the reference's committed
        scene (33.05 dB). The reference itself always stops at the stage
        budget (train.rs:128-129).

        Re-exports scene.json and a ``final_polished.png`` preview when
        ``export`` (matching what ``run`` wrote for the unpolished scene).
        """
        from burn_raymarching.train.evaluate import evaluate_views

        cfg = self.cfg
        if key is None:
            key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 0x90115)
        if cameras is None:
            from burn_raymarching.data.scene_io import load_cameras

            cameras = load_cameras(cfg.cameras_json)
            targets = [load_image_as_array(c["file"]) for c in cameras]

        def psnr(p, m):
            return evaluate_views(
                p, cameras, targets, cfg.width, cfg.height, mask=m,
                smooth_k=cfg.max_smooth_k,
                march_normal_fn=self.march_normal_fn,
                softmax_sharpness=cfg.render.softmax_sharpness,
                mask_sharpness=cfg.render.mask_sharpness,
                cull=self._cull_render(),
                mask_pixel_mult=cfg.render.mask_pixel_mult,
                pixel_angle=cfg.render.pixel_angle,
                coverage_mode=cfg.render.coverage_mode)["mean"]

        best_psnr = psnr(padded, mask)
        self.log(f"Polish baseline: PSNR {best_psnr:.2f}")
        n = int(np.asarray(mask).sum())
        for r in range(rounds):
            key, sub = jax.random.split(key)
            cand, cand_mask, _ = self.run_stage(
                self._unpad(padded, n), cfg.stages - 1, sub,
                step_offset=cfg.steps_per_stage)
            cand_psnr = psnr(cand, cand_mask)
            kept = cand_psnr > best_psnr
            self.log(f"=== Polish round {r + 1}/{rounds}: PSNR "
                     f"{cand_psnr:.2f} ({'kept' if kept else 'reverted'}) "
                     f"===")
            if kept:
                best_psnr, padded, mask = cand_psnr, cand, cand_mask
        if export and self._io:
            export_scene_json(padded, cfg.scene_json, mask=np.asarray(mask))
            self.log(f"  => Saved polished scene to {cfg.scene_json} "
                     f"(PSNR {best_psnr:.2f})")
            self.save_preview(padded, mask,
                              os.path.join(cfg.steps_dir,
                                           "final_polished.png"))
        return padded, mask

    def refine_geometry(
        self,
        padded: SceneParams,
        mask: jax.Array,
        rounds: int = 1,
        proposals: int = 768,
        phases: int = 3,
        frac: float = 0.05,
        tiles: int = 512,
        proposal_bias: str = "uniform",   # "uniform" | "residual"
        sigma_c: float = 0.3,             # center noise (x primitive radius)
        sigma_r: float = 0.15,            # raw radius noise
        sigma_col: float = 0.0,           # joint color-logit proposals
        accept_temp: float = 0.0,         # Metropolis chain temperature
        fringe_weight: float = 1.0,       # band-weighted acceptance loss
        light_proposals: int = 0,         # global light/ambient micro-search
        key: Optional[jax.Array] = None,
        chunk: Optional[int] = None,      # proposals/program (None = auto)
        export: bool = True,
        cameras: Optional[list] = None,
        targets: Optional[list] = None,
    ) -> tuple[SceneParams, jax.Array]:
        """Derivative-free geometry refinement, greedily PSNR-gated.

        Runs train/refine.geometry_refine (stochastic hill-climbing on
        centers/radii — and colors when ``sigma_col`` > 0 — against two
        disjoint fg-tile ray batches), optionally followed by
        train/refine.light_refine (``light_proposals`` > 0: the global
        light_dir/ambient pair under the same gate), and keeps a
        round only if mean train-view PSNR improves — the same
        never-regress contract as ``polish``. Each round samples FRESH
        acceptance batches, so later rounds can move primitives the earlier
        batches did not constrain. Measured on the committed round-3
        scenes: c4 27.62 → 27.95, c5 +0.09 (scripts/exp_geom_jiggle.py,
        runs/*/refine.json); round 4's gated alternation lifted c4 to
        28.39 and c5 to 27.98. No reference counterpart (its 6-7 fat
        spheres never reach this regime).

        ``fringe_weight`` > 1 applies LossConfig.fringe_weight semantics to
        the ACCEPTANCE loss (the ±2 px silhouette band carries 74% of the
        residual — runs/c4_headline/error_decomp.json); ``accept_temp`` > 0
        runs the annealed Metropolis chain (best-snapshot result, see
        train/refine.py).

        Requires the tile-culled configuration (the regime it exists for:
        compact many-primitive clouds trained with use_culling).
        """
        from burn_raymarching.train.evaluate import evaluate_views
        from burn_raymarching.train.refine import (
            geometry_refine,
            light_refine,
            sample_fg_tile_batches,
        )

        cfg = self.cfg
        if not cfg.use_culling or cfg.dataset_order != "morton":
            raise ValueError(
                "refine_geometry needs use_culling + dataset_order='morton' "
                "(fg-tile acceptance batches + the culled renderer)")
        if key is None:
            key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 0xEF1E)
        if cameras is None:
            cameras = load_cameras(cfg.cameras_json)
            targets = [load_image_as_array(c["file"]) for c in cameras]

        def psnr(p, m):
            return evaluate_views(
                p, cameras, targets, cfg.width, cfg.height, mask=m,
                smooth_k=cfg.max_smooth_k,
                march_normal_fn=self.march_normal_fn,
                softmax_sharpness=cfg.render.softmax_sharpness,
                mask_sharpness=cfg.render.mask_sharpness,
                cull=self._cull_render(),
                mask_pixel_mult=cfg.render.mask_pixel_mult,
                pixel_angle=cfg.render.pixel_angle,
                coverage_mode=cfg.render.coverage_mode)["mean"]

        best_psnr = psnr(padded, mask)
        self.log(f"Refine baseline: PSNR {best_psnr:.2f}")
        ds = getattr(self.dataset, "base", self.dataset)
        for r in range(rounds):
            key, sub = jax.random.split(key)
            batches = sample_fg_tile_batches(
                ds, tiles=tiles, seed=cfg.seed + 7919 * (r + 1),
                tile=cfg.cull_tile)
            select_probs = None
            if proposal_bias == "residual":
                # Concentrate proposals on the primitives carrying the
                # residual error (recomputed per round — geometry moves).
                from burn_raymarching.train.residual import (
                    primitive_residual_scores,
                )

                select_probs = jnp.asarray(primitive_residual_scores(
                    padded, mask, ds, cfg, cfg.max_smooth_k,
                    kern=self.culled_march_normal_fn))
            elif proposal_bias != "uniform":
                raise ValueError(f"unknown proposal_bias {proposal_bias!r}")
            cand, stats = geometry_refine(
                padded, mask, batches, cfg,
                kern=self.culled_march_normal_fn,
                proposals=proposals, phases=phases, frac=frac,
                sigma_c=sigma_c, sigma_r=sigma_r,
                sigma_col=sigma_col, accept_temp=accept_temp,
                fringe_weight=fringe_weight,
                select_probs=select_probs,
                key=sub, chunk=chunk, log=self.log)
            n_acc, n_prop = stats.accepted, stats.proposals
            if light_proposals > 0:
                key, sub = jax.random.split(key)
                cand, lstats = light_refine(
                    cand, mask, batches, cfg,
                    kern=self.culled_march_normal_fn,
                    proposals=light_proposals,
                    fringe_weight=fringe_weight, key=sub, log=self.log)
                n_acc += lstats.accepted
                n_prop += lstats.proposals
            cand_psnr = psnr(cand, mask)
            kept = cand_psnr > best_psnr
            self.log(f"=== Refine round {r + 1}/{rounds}: PSNR "
                     f"{cand_psnr:.2f} ({n_acc}/{n_prop} "
                     f"proposals, {'kept' if kept else 'reverted'}) ===")
            if kept:
                best_psnr, padded = cand_psnr, cand
        if export and self._io:
            export_scene_json(padded, cfg.scene_json, mask=np.asarray(mask))
            self.log(f"  => Saved refined scene to {cfg.scene_json} "
                     f"(PSNR {best_psnr:.2f})")
        return padded, mask

    def prefill_t_cache(self, padded, mask, smooth_k):
        """Full cold march over every dataset pixel → fresh t cache.

        One-time ~(P/B) march batches per stage; every training step then
        marches only cfg.warm_steps from the cached roots.
        """
        cfg = self.cfg
        ds = self.dataset
        centers_p, _, radii_p, _, _ = activate(padded)
        culled = cfg.use_culling
        chunks = []
        chunk = cfg.batch_size
        n = ds.num_total_pixels
        for start in range(0, n, chunk):
            end = min(start + chunk, n)
            ro = jax.lax.dynamic_slice_in_dim(ds.rays_o, start, end - start)
            rd = jax.lax.dynamic_slice_in_dim(ds.rays_d, start, end - start)
            if culled:
                t_flat = self._culled_cold_march(ro, rd, centers_p, radii_p,
                                                 mask, smooth_k)
            else:
                t, _ = self.march_normal_fn(ro, rd, centers_p, radii_p,
                                            jnp.float32(smooth_k), mask=mask)
                t_flat = t[:, 0]
            chunks.append(t_flat)
        self.t_cache = jnp.concatenate(chunks)

    def _culled_cold_march(self, ro, rd, centers_p, radii_p, mask, smooth_k):
        """Full cold march of one pixel chunk through the culled kernel
        (flat selection — equivalent to hierarchical whenever the cluster
        budget covers the qualifying set, and always conservative)."""
        from burn_raymarching.ops.culling import (
            select_tile_primitives,
            tile_cones,
        )

        cfg = self.cfg
        n = ro.shape[0]
        tile = cfg.cull_tile
        n_pad = ((n + tile - 1) // tile) * tile
        if n_pad != n:
            ro = jnp.concatenate([ro, jnp.repeat(ro[-1:], n_pad - n, axis=0)])
            rd = jnp.concatenate([rd, jnp.repeat(rd[-1:], n_pad - n, axis=0)])
        k_val = jnp.float32(smooth_k)
        cones = tile_cones(ro, rd, tile)
        idx_t, valid_t = select_tile_primitives(
            cones, centers_p, radii_p, k_val, cfg.cull_budget, mask=mask)
        cs = jnp.take(centers_p, idx_t, axis=0)
        rs = jnp.take(radii_p.reshape(-1), idx_t, axis=0)
        qs = jnp.where(valid_t, jnp.sum(cs * cs, axis=2), 1e30)
        b = n_pad // tile
        t, _ = self.culled_march_normal_fn(
            ro.reshape(b, tile, 3), rd.reshape(b, tile, 3), cs, rs, qs,
            k_val, num_steps=cfg.render.march_steps,
            normal_eps=cfg.render.normal_eps)
        return t.reshape(-1)[:n]

    def _unpad(self, padded: SceneParams, n: int) -> SceneParams:
        return SceneParams(
            centers=padded.centers[:n],
            colors=padded.colors[:n],
            radii=padded.radii[:n],
            light_dir=padded.light_dir,
            ambient=padded.ambient,
        )

    def _cull_render(self):
        """CullRender options mirroring the training-step culling, or None.

        Inference-side culling keeps large-M previews/polish evals tractable
        (the dense [chunk, M] march is minutes per 512² view at M≈50k).
        Flat selection (no cluster table) — always conservative."""
        cfg = self.cfg
        if not cfg.use_culling:
            return None
        from burn_raymarching.render.preview import CullRender

        return CullRender(tile=cfg.cull_tile, k_budget=cfg.cull_budget,
                          march_normal_fn=self.culled_march_normal_fn)

    def save_preview(self, padded, mask, path: str):
        if not self._io:
            return
        cfg = self.cfg
        ro, rd = create_camera_rays(
            cfg.width, cfg.height, [0.0, 0.0, -2.5], [0.0, 0.0, 0.0], 50.0
        )
        img = render_tiled(padded, ro, rd, smooth_k=cfg.max_smooth_k,
                           mask=mask, chunk=cfg.preview_chunk,
                           march_normal_fn=self.march_normal_fn,
                           softmax_sharpness=cfg.render.softmax_sharpness,
                           mask_sharpness=cfg.render.mask_sharpness,
                           cull=self._cull_render(),
                           order_wh=(cfg.width, cfg.height),
                           mask_pixel_mult=cfg.render.mask_pixel_mult,
                           pixel_angle=cfg.render.pixel_angle,
                           coverage_mode=cfg.render.coverage_mode)
        save_array_as_image(img, cfg.width, cfg.height, path)
        self.log(f"Saved image to {path}")

    # --- stage guard (config.stage_guard) ------------------------------- #

    _guard_eval = None

    def _guard_psnr(self, padded: SceneParams, mask: jax.Array) -> float:
        """Mean train-view PSNR under the FINAL render config — the
        stage-invariant health metric the in-run guard compares."""
        from burn_raymarching.train.evaluate import evaluate_views

        cfg = self.cfg
        if self._guard_eval is None:
            cams = load_cameras(cfg.cameras_json)
            if cfg.stage_guard_views and cfg.stage_guard_views < len(cams):
                stride = max(len(cams) // cfg.stage_guard_views, 1)
                cams = cams[::stride][: cfg.stage_guard_views]
            tgts = [load_image_as_array(c["file"]) for c in cams]
            self._guard_eval = (cams, tgts)
        cams, tgts = self._guard_eval
        return evaluate_views(
            padded, cams, tgts, cfg.width, cfg.height, mask=mask,
            smooth_k=cfg.max_smooth_k, chunk=16384,
            march_normal_fn=self.march_normal_fn,
            softmax_sharpness=cfg.render.softmax_sharpness,
            mask_sharpness=cfg.render.mask_sharpness,
            cull=self._cull_render(),
            mask_pixel_mult=cfg.render.mask_pixel_mult,
            pixel_angle=cfg.render.pixel_angle,
            coverage_mode=cfg.render.coverage_mode)["mean"]

    def _guarded_boundary(self, prev: dict, attempt: int) -> tuple[
            SceneParams, float]:
        """Density control with the boundary guard: run prune/split/merge
        from the previous ACCEPTED stage result with an (attempt, redo)-
        salted rng, measure the next generation's PSNR, and re-roll when
        the boundary alone costs more than stage_guard_boundary_db —
        measured collapse/underperformer trajectories lose 1.3-2.2 dB at
        a boundary (a bad stochastic split draw, training.rs:191-221)
        before the next stage ever runs, while healthy boundaries cost
        0-0.5 dB. Returns (next params, their PSNR); keeps the best roll
        even if every roll fails the bar."""
        cfg = self.cfg
        stage = prev["stage"]
        best = None
        for redo in range(cfg.stage_guard_retries + 1):
            rng = np.random.default_rng((cfg.seed, stage, attempt, redo))
            cand = self._density_control(
                prev["padded"], prev["mask"], prev["n_live"],
                prev["init_centers"], stage, rng)
            cpad, cmask = self._place(*pad_params(cand,
                                                  self._bucket(cand.n)))
            p = self._guard_psnr(cpad, cmask)
            if best is None or p > best[0]:
                best = (p, cand)
            if p >= prev["psnr"] - cfg.stage_guard_boundary_db:
                break
            self.guard_boundary_redo_count += 1
            self.log(f"  !! stage guard: boundary after stage {stage} cost "
                     f"{prev['psnr'] - p:.2f} dB "
                     f"({prev['psnr']:.2f} -> {p:.2f}) — re-rolling density "
                     f"control ({redo + 1}/{cfg.stage_guard_retries + 1})")
            self.metrics.log(stage=stage, guard_boundary_psnr=round(p, 3),
                             guard_boundary_redo=redo)
        return best[1], best[0]

    def _run_guarded(self, params: SceneParams, key: jax.Array,
                     start_stage: int) -> tuple[SceneParams, jax.Array]:
        """The multi-stage loop with the in-run collapse guard
        (config.stage_guard).

        The density-control trajectory is stochastic and occasionally
        collapses a run (runaway splitting: runs/r3_hw:turbo_seeds — 2/10
        turbo seeds end 24-30 dB with N 10-12 instead of 32.8-33.05 with
        N 6-7; a further seed underperforms ~1 dB through two expensive
        boundaries). Measured on those trajectories, a failing stage fails
        DETERMINISTICALLY under restart-key retries — the damage is in the
        stage's ENTRY params, i.e. the preceding stochastic prune/split
        draw. The guard therefore retries the (boundary, stage) pair
        jointly: a stage that fails to improve train-view PSNR by
        stage_guard_min_gain_db is re-run from a FRESH density-control
        roll of the previous accepted result (plus a fresh restart key),
        and the boundary itself re-rolls immediately when it alone costs
        more than stage_guard_boundary_db. Best candidates are kept at
        both levels, so the guard never returns worse than unguarded. The
        reference has no counterpart — its committed scene is itself one
        selected run of the same stochastic pipeline (training.rs:191-199
        is the stochastic split)."""
        cfg = self.cfg
        padded = mask = None
        prev = None                       # accepted previous-stage state
        entry, entry_psnr = params, None  # current stage entry params
        for stage in range(start_stage, cfg.stages):
            self.log(f"=== Stage {stage + 1}/{cfg.stages} "
                     f"(N = {entry.n}) ===")
            key, key_stage = jax.random.split(key)
            best = None
            for attempt in range(cfg.stage_guard_retries + 1):
                if attempt > 0 and prev is not None:
                    entry, entry_psnr = self._guarded_boundary(prev, attempt)
                params_s = self._prepare_stage_params(entry)
                init_centers = np.asarray(params_s.centers)
                if entry_psnr is None:
                    pre_p, pre_m = self._place(*pad_params(
                        params_s, self._bucket(params_s.n)))
                    entry_psnr = self._guard_psnr(pre_p, pre_m)
                padded_c, mask_c, _ = self.run_stage(
                    params_s, stage, jax.random.fold_in(key_stage, attempt))
                psnr_post = self._guard_psnr(padded_c, mask_c)
                self.metrics.log(stage=stage,
                                 guard_psnr_pre=round(entry_psnr, 3),
                                 guard_psnr_post=round(psnr_post, 3),
                                 guard_attempt=attempt)
                if best is None or psnr_post > best[0]:
                    best = (psnr_post, padded_c, mask_c, params_s,
                            init_centers)
                if psnr_post >= entry_psnr + cfg.stage_guard_min_gain_db:
                    self.log(f"  stage guard: {entry_psnr:.2f} -> "
                             f"{psnr_post:.2f} dB"
                             + (f" (attempt {attempt} recovered)" if attempt
                                else ""))
                    break
                retryable = attempt < cfg.stage_guard_retries
                if retryable:
                    self.guard_retry_count += 1
                self.log(f"  !! stage guard: stage {stage} PSNR "
                         f"{psnr_post:.2f} < entry {entry_psnr:.2f} "
                         f"{cfg.stage_guard_min_gain_db:+g} — "
                         f"{'retrying (fresh boundary + key)' if retryable else 'keeping best attempt'} "
                         f"({attempt + 1}/{cfg.stage_guard_retries + 1})")
            psnr_stage, padded, mask, params_s, init_centers = best
            if stage == cfg.stages - 1:
                self.log("🎉 Final Stage Complete! Exporting results...")
                if self._io:
                    export_scene_json(padded, cfg.scene_json,
                                      mask=np.asarray(mask))
                self.log(f"  => Saved to {cfg.scene_json} "
                         f"(N = {params_s.n})")
                self.save_preview(padded, mask,
                                  os.path.join(cfg.steps_dir, "final_1.png"))
                break
            self.save_preview(
                padded, mask,
                os.path.join(cfg.steps_dir, f"stage_{stage}.png"))
            prev = {"padded": padded, "mask": mask, "n_live": params_s.n,
                    "init_centers": init_centers, "psnr": psnr_stage,
                    "stage": stage}
            entry, entry_psnr = self._guarded_boundary(prev, 0)
            self.save_checkpoint(stage + 1, entry, key)
        return padded, mask

    def _ckpt_path(self, stage: int) -> Optional[str]:
        if not self.cfg.checkpoint_dir:
            return None
        return os.path.join(self.cfg.checkpoint_dir, f"stage_{stage}.npz")

    def save_checkpoint(self, stage: int, params: SceneParams, key):
        """Stage-boundary checkpoint of RAW next-generation params — the
        resume point the reference lacks (SURVEY §5 failure recovery)."""
        path = self._ckpt_path(stage)
        if not path or not self._io:
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(
            path,
            stage=stage,
            centers=np.asarray(params.centers),
            colors=np.asarray(params.colors),
            radii=np.asarray(params.radii),
            light_dir=np.asarray(params.light_dir),
            ambient=np.asarray(params.ambient),
            key=np.asarray(key),
        )

    def latest_checkpoint(self) -> Optional[tuple[int, SceneParams, jax.Array]]:
        if not self.cfg.checkpoint_dir or not os.path.isdir(self.cfg.checkpoint_dir):
            return None
        best = None
        for f in os.listdir(self.cfg.checkpoint_dir):
            if f.startswith("stage_") and f.endswith(".npz"):
                s = int(f[len("stage_"):-len(".npz")])
                best = max(best, s) if best is not None else s
        if best is None:
            return None
        d = np.load(self._ckpt_path(best))
        params = SceneParams(
            centers=jnp.asarray(d["centers"]),
            colors=jnp.asarray(d["colors"]),
            radii=jnp.asarray(d["radii"]),
            light_dir=jnp.asarray(d["light_dir"]),
            ambient=jnp.asarray(d["ambient"]),
        )
        return best, params, jnp.asarray(d["key"])

    # ------------------------------------------------------------------ #

    def run(self, resume: bool = False) -> tuple[SceneParams, jax.Array]:
        """Full multi-stage run → (final padded params, mask).

        Reference train.rs:101-330.
        """
        cfg = self.cfg
        key = jax.random.PRNGKey(cfg.seed)
        rng = np.random.default_rng(cfg.seed)
        if cfg.init_layout == "cloud":
            from burn_raymarching.models.scene import (
                init_scene_params_cloud,
            )

            points = None
            if cfg.init_points:
                import json

                with open(cfg.init_points) as f:
                    points = np.asarray(
                        json.load(f)["points"], np.float32).reshape(-1, 3)
            params = init_scene_params_cloud(
                cfg.init_n, seed=cfg.seed, extent=cfg.init_cloud_extent,
                radius=cfg.init_cloud_radius,
                ambient_logit=cfg.init_ambient_logit,
                points=points, jitter=cfg.init_points_jitter)
        else:
            params = init_scene_params(cfg.init_n, cfg.init_offset,
                                       cfg.init_ambient_logit)
        start_stage = 0
        if resume:
            ck = self.latest_checkpoint()
            if ck is not None:
                start_stage, params, key = ck
                self.log(f"Resuming from stage {start_stage} checkpoint")

        self.log("🚀 Start Multi-Stage Optimization...")
        if cfg.stage_guard:
            return self._run_guarded(params, key, start_stage)
        padded, mask = pad_params(params, bucket_size(params.n))
        for stage in range(start_stage, cfg.stages):
            self.log(f"=== Stage {stage + 1}/{cfg.stages} (N = {params.n}) ===")
            params = self._prepare_stage_params(params)
            stage_init_centers = np.asarray(params.centers)
            key, sub = jax.random.split(key)
            padded, mask, _ = self.run_stage(params, stage, sub)

            if stage == cfg.stages - 1:
                self.log("🎉 Final Stage Complete! Exporting results...")
                if self._io:
                    export_scene_json(padded, cfg.scene_json,
                                      mask=np.asarray(mask))
                self.log(f"  => Saved to {cfg.scene_json} (N = {params.n})")
                self.save_preview(padded, mask,
                                  os.path.join(cfg.steps_dir, "final_1.png"))
                break

            self.save_preview(padded, mask,
                              os.path.join(cfg.steps_dir, f"stage_{stage}.png"))
            params = self._density_control(padded, mask, params.n,
                                           stage_init_centers, stage, rng)
            self.save_checkpoint(stage + 1, params, key)
        return padded, mask

    def _density_control(
        self,
        padded: SceneParams,
        mask: jax.Array,
        n_live: int,
        stage_init_centers: np.ndarray,
        stage: int,
        rng: np.random.Generator,
    ) -> SceneParams:
        """Generation boundary: prune/split (+ optional merge / residual
        scoring) on the live rows → next-generation params
        (training.rs:87-238)."""
        cfg = self.cfg
        unpadded = self._unpad(padded, n_live)
        split_scores = None
        if cfg.density.split_mode == "residual":
            # Scale-aware growth signal: residual attribution through
            # the compositor weights (train/residual.py). Scored on the
            # padded params; live rows are the first n by construction.
            from burn_raymarching.train.residual import (
                primitive_residual_scores,
            )

            k_end = anneal_for_step(cfg, stage, cfg.steps_per_stage)[1]
            # Score under the STAGE's forward (per-stage coverage /
            # sharpness schedules), not the final one — residuals must
            # reflect the model the stage actually trained.
            split_scores = primitive_residual_scores(
                padded, mask, self.dataset,
                self._stage_cfg(self._render_overrides_for_stage(stage)),
                k_end, kern=self.culled_march_normal_fn)[:n_live]
        centers, colors, radii, stats = prune_and_split(
            np.asarray(unpadded.centers),
            np.asarray(unpadded.colors),
            np.asarray(unpadded.radii),
            stage_init_centers,
            stage, cfg.stages, rng, cfg.density,
            split_scores=split_scores,
        )
        params = SceneParams(
            centers=jnp.asarray(centers),
            colors=jnp.asarray(colors),
            radii=jnp.asarray(radii),
            light_dir=padded.light_dir,
            ambient=padded.ambient,
        )
        self.log(
            f"  => Pruning & Splitting complete. Next N = {params.n} "
            f"(kept {stats.kept}, split {stats.split}, pruned "
            f"{stats.pruned_size}+{stats.pruned_flyaway}+"
            f"{stats.pruned_black}, merged {stats.merged})"
        )
        return params
