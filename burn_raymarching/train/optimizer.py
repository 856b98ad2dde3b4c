"""Adam optimizer matching the reference's Burn configuration.

Burn's AdamConfig with WeightDecayConfig (reference src/bin/train.rs:161-163)
is classic Adam with L2-style decay folded into the gradient BEFORE the
moment updates (not AdamW-decoupled), beta1=0.9, beta2=0.999, epsilon=1e-5
(Burn's default epsilon), applied to the RAW parameters. The learning rate is
supplied per step (stage decay × mid-stage drop), so the returned transform
excludes the lr scaling — the train step applies `params - lr * update`.
"""

from __future__ import annotations

import optax

from burn_raymarching.config import TrainConfig


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    """Adam with weight decay.

    weight_decay_mode="folded" (default) matches Burn: decay is added to the
    gradient BEFORE the moment updates. CAUTION at scale: Adam normalizes
    per-coordinate, so folded decay moves any coordinate whose data gradient
    is ~zero by the FULL learning rate per step (sign(p), not wd·p). With the
    reference's 6-7 primitives every sphere gets data gradient every batch
    and the drift never shows; with hundreds+ of small primitives most get
    none in a given batch and folded decay alone dissolves the scene
    (measured: a frozen-gradient GT knot collapses 35.6 → 18 dB in 300
    steps). Large-M configs should use "decoupled" (AdamW-style: the decay
    bypasses the moments, giving the intended p -= lr·wd·p).
    """
    if cfg.weight_decay_mode == "decoupled":
        return optax.chain(
            optax.scale_by_adam(b1=cfg.adam_b1, b2=cfg.adam_b2,
                                eps=cfg.adam_eps),
            optax.add_decayed_weights(cfg.weight_decay),
        )
    return optax.chain(
        optax.add_decayed_weights(cfg.weight_decay),
        optax.scale_by_adam(b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps),
    )


def lr_for_step(cfg: TrainConfig, stage: int, step: int) -> float:
    """Reference LR schedule (train.rs:166,193-197): base 0.05 * 0.6^stage,
    ×0.2 after the stage midpoint. ``step`` is 1-based like the reference."""
    base = cfg.base_lr * (cfg.lr_stage_decay ** stage)
    return base * cfg.lr_midstage_factor if step > cfg.steps_per_stage // 2 else base


def anneal_for_step(cfg: TrainConfig, stage: int, step: int) -> tuple[float, float, float]:
    """(progress, smooth_k, uniform_ratio) for a 1-based step in a stage
    (reference train.rs:170-176)."""
    global_step = stage * cfg.steps_per_stage + step
    # Capped at 1 so post-schedule steps (Trainer.polish) hold the final
    # annealed values; a no-op within the schedule.
    progress = min(global_step / cfg.total_steps, 1.0)
    smooth_k = cfg.min_smooth_k + (cfg.max_smooth_k - cfg.min_smooth_k) * progress
    uniform_ratio = cfg.uniform_ratio_start - (
        (cfg.uniform_ratio_start - cfg.uniform_ratio_end) * progress
    )
    return progress, smooth_k, uniform_ratio
