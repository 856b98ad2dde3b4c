"""Reconstruction-quality evaluation: PSNR of rendered views vs targets.

The reference verifies visually (committed steps/*.png, SURVEY §4); the
driver's north-star adds "PSNR parity vs Burn reference" (BASELINE.md).
PSNR here is computed in the 8-bit gamma-encoded domain (what both the
reference's artifacts and typical NeRF-style comparisons use).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from burn_raymarching.data.camera import create_camera_rays
from burn_raymarching.models.scene import SceneParams
from burn_raymarching.render.preview import render_tiled


def encode_u8(img: np.ndarray) -> np.ndarray:
    """Linear → gamma-2.2 u8, matching the save pipeline (util.rs:8)."""
    return (np.clip(img, 0.0, 1.0) ** (1.0 / 2.2) * 255.0).astype(np.uint8)


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(255.0) - 10.0 * np.log10(mse))


def evaluate_views(
    params: SceneParams,
    cameras: list[dict],
    targets: list[np.ndarray],     # per-view [H*W, 3] linear float
    width: int,
    height: int,
    smooth_k: float = 32.0,
    mask=None,
    march_normal_fn=None,
    chunk: int = 4096,
    softmax_sharpness: float = 10.0,
    mask_sharpness: float = 15.0,
    cull=None,
    clusters=None,
    mask_pixel_mult: float = 0.0,
    pixel_angle: float = 0.0,
    coverage_mode: str = "sigmoid",
) -> dict:
    """Render every camera with the training forward model and compare.

    ``cull`` (render.preview.CullRender) routes rendering through the
    per-tile top-K path — required for tolerable eval times at M ≳ 10k.
    Returns {"per_view": [psnr...], "mean": float, "min": float}.
    """
    per_view = []
    for cam, tgt in zip(cameras, targets):
        ro, rd = create_camera_rays(width, height, cam["origin"],
                                    cam["target"], cam["fov"])
        img = render_tiled(params, ro, rd, smooth_k=smooth_k, mask=mask,
                           chunk=chunk, march_normal_fn=march_normal_fn,
                           softmax_sharpness=softmax_sharpness,
                           mask_sharpness=mask_sharpness,
                           cull=cull, clusters=clusters,
                           order_wh=(width, height),
                           mask_pixel_mult=mask_pixel_mult,
                           pixel_angle=pixel_angle,
                           coverage_mode=coverage_mode)
        per_view.append(psnr_u8(encode_u8(img), encode_u8(np.asarray(tgt))))
    return {
        "per_view": per_view,
        "mean": float(np.mean(per_view)),
        "min": float(np.min(per_view)),
    }
