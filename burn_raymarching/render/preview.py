"""Tiled (chunked) inference rendering for previews and offline viewing.

Reference: save_tiled_preview (src/bin/train.rs:335-366) renders in
4096-ray chunks to bound memory. Same chunking here, but all chunks of a
render run inside ONE device program (lax.map over [n_chunks, chunk, 3]),
so a render pays one program launch instead of one per chunk (and the
polish loop pays a full PSNR eval per round).

For large primitive counts pass ``cull=CullRender(...)``: chunks render
through render_diff_culled (per-tile top-K tables) instead of the dense
[chunk, M] march — the same selection the culled training step uses, and
the difference between minutes and seconds per 512² eval at M≈50k.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from burn_raymarching.models.scene import SceneParams, activate, scene_forward


@dataclasses.dataclass(frozen=True)
class CullRender:
    """Culled-render options for render_tiled (hashable → jit-static).

    ``march_normal_fn`` is the platform's culled march
    (ops/kernels.select_kernels) or None for the renderer's own XLA tile
    march. ``clusters`` (a PrimitiveClusters pytree) is passed separately
    to render_tiled since it holds arrays.
    """

    tile: int = 512
    k_budget: int = 256
    cluster_budget: int = 32
    march_normal_fn: Any = None


@partial(jax.jit, static_argnames=("march_normal_fn",
                                   "softmax_sharpness", "mask_sharpness",
                                   "cull", "mask_pixel_mult", "pixel_angle",
                                   "coverage_mode"))
def _forward_chunks(params, ro3, rd3, smooth_k, mask,
                    march_normal_fn, softmax_sharpness=10.0,
                    mask_sharpness=15.0, cull=None, clusters=None,
                    mask_pixel_mult=0.0, pixel_angle=0.0,
                    coverage_mode="sigmoid"):
    """[K, chunk, 3] rays → [K, chunk, 3] colors, one device program."""

    def one(args):
        ro, rd = args
        if cull is not None:
            from burn_raymarching.render.culled import render_diff_culled

            c, col, r, ld, amb = activate(params)
            return render_diff_culled(
                ro, rd, c, col, r, ld, amb, smooth_k, mask=mask,
                tile=cull.tile, k_budget=cull.k_budget,
                clusters=clusters, cluster_budget=cull.cluster_budget,
                softmax_sharpness=softmax_sharpness,
                mask_sharpness=mask_sharpness,
                march_normal_fn=cull.march_normal_fn,
                mask_pixel_mult=mask_pixel_mult, pixel_angle=pixel_angle,
                coverage_mode=coverage_mode)
        return scene_forward(params, ro, rd, smooth_k, mask=mask,
                             march_normal_fn=march_normal_fn,
                             softmax_sharpness=softmax_sharpness,
                             mask_sharpness=mask_sharpness,
                             mask_pixel_mult=mask_pixel_mult,
                             pixel_angle=pixel_angle,
                             coverage_mode=coverage_mode)

    return jax.lax.map(one, (ro3, rd3))


def render_tiled(
    params: SceneParams,
    rays_o,
    rays_d,
    smooth_k: float = 32.0,
    mask: Optional[jax.Array] = None,
    chunk: int = 4096,
    march_normal_fn=None,
    softmax_sharpness: float = 10.0,
    mask_sharpness: float = 15.0,
    cull: Optional[CullRender] = None,
    clusters=None,
    order_wh: Optional[tuple[int, int]] = None,
    mask_pixel_mult: float = 0.0,
    pixel_angle: float = 0.0,
    coverage_mode: str = "sigmoid",
) -> np.ndarray:
    """Render [P, 3] rays in fixed-size chunks → np.float32 [P, 3].

    ``order_wh=(width, height)``: the rays are one raster-ordered view of
    that size — render them Morton-permuted (inverse-permuted back on
    return). Raster chunks are full-width strips whose tile cones span the
    whole scene, so culled rendering with a K budget silently drops most of
    a large scene's qualifying primitives (measured: the 51k-primitive
    config-5 init scored 21.5 dB raster vs 27+ dB with compact tiles —
    round-1's "flat" config-5 evals were largely this artifact). Only
    meaningful with ``cull``; the dense path is order-free.
    """
    if cull is not None and chunk % cull.tile != 0:
        raise ValueError(f"chunk ({chunk}) must divide by cull.tile "
                         f"({cull.tile})")
    inv = None
    if order_wh is not None and cull is not None:
        from burn_raymarching.utils.morton import morton_permutation

        w, h = order_wh
        if w * h != rays_o.shape[0]:
            raise ValueError(f"order_wh {order_wh} != {rays_o.shape[0]} rays")
        perm = morton_permutation(w, h)
        inv = np.argsort(perm)
        rays_o = np.asarray(rays_o)[perm]
        rays_d = np.asarray(rays_d)[perm]
    n = rays_o.shape[0]
    sk = jnp.asarray(smooth_k, dtype=jnp.float32)
    k = (n + chunk - 1) // chunk
    pad = k * chunk - n

    def pad_rows(x):
        # Repeat the last ray (NOT zeros): culled selection builds per-tile
        # cones, and zero directions in a mixed real/pad tail tile would
        # skew the cone real rays in that tile select against.
        x = jnp.asarray(x)
        if pad:
            x = jnp.concatenate([x, jnp.repeat(x[-1:], pad, axis=0)])
        return x.reshape(k, chunk, 3)

    ro3 = pad_rows(rays_o)
    rd3 = pad_rows(rays_d)
    out = _forward_chunks(params, ro3, rd3, sk, mask, march_normal_fn,
                          softmax_sharpness=softmax_sharpness,
                          mask_sharpness=mask_sharpness,
                          cull=cull, clusters=clusters,
                          mask_pixel_mult=mask_pixel_mult,
                          pixel_angle=pixel_angle,
                          coverage_mode=coverage_mode)
    img = np.asarray(out).reshape(k * chunk, 3)[:n]
    return img[inv] if inv is not None else img
