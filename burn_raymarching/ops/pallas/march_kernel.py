"""Fused detached march + normals kernel (Pallas, Triton route).

The training forward evaluates the scene's soft-min field 49 times per step:
40 march steps + 1 detached reattach point + 6 normal taps, then (with
gradients) 1 reattach + 1 compositor + 1 mask (reference
renderer_diff.rs:22-46, scene.rs:81-128). The first 47 carry no gradients:
the march is detached and the normals are taken at a detached point with
detached parameters. Under XLA each of those evaluations writes and reads
[rays, primitives] distance/exp intermediates in device memory. This kernel
runs all 47 for one block of rays inside one program, so the march never
touches device memory between steps:

  * ``num_steps`` sphere-tracing steps (t capped at ops.march.T_MAX);
  * one detached soft-min at the converged point -> p_final;
  * the 6-tap central-difference normals with the reference's +1e-6 inside
    the normalization.

One kernel body serves the dense renderer (one primitive table shared by
all rays) and the tile-culled renderer (one top-K table per ray tile): the
grid is (tables, ray blocks of the table). The table is streamed in
``block_prims`` columns with an online logsumexp, so its width has no limit
beyond device memory; a table that fits one chunk is loaded once per
program. Distances are taken in the direct form sqrt(|p - c|^2) with
float32 FMAs (no tensor-core dot, so no TF32 anywhere), in the operation
order of the XLA twins' detached evaluations (ops.sdf.direct_sphere_dists,
render.culled._tile_dists_direct), so kernel and twin compute the same
float32 function up to the order of the logsumexp sums.

Layouts are structure-of-arrays so every load is a power-of-two vector of
one coordinate: rays [tables, 7, rays] (ox, oy, oz, dx, dy, dz, t0) and
tables [tables, 4, K] (cx, cy, cz, r; invalid slots sit at 1e15, which
gives them an exactly zero soft-min weight). Ragged ray counts and
table widths are masked loads and stores, not padding.

Outputs t and normal are detached by construction; the gradient-carrying
evaluations stay in XLA where reverse AD handles them.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from burn_raymarching.ops.march import T_MAX

# Block sizes measured on an H100: 16-ray blocks against 256-column table
# chunks, with about 32 [rays, chunk] elements per thread (num_warps
# follows the block), beat larger blocks at N = 16,384 rays (PERF.md).
BLOCK_RAYS = 16
BLOCK_PRIMS = 256
_ELEMS_PER_WARP = 1024
_FAR = 1e15       # invalid slots: |p - c| ~ 1e15 -> exp(-k * 1e15) = 0
_INVALID_CSQ = 1e30   # the tables' ||c||^2 marker of an invalid slot


def _march_normals_kernel(ray_ref, tab_ref, k_ref, t_ref, n_ref, *,
                          num_steps: int, normal_eps: float, block_rays: int,
                          block_prims: int):
    b = pl.program_id(0)
    start = pl.program_id(1) * block_rays
    n_rays = ray_ref.shape[2]
    n_prims = tab_ref.shape[2]
    live = start + jnp.arange(block_rays) < n_rays

    def ray_row(i):
        return plgpu.load(ray_ref.at[b, i, pl.ds(start, block_rays)],
                          mask=live, other=0.0)

    ox, oy, oz, dx, dy, dz, t0 = (ray_row(i) for i in range(7))
    k = k_ref[0]

    def load_chunk(c0):
        ok = c0 + jnp.arange(block_prims) < n_prims

        def row(i, other):
            return plgpu.load(tab_ref.at[b, i, pl.ds(c0, block_prims)],
                              mask=ok, other=other)

        return row(0, _FAR), row(1, _FAR), row(2, _FAR), row(3, 0.0)

    def neg_k_dists(px, py, pz, chunk):
        """[rays, chunk] -k * surface distance (sphere_sdf's clamp, then
        soft_min's scaling)."""
        cx, cy, cz, r = chunk
        ex = px[:, None] - cx[None, :]
        ey = py[:, None] - cy[None, :]
        ez = pz[:, None] - cz[None, :]
        q = ex * ex + ey * ey + ez * ez
        return (jnp.sqrt(jnp.maximum(q, 1e-6)) - r[None, :]) * (-k)

    n_chunks = pl.cdiv(n_prims, block_prims)
    if n_chunks == 1:
        table = load_chunk(0)

        def soft_min(px, py, pz):
            val = neg_k_dists(px, py, pz, table)
            mx = jnp.max(val, axis=1)
            s = jnp.sum(jnp.exp(val - mx[:, None]), axis=1)
            return (jnp.log(jnp.maximum(s, 1e-8)) + mx) / (-k)
    else:
        def soft_min(px, py, pz):
            def chunk_body(c, carry):
                mx, s = carry
                val = neg_k_dists(px, py, pz, load_chunk(c * block_prims))
                mx_new = jnp.maximum(mx, jnp.max(val, axis=1))
                s = (s * jnp.exp(mx - mx_new)
                     + jnp.sum(jnp.exp(val - mx_new[:, None]), axis=1))
                return mx_new, s

            mx, s = jax.lax.fori_loop(
                0, n_chunks, chunk_body,
                (jnp.full((block_rays,), -jnp.inf, jnp.float32),
                 jnp.zeros((block_rays,), jnp.float32)))
            return (jnp.log(jnp.maximum(s, 1e-8)) + mx) / (-k)

    def march_step(_, t):
        sm = soft_min(ox + dx * t, oy + dy * t, oz + dz * t)
        return jnp.minimum(t + sm, T_MAX)

    t = jax.lax.fori_loop(0, num_steps, march_step, t0)
    plgpu.store(t_ref.at[b, pl.ds(start, block_rays)], t, mask=live)

    # Detached reattach point (renderer_diff.rs:28-38) -> p_final.
    dist_last = soft_min(ox + dx * t, oy + dy * t, oz + dz * t)
    t_final = t + dist_last
    px, py, pz = ox + dx * t_final, oy + dy * t_final, oz + dz * t_final

    # 6-tap central differences (scene.rs:81-128), eps = normal_eps.
    nx = soft_min(px + normal_eps, py, pz) - soft_min(px - normal_eps, py, pz)
    ny = soft_min(px, py + normal_eps, pz) - soft_min(px, py - normal_eps, pz)
    nz = soft_min(px, py, pz + normal_eps) - soft_min(px, py, pz - normal_eps)
    length = jnp.sqrt(nx * nx + ny * ny + nz * nz + 1e-6)
    for i, comp in enumerate((nx, ny, nz)):
        plgpu.store(n_ref.at[b, i, pl.ds(start, block_rays)], comp / length,
                    mask=live)


@functools.partial(jax.jit, static_argnames=(
    "num_steps", "normal_eps", "interpret", "block_rays", "block_prims"))
def _march_call(rays, table, k, *, num_steps, normal_eps, interpret,
                block_rays, block_prims):
    """rays [B, 7, T], table [B, 4, K], k [1] -> (t [B, T], n [B, 3, T])."""
    n_tables, _, n_rays = rays.shape
    block_prims = min(block_prims, pl.next_power_of_2(table.shape[2]))
    num_warps = min(8, max(1, block_rays * block_prims // _ELEMS_PER_WARP))
    kernel = functools.partial(
        _march_normals_kernel, num_steps=num_steps, normal_eps=normal_eps,
        block_rays=block_rays, block_prims=block_prims)
    return pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((n_tables, n_rays), jnp.float32),
                   jax.ShapeDtypeStruct((n_tables, 3, n_rays), jnp.float32)),
        grid=(n_tables, pl.cdiv(n_rays, block_rays)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="march_normals",
    )(rays, table, k)


def _launch(ro, rd, t0, table, smooth_k, num_steps, normal_eps, interpret,
            block_rays, block_prims):
    """[B, T, 3] rays + [B, T] t0 + [B, 4, K] table -> (t [B, T],
    normal [B, T, 3]), all inputs detached."""
    rays = jnp.concatenate([ro, rd, t0[..., None]], axis=2)
    rays = jnp.swapaxes(jax.lax.stop_gradient(rays).astype(jnp.float32), 1, 2)
    k = jnp.asarray(jax.lax.stop_gradient(smooth_k), jnp.float32).reshape(1)
    t, normal = _march_call(
        rays, jax.lax.stop_gradient(table).astype(jnp.float32), k,
        num_steps=num_steps, normal_eps=normal_eps, interpret=interpret,
        block_rays=block_rays, block_prims=block_prims)
    return t, jnp.swapaxes(normal, 1, 2)


def march_normals_triton(
    ray_org: jax.Array,
    ray_dir: jax.Array,
    centers: jax.Array,
    radii: jax.Array,
    smooth_k,
    mask: Optional[jax.Array] = None,
    num_steps: int = 40,
    normal_eps: float = 1e-4,
    t_init: Optional[jax.Array] = None,
    interpret: bool = False,
    block_rays: int = BLOCK_RAYS,
    block_prims: int = BLOCK_PRIMS,
) -> tuple[jax.Array, jax.Array]:
    """Dense detached march + normals -> (t [N, 1], normal [N, 3]).

    Kernel twin of ops.march.march_normals_xla (same signature and
    semantics); ``t_init`` warm-starts the march, paired with a reduced
    ``num_steps``. ``interpret`` runs the kernel on the CPU (tests only).
    """
    n = ray_org.shape[0]
    centers = jax.lax.stop_gradient(centers).astype(jnp.float32)
    valid = jnp.ones((centers.shape[0],), bool)
    if mask is not None:
        valid = mask.astype(bool)
    table = jnp.concatenate([jnp.where(valid, centers.T, _FAR),
                             radii.reshape(1, -1)], axis=0)[None]
    t0 = (jnp.zeros((1, n), jnp.float32) if t_init is None
          else t_init.reshape(1, n))
    t, normal = _launch(ray_org[None], ray_dir[None], t0, table, smooth_k,
                        num_steps, normal_eps, interpret, block_rays,
                        block_prims)
    return t.reshape(n, 1), normal[0]


def culled_march_normals_triton(
    ray_org: jax.Array,      # [B, T, 3] tile-coherent rays
    ray_dir: jax.Array,      # [B, T, 3]
    centers_t: jax.Array,    # [B, K, 3] per-tile tables
    radii_t: jax.Array,      # [B, K]
    c_sq_t: jax.Array,       # [B, K], 1e30 marks invalid slots
    smooth_k,
    num_steps: int = 40,
    normal_eps: float = 1e-4,
    t_init: Optional[jax.Array] = None,   # [B, T, 1] warm-start roots
    interpret: bool = False,
    block_rays: int = BLOCK_RAYS,
    block_prims: int = BLOCK_PRIMS,
) -> tuple[jax.Array, jax.Array]:
    """Culled detached march + normals -> (t [B, T, 1], normal [B, T, 3]).

    Kernel twin of render.culled.culled_march_normals_xla on the same
    per-tile tables; table gathering (ops.culling) stays outside.
    """
    b, n_t = ray_org.shape[0], ray_org.shape[1]
    valid = (c_sq_t < 0.5 * _INVALID_CSQ)[:, None, :]
    table = jnp.concatenate([
        jnp.where(valid, jnp.swapaxes(centers_t, 1, 2), _FAR),
        radii_t[:, None, :]], axis=1)
    t0 = (jnp.zeros((b, n_t), jnp.float32) if t_init is None
          else t_init.reshape(b, n_t))
    t, normal = _launch(ray_org, ray_dir, t0, table, smooth_k, num_steps,
                        normal_eps, interpret, block_rays, block_prims)
    return t[..., None], normal
