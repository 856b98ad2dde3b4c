"""Sharded training step: rays data-parallel × primitives model-parallel.

Scaling design (SURVEY §2/§5; no equivalent exists in the single-device
reference):

  * "data" axis — the batch of rays is split across devices. Each device
    samples its own sub-batch (PRNG folded with its axis index), marches and
    shades it against its primitive (shard), and computes the local loss.
    Gradients are combined with ``pmean`` over the axis — per-primitive grads
    are M×7 floats, so this all-reduce is latency-bound (NVLink between the
    cards of one host, all to all).
  * "model" axis — the primitive table (M) is sharded. Soft-min / softmax
    compositing combine shards with the two-pass pmax+psum logsumexp inside
    the forward (ops/sdf.py, render/diff.py); reverse-mode AD threads the
    corresponding collectives through the backward automatically. Replicated
    params (light_dir, ambient) need an explicit psum of their partial grads.

The optimizer update runs outside shard_map under jit — elementwise over
already-sharded leaves, so XLA keeps it local with no extra collectives.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from burn_raymarching.config import TrainConfig
from burn_raymarching.data.dataset import sample_batch_indices
from burn_raymarching.models.scene import SceneParams, scene_forward
from burn_raymarching.train.loss import compute_loss


def param_specs(model_sharded: bool) -> SceneParams:
    """PartitionSpec pytree for SceneParams."""
    m = P("model", None) if model_sharded else P(None, None)
    return SceneParams(
        centers=m, colors=m, radii=m,
        light_dir=P(None), ambient=P(None),
    )


def make_sharded_train_step(
    cfg: TrainConfig,
    mesh: Mesh,
    tx,
) -> Callable:
    """Build a jitted sharded step:
    (params, opt_state, key, mask, dataset arrays, anneal scalars, lr)
        -> (params, opt_state, loss).

    ``params``/``mask`` must be laid out with primitive rows divisible by the
    model-axis size (bucket padding guarantees this).
    """
    n_data = mesh.shape["data"]
    n_model = mesh.shape["model"]
    model_sharded = n_model > 1
    model_axis = "model" if model_sharded else None
    batch_local = cfg.batch_size // n_data
    if batch_local * n_data != cfg.batch_size:
        raise ValueError("batch_size must divide the data axis")

    pspec = param_specs(model_sharded)
    mask_spec = P("model") if model_sharded else P(None)
    rep2 = P(None, None)

    def device_grads(params, key, mask, rays_o, rays_d, targets,
                     fg_indices, n_fg, progress, smooth_k, uniform_ratio):
        # Per-device sub-batch: fold the data-shard index into the key.
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        idx = sample_batch_indices(
            key, rays_o.shape[0], fg_indices, n_fg, batch_local, uniform_ratio
        )
        if cfg.use_culling:
            # Tile-coherent rays (loop.py does the same; order-free sample).
            idx = jnp.sort(idx)
        ro = jnp.take(rays_o, idx, axis=0)
        rd = jnp.take(rays_d, idx, axis=0)
        tgt = jnp.take(targets, idx, axis=0)

        rep_clusters = None
        if cfg.cluster_repulsion:
            # The primitive buffer is kept Morton-ordered (DistributedTrainer
            # re-sorts at stage start), so the shard's cluster structure is
            # implicit: consecutive groups of G local rows. Validity comes
            # from the local mask shard inside cluster_repulsion.
            from burn_raymarching.ops.culling import PrimitiveClusters

            g = cfg.cull_cluster_group
            m_local = mask.shape[0]
            if m_local % g:
                raise ValueError(
                    f"cluster_repulsion needs the local primitive shard "
                    f"({m_local}) divisible by cull_cluster_group ({g})")
            rep_clusters = PrimitiveClusters(
                jnp.arange(m_local, dtype=jnp.int32).reshape(-1, g),
                jnp.ones((m_local // g, g), bool))

        def loss_fn(p):
            if cfg.use_culling:
                # Config-5 path: every device culls ITS primitive shard to
                # per-tile top-K tables; soft-min/softmax combine shards
                # with pmax/psum inside render_diff_culled.
                from burn_raymarching.models.scene import activate
                from burn_raymarching.render.culled import (
                    render_diff_culled,
                )

                c_p, col_p, r_p, ld_p, amb_p = activate(p)
                out = render_diff_culled(
                    ro, rd, c_p, col_p, r_p, ld_p, amb_p, smooth_k,
                    mask=mask, tile=cfg.cull_tile, k_budget=cfg.cull_budget,
                    model_axis=model_axis)
            else:
                out = scene_forward(p, ro, rd, smooth_k, mask=mask,
                                    model_axis=model_axis)
            return compute_loss(p, out, tgt, progress, mask=mask,
                                cfg=cfg.loss, model_axis=model_axis,
                                repulsion_clusters=rep_clusters)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        # Mean over ray shards (equal shard sizes → mean of means is exact).
        loss = jax.lax.pmean(loss, "data")
        grads = jax.lax.pmean(grads, "data")
        if model_sharded:
            # Replicated leaves accumulated their shard-partial contributions.
            grads = SceneParams(
                centers=grads.centers,
                colors=grads.colors,
                radii=grads.radii,
                light_dir=jax.lax.psum(grads.light_dir, "model"),
                ambient=jax.lax.psum(grads.ambient, "model"),
            )
        return loss, grads

    sharded_grads = jax.shard_map(
        device_grads,
        mesh=mesh,
        in_specs=(pspec, P(), mask_spec, rep2, rep2, rep2, P(None), P(), P(),
                  P(), P()),
        out_specs=(P(), pspec),
        check_vma=False,
    )

    @jax.jit
    def step(params, opt_state, key, mask, rays_o, rays_d, targets,
             fg_indices, n_fg, progress, smooth_k, uniform_ratio, lr):
        loss, grads = sharded_grads(
            params, key, mask, rays_o, rays_d, targets, fg_indices, n_fg,
            progress, smooth_k, uniform_ratio,
        )
        updates, opt_state = tx.update(grads, opt_state, params)
        lr_scales = SceneParams(
            centers=cfg.lr_scale_centers, colors=cfg.lr_scale_colors,
            radii=cfg.lr_scale_radii, light_dir=cfg.lr_scale_light,
            ambient=cfg.lr_scale_light)
        params = jax.tree.map(lambda p, u, s: p - lr * s * u, params,
                              updates, lr_scales)
        return params, opt_state, loss

    return step


def opt_state_specs(tx, model_sharded: bool):
    """PartitionSpec pytree for the optimizer state of a SceneParams tree.

    Derived structurally via eval_shape on a dummy params tree: every 2-D
    leaf of the state is a per-primitive moment buffer (mu/nu mirror the
    params tree — centers/colors [M,3], radii [M,1]) and shards with the
    model axis; 1-D leaves (light_dir/ambient moments) and scalars (Adam's
    count) are replicated. The dummy M is irrelevant — only the tree
    structure and leaf ranks matter.
    """
    dummy = SceneParams(
        centers=jax.ShapeDtypeStruct((8, 3), jnp.float32),
        colors=jax.ShapeDtypeStruct((8, 3), jnp.float32),
        radii=jax.ShapeDtypeStruct((8, 1), jnp.float32),
        light_dir=jax.ShapeDtypeStruct((3,), jnp.float32),
        ambient=jax.ShapeDtypeStruct((1,), jnp.float32),
    )
    struct = jax.eval_shape(tx.init, dummy)

    def leaf_spec(leaf):
        if leaf.ndim == 2:
            return P("model", None) if model_sharded else P(None, None)
        if leaf.ndim == 1:
            return P(None)
        return P()

    return jax.tree.map(leaf_spec, struct)


def make_sharded_chunk_runner(
    cfg: TrainConfig,
    mesh: Mesh,
    tx,
    chunk: int,
    *,
    march_normal_fn,
    culled_march_fn,
    warm: bool = False,
):
    """Scan-chunked sharded step with the SAME signature as the single-chip
    Trainer's ``_step_fn`` — ``chunk`` full training steps (sample → forward
    → loss → grads → Adam) per device program.

    This is the driver-parity twin of train/loop.Trainer._build_step: the
    identical per-step body (train/step_body.make_device_step — warm-start
    cache, tile culling, march kernels, in-graph anneals) runs under
    shard_map over the (data, model) mesh, and the ENTIRE scan chunk —
    including the Adam update — lives inside one shard_map region. A
    shard_map boundary per scan step would materialize the grads tree every
    step instead of fusing it into Adam; with the scan inside, the program
    crosses the boundary once per CHUNK and grads stay fused. The update is elementwise on already-sharded
    leaves; grads are pmean'd over the data axis first, so every data
    replica computes the identical update (opt_state stays consistent).
    Expected layouts:

      params/opt_state  — model-sharded rows (or replicated when model=1)
      mask              — P("model")
      packed [P, 9]     — P("data", None): each device owns a pixel shard
      fg_indices [D, Pl] / n_fg [D] — per-shard fg index sets (LOCAL ids)
      t_cache [P]       — P("data"), rides with the pixel shard
      cl_idx/cl_valid   — GLOBAL row ids, P("model", None): whole clusters
                          per shard (bucket quantum = model * G)
    """
    from burn_raymarching.train.step_body import (
        lr_scale_tree,
        make_device_step,
    )

    n_data = mesh.shape["data"]
    n_model = mesh.shape["model"]
    model_sharded = n_model > 1
    model_axis = "model" if model_sharded else None
    batch_local = cfg.batch_size // n_data
    if batch_local * n_data != cfg.batch_size:
        raise ValueError("batch_size must divide the data axis")

    device_step = make_device_step(
        cfg, march_normal_fn=march_normal_fn,
        culled_march_fn=culled_march_fn,
        batch=batch_local, warm=warm,
        data_axis="data", model_axis=model_axis, model_size=n_model,
        # A 1-wide data axis samples exactly like the single-chip driver
        # (no key fold) — the driver-equivalence tests rely on it.
        fold_data_index=n_data > 1)

    pspec = param_specs(model_sharded)
    mask_spec = P("model") if model_sharded else P(None)
    cl_spec = P("model", None) if model_sharded else P(None, None)
    opt_spec = opt_state_specs(tx, model_sharded)

    def dev_chunk(params, opt_state, key, mask, packed, fgi, nfg, t_cache,
                  stage, step0, cl_idx, cl_valid):
        # fgi/nfg keep a length-1 leading data-shard dim → local views.
        lr_scales = lr_scale_tree(cfg, stage)

        def one_step(carry, i):
            params, opt_state, t_cache = carry
            k = jax.random.fold_in(key, i)
            loss, grads, t_cache, lr = device_step(
                params, k, i, stage, step0, mask, packed, fgi[0], nfg[0],
                t_cache, cl_idx, cl_valid)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = jax.tree.map(lambda p, u, s: p - lr * s * u, params,
                                  updates, lr_scales)
            return (params, opt_state, t_cache), loss

        (params, opt_state, t_cache), losses = jax.lax.scan(
            one_step, (params, opt_state, t_cache), jnp.arange(chunk),
            unroll=cfg.scan_unroll)
        return params, opt_state, t_cache, losses

    run_chunk = jax.jit(jax.shard_map(
        dev_chunk,
        mesh=mesh,
        in_specs=(pspec, opt_spec, P(), mask_spec, P("data", None),
                  P("data", None), P("data"), P("data"), P(), P(),
                  cl_spec, cl_spec),
        # losses are pmean'd per step → replicated.
        out_specs=(pspec, opt_spec, P("data"), P()),
        check_vma=False,
    ))

    return run_chunk


def shard_params(params: SceneParams, mesh: Mesh, model_sharded: bool):
    """Place a params pytree onto the mesh with the step's expected layout."""
    specs = param_specs(model_sharded)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params, specs
    )
