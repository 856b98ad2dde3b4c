"""Multi-process runtime: process init, host-0 I/O, distributed training loop.

The reference is strictly single-device (SURVEY §2 — no collectives of any
kind); this is the scaling layer.

Topology model:
  * every process runs the same program; ``init_distributed()`` wires
    jax.distributed from an explicit coordinator address, process count
    and process id (nothing on a GPU host discovers them);
  * the global mesh is (data, model) over ALL devices; the cards of one
    host are joined all to all by NVLink, so the mesh follows the
    algorithm alone and gradients all-reduce through the same psum/pmean
    (XLA hands the collectives to NCCL);
  * per-primitive parameter gradients are tiny (M×7 floats), so the
    all-reduce is latency-bound — DP scaling efficiency is limited only by
    per-step launch overhead, which the scan-chunked step amortizes to
    one dispatch per cfg.steps_per_call steps;
  * the DATASET is sharded over the data axis: each device owns a
    contiguous pixel shard (plus its fg index set and its slice of the
    warm-start t cache) and samples its sub-batch from it by folding its
    axis index into the PRNG key — no data exchange on the sample path.
    Shards are equal-sized, so the mean of shard means is the global batch
    mean; the fg boost applies per shard (statistically equivalent — the
    reference's sampling is host-RNG anyway, SURVEY §7 "RNG parity policy");
  * host 0 alone writes previews / scene.json / checkpoints (``is_host0``).

DistributedTrainer IS the single-chip Trainer (a subclass): the same
multi-stage schedule, warm-start cache, tile culling, density control,
stage checkpoints/resume, previews, scene.json export, and greedy polish —
run_stage simply dispatches the shared per-step body
(train/step_body.make_device_step) through shard_map instead of calling it
directly. There is no reduced second driver.

KNOWN LIMITATION of the virtual CPU mesh (xla_force_host_platform_
device_count): XLA:CPU's collective rendezvous nondeterministically crashes
(rendezvous.h "Check failed: id < num_threads" → SIGSEGV) once a run issues
a few thousand subgroup all-reduces — typically 30-150 training steps of
this pipeline, dense or culled, synced or not (reproduced on jax 0.8.x).
Keep CPU-simulation runs to smoke length (tests and dryrun_multichip do);
GPU meshes run their collectives through NCCL and do not use this path.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from burn_raymarching.config import TrainConfig
from burn_raymarching.data.dataset import RayDataset, compute_fg_indices
from burn_raymarching.models.scene import SceneParams, activate
from burn_raymarching.parallel.mesh import make_mesh
from burn_raymarching.parallel.train_step import (
    make_sharded_chunk_runner,
    param_specs,
)
from burn_raymarching.train.loop import Trainer
from burn_raymarching.utils.padding import bucket_size


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed. Pass the coordinator address
    (``host:port``), process count and process id explicitly. Safe to call
    when already initialized."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def is_host0() -> bool:
    return jax.process_index() == 0


class ShardedRayDataset:
    """A RayDataset laid out for a (data, model) mesh.

    Pixels (packed rays+targets) are sharded contiguously over the data
    axis; each shard gets its OWN fg index set in shard-local coordinates
    (padded to the local pixel count, like compute_fg_indices) so every
    device runs the reference's fg-boosted sampler (dataset.rs:47-82) over
    its local pixels. Total pixel count must divide the data axis — pad the
    capture (or pick a mesh) accordingly; every real config does
    (views × H × W is highly composite).
    """

    def __init__(self, ds: RayDataset, mesh, fg_threshold: float = 0.05):
        n_data = mesh.shape["data"]
        p_total = ds.num_total_pixels
        if p_total % n_data:
            raise ValueError(
                f"total pixels ({p_total}) must divide the data axis "
                f"({n_data})")
        self.base = ds
        self.mesh = mesh
        self.n_data = n_data
        self.fg_threshold = fg_threshold
        self.num_total_pixels = p_total
        self.p_local = p_total // n_data
        self.num_fg = ds.num_fg
        self.num_bg = ds.num_bg

        tgt = np.asarray(ds.targets)
        fgi = np.zeros((n_data, self.p_local), np.int32)
        nfg = np.zeros((n_data,), np.int32)
        for d in range(n_data):
            block = tgt[d * self.p_local:(d + 1) * self.p_local]
            fgi[d], nfg[d] = compute_fg_indices(block, fg_threshold)
        self.packed = jax.device_put(
            ds.packed, NamedSharding(mesh, P("data", None)))
        self.fg_indices = jax.device_put(
            jnp.asarray(fgi), NamedSharding(mesh, P("data", None)))
        self.n_fg = jax.device_put(
            jnp.asarray(nfg), NamedSharding(mesh, P("data")))
        self.rays_o = jax.device_put(
            ds.rays_o, NamedSharding(mesh, P("data", None)))
        self.rays_d = jax.device_put(
            ds.rays_d, NamedSharding(mesh, P("data", None)))
        self.targets = ds.targets

    def tile_fg(self, tile: int):
        """Per-shard tile-granular fg split (RayDataset.tile_fg semantics):
        ([n_data, tiles_local] local tile ids, [n_data] counts)."""
        if self.p_local % tile:
            raise ValueError(f"local pixels ({self.p_local}) must divide "
                             f"by tile ({tile})")
        t_loc = self.p_local // tile
        px = np.asarray(self.base.targets).reshape(-1, 3).sum(axis=1)
        any_fg = (px > self.fg_threshold).reshape(-1, tile).any(axis=1)
        fgt = np.zeros((self.n_data, t_loc), np.int32)
        nft = np.zeros((self.n_data,), np.int32)
        for d in range(self.n_data):
            ids = np.nonzero(any_fg[d * t_loc:(d + 1) * t_loc])[0]
            fgt[d, : ids.size] = ids.astype(np.int32)
            nft[d] = ids.size
        return (jax.device_put(jnp.asarray(fgt),
                               NamedSharding(self.mesh, P("data", None))),
                jax.device_put(jnp.asarray(nft),
                               NamedSharding(self.mesh, P("data"))))


class DistributedTrainer(Trainer):
    """The Trainer, over a (data, model) mesh.

    Everything non-step (stages, anneals, density control, warm prefill,
    checkpoints/resume, previews, export, polish) is inherited; the step is
    the shared body under shard_map (parallel/train_step.
    make_sharded_chunk_runner), and file I/O runs on host 0 only.
    """

    def __init__(self, cfg: TrainConfig, dataset: RayDataset,
                 data: Optional[int] = None, model: int = 1,
                 log: Callable[[str], None] = print):
        self.mesh = make_mesh(data=data, model=model)
        self.model = self.mesh.shape["model"]
        self.n_data = self.mesh.shape["data"]
        sharded = ShardedRayDataset(dataset, self.mesh,
                                    fg_threshold=cfg.fg_pixel_threshold)
        super().__init__(cfg, sharded,
                         log=log if is_host0() else (lambda s: None))
        self._io = is_host0()

    # --- step construction -------------------------------------------- #

    def _chunk_target(self) -> int:
        """Sharded auto steps_per_call: chunk boundaries cost more here
        (shard_map materializes gradients at the program edge), so auto
        mode targets longer chunks; explicit cfg.steps_per_call still wins
        (config.steps_per_call)."""
        return 350

    def _build_step(self, render_overrides=None):
        return make_sharded_chunk_runner(
            self._stage_cfg(render_overrides), self.mesh, self.tx,
            self._chunk,
            march_normal_fn=self.march_normal_fn,
            culled_march_fn=self.culled_march_normal_fn,
            warm=self.warm)

    def _warm_gate(self) -> bool:
        # The sharded prefill (below) is the culled march; the dense warm
        # path needs a single-device table.
        return bool(self.cfg.warm_start and self.cfg.use_culling)

    # --- layout hooks --------------------------------------------------- #

    def _bucket(self, n: int) -> int:
        """Bucket must split into even model shards; cluster features
        additionally need whole G-groups per shard so every cluster's
        members live in exactly one shard."""
        cfg = self.cfg
        b = bucket_size(n)
        quantum = self.model
        if ((cfg.use_culling and cfg.cull_hierarchical)
                or cfg.cluster_repulsion):
            quantum *= cfg.cull_cluster_group
        while b % quantum:
            b *= 2
        return b

    def _place(self, padded: SceneParams, mask: jax.Array):
        specs = param_specs(self.model > 1)
        padded = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(self.mesh, s)),
            padded, specs)
        mask = jax.device_put(
            mask, NamedSharding(
                self.mesh, P("model") if self.model > 1 else P(None)))
        return padded, mask

    def _init_t_cache(self) -> jax.Array:
        return jax.device_put(
            jnp.zeros((self.dataset.num_total_pixels,), jnp.float32),
            NamedSharding(self.mesh, P("data")))

    def _prepare_stage_params(self, params: SceneParams) -> SceneParams:
        """Morton-sort the live rows at stage start (a scene is a set —
        pure reordering) so consecutive G-groups (= the step's cluster
        table) and the contiguous model shards are spatially coherent."""
        cfg = self.cfg
        if not (((cfg.use_culling and cfg.cull_hierarchical)
                 or cfg.cluster_repulsion) or self.model > 1):
            return params
        from burn_raymarching.ops.culling import morton_order

        order = morton_order(np.asarray(params.centers))
        return SceneParams(
            centers=params.centers[order],
            colors=params.colors[order],
            radii=params.radii[order],
            light_dir=params.light_dir,
            ambient=params.ambient,
        )

    def _build_cluster_table(self, padded: SceneParams, mask: jax.Array):
        """Implicit consecutive-G grouping in GLOBAL row ids.

        Rows are Morton-sorted with the pad at the end
        (_prepare_stage_params + pad_params), so arange grouping equals
        build_clusters' output while keeping whole clusters inside each
        model shard (bucket quantum model*G); the step body converts to
        shard-local ids."""
        cfg = self.cfg
        if not ((cfg.use_culling and cfg.cull_hierarchical)
                or cfg.cluster_repulsion):
            return jnp.zeros((0, 0), jnp.int32), jnp.zeros((0, 0), bool)
        g = cfg.cull_cluster_group
        m_pad = padded.centers.shape[0]
        cl_idx = jnp.arange(m_pad, dtype=jnp.int32).reshape(-1, g)
        cl_valid = jnp.asarray(mask, bool).reshape(-1, g)
        spec = P("model", None) if self.model > 1 else P(None, None)
        cl_idx = jax.device_put(cl_idx, NamedSharding(self.mesh, spec))
        cl_valid = jax.device_put(cl_valid, NamedSharding(self.mesh, spec))
        return cl_idx, cl_valid

    # --- warm prefill ----------------------------------------------------- #

    def prefill_t_cache(self, padded, mask, smooth_k):
        """Cold march of every pixel, each device over its own shard.

        One shard_map call: flat per-shard top-K selection + the culled
        march (the platform's march when a single device owns its tables,
        the XLA twin with pmax/psum under model sharding), lax.map-chunked so the
        per-device working set stays at one batch of tiles."""
        from functools import partial

        from burn_raymarching.ops.culling import (
            select_tile_primitives,
            tile_cones,
        )
        from burn_raymarching.render.culled import (
            culled_march_normals_xla,
        )

        cfg = self.cfg
        ds = self.dataset
        model_axis = "model" if self.model > 1 else None
        kern = (self.culled_march_normal_fn if model_axis is None
                else partial(culled_march_normals_xla, model_axis=model_axis))
        tile = cfg.cull_tile
        k_val = jnp.float32(smooth_k)
        centers_p, _, radii_p, _, _ = activate(padded)
        p_loc = ds.p_local
        # Tiles per lax.map slice: one training batch's worth.
        group = max(1, min(cfg.batch_size, p_loc) // tile)
        quantum = tile * group
        n_pad = ((p_loc + quantum - 1) // quantum) * quantum

        def dev(centers_p, radii_p, mask, ro, rd):
            if n_pad != p_loc:
                ro = jnp.concatenate(
                    [ro, jnp.repeat(ro[-1:], n_pad - p_loc, axis=0)])
                rd = jnp.concatenate(
                    [rd, jnp.repeat(rd[-1:], n_pad - p_loc, axis=0)])
            b = n_pad // tile

            def one(args):
                # Selection AND march per map slice: selecting all local
                # tiles up front materializes a [tiles*K, 3] gather that
                # blows device memory at real shapes (15,360 tiles x K=2048
                # on the c4 recipe with data=1).
                ro3, rd3 = args                       # [group, tile, 3]
                cones = tile_cones(ro3.reshape(-1, 3), rd3.reshape(-1, 3),
                                   tile)
                idx_t, valid_t = select_tile_primitives(
                    cones, centers_p, radii_p, k_val, cfg.cull_budget,
                    mask=mask)
                cs = jnp.take(centers_p, idx_t, axis=0)
                rs = jnp.take(radii_p.reshape(-1), idx_t, axis=0)
                qs = jnp.where(valid_t, jnp.sum(cs * cs, axis=2), 1e30)
                t, _ = kern(ro3, rd3, cs, rs, qs, k_val,
                            num_steps=cfg.render.march_steps,
                            normal_eps=cfg.render.normal_eps)
                return t

            t = jax.lax.map(one, (
                ro.reshape(b // group, group, tile, 3),
                rd.reshape(b // group, group, tile, 3),
            ))
            return t.reshape(-1)[:p_loc]

        pspec2 = P("model", None) if self.model > 1 else P(None, None)
        mspec = P("model") if self.model > 1 else P(None)
        sharded = jax.shard_map(
            dev, mesh=self.mesh,
            in_specs=(pspec2, pspec2, mspec, P("data", None),
                      P("data", None)),
            out_specs=P("data"),
            check_vma=False)
        self.t_cache = jax.jit(sharded)(centers_p, radii_p, mask,
                                        ds.rays_o, ds.rays_d)
