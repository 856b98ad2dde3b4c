"""Scatter-free custom VJPs for chunk-frozen gathers.

The two-level repulsion's differentiable prep gathers member positions
into cluster blocks and then neighbor-cluster blocks
(``train/loss.cluster_repulsion``; approximates reference
src/training.rs:73-83 at scale). Reverse AD of ``jnp.take`` emits an XLA
scatter-add, which a backend may lower conservatively (possible duplicate
indices → serialized updates). When the index tables are frozen for a
scan chunk (``train/loss.RepulsionStatic``) we can do better than the
generic scatter:

* the neighbor-block gather ``take(cs, nb, axis=0)`` has genuinely
  duplicated indices (every cluster is a neighbor of ~W others), but its
  transpose is a fixed linear map — precompute the transposed one-hot
  ``hot_t[j, c·W+w] = [nb[c, w] == j]`` once per chunk and the backward
  becomes one matmul ``hot_t @ ḡ`` ([C, C·W]×[C·W, G·3]; ~2 GFLOP and
  ~25 MB of device-memory traffic at M=51,200 — vs a 409,600-row
  scatter-add).

``precision=HIGHEST`` keeps the accumulation f32 (default precision would
round the cotangents through a reduced format; the repo invariant is
HIGHEST on every dot).

Not wired into the training step: on the hardware it was first measured
on, XLA's [C, W]-block scatter-add beat streaming the hot table at this
size. Whether that holds on the H100 is open (ROADMAP); the wrapper stays
correct and tested (tests/test_static_gather.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.custom_vjp
def take_blocks(cs: jax.Array, nb: jax.Array, hot_t: jax.Array) -> jax.Array:
    """``jnp.take(cs, nb, axis=0).reshape(C, W·G, 3)`` with a one-hot
    matmul backward.

    cs: [C, G, 3] member positions; nb: [C, W] int32 neighbor-cluster
    ids; hot_t: [C, C·W] f32 transposed one-hot of ``nb`` (chunk-frozen,
    ``train/loss.build_repulsion_static``). Forward is the identical
    block-structured gather (whole [G, 3] blocks — see the round-5
    gather-granularity lesson in train/loss.py).
    """
    c, g, _ = cs.shape
    w = nb.shape[1]
    return jnp.take(cs, nb, axis=0).reshape(c, w * g, 3)


def _take_blocks_fwd(cs, nb, hot_t):
    return take_blocks(cs, nb, hot_t), (cs.shape, nb, hot_t)


def _take_blocks_bwd(res, gbar):
    (c, g, _), nb, hot_t = res
    w = nb.shape[1]
    g2 = gbar.reshape(c, w, g, 3).reshape(c * w, g * 3)
    d_cs = jax.lax.dot_general(
        hot_t, g2, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST)              # [C, G·3]
    return d_cs.reshape(c, g, 3), jnp.zeros_like(nb), jnp.zeros_like(hot_t)


take_blocks.defvjp(_take_blocks_fwd, _take_blocks_bwd)


def neighbor_hot_t(nb: jax.Array, c_count: int) -> jax.Array:
    """[C, C·W] transposed one-hot of the neighbor table (f32).

    ``hot_t @ ḡ_blocks`` reproduces the scatter-add transpose of
    ``take(·, nb, axis=0)`` exactly (every duplicated neighbor edge
    contributes its own row). ~C²·W·4 bytes — 20 MB at M=51,200 (C=800,
    W=8), rebuilt once per scan chunk.
    """
    return jax.nn.one_hot(nb.reshape(-1), c_count,
                          dtype=jnp.float32).T
