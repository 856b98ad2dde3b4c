"""Ray dataset with foreground-boosted importance sampling.

The reference (src/dataset.rs) holds all rays/targets on device, splits
pixels into fg/bg on the host (color sum > 0.05) and builds every batch's
indices with a CPU RNG before a device gather. Here the fg index set is
computed once (vectorized) and batch sampling is a pure jittable function of
a jax PRNG key — the whole step stays on device, no per-step host round trip.

Sampling semantics (src/dataset.rs:47-82): a batch is
floor(batch*uniform_ratio) uniform picks over all pixels plus
(batch - that) picks uniform over the fg set, with the fg-boost count capped
at |fg| (and the remainder shifted back to uniform) when the fg set is small.
Both pools sample with replacement.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def compute_fg_indices(targets: np.ndarray, threshold: float = 0.05):
    """Split pixel indices by target brightness (reference dataset.rs:26-35).

    Returns (fg_indices_padded [P] int32, n_fg). The fg array is padded to the
    full pixel count with zeros so its shape is static for jit.
    """
    sums = np.asarray(targets).reshape(-1, 3).sum(axis=1)
    fg = np.nonzero(sums > threshold)[0].astype(np.int32)
    n_total = sums.shape[0]
    padded = np.zeros((n_total,), np.int32)
    padded[: fg.shape[0]] = fg
    return padded, int(fg.shape[0])


def sample_batch_indices(
    key: jax.Array,
    n_total: int,
    fg_indices: jax.Array,   # [P] padded
    n_fg: jax.Array,         # scalar int32
    batch_size: int,
    uniform_ratio: jax.Array,  # scalar in [0, 1]
) -> jax.Array:
    """Jittable batch index sampler → [batch_size] int32."""
    k_uni, k_fg = jax.random.split(key)
    n_uniform_req = jnp.floor(batch_size * uniform_ratio).astype(jnp.int32)
    n_fg_boost = jnp.where(
        n_fg > 0,
        jnp.minimum(batch_size - n_uniform_req, n_fg),
        0,
    )
    n_uniform = batch_size - n_fg_boost

    uni = jax.random.randint(k_uni, (batch_size,), 0, n_total, dtype=jnp.int32)
    fg_pos = jax.random.randint(
        k_fg, (batch_size,), 0, jnp.maximum(n_fg, 1), dtype=jnp.int32
    )
    fg = fg_indices[fg_pos]
    slots = jnp.arange(batch_size, dtype=jnp.int32)
    return jnp.where(slots < n_uniform, uni, fg)


class RayDataset:
    """All training rays + targets, device-resident.

    Mirrors reference SceneDataset (src/dataset.rs:4-45) but fg/bg membership
    is vectorized and sampling is device-side.
    """

    def __init__(self, rays_o, rays_d, targets, fg_threshold: float = 0.05):
        self.fg_threshold = fg_threshold
        self.rays_o = jnp.asarray(rays_o)
        self.rays_d = jnp.asarray(rays_d)
        self.targets = jnp.asarray(targets)
        # Packed [P, 9] copy (ro | rd | target): batch sampling is one row
        # gather instead of three.
        self.packed = jnp.concatenate(
            [self.rays_o, self.rays_d, self.targets], axis=1)
        self.num_total_pixels = int(self.rays_o.shape[0])
        fg_padded, n_fg = compute_fg_indices(np.asarray(targets), fg_threshold)
        self.fg_indices = jnp.asarray(fg_padded)
        self.n_fg = jnp.asarray(n_fg, dtype=jnp.int32)
        self.num_fg = n_fg
        self.num_bg = self.num_total_pixels - n_fg

    def sample_batch(self, key, batch_size: int, uniform_ratio):
        """Gather one batch → (rays_o, rays_d, targets), each [B, 3]."""
        idx = sample_batch_indices(
            key, self.num_total_pixels, self.fg_indices, self.n_fg,
            batch_size, jnp.asarray(uniform_ratio),
        )
        return gather_batch(self.packed, idx)

    def tile_fg(self, tile: int):
        """Tile-granular fg split for block sampling: a tile is foreground
        if ANY of its pixels is (same brightness rule as compute_fg_indices).
        Returns (fg_tile_indices padded to n_tiles [int32], n_fg_tiles).

        Requires the dataset to be Morton-ordered (dataset_order="morton")
        so each run of ``tile`` consecutive pixels is a compact pixel block
        of one view — the coherence contract of ops/culling.
        """
        if self.num_total_pixels % tile:
            raise ValueError(f"pixels ({self.num_total_pixels}) must divide "
                             f"by tile ({tile})")
        px = np.asarray(self.targets).reshape(-1, 3).sum(axis=1)
        any_fg = (px > self.fg_threshold).reshape(-1, tile).any(axis=1)
        fg = np.nonzero(any_fg)[0].astype(np.int32)
        n_tiles = any_fg.shape[0]
        padded = np.zeros((n_tiles,), np.int32)
        padded[: fg.shape[0]] = fg
        return jnp.asarray(padded), int(fg.shape[0])


def gather_batch(packed: jax.Array, idx: jax.Array):
    """One [B, 9] row gather → (ro, rd, target) [B, 3] views."""
    rows = jnp.take(packed, idx, axis=0)
    return rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
