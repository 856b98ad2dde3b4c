"""Device mesh construction.

The scaling axes for this workload (SURVEY §2, §5):
  * "data"  — rays/pixels: embarrassingly parallel forward, gradients psum'd.
    This is the primary axis; collectives are tiny (per-primitive param grads
    are M×7 floats) and latency-bound.
  * "model" — primitives (the M axis): only needed for very large M (~50k),
    where each device holds a shard of the primitive table and the soft-min /
    softmax compositor is combined across devices with a two-pass
    max-then-sum logsumexp (ops/sdf.py, render/culled.py).

The cards of one host are joined all to all (NVLink), so the device order
carries no topology: the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ("data", "model") mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if data is None:
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs more than {n} devices")
    arr = np.asarray(devices[: data * model]).reshape(data, model)
    return Mesh(arr, ("data", "model"))
