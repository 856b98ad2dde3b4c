"""The one place that chooses the march implementation for a platform.

Every driver (Trainer, DistributedTrainer, bench.py, chip_smoke.py, the
scripts) asks ``select_kernels`` for its march callables, so a platform gets
the same path everywhere and an unsupported one fails instead of silently
taking another:

  * ``"gpu"`` with ``use_pallas``: the Pallas/Triton march+normals kernels
    (ops/pallas/march_kernel.py);
  * ``"cpu"``, or ``use_pallas=False``: their plain jax.numpy/lax twins;
  * anything else raises.

Both callables are always set, so features that need a fused
(t, normal) march (warm start, the t-cache prefill) work on every platform.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax

SUPPORTED_BACKENDS = ("gpu", "cpu")


class MarchKernels(NamedTuple):
    march_normal_fn: Callable         # dense (t [N, 1], normal [N, 3])
    culled_march_normal_fn: Callable  # per-tile (t [B,T,1], normal [B,T,3])


def select_kernels(use_pallas: bool,
                   backend: Optional[str] = None) -> MarchKernels:
    """March callables for ``backend`` (default: jax.default_backend())."""
    from burn_raymarching.ops.march import march_normals_xla
    from burn_raymarching.render.culled import culled_march_normals_xla

    backend = jax.default_backend() if backend is None else backend
    if backend not in SUPPORTED_BACKENDS:
        raise ValueError(f"unsupported JAX backend {backend!r}: the march "
                         f"runs on {SUPPORTED_BACKENDS}")
    if backend == "gpu" and use_pallas:
        from burn_raymarching.ops.pallas.march_kernel import (
            culled_march_normals_triton,
            march_normals_triton,
        )

        return MarchKernels(march_normals_triton, culled_march_normals_triton)
    return MarchKernels(march_normals_xla, culled_march_normals_xla)
