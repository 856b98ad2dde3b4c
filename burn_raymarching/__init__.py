"""burn_raymarching — a differentiable SDF raymarching framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
kokutoupan/burn_raymarching reference (Rust/Burn/WGPU): inverse rendering of
sphere-primitive scenes from multi-view images via differentiable sphere
tracing with softmax depth compositing, learnable Lambertian lighting, Adam
optimization, and 3DGS-style adaptive density control between stages.

Layer map:
  ops/       — SDF math, soft-min, march, shading (pure JAX + Pallas kernels,
               chosen per platform in ops/kernels.py)
  models/    — SceneParams pytree + activations + forward
  render/    — differentiable + ground-truth renderers
  data/      — cameras, ray dataset + importance sampling, image/scene I/O
  train/     — loss, density control, multi-stage training loop
  parallel/  — device mesh, shard_map train step, M-sharded compositing
  tools/     — generate / train / viewer / chromakey / COLMAP CLIs
  utils/     — padding buckets, misc
"""

__version__ = "0.1.0"

from burn_raymarching.config import TrainConfig  # noqa: F401
