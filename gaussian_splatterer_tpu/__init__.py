"""A JAX (XLA + Pallas Triton kernels) Gaussian-splat training framework for GPUs.

A from-scratch rebuild of the capabilities of osreboot/Gaussian-Splatterer
(mesh + texture -> path-traced truth photographs -> differentiable splat
rasterization -> per-feature SGD -> densify):

* All training state is a pytree of fixed-capacity padded arrays
  (XLA-friendly static shapes; the reference's ``capacity``/``count`` model,
  see reference src/ModelSplatsHost.h:11-21, maps directly onto padding +
  a validity count).
* The differentiable rasterizer is tile-binned; one Triton program per
  tile walks its depth-sorted splats in chunks, compositing each chunk
  with cumulative log-transmittance.
* The truth "photographer" is a batched JAX path tracer (rays are just
  data).
* Multi-GPU scaling is expressed with jax.sharding meshes + shard_map —
  data-parallel over truth cameras, splat-sharded for large models.

Package layout:
  models/    splat model pytree, cameras
  ops/       rasterization math (SH, covariance, EWA), oracle + tiled rasterizer
  rt/        JAX path tracer for truth generation (mesh, BVH, tracer)
  train/     trainer (capture/train/densify), schedules
  parallel/  device-mesh helpers, sharded train step
  io/        .gobj / OBJ / image / settings-JSON round-trips
  utils/     metrics, logging
  native/    C++ host-side runtime (fast parsers, BVH build)
"""

__version__ = "0.1.0"

from gaussian_splatterer_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from gaussian_splatterer_tpu.config import Project, CameraSphere, RuntimeConfig  # noqa: F401
from gaussian_splatterer_tpu.models.splats import SplatModel, SplatModelHost  # noqa: F401
from gaussian_splatterer_tpu.models.camera import Camera  # noqa: F401
