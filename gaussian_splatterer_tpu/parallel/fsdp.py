"""Two-axis sharding: camera data-parallel x splat-sharded parameters.

The splat axis is the tensor-parallel analog for this workload (SURVEY
§2.4): model state lives sharded across the ``splat`` mesh axis (FSDP /
ZeRO-3 style), every device trains on its own shard of the truth frames
(both mesh axes act as data parallelism), and each step:

  1. all-gathers the splat parameters over the ``splat`` axis (one fused
     all-gather; ~50 MB at 1M splats),
  2. runs the local frames through the frame-batched train core (the same
     fast path as the single-device Trainer),
  3. reduce-scatters the parameter gradients over ``splat`` (so each device
     only materializes its shard's gradient sum) and psums over ``camera``,
  4. applies the SGD update to its local shard only.

Rest-state memory per device is capacity/num_splat_shards splats; the
transient full-parameter copy during the step bounds scaling by device
memory — past that, binning itself must go distributed (routed3.py).

Densify runs on gathered state between steps (host-driven, same cadence as
the reference's CPU densify).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gaussian_splatterer_tpu.config import RuntimeConfig
from gaussian_splatterer_tpu.models.splats import SplatModel
from gaussian_splatterer_tpu.parallel.dp import make_local_accumulate
from gaussian_splatterer_tpu.train.trainer import (
    CameraBatch,
    LearningRates,
    RenderFn,
    TrainMetrics,
)

CAMERA_AXIS = "camera"
SPLAT_AXIS = "splat"


def make_2d_mesh(n_camera: int, n_splat: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_camera * n_splat
    grid = np.asarray(devices[: n_camera * n_splat]).reshape(n_camera, n_splat)
    return Mesh(grid, (CAMERA_AXIS, SPLAT_AXIS))


def shard_model(mesh: Mesh, model: SplatModel) -> SplatModel:
    """Place the model's capacity axis across the splat mesh axis."""
    def put(x):
        if x.ndim == 0:
            return jax.device_put(x, NamedSharding(mesh, P()))
        return jax.device_put(
            x, NamedSharding(mesh, P(SPLAT_AXIS, *([None] * (x.ndim - 1))))
        )

    return jax.tree.map(put, model)


def shard_truths_2d(mesh: Mesh, truths: jax.Array) -> jax.Array:
    """Frames sharded over BOTH axes (every device is data-parallel)."""
    return jax.device_put(
        truths,
        NamedSharding(mesh, P((CAMERA_AXIS, SPLAT_AXIS), *[None] * (truths.ndim - 1))),
    )


def make_fsdp_train_step(
    mesh: Mesh,
    width: int,
    height: int,
    sh_degree: int,
    renderer: str = "tiled",
    render_fn: Optional[RenderFn] = None,
    row_chunk: int = 32,
    runtime: Optional[RuntimeConfig] = None,
    fused: Optional[bool] = None,
    frame_group: int = 8,
):
    """Sharded-parameter train step over a ('camera', 'splat') mesh.

    truths: (2F, ...) with 2F divisible by the total device count; model
    arrays sharded on their capacity axis (see shard_model).  On the fused
    fast path (default for the tiled renderer) truths must be PRE-TILED
    channel-major to (2F, T, 8, tile*tile) with
    ops.raster_tiled.image_to_tiles_cm.  ``sh_degree`` must match the model's static
    sh_degree field (it shapes the pytree the shard_map specs bind to)."""
    local_accumulate, fused = make_local_accumulate(
        width, height, sh_degree, renderer, render_fn, row_chunk,
        runtime, fused, frame_group,
    )
    n_dev = mesh.devices.size

    # NOTE: sh_degree is a static (treedef) field of the flax struct — the
    # spec pytree must carry the SAME value as the incoming model or the
    # shard_map binding fails (round-1 bug: hardcoded 1 broke degree-3).
    model_specs = SplatModel(
        means=P(SPLAT_AXIS), shs=P(SPLAT_AXIS), scales=P(SPLAT_AXIS),
        opacities=P(SPLAT_AXIS), rotations=P(SPLAT_AXIS),
        count=P(), sh_degree=sh_degree,
    )
    metric_specs = TrainMetrics(
        loss=P(), var_loc=P(SPLAT_AXIS), avg_grad_loc=P(SPLAT_AXIS),
        num_dup=P(),
    )

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            model_specs,
            P((CAMERA_AXIS, SPLAT_AXIS)),  # truths (frame axis over all devices)
            P((CAMERA_AXIS, SPLAT_AXIS)),  # cameras
            P((CAMERA_AXIS, SPLAT_AXIS)),  # backgrounds
            P(),  # lrs
        ),
        out_specs=(model_specs, metric_specs),
        check_vma=False,
    )
    def step_sharded(model_shard, truths, cams, bgs, lrs):
        # 1. materialize full parameters: one fused all-gather
        full = jax.tree.map(
            lambda x: (
                jax.lax.all_gather(x, SPLAT_AXIS, tiled=True)
                if x.ndim > 0
                else x
            ),
            model_shard,
        )
        params = (full.means, full.shs, full.scales, full.opacities,
                  full.rotations)
        g_sum, var_sum, loss_sum, num_dup = local_accumulate(
            params, full.active_mask(), full.capacity, truths, cams, bgs
        )
        num_dup = jax.lax.pmax(num_dup, (CAMERA_AXIS, SPLAT_AXIS))

        # 2. gradient reduction: reduce-scatter over the splat axis keeps
        #    only the local shard's gradients, then psum over cameras
        def reduce_grad(g):
            g = jax.lax.psum_scatter(g, SPLAT_AXIS, scatter_dimension=0, tiled=True)
            return jax.lax.psum(g, CAMERA_AXIS)

        g_means, g_shs, g_scales, g_opac, g_rot = jax.tree.map(reduce_grad, g_sum)
        var_shard = jax.lax.psum(
            jax.lax.psum_scatter(var_sum, SPLAT_AXIS, scatter_dimension=0, tiled=True),
            CAMERA_AXIS,
        )
        loss_sum = jax.lax.psum(loss_sum, (CAMERA_AXIS, SPLAT_AXIS))

        samples = jnp.float32(truths.shape[0] * n_dev)
        g_means = g_means / samples
        new_shard = model_shard.replace(
            means=model_shard.means + g_means * lrs.location,
            shs=model_shard.shs + (g_shs / samples) * lrs.sh,
            scales=jnp.clip(
                model_shard.scales + (g_scales / samples) * lrs.scale,
                0.0, lrs.scale_max,
            ),
            opacities=jnp.clip(
                model_shard.opacities + (g_opac / samples) * lrs.opacity, 0.0, 1.0
            ),
            rotations=model_shard.rotations + (g_rot / samples) * lrs.rotation,
        )
        metrics = TrainMetrics(
            loss=loss_sum / samples,
            var_loc=var_shard / samples,
            avg_grad_loc=g_means,
            num_dup=num_dup,
        )
        return new_shard, metrics

    @jax.jit
    def step(model: SplatModel, truths, cams: CameraBatch, lrs: LearningRates):
        f = cams.num_frames
        assert truths.shape[0] == 2 * f, "need white+black frame per camera"
        assert (2 * f) % n_dev == 0, "2*num_cameras must divide the mesh size"
        assert model.sh_degree == sh_degree, (
            "model sh_degree must match the step's (shard_map spec treedef)"
        )
        cams2 = jax.tree.map(lambda x: jnp.concatenate([x, x], 0), cams)
        bgs = jnp.concatenate(
            [jnp.ones((f, 3), jnp.float32), jnp.zeros((f, 3), jnp.float32)], 0
        )
        return step_sharded(model, truths, cams2, bgs, lrs)

    return step
