"""Full 3-axis sharding: camera DP x image bands x splat-sharded params.

Composes the three parallel axes this framework implements (SURVEY §2.4 /
§5) on ONE mesh, so a multi-device run can scale along whichever
resource is scarce:

  * ``camera`` — truth frames are data-parallel (parallel/dp.py),
  * ``tile``   — each device rasterizes a horizontal band of its frames
    (parallel/tp.py's band offset; the duplicate buffer itself shards by
    tile ownership),
  * ``splat``  — parameters live sharded at rest (parallel/fsdp.py's
    ZeRO-3 pattern: one fused all-gather in, reduce-scattered gradients
    out).

Reduction order per step: the per-frame location gradients psum over
``tile`` BEFORE the nonlinear densify-variance norm (exactness — see
parallel/tp.py), then everything psums over ``camera`` and
reduce-scatters over ``splat`` so each device only materializes its
shard's gradients.  Gradient-mean semantics match src/Trainer.cu:416-419.
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
from gaussian_splatterer_tpu.parallel.dp import CAMERA_AXIS, _fused_kw
from gaussian_splatterer_tpu.parallel.fsdp import SPLAT_AXIS
from gaussian_splatterer_tpu.parallel.tp import TILE_AXIS, make_band_accumulate
from gaussian_splatterer_tpu.train.trainer import (
    CameraBatch,
    LearningRates,
    TrainMetrics,
)


def make_3d_mesh(n_camera: int, n_tile: int, n_splat: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = n_camera * n_tile * n_splat
    assert len(devices) >= n
    grid = np.asarray(devices[:n]).reshape(n_camera, n_tile, n_splat)
    return Mesh(grid, (CAMERA_AXIS, TILE_AXIS, SPLAT_AXIS))


def shard_model_3d(mesh: Mesh, model: SplatModel) -> SplatModel:
    """Capacity axis over 'splat'; replicated over 'camera' and 'tile'."""
    def put(x):
        if x.ndim == 0:
            return jax.device_put(x, NamedSharding(mesh, P()))
        return jax.device_put(
            x, NamedSharding(mesh, P(SPLAT_AXIS, *([None] * (x.ndim - 1))))
        )

    return jax.tree.map(put, model)


def shard_truths_3d(mesh: Mesh, truth_tiles: jax.Array) -> jax.Array:
    """(2F, T, 8, P): frames over ('camera', 'splat') jointly — the splat
    axis is data-parallel too, exactly like fsdp.py — and tile rows over
    'tile'."""
    return jax.device_put(
        truth_tiles,
        NamedSharding(
            mesh, P((CAMERA_AXIS, SPLAT_AXIS), TILE_AXIS, None, None)
        ),
    )


def make_3d_train_step(
    mesh: Mesh,
    width: int,
    height: int,
    sh_degree: int,
    runtime: Optional[RuntimeConfig] = None,
    frame_group: int = 8,
):
    """Sharded (model, truths, cams, lrs) -> (model', metrics) step over a
    ('camera', 'tile', 'splat') mesh.

    Model arrays sharded on the capacity axis (shard_model_3d); truths
    pre-tiled channel-major with frames over 'camera' and tile ROWS over
    'tile' (shard_truths_3d).  2F must divide the camera axis; the tile-row
    count must divide the tile axis.  Fused tiled path only."""
    fkw = _fused_kw(runtime)
    tile = fkw.get("tile", RuntimeConfig.tile_px)
    n_cam_ax = mesh.shape[CAMERA_AXIS]
    n_band = mesh.shape[TILE_AXIS]
    ty_tiles = -(-height // tile)
    assert ty_tiles % n_band == 0, (
        f"tile rows ({ty_tiles}) must divide evenly into {n_band} bands"
    )
    band_h = (ty_tiles // n_band) * tile

    n_splat = mesh.shape[SPLAT_AXIS]
    model_specs = SplatModel(
        means=P(SPLAT_AXIS), shs=P(SPLAT_AXIS), scales=P(SPLAT_AXIS),
        opacities=P(SPLAT_AXIS), rotations=P(SPLAT_AXIS),
        count=P(), sh_degree=sh_degree,
    )
    metric_specs = TrainMetrics(
        loss=P(), var_loc=P(SPLAT_AXIS), avg_grad_loc=P(SPLAT_AXIS),
        num_dup=P(),
    )

    local_accumulate = make_band_accumulate(
        width, height, sh_degree, fkw, band_h, frame_group
    )

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            model_specs,
            P((CAMERA_AXIS, SPLAT_AXIS), TILE_AXIS),  # pre-tiled truths
            P((CAMERA_AXIS, SPLAT_AXIS)),  # cameras
            P((CAMERA_AXIS, SPLAT_AXIS)),  # backgrounds
            P(),  # lrs
        ),
        out_specs=(model_specs, metric_specs),
        check_vma=False,
    )
    def step_sharded(model_shard, truths, cams, bgs, lrs):
        # 1. materialize full parameters (fsdp.py pattern)
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
        num_dup = jax.lax.pmax(num_dup, (CAMERA_AXIS, TILE_AXIS, SPLAT_AXIS))

        # 2. means/variance were tile-reduced in the scan; the rest still
        #    carries band partials.  reduce-scatter over 'splat' first so
        #    only shard-sized gradients ride the remaining psums (splat
        #    ranks hold DIFFERENT frames, so the scatter-sum is a true
        #    data-parallel reduction, same as fsdp.py).
        def rs(g):
            return jax.lax.psum_scatter(
                g, SPLAT_AXIS, scatter_dimension=0, tiled=True
            )

        g_means = jax.lax.psum(rs(g_sum[0]), CAMERA_AXIS)
        g_rest = jax.lax.psum(
            jax.tree.map(rs, g_sum[1:]), (CAMERA_AXIS, TILE_AXIS)
        )
        var_shard = jax.lax.psum(rs(var_sum), CAMERA_AXIS)
        loss_sum = (
            jax.lax.psum(loss_sum, (CAMERA_AXIS, TILE_AXIS, SPLAT_AXIS))
            / n_band
        )

        samples = jnp.float32(truths.shape[0] * n_cam_ax * n_splat)
        g_shs, g_scales, g_opac, g_rot = jax.tree.map(
            lambda g: g / samples, g_rest
        )
        g_means = g_means / samples
        new_shard = model_shard.replace(
            means=model_shard.means + g_means * lrs.location,
            shs=model_shard.shs + g_shs * lrs.sh,
            scales=jnp.clip(
                model_shard.scales + g_scales * lrs.scale, 0.0, lrs.scale_max
            ),
            opacities=jnp.clip(
                model_shard.opacities + g_opac * lrs.opacity, 0.0, 1.0
            ),
            rotations=model_shard.rotations + g_rot * lrs.rotation,
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
        assert (2 * f) % (n_cam_ax * n_splat) == 0, (
            "2*num_cameras must divide camera_axis * splat_axis"
        )
        assert model.sh_degree == sh_degree, (
            "model sh_degree must match the step's (shard_map spec treedef)"
        )
        cams2 = jax.tree.map(lambda x: jnp.concatenate([x, x], 0), cams)
        bgs = jnp.concatenate(
            [jnp.ones((f, 3), jnp.float32), jnp.zeros((f, 3), jnp.float32)], 0
        )
        return step_sharded(model, truths, cams2, bgs, lrs)

    return step
