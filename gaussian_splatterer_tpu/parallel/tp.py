"""Tile-axis (image-band) parallelism: shard the rasterized image itself.

Camera DP (parallel/dp.py) runs out of parallelism when the rig has fewer
frames than the mesh has chips (SURVEY §5: "tile sharding when cameras <
chips").  This axis splits every frame's TILE GRID into horizontal bands —
device (c, t) rasterizes band t of the frames in camera-shard c:

  * the projection stays full-image; each device shifts the projected
    centers by -band_offset and bins against its band-local tile grid
    (ops.raster_tiled.render_train_grads_batch ``band=`` support).  Splats
    outside the band clamp to empty tile AABBs and cost nothing,
  * pre-tiled truths are sharded along the TILE axis — row-major tile
    order makes a band a contiguous slice, so placement is a plain
    NamedSharding, no re-layout,
  * per-band gradients are partial sums over the band's pixels, so one
    psum over ('camera', 'tile') restores the exact full-frame gradient
    (gradient-mean semantics match src/Trainer.cu:416-419),
  * the densify "variance" signal is Σ_frames ‖∇location‖ — a NONLINEAR
    norm, so the raw per-frame location gradients are psum'd over the band
    axis FIRST (frame_loc_grads=True), then normed; the result is
    bit-comparable to the single-device signal.

The model is replicated (bands all need all splats); compose with
parallel/fsdp.py's splat axis instead when parameters dominate memory.
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
from gaussian_splatterer_tpu.train.trainer import (
    CameraBatch,
    LearningRates,
    TrainMetrics,
    _largest_divisor_leq,
)

TILE_AXIS = "tile"


def make_tile_mesh(n_camera: int, n_tile: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_camera * n_tile
    grid = np.asarray(devices[: n_camera * n_tile]).reshape(n_camera, n_tile)
    return Mesh(grid, (CAMERA_AXIS, TILE_AXIS))


def shard_truths_tp(mesh: Mesh, truth_tiles: jax.Array) -> jax.Array:
    """(2F, T, 8, P) pre-tiled truths: frames over 'camera', tiles over
    'tile' (bands are contiguous T-slices in row-major tile order)."""
    return jax.device_put(
        truth_tiles,
        NamedSharding(mesh, P(CAMERA_AXIS, TILE_AXIS, None, None)),
    )


def make_band_accumulate(width, height, sh_degree, fkw, band_h, frame_group):
    """Per-device frame loop for band-sharded rasterization: returns
    (params, active, capacity, truths, cams, bgs) -> SUMS over the local
    frames of (grads, densify variance, loss, num_dup), with the
    per-frame location gradients psum'd over TILE_AXIS BEFORE the
    nonlinear variance norm (exactness — module docstring).  Shared by the
    2-axis tp step and the 3-axis mesh3 step."""
    from gaussian_splatterer_tpu.ops.raster_tiled import render_train_grads_batch

    def band_accumulate(params, active, capacity, truths, cams, bgs):
        y_off = (jax.lax.axis_index(TILE_AXIS) * band_h).astype(jnp.float32)
        n_local = truths.shape[0]
        group = _largest_divisor_leq(n_local, frame_group)
        xs = jax.tree.map(
            lambda x: x.reshape(n_local // group, group, *x.shape[1:]),
            (truths, cams.view, cams.proj_view, cams.cam_pos,
             cams.tan_fovx, cams.tan_fovy, bgs),
        )

        def group_fn(carry, xg):
            g_sum, var_sum, loss_sum, ndup = carry
            truth_g, view_g, pv_g, pos_g, tx_g, ty_g, bg_g = xg
            l_sum, g, d_means_b, _, nd = render_train_grads_batch(
                *params, active, view_g, pv_g, pos_g, tx_g, ty_g,
                width, height, truth_g, bg_g, sh_degree,
                band=(y_off, band_h), frame_loc_grads=True, **fkw,
            )
            # exact per-frame location grads: sum the band partials BEFORE
            # the nonlinear norm (one (group, C, 3) psum per group)
            d_means_b = jax.lax.psum(d_means_b, TILE_AXIS)
            g = (jnp.sum(d_means_b, axis=0),) + tuple(g[1:])
            var = jnp.sum(
                jnp.sqrt(jnp.sum(jnp.square(d_means_b), axis=-1)), axis=0
            )
            return (
                jax.tree.map(jnp.add, g_sum, g),
                var_sum + var,
                loss_sum + l_sum,
                jnp.maximum(ndup, nd),
            ), None

        init = (
            jax.tree.map(jnp.zeros_like, params),
            jnp.zeros((capacity,), jnp.float32),
            jnp.float32(0.0),
            jnp.int32(0),
        )
        if n_local // group == 1:
            # single group: skip lax.scan (xs dynamic-slice copies the
            # whole local truth batch every step — trainer.py)
            return group_fn(init, jax.tree.map(lambda x: x[0], xs))[0]
        return jax.lax.scan(group_fn, init, xs)[0]

    return band_accumulate


def make_tp_train_step(
    mesh: Mesh,
    width: int,
    height: int,
    sh_degree: int,
    runtime: Optional[RuntimeConfig] = None,
    frame_group: int = 8,
):
    """Sharded (model, truths, cams, lrs) -> (model', metrics) step over a
    ('camera', 'tile') mesh.

    truths: (2F, T, 4, tile*tile) pre-tiled channel-major
    (ops.raster_tiled.image_to_tiles_cm) with 2F divisible by the camera
    axis and the tile-ROW count divisible by the tile axis.  Model and
    learning rates are replicated.  Only the fused tiled path is supported
    on this axis (band rasterization is a property of the fused kernel)."""
    fkw = _fused_kw(runtime)
    tile = fkw.get("tile", RuntimeConfig.tile_px)
    n_cam_ax, n_band = mesh.shape[CAMERA_AXIS], mesh.shape[TILE_AXIS]
    ty_tiles = -(-height // tile)
    assert ty_tiles % n_band == 0, (
        f"tile rows ({ty_tiles}) must divide evenly into {n_band} bands"
    )
    band_h = (ty_tiles // n_band) * tile

    local_accumulate = make_band_accumulate(
        width, height, sh_degree, fkw, band_h, frame_group
    )

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(),  # model (replicated)
            P(CAMERA_AXIS, TILE_AXIS),  # pre-tiled truths
            P(CAMERA_AXIS),  # cameras
            P(CAMERA_AXIS),  # backgrounds
            P(),  # lrs
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def step_sharded(model, truths, cams, bgs, lrs):
        params = (model.means, model.shs, model.scales, model.opacities,
                  model.rotations)
        g_sum, var_sum, loss_sum, num_dup = local_accumulate(
            params, model.active_mask(), model.capacity, truths, cams, bgs
        )
        # means grads + variance were already band-reduced inside the
        # group scan; the rest reduce over both axes in one fused psum
        (g_means, var_sum) = jax.lax.psum((g_sum[0], var_sum), CAMERA_AXIS)
        g_rest = jax.lax.psum(g_sum[1:], (CAMERA_AXIS, TILE_AXIS))
        # per-frame loss is the mean over the FULL tile grid: band means
        # psum to n_band x the full mean
        loss_sum = jax.lax.psum(loss_sum, (CAMERA_AXIS, TILE_AXIS)) / n_band
        num_dup = jax.lax.pmax(num_dup, (CAMERA_AXIS, TILE_AXIS))
        samples = jnp.float32(truths.shape[0] * n_cam_ax)
        g_shs, g_scales, g_opac, g_rot = jax.tree.map(
            lambda g: g / samples, g_rest
        )
        g_means = g_means / samples
        new_model = model.replace(
            means=model.means + g_means * lrs.location,
            shs=model.shs + g_shs * lrs.sh,
            scales=jnp.clip(
                model.scales + g_scales * lrs.scale, 0.0, lrs.scale_max
            ),
            opacities=jnp.clip(
                model.opacities + g_opac * lrs.opacity, 0.0, 1.0
            ),
            rotations=model.rotations + g_rot * lrs.rotation,
        )
        metrics = TrainMetrics(
            loss=loss_sum / samples, var_loc=var_sum / samples,
            avg_grad_loc=g_means, num_dup=num_dup,
        )
        return new_model, metrics

    @jax.jit
    def step(model: SplatModel, truths, cams: CameraBatch, lrs: LearningRates):
        f = cams.num_frames
        assert truths.shape[0] == 2 * f, "need white+black frame per camera"
        assert (2 * f) % n_cam_ax == 0, (
            "2*num_cameras must divide the camera mesh axis"
        )
        cams2 = jax.tree.map(lambda x: jnp.concatenate([x, x], 0), cams)
        bgs = jnp.concatenate(
            [jnp.ones((f, 3), jnp.float32), jnp.zeros((f, 3), jnp.float32)], 0
        )
        return step_sharded(model, truths, cams2, bgs, lrs)

    return step
