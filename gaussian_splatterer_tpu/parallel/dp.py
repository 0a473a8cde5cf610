"""Data parallelism over truth cameras: shard_map + psum over the mesh.

The reference is strictly single-GPU (SURVEY §2.4) — this is new capability:
truth frames are embarrassingly parallel (the reference proves order
doesn't matter because gradients are averaged over all frames,
src/Trainer.cu:416-419), so we shard the frame axis across a ``('camera',)``
device mesh.  Each device runs its local frames through the frame-batched
train core (ops.raster_tiled.render_train_grads_batch — the same fast path
the single-device Trainer uses), the per-splat gradient sums are
``psum``-reduced, and every device applies the identical SGD update to its
replicated model copy.

Scaling model (How-to-Scale-Your-Model recipe): pick the mesh, annotate
shardings, let XLA place the collectives.  The psum payload is one gradient
set (capacity x ~23 floats) per step — at 50k splats that's ~4.6 MB, far
below interconnect bandwidth at any realistic step time; scaling efficiency is
gated by per-device frame count balance, so keep 2F divisible by the mesh
size.

Splat-axis (tensor-parallel analog) sharding for >1M-splat models is the
second axis on the same mesh (fsdp.py); the gradient math here already
works per-shard since the update is elementwise.
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
from gaussian_splatterer_tpu.train.trainer import (
    CameraBatch,
    fused_kw_from_runtime,
    LearningRates,
    RenderFn,
    TrainMetrics,
    _default_render,
    _largest_divisor_leq,
)

CAMERA_AXIS = "camera"


def make_camera_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (CAMERA_AXIS,))


# the canonical RuntimeConfig -> fused-kernel options mapping lives next
# to the Trainer; parallel builders share it so single-chip and multi-chip
# steps can never train with different kernel options
_fused_kw = fused_kw_from_runtime


def make_local_accumulate(
    width: int,
    height: int,
    sh_degree: int,
    renderer: str,
    render_fn: Optional[RenderFn],
    row_chunk: int,
    runtime: Optional[RuntimeConfig],
    fused: Optional[bool],
    frame_group: int,
):
    """Per-device frame loop shared by the DP and FSDP steps: returns a
    function (params, active, capacity, truths, cams, bgs) ->
    (g_sum, var_sum, loss_sum, num_dup) of SUMS over the local frames
    (num_dup = local max binning duplicates; -1 off the fused path).

    ``fused=None`` auto-selects the fused frame-batched train core
    whenever the tiled renderer with default render_fn is in play and the
    resolution is tile-aligned — the same fast path as the single-chip
    Trainer.  The fused path consumes PRE-TILED channel-major truths
    (F, T, 4, P) built with ops.raster_tiled.image_to_tiles_cm."""
    tile = runtime.tile_px if runtime is not None else RuntimeConfig.tile_px
    if fused is None:
        fused = (
            renderer == "tiled"
            and render_fn is None
            and width % tile == 0
            and height % tile == 0
        )
    if fused:
        from gaussian_splatterer_tpu.ops.raster_tiled import (
            render_train_grads_batch,
        )

        fkw = _fused_kw(runtime)

        def local_accumulate(params, active, capacity, truths, cams, bgs):
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
                l_sum, g, v, _, nd = render_train_grads_batch(
                    *params, active, view_g, pv_g, pos_g, tx_g, ty_g,
                    width, height, truth_g, bg_g, sh_degree, **fkw,
                )
                return (
                    jax.tree.map(jnp.add, g_sum, g),
                    var_sum + v,
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
                # single group: skip lax.scan — its xs dynamic-slice copies
                # the whole local truth batch every step
                out, _ = group_fn(init, jax.tree.map(lambda x: x[0], xs))
            else:
                out, _ = jax.lax.scan(group_fn, init, xs)
            return out

        return local_accumulate, True

    render = (
        render_fn if render_fn is not None
        else _default_render(renderer, row_chunk, runtime)
    )

    def local_accumulate(params, active, capacity, truths, cams, bgs):
        def frame_fn(carry, xs):
            g_sum, var_sum, loss_sum = carry
            truth, view, pv, pos, tx, ty, bg = xs

            def fwd(p):
                means, shs, scales, opac, rot = p
                return render(
                    means, shs, scales, opac, rot, active,
                    view, pv, pos, tx, ty, width, height, bg, sh_degree, 1.0,
                )

            img, pull = jax.vjp(fwd, params)
            residual = truth - img
            g = pull(residual)[0]
            g_sum = jax.tree.map(jnp.add, g_sum, g)
            var_sum = var_sum + jnp.linalg.norm(g[0], axis=-1)
            loss_sum = loss_sum + jnp.mean(jnp.square(residual))
            return (g_sum, var_sum, loss_sum), None

        init = (
            jax.tree.map(jnp.zeros_like, params),
            jnp.zeros((capacity,), jnp.float32),
            jnp.float32(0.0),
        )
        (g_sum, var_sum, loss_sum), _ = jax.lax.scan(
            frame_fn, init,
            (truths, cams.view, cams.proj_view, cams.cam_pos,
             cams.tan_fovx, cams.tan_fovy, bgs),
        )
        return g_sum, var_sum, loss_sum, jnp.int32(-1)

    return local_accumulate, False


def make_dp_train_step(
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
    """Build the sharded (model, truths, cams, lrs) -> (model', metrics) step.

    truths: (2F, ...) with 2F divisible by the mesh size; white-background
    frames first, then black (src/Trainer.cu:311-314).  Model and learning
    rates are replicated; only the frame axis is sharded.  On the fused
    fast path (default for the tiled renderer) truths must be PRE-TILED
    channel-major to (2F, T, 4, tile*tile) with
    ops.raster_tiled.image_to_tiles_cm; pass
    ``fused=False`` to train on (2F, H, W, 3) images with a custom
    render_fn.  ``runtime`` threads tile_px / max_dup / etc. into the
    renderer (RuntimeConfig defaults otherwise)."""
    local_accumulate, fused = make_local_accumulate(
        width, height, sh_degree, renderer, render_fn, row_chunk,
        runtime, fused, frame_group,
    )
    n_dev = mesh.devices.size

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(CAMERA_AXIS), P(CAMERA_AXIS), P(CAMERA_AXIS), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def step_sharded(model, truths, cams, bgs, lrs):
        params = (model.means, model.shs, model.scales, model.opacities,
                  model.rotations)
        g_sum, var_sum, loss_sum, num_dup = local_accumulate(
            params, model.active_mask(), model.capacity, truths, cams, bgs
        )
        # single fused all-reduce for every gradient tensor
        g_sum, var_sum, loss_sum = jax.lax.psum(
            (g_sum, var_sum, loss_sum), CAMERA_AXIS
        )
        num_dup = jax.lax.pmax(num_dup, CAMERA_AXIS)
        samples = jnp.float32(truths.shape[0] * n_dev)
        g_means, g_shs, g_scales, g_opac, g_rot = jax.tree.map(
            lambda g: g / samples, g_sum
        )
        new_model = model.replace(
            means=model.means + g_means * lrs.location,
            shs=model.shs + g_shs * lrs.sh,
            scales=jnp.clip(model.scales + g_scales * lrs.scale, 0.0, lrs.scale_max),
            opacities=jnp.clip(model.opacities + g_opac * lrs.opacity, 0.0, 1.0),
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
        assert (2 * f) % n_dev == 0, "2*num_cameras must divide the mesh size"
        cams2 = jax.tree.map(lambda x: jnp.concatenate([x, x], 0), cams)
        bgs = jnp.concatenate(
            [jnp.ones((f, 3), jnp.float32), jnp.zeros((f, 3), jnp.float32)], 0
        )
        return step_sharded(model, truths, cams2, bgs, lrs)

    return step


def shard_truths(mesh: Mesh, truths: jax.Array) -> jax.Array:
    """Place the frame axis of a truth batch across the camera mesh."""
    return jax.device_put(truths, NamedSharding(mesh, P(CAMERA_AXIS)))
