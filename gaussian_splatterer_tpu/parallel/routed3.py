"""Sub-transient 3-axis sharding: routed duplicates, NO parameter gather.

The standard 3-axis step (parallel/mesh3.py) shards splat parameters at
rest but transiently all-gathers the full model every step — bounded by
one device's memory (fsdp.py docstring).  This module is the
sub-transient design: every device only ever touches

  * its OWN parameter shard (N / S splats), and
  * the projected ROWS of splats that actually land on its image band
    (~D_band duplicates, not N),

so per-device memory scales with N/S + screen work instead of N.  The
reference has no analog — its single GPU radix-sorts the full duplicate
buffer (src/Trainer.cu:334-360, delegated to diff-gaussian-rasterization).

Dataflow per step, on a ('camera', 'tile', 'splat') mesh (C x B x S):

  device (c, b, s)                                  [projector role]
    1. projects its shard for projection-frame set Fp(c, b) — the 2F
       frames split over camera x band (dense local math, no gathers),
    2. enumerates, per (frame, splat), the destination BANDS its tile
       AABB overlaps (<= B records per splat),
    3. bucket_route along 'tile': records for band d -> device (c, d, s),
    4. bucket_route along 'splat': records for frame f -> the device
       owning f's truth shard (truths shard frames over camera x splat),
  device (c, d, s')                                 [compositor role]
    5. re-buckets received records by local frame, builds per-frame
       "virtual splat" component arrays, and runs the UNCHANGED fused
       band pipeline from pre-projected rows
       (ops.raster_tiled.render_train_grads_rows),
    6. routes the per-virtual-splat row gradients BACK along the same
       two hops (parallel/route.route_back — all_to_all is its own
       transpose; the pack permutations are recomputed, not stored),
  device (c, b, s)                                  [projector again]
    7. sums band-slot gradients per (frame, splat), pulls them through
       its LOCAL projection vjp -> shard-sized parameter gradients, and
    8. psums over ('camera', 'tile') only — gradients are BORN sharded
       over 'splat'; no reduce-scatter, no full-N array anywhere.

Exactness: compositing math is identical to the single-device fused
path; only summation orders differ (reassociation-level, same bound the
realistic-shape mesh3 tests assert).  The densify variance signal is
EXACT by construction: each projector holds complete per-frame location
gradients for its frames, so the nonlinear per-frame norm needs no
pre-norm psum (unlike tp.py/mesh3.py band sharding).

Capacity contract: the three static capacities (``route_cap1`` per
source->band bucket, ``route_cap2`` per band->frame-owner bucket,
``virt_cap`` virtual splats per frame) follow the max_dup/work_cap
overflow-telemetry pattern — RouteStats reports the true maxima, callers
grow and recompile (route.py module docstring has the sizing math)."""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from gaussian_splatterer_tpu.config import RuntimeConfig
from gaussian_splatterer_tpu.models.splats import SplatModel
from gaussian_splatterer_tpu.ops.transforms import (
    SplatComponents,
    project_splat_components,
)
from gaussian_splatterer_tpu.parallel.dp import CAMERA_AXIS, _fused_kw
from gaussian_splatterer_tpu.parallel.fsdp import SPLAT_AXIS
from gaussian_splatterer_tpu.parallel.route import (
    bucket_local,
    bucket_route,
    route_back,
    unbucket_local,
)
from gaussian_splatterer_tpu.parallel.tp import TILE_AXIS
from gaussian_splatterer_tpu.train.trainer import (
    CameraBatch,
    LearningRates,
    TrainMetrics,
)

# payload rows per routed record: the 9 differentiable feature rows
# (build_rows order), then binning-only extras + the frame id carrier
_R_MX, _R_MY, _R_CA, _R_CB, _R_CC, _R_CR, _R_CG, _R_CB2, _R_OP = range(9)
_R_DEPTH, _R_RX, _R_RY, _R_FRAME = 9, 10, 11, 12
_R_ROWS = 13


class RouteStats(NamedTuple):
    """True per-step maxima of the three static routing capacities
    (pmax over the mesh).  Any value exceeding its configured capacity
    means records were dropped that step — grow and recompile, exactly
    the max_dup overflow contract."""

    route1_max: jax.Array  # () int32 vs route_cap1
    route2_max: jax.Array  # () int32 vs route_cap2
    frame_max: jax.Array  # () int32 vs virt_cap


def make_routed3_train_step(
    mesh,
    width: int,
    height: int,
    sh_degree: int,
    runtime: Optional[RuntimeConfig] = None,
    *,
    route_cap1: int = 1024,
    route_cap2: int = 1024,
    virt_cap: int = 2048,
):
    """Sharded (model, truths, cams, lrs) -> (model', metrics, RouteStats)
    step over a ('camera', 'tile', 'splat') mesh that NEVER materializes
    the full parameter arrays on any device (module docstring).

    Inputs are placed like mesh3: model via mesh3.shard_model_3d (capacity
    axis over 'splat'), truths via mesh3.shard_truths_3d (frames over
    camera x splat, tile rows over 'tile').  2F must divide both
    (camera_axis * splat_axis) and (camera_axis * tile_axis)."""
    from gaussian_splatterer_tpu.ops.binning import tile_aabb
    from gaussian_splatterer_tpu.ops.raster_tiled import (
        render_train_grads_rows,
    )

    fkw = _fused_kw(runtime)
    tile = fkw.get("tile", RuntimeConfig.tile_px)
    chunk = fkw.get("chunk", RuntimeConfig.train_chunk)
    max_dup = fkw.get("max_dup", 2**18)
    aa = fkw.get("aa", False)
    n_cam_ax = mesh.shape[CAMERA_AXIS]
    n_band = mesh.shape[TILE_AXIS]
    n_splat = mesh.shape[SPLAT_AXIS]
    tx_tiles = -(-width // tile)
    ty_tiles = -(-height // tile)
    assert ty_tiles % n_band == 0, (
        f"tile rows ({ty_tiles}) must divide evenly into {n_band} bands"
    )
    rows_per_band = ty_tiles // n_band
    band_h = rows_per_band * tile
    # virtual splat count is the capacity the band kernel sees
    assert virt_cap >= chunk, "virt_cap must cover at least one chunk"

    model_specs = SplatModel(
        means=jax.sharding.PartitionSpec(SPLAT_AXIS),
        shs=jax.sharding.PartitionSpec(SPLAT_AXIS),
        scales=jax.sharding.PartitionSpec(SPLAT_AXIS),
        opacities=jax.sharding.PartitionSpec(SPLAT_AXIS),
        rotations=jax.sharding.PartitionSpec(SPLAT_AXIS),
        count=jax.sharding.PartitionSpec(),
        sh_degree=sh_degree,
    )
    P = jax.sharding.PartitionSpec
    metric_specs = TrainMetrics(
        loss=P(), var_loc=P(SPLAT_AXIS), avg_grad_loc=P(SPLAT_AXIS),
        num_dup=P(),
    )
    stats_specs = RouteStats(route1_max=P(), route2_max=P(), frame_max=P())
    ALL_AXES = (CAMERA_AXIS, TILE_AXIS, SPLAT_AXIS)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            model_specs,
            P((CAMERA_AXIS, SPLAT_AXIS), TILE_AXIS),  # pre-tiled truths
            P((CAMERA_AXIS, TILE_AXIS)),  # cameras (projection split)
            P((CAMERA_AXIS, SPLAT_AXIS)),  # backgrounds (composite split)
            P(),  # lrs
        ),
        out_specs=(model_specs, metric_specs, stats_specs),
        check_vma=False,
    )
    def step_sharded(model_shard, truths, cams, bgs, lrs):
        i32 = jnp.int32
        c_idx = jax.lax.axis_index(CAMERA_AXIS)
        b_idx = jax.lax.axis_index(TILE_AXIS)
        s_idx = jax.lax.axis_index(SPLAT_AXIS)
        n_loc = model_shard.means.shape[0]
        fpp = cams.view.shape[0]  # projection frames per device
        fpb = truths.shape[0]  # composite frames per device
        total_frames = fpp * n_cam_ax * n_band

        # shard-local active mask: global ids [s*n_loc, (s+1)*n_loc)
        active = (
            jnp.arange(n_loc, dtype=i32) + s_idx * n_loc
        ) < model_shard.count

        # ---- 1. project OWN shard for OWN projection frames ----------
        means_b = jnp.broadcast_to(
            model_shard.means, (fpp,) + model_shard.means.shape
        )

        def build_rows(means_b, shs_, scales_, opac_, rot_):
            def one(mb, view, pv, pos, tx, ty):
                pr = project_splat_components(
                    mb, shs_, scales_, opac_, rot_, active,
                    view, pv, pos, tx, ty, width, height, sh_degree, 1.0,
                    aa=aa,
                )
                return jnp.stack(
                    [pr.mx, pr.my, pr.ca, pr.cb, pr.cc,
                     pr.cr, pr.cg, pr.cb2, pr.opacity], axis=0,
                )  # (9, n_loc) — GLOBAL my; compositors band-shift

            return jax.vmap(one)(
                means_b, cams.view, cams.proj_view, cams.cam_pos,
                cams.tan_fovx, cams.tan_fovy,
            )  # (fpp, 9, n_loc)

        rows, pull_rows = jax.vjp(
            build_rows, means_b, model_shard.shs, model_shard.scales,
            model_shard.opacities, model_shard.rotations,
        )
        proj_sg = jax.lax.stop_gradient(
            jax.vmap(
                lambda view, pv, pos, tx, ty: project_splat_components(
                    model_shard.means, model_shard.shs, model_shard.scales,
                    model_shard.opacities, model_shard.rotations, active,
                    view, pv, pos, tx, ty, width, height, sh_degree, 1.0,
                    aa=aa,
                )
            )(cams.view, cams.proj_view, cams.cam_pos,
              cams.tan_fovx, cams.tan_fovy)
        )  # SplatComponents, fields (fpp, n_loc)

        # ---- 2. destination bands per (frame, splat) ------------------
        l0 = fpp * n_loc
        mx = proj_sg.mx.reshape(-1)
        my = proj_sg.my.reshape(-1)
        x0, y0, x1, y1 = tile_aabb(
            mx, my, proj_sg.rx.reshape(-1), proj_sg.ry.reshape(-1),
            tile, tx_tiles, ty_tiles,
        )
        nonempty = (
            (x1 > x0) & (y1 > y0) & proj_sg.valid.reshape(-1)
        )
        b_lo = y0 // rows_per_band
        b_hi = (y1 - 1) // rows_per_band
        # frame ids of the local projection frames (GLOBAL, camera-major
        # then band — matches the P((camera, tile)) cams split)
        f_ids = jnp.broadcast_to(
            (
                (c_idx * n_band + b_idx) * fpp + jnp.arange(fpp, dtype=i32)
            )[:, None],
            (fpp, n_loc),
        ).reshape(-1)

        payload = jnp.concatenate(
            [
                jax.lax.stop_gradient(rows).transpose(1, 0, 2).reshape(9, l0),
                proj_sg.depth.reshape(1, -1),
                proj_sg.rx.reshape(1, -1),
                proj_sg.ry.reshape(1, -1),
                f_ids.astype(jnp.float32)[None, :],
            ],
            axis=0,
        )  # (_R_ROWS, L0)
        kslots = jnp.arange(n_band, dtype=i32)[:, None]  # (B, 1)
        dst1 = jnp.where(
            nonempty[None, :] & (b_lo[None, :] + kslots <= b_hi[None, :]),
            b_lo[None, :] + kslots,
            -1,
        ).reshape(-1)  # (B * L0,) band-slot-major
        payload_x = jnp.broadcast_to(
            payload[:, None, :], (_R_ROWS, n_band, l0)
        ).reshape(_R_ROWS, n_band * l0)

        # ---- 3./4. two-hop route: band, then frame owner -------------
        recv1, valid1, mc1 = bucket_route(
            dst1, payload_x, route_cap1, TILE_AXIS
        )  # (B_src, R, cap1)
        pay2 = jnp.moveaxis(recv1, 1, 0).reshape(_R_ROWS, n_band * route_cap1)
        f2 = pay2[_R_FRAME].astype(i32)
        dst2 = jnp.where(
            valid1.reshape(-1), (f2 // fpb) % n_splat, -1
        )
        recv2, valid2, mc2 = bucket_route(
            dst2, pay2, route_cap2, SPLAT_AXIS
        )  # (S_src, R, cap2)
        pay3 = jnp.moveaxis(recv2, 1, 0).reshape(
            _R_ROWS, n_splat * route_cap2
        )
        f3 = pay3[_R_FRAME].astype(i32)
        dst3 = jnp.where(valid2.reshape(-1), f3 % fpb, -1)
        b3, valid3, mc3 = bucket_local(dst3, pay3, fpb, virt_cap)
        # b3: (fpb, R, virt_cap) — per-LOCAL-frame virtual splat rows

        # ---- 5. composite the band from pre-projected rows -----------
        y_off_px = (b_idx * band_h).astype(jnp.float32)
        comps = SplatComponents(
            mx=b3[:, _R_MX], my=b3[:, _R_MY] - y_off_px,
            ca=b3[:, _R_CA], cb=b3[:, _R_CB], cc=b3[:, _R_CC],
            cr=b3[:, _R_CR], cg=b3[:, _R_CG], cb2=b3[:, _R_CB2],
            opacity=b3[:, _R_OP], depth=b3[:, _R_DEPTH],
            radius=b3[:, _R_RX], rx=b3[:, _R_RX], ry=b3[:, _R_RY],
            valid=valid3,
        )
        loss_sum, d_rows, _res, num_dup = render_train_grads_rows(
            comps, width, band_h, truths, bgs,
            tile=tile, chunk=chunk, max_dup=max_dup,
        )

        # ---- 6. gradient return route (reverse both hops) ------------
        # d_rows (fpb, 9, virt_cap) is already in bucket (n_dst, K, cap)
        # layout for the frame un-bucketing
        g_l3 = unbucket_local(dst3, d_rows, virt_cap)  # (9, S*cap2)
        g_recv2 = jnp.moveaxis(
            g_l3.reshape(9, n_splat, route_cap2), 1, 0
        )  # (S_src, 9, cap2)
        g_l2 = route_back(dst2, g_recv2, route_cap2, SPLAT_AXIS)
        g_recv1 = jnp.moveaxis(
            g_l2.reshape(9, n_band, route_cap1), 1, 0
        )  # (B_src, 9, cap1)
        g_l1 = route_back(dst1, g_recv1, route_cap1, TILE_AXIS)
        # (9, B*L0): sum the band-slot replicas per (frame, splat)
        d_rows_proj = jnp.moveaxis(
            g_l1.reshape(9, n_band, fpp, n_loc).sum(axis=1), 0, 1
        )  # (fpp, 9, n_loc)

        # ---- 7. pull through the local projection vjp ----------------
        d_means_b, d_shs, d_scales, d_opac, d_rot = pull_rows(d_rows_proj)
        # per-frame location grads are COMPLETE here (full image), so the
        # nonlinear densify norm is exact with no pre-norm collective
        var_loc = jnp.sum(
            jnp.sqrt(jnp.sum(jnp.square(d_means_b), axis=-1)), axis=0
        )
        g_means = jnp.sum(d_means_b, axis=0)

        # ---- 8. shard-sized reductions over the frame-split axes -----
        g_means, var_loc, g_rest = jax.lax.psum(
            (g_means, var_loc, (d_shs, d_scales, d_opac, d_rot)),
            (CAMERA_AXIS, TILE_AXIS),
        )
        loss_sum = jax.lax.psum(loss_sum, ALL_AXES) / n_band
        num_dup = jax.lax.pmax(num_dup, ALL_AXES)
        stats = RouteStats(
            route1_max=jax.lax.pmax(mc1, ALL_AXES),
            route2_max=jax.lax.pmax(mc2, ALL_AXES),
            frame_max=jax.lax.pmax(mc3, ALL_AXES),
        )

        samples = jnp.float32(total_frames)
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
            var_loc=var_loc / samples,
            avg_grad_loc=g_means,
            num_dup=num_dup,
        )
        return new_shard, metrics, stats

    @jax.jit
    def step(model: SplatModel, truths, cams: CameraBatch, lrs: LearningRates):
        f = cams.num_frames
        assert truths.shape[0] == 2 * f, "need white+black frame per camera"
        assert (2 * f) % (n_cam_ax * n_splat) == 0, (
            "2*num_cameras must divide camera_axis * splat_axis"
        )
        assert (2 * f) % (n_cam_ax * n_band) == 0, (
            "2*num_cameras must divide camera_axis * tile_axis"
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
