"""Training engine: capture, train step, SGD apply, interactive render.

Functional re-design of the reference Trainer (src/Trainer.{cuh,cu}):

* One training iteration renders the model from every truth camera twice
  (white background set, then black background set — dual-background
  supervision is what teaches opacity, src/Trainer.cu:311-314), feeds the
  **signed residual** ``truth - rendered`` back through the rasterizer VJP
  (src/Trainer.cu:33-44,378-412), averages per-splat gradients over all
  2F frames, accumulates the mean |location-gradient| as the densify
  "variance" signal (src/Trainer.cu:47-77), and applies one per-feature-LR
  SGD step with scale/opacity clamps (src/Trainer.cu:81-101).
* Because the residual is the negative L2 gradient, ``param += grad * lr``
  is plain gradient descent on 0.5*||render - truth||^2.
* The whole step is one jitted ``lax.scan`` over frames: no per-frame
  allocation (the reference cudaMallocs/frees rasterizer scratch every
  frame, src/Trainer.cu:335-337,422-424 — XLA buffers are planned once).

The renderer is injected, so the oracle (exact) and the tiled fast path
share the same trainer; both are pure jnp/Pallas functions of the model
pytree.
"""

from __future__ import annotations

import random
from functools import partial
from typing import Callable, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_splatterer_tpu.config import Project, RuntimeConfig
from gaussian_splatterer_tpu.models.camera import Camera
from gaussian_splatterer_tpu.models.splats import SplatModel
from gaussian_splatterer_tpu.train.densify import DensifyParams, densify


class CameraBatch(NamedTuple):
    """Stacked per-frame camera tensors (F, ...)."""

    view: jax.Array  # (F, 4, 4)
    proj_view: jax.Array  # (F, 4, 4)
    cam_pos: jax.Array  # (F, 3)
    tan_fovx: jax.Array  # (F,)
    tan_fovy: jax.Array  # (F,)

    @classmethod
    def from_cameras(
        cls, cameras: Sequence[Camera], width: int, height: int, train: bool = True
    ) -> "CameraBatch":
        views = np.stack([c.get_view() for c in cameras])
        pvs = np.stack([c.get_proj_view(width / height) for c in cameras])
        pos = np.stack([c.location for c in cameras])
        tans = np.array([c.tan_fov(width, height, train=train) for c in cameras], np.float32)
        return cls(
            view=jnp.asarray(views),
            proj_view=jnp.asarray(pvs),
            cam_pos=jnp.asarray(pos),
            tan_fovx=jnp.asarray(tans[:, 0]),
            tan_fovy=jnp.asarray(tans[:, 1]),
        )

    @property
    def num_frames(self) -> int:
        return self.view.shape[0]


class LearningRates(NamedTuple):
    location: jnp.float32
    sh: jnp.float32
    scale: jnp.float32
    opacity: jnp.float32
    rotation: jnp.float32
    scale_max: jnp.float32

    @classmethod
    def from_project(cls, p: Project) -> "LearningRates":
        return cls(
            location=jnp.float32(p.lrLocation),
            sh=jnp.float32(p.lrSh),
            scale=jnp.float32(p.lrScale),
            opacity=jnp.float32(p.lrOpacity),
            rotation=jnp.float32(p.lrRotation),
            scale_max=jnp.float32(p.paramScaleMax),
        )


class TrainMetrics(NamedTuple):
    loss: jax.Array  # () mean MSE over all 2F frames
    var_loc: jax.Array  # (C,) densify variance signal
    avg_grad_loc: jax.Array  # (C, 3) mean location gradient
    num_dup: jax.Array  # () int32 max binning duplicates this step (fused
    # path; -1 when the renderer doesn't report it).  > max_dup means the
    # duplicate buffer overflowed and the deepest splats were dropped —
    # Trainer.maybe_grow_dup_buffer auto-recovers.


# Renderer signature shared by oracle and tiled paths.
RenderFn = Callable[..., jax.Array]


def _default_render(
    kind: str, row_chunk: int, runtime: Optional[RuntimeConfig] = None
) -> RenderFn:
    if kind == "oracle":
        from gaussian_splatterer_tpu.ops.raster_reference import render_oracle

        return partial(render_oracle, row_chunk=row_chunk)
    if kind == "tiled":
        from gaussian_splatterer_tpu.ops.raster_tiled import render_tiled

        if runtime is not None:
            return partial(
                render_tiled, tile=runtime.tile_px, max_dup=runtime.max_dup,
                chunk=runtime.train_chunk,
                aa=getattr(runtime, "mip_antialias", False),
            )
        return render_tiled
    raise ValueError(f"unknown renderer {kind!r}")


def fused_kw_from_runtime(runtime: Optional[RuntimeConfig]) -> dict:
    """Fused-kernel options derived from RuntimeConfig — THE single mapping,
    shared by Trainer._build_step and every parallel step builder
    (parallel/dp.py re-exports it).  A field missed in one copy would
    silently train single-chip and multi-chip with different kernel
    options."""
    if runtime is None:
        return {}
    return dict(
        tile=runtime.tile_px, max_dup=runtime.max_dup,
        chunk=runtime.train_chunk,
        aa=getattr(runtime, "mip_antialias", False),
    )


_DUP_ROUND = 256  # max_dup is resized in multiples of this


def _largest_divisor_leq(n: int, k: int) -> int:
    k = max(1, min(n, k))
    while n % k:
        k -= 1
    return k


def make_train_step(
    width: int,
    height: int,
    sh_degree: int,
    renderer: str = "oracle",
    row_chunk: int = 32,
    render_fn: Optional[RenderFn] = None,
    fused: bool = False,
    fused_opts: Optional[dict] = None,
    frame_group: int = 8,
):
    """Build a jitted (model, truths, cams, lrs) -> (model', metrics) step.

    truths: (2F, H, W, 3) float32 — F white-background frames then F
    black-background frames, same camera order (src/Trainer.cu:311-314).
    When ``fused=True``, truths must be pre-tiled CHANNEL-MAJOR to
    (2F, T, 4, P) with image_to_tiles_cm.

    ``fused=True`` uses the frame-BATCHED train core
    (ops.raster_tiled.render_train_grads_batch): binning + forward +
    residual + gradient replay for ``frame_group`` frames per launch over
    pre-tiled truths — no per-frame image/gin round-trips or glue.
    fused_opts forwards tile/chunk/max_dup; frame_group bounds transient
    memory (the duplicate buffers scale with group size) and is snapped
    down to a divisor of 2F.
    """
    render = render_fn if render_fn is not None else _default_render(renderer, row_chunk)
    fkw = fused_opts or {}
    if fused:
        from gaussian_splatterer_tpu.ops.raster_tiled import (
            render_train_grads_batch,
        )

    @jax.jit
    def step(model: SplatModel, truths: jax.Array, cams: CameraBatch, lrs: LearningRates):
        f = cams.num_frames
        assert truths.shape[0] == 2 * f, "need white+black frame per camera"
        samples = jnp.float32(2 * f)
        active = model.active_mask()
        params = (model.means, model.shs, model.scales, model.opacities, model.rotations)

        # duplicate camera tensors for the white and black passes
        cams2 = jax.tree.map(lambda x: jnp.concatenate([x, x], 0), cams)
        bgs = jnp.concatenate(
            [jnp.ones((f, 3), jnp.float32), jnp.zeros((f, 3), jnp.float32)], 0
        )

        avg0 = jax.tree.map(jnp.zeros_like, params)
        var0 = jnp.zeros((model.capacity,), jnp.float32)
        xs = (truths, cams2.view, cams2.proj_view, cams2.cam_pos,
              cams2.tan_fovx, cams2.tan_fovy, bgs)

        if fused:
            group = _largest_divisor_leq(2 * f, frame_group)
            xs = jax.tree.map(
                lambda x: x.reshape((2 * f) // group, group, *x.shape[1:]), xs
            )

            def group_fn(carry, xg):
                gsum, var, loss_sum, ndup = carry
                truth_g, view_g, pv_g, pos_g, tx_g, ty_g, bg_g = xg
                l_sum, g, v, _, nd = render_train_grads_batch(
                    *params, active, view_g, pv_g, pos_g, tx_g, ty_g,
                    width, height, truth_g, bg_g, sh_degree, **fkw,
                )
                gsum = jax.tree.map(jnp.add, gsum, g)
                return (gsum, var + v, loss_sum + l_sum, jnp.maximum(ndup, nd))

            # Unroll the group loop statically instead of lax.scan: the
            # scan's xs dynamic-slice would copy the whole truth batch every
            # step, while static x[gi] slices are free views.  Group counts
            # are tiny (1-4).
            carry = (avg0, var0, jnp.float32(0.0), jnp.int32(0))
            for gi in range((2 * f) // group):
                carry = group_fn(carry, jax.tree.map(lambda x: x[gi], xs))
            gsum, var, loss_sum, num_dup = carry
            avg = jax.tree.map(lambda g: g / samples, gsum)
            var = var / samples
        else:
            def frame_fn(carry, xs):
                avg, var, loss_sum = carry
                truth, view, pv, pos, tx, ty, bg = xs

                def fwd(p):
                    means, shs, scales, opac, rot = p
                    return render(
                        means, shs, scales, opac, rot, active,
                        view, pv, pos, tx, ty, width, height, bg, sh_degree, 1.0,
                    )

                img, pull = jax.vjp(fwd, params)
                residual = truth - img  # signed diff = -dL/dpixel of L2/2
                g = pull(residual)[0]
                loss = jnp.mean(jnp.square(residual))
                avg = jax.tree.map(lambda a, gi: a + gi / samples, avg, g)
                var = var + jnp.linalg.norm(g[0], axis=-1) / samples
                loss_sum = loss_sum + loss
                return (avg, var, loss_sum), None

            (avg, var, loss_sum), _ = jax.lax.scan(
                frame_fn, (avg0, var0, jnp.float32(0.0)), xs
            )
            num_dup = jnp.int32(-1)  # not reported off the fused path

        g_means, g_shs, g_scales, g_opac, g_rot = avg
        new_model = model.replace(
            means=model.means + g_means * lrs.location,
            shs=model.shs + g_shs * lrs.sh,
            scales=jnp.clip(model.scales + g_scales * lrs.scale, 0.0, lrs.scale_max),
            opacities=jnp.clip(model.opacities + g_opac * lrs.opacity, 0.0, 1.0),
            rotations=model.rotations + g_rot * lrs.rotation,
        )
        metrics = TrainMetrics(
            loss=loss_sum / samples, var_loc=var, avg_grad_loc=g_means,
            num_dup=num_dup,
        )
        return new_model, metrics

    return step


def randomize_rig_rotations(project: Project, rng: Optional[random.Random] = None) -> None:
    """All four rig rotations -> uniform [0, 360) (reference
    src/ui/tools/UiPanelToolsTruth.cpp:192-197; auto-train triggers this
    before every re-capture, src/ui/UiFrame.cpp:286-290)."""
    r = rng or random
    for sph in (project.sphere1, project.sphere2):
        sph.rotX = r.uniform(0.0, 360.0)
        sph.rotY = r.uniform(0.0, 360.0)


class Trainer:
    """Host-side orchestration: owns the model, truth buffers and schedules.

    ``rtx`` is any object with ``render(camera, background, samples) ->
    (H, W, 3) array`` — the JAX path tracer in production, or a surrogate
    (e.g. oracle renders of a target splat model) in tests.
    """

    def __init__(
        self,
        project: Project,
        runtime: RuntimeConfig,
        model: SplatModel,
        renderer: str = "oracle",
        row_chunk: int = 32,
        render_fn: Optional[RenderFn] = None,
        devices: Optional[Sequence] = None,
    ):
        self.project = project
        self.runtime = runtime
        self.model = model
        self.renderer = renderer
        self.row_chunk = row_chunk
        self._user_render = render_fn is not None
        self._render_fn = render_fn
        self.truths: Optional[jax.Array] = None  # (2F, H, W, 3) or tiled
        self.truth_cams: Optional[CameraBatch] = None
        self.last_metrics: Optional[TrainMetrics] = None
        self._capture_seed = 0  # sharded-capture PRNG stream counter
        # multi-device product path (RuntimeConfig.train_devices /
        # gsplat-tpu train --devices N): explicit ``devices`` wins,
        # otherwise the runtime knob selects the first N local devices
        self.devices = self._resolve_devices(devices)
        self._mesh = None
        self._model_sharded = False
        self._build_step()

    def _resolve_devices(self, devices) -> Optional[list]:
        if devices is None:
            n = int(getattr(self.runtime, "train_devices", 0) or 0)
            if n <= 1:
                return None
            all_dev = jax.devices()
            if len(all_dev) < n:
                raise RuntimeError(
                    f"train_devices={n} but only {len(all_dev)} devices "
                    "are attached"
                )
            devices = all_dev[:n]
        devices = list(devices)
        if len(devices) <= 1:
            return None
        # the DP/FSDP steps shard the 2F truth frames evenly: shrink to
        # the largest divisor of the frame count rather than fail
        frames = 2 * self.project.num_cameras
        n = len(devices)
        while frames % n:
            n -= 1
        if n != len(devices):
            import warnings

            warnings.warn(
                f"2*num_cameras={frames} not divisible by "
                f"{len(devices)} devices; training on {n}"
            )
        return devices[:n] if n > 1 else None

    def refresh_devices(self) -> None:
        """Re-resolve the device list after the Project changed under us
        (Session.load_settings swaps the camera rig in place): the
        frame-divisor shrink depends on 2*num_cameras, so a rig loaded
        after construction could otherwise train on a stale mesh size."""
        new = self._resolve_devices(None)
        cur = self.devices
        if (new is None) != (cur is None) or (
            new is not None and cur is not None
            and [d.id for d in new] != [d.id for d in cur]
        ):
            self.devices = new
            self._mesh = None
            self._model_sharded = False
            self._build_step()

    def _build_step(self) -> None:
        """(Re)build the jitted step from the current RuntimeConfig —
        called at construction and when maybe_grow_dup_buffer recompiles."""
        runtime = self.runtime
        if not self._user_render:
            # the serve-path renderer bakes tile/max_dup/aa into a partial;
            # buffer grow/shrink mutates runtime.max_dup, so a stale partial
            # would silently drop the deepest duplicates on Trainer.render
            # (previews, PSNR eval, snapshots) after an auto-grow
            self._render_fn = _default_render(
                self.renderer, self.row_chunk, runtime
            )
        # tile-space fast path: train against pre-tiled truths so the step
        # never assembles (H, W) images (saves two transposes per frame
        # forward + two backward).  A caller-supplied render_fn drives the
        # generic image-space step instead (it expects (H, W, 3) truths).
        self._tile_space = 0
        fused = False
        fused_opts = None
        if (
            self.renderer == "tiled"
            and not self._user_render
            and runtime.render_resolution_x % runtime.tile_px == 0
            and runtime.render_resolution_y % runtime.tile_px == 0
        ):
            # tile-space + frame-batched train core (binning + forward
            # kernel + residual + backward kernel, one launch pair per group)
            self._tile_space = runtime.tile_px
            fused = True
            fused_opts = fused_kw_from_runtime(runtime)
        if self.devices is not None:
            self._build_mesh_step(fused)
            return
        self._step = make_train_step(
            runtime.render_resolution_x,
            runtime.render_resolution_y,
            runtime.sh_degree,
            renderer=self.renderer,
            row_chunk=self.row_chunk,
            # thread the runtime-configured renderer even when it is the
            # default: the bare make_train_step fallback would bin with
            # render_tiled's baked defaults (tile 16, max_dup 2^19, no AA)
            # on the non-fused tiled path
            render_fn=self._render_fn,
            fused=fused,
            fused_opts=fused_opts,
            frame_group=runtime.frame_group,
        )

    def _build_mesh_step(self, fused: bool) -> None:
        """Sharded step for the multi-device product path.  The mesh
        kind comes from RuntimeConfig.train_mesh:

          * "dp": replicated model over a 1-D camera mesh
            (parallel/dp.py) — densify and serve renders work unchanged.
          * "fsdp": splat-sharded model on a 1 x N (camera x splat) mesh
            (parallel/fsdp.py) — rest-state model memory is capacity/N
            per device; densify gathers (parallel/densify.py) and serve
            renders gather the parameters first.

        Both consume the SAME (model, truths, cams, lrs) call signature
        as the single-device step, so train()/auto_train/session code is
        sharding-agnostic."""
        from jax.sharding import PartitionSpec as P

        runtime = self.runtime
        kind = getattr(runtime, "train_mesh", "dp")
        common = dict(
            renderer=self.renderer,
            render_fn=self._render_fn if self._user_render else None,
            row_chunk=self.row_chunk,
            runtime=runtime,
            frame_group=runtime.frame_group,
        )
        if kind == "dp":
            from gaussian_splatterer_tpu.parallel.dp import (
                CAMERA_AXIS,
                make_camera_mesh,
                make_dp_train_step,
            )

            self._mesh = make_camera_mesh(self.devices)
            self._model_sharded = False
            self._truth_pspec = P(CAMERA_AXIS)
            self._step = make_dp_train_step(
                self._mesh,
                runtime.render_resolution_x, runtime.render_resolution_y,
                runtime.sh_degree, **common,
            )
        elif kind == "fsdp":
            from gaussian_splatterer_tpu.parallel.fsdp import (
                CAMERA_AXIS,
                SPLAT_AXIS,
                make_2d_mesh,
                make_fsdp_train_step,
                shard_model,
            )

            self._mesh = make_2d_mesh(1, len(self.devices), self.devices)
            self._model_sharded = True
            self._reshard_model = shard_model
            self._truth_pspec = P((CAMERA_AXIS, SPLAT_AXIS))
            self._step = make_fsdp_train_step(
                self._mesh,
                runtime.render_resolution_x, runtime.render_resolution_y,
                runtime.sh_degree, **common,
            )
            # rest-state sharding: place the model now (steps re-emit the
            # same sharding; a later direct model assignment still works —
            # the jitted step reshards its inputs)
            self.model = shard_model(self._mesh, self.model)
        else:
            raise ValueError(
                f"unknown train_mesh {kind!r} (expected 'dp' or 'fsdp')"
            )

    def _gathered_model(self) -> SplatModel:
        """Replicated copy of the model (identity for dp/single-device)."""
        if not self._model_sharded or self._mesh is None:
            return self.model
        from jax.sharding import NamedSharding, PartitionSpec as P

        rep = NamedSharding(self._mesh, P())
        return jax.tree.map(
            lambda x: jax.device_put(x, rep)
            if getattr(x, "ndim", None) is not None else x,
            self.model,
        )

    # ------------------------------------------------------------------
    def maybe_grow_dup_buffer(self, metrics: Optional[TrainMetrics] = None) -> bool:
        """Auto-recover from binning duplicate-buffer overflow.

        The fused step reports the max duplicates any frame generated
        (TrainMetrics.num_dup).  The reference radix-sorts the exact count
        and cannot truncate (src/Trainer.cu:334-360); we must not silently
        drop the deepest splats, so when num_dup > max_dup this grows
        max_dup with 25% headroom and recompiles the step.  Returns True
        when the buffer changed.  NOTE: reading num_dup syncs the device —
        call at natural sync points (densify, capture), not every step.

        The same call also SHRINKS the buffer when utilization stays below
        40% for three consecutive checks (densify culls can drop the
        duplicate count far below a previously-grown capacity, and every
        D-sized gradient-reduction op scales with max_dup).  Hysteresis
        guards the recompile cost: three low readings, and only when the
        resized buffer is at most 2/3 of the current one."""
        import warnings

        metrics = metrics if metrics is not None else self.last_metrics
        if metrics is None:
            return False
        # one check per training iteration: densify-time and session-cadence
        # callers can both fire on the same step, and a duplicated reading
        # must not double-advance the shrink hysteresis streak
        it = self.project.iterations
        if getattr(self, "_last_buffer_check_it", None) == it:
            return False
        self._last_buffer_check_it = it
        nd = int(metrics.num_dup)
        if nd > self.runtime.max_dup:
            new_max = -(-int(nd * 1.25) // _DUP_ROUND) * _DUP_ROUND
            warnings.warn(
                f"binning duplicate buffer overflow: {nd} > max_dup="
                f"{self.runtime.max_dup}; growing to {new_max} and recompiling "
                "(the overflowing step dropped its deepest duplicates)"
            )
            self.runtime.max_dup = new_max
            self._dup_low_streak = 0
            self._build_step()
            return True
        if not getattr(self.runtime, "auto_shrink_buffers", True):
            # pinned buffer (long scripted runs): growth safety stays ON
            # above, but no shrink recompiles mid-run
            return False
        if 0 < nd < int(0.4 * self.runtime.max_dup):
            self._dup_low_streak = getattr(self, "_dup_low_streak", 0) + 1
        else:
            self._dup_low_streak = 0
        if self._dup_low_streak < 3:
            return False
        self._dup_low_streak = 0
        # 2x headroom (vs the grow path's 1.25x): checks only run at sync
        # points, so a densify wave right after a tight shrink would
        # silently truncate until the NEXT check — leave room
        new_max = max(-(-int(nd * 2.0) // _DUP_ROUND) * _DUP_ROUND, 4 * _DUP_ROUND)
        if new_max > (2 * self.runtime.max_dup) // 3:
            return False
        self.runtime.max_dup = new_max
        self._build_step()
        return True

    # ------------------------------------------------------------------
    def capture_truths(self, rtx, devices=None) -> None:
        """Photograph the scene from every rig camera against white AND
        black backgrounds (src/Trainer.cu:218-250).

        ``rtx.render(camera, background, samples[, width, height])`` — the
        resolution args are passed when the renderer accepts them (the JAX
        path tracer does; simple test surrogates may bake their own).

        ``devices``: shard the capture frames over a camera mesh of these
        devices (parallel/capture.py) — captures are embarrassingly
        parallel, which cuts recapture cost at the reference's
        intervalCapture=50 cadence.  Frames depend only on the capture
        seed, not on the mesh size."""
        w = self.runtime.render_resolution_x
        h = self.runtime.render_resolution_y
        cameras = Camera.get_cameras(self.project)
        if devices is None and self.devices is not None:
            # multi-device training shards its recaptures over the same
            # devices by default (captures are embarrassingly parallel)
            devices = self.devices

        if devices is not None and getattr(rtx, "_tris", None) is not None:
            from gaussian_splatterer_tpu.parallel.capture import (
                capture_images_sharded,
            )

            self._capture_seed += 1
            truths = capture_images_sharded(
                rtx, cameras, self.project.rtSamples, w, h,
                devices=devices, seed=self._capture_seed,
            )
        else:
            def shoot(c, bg):
                try:
                    return rtx.render(c, bg, self.project.rtSamples, w, h)
                except TypeError:
                    return rtx.render(c, bg, self.project.rtSamples)

            whites = [shoot(c, (1.0, 1.0, 1.0)) for c in cameras]
            blacks = [shoot(c, (0.0, 0.0, 0.0)) for c in cameras]
            truths = jnp.stack(
                [jnp.asarray(i, jnp.float32) for i in whites + blacks]
            )
        if self._tile_space:
            from gaussian_splatterer_tpu.ops.raster_tiled import image_to_tiles_cm

            truths = jax.vmap(
                lambda im: image_to_tiles_cm(im, self._tile_space)
            )(truths)
        if self._mesh is not None:
            # place the frame axis across the training mesh so the sharded
            # step starts from the right layout (a stale placement would
            # still be correct — jit reshards — but costs a gather/step)
            from jax.sharding import NamedSharding

            truths = jax.device_put(
                truths, NamedSharding(self._mesh, self._truth_pspec)
            )
        self.truths = truths
        self.truth_cams = CameraBatch.from_cameras(cameras, w, h, train=True)

    # ------------------------------------------------------------------
    def train(self, densify_now: bool = False) -> TrainMetrics:
        if self.truths is None:
            raise RuntimeError("Can't run training iteration, no truth data available!")
        self.project.iterations += 1
        lrs = LearningRates.from_project(self.project)
        lr_ref = getattr(self.runtime, "lr_resolution_ref", 0)
        px_scale = 1.0
        if lr_ref:
            # gradients are pixel sums (src/Trainer.cu:33-44): scale the
            # LRs by ref_pixels / actual_pixels so a recipe tuned at
            # lr_resolution_ref^2 behaves identically at this resolution
            # (config.py lr_resolution_ref).  HOST-side math from the
            # Project floats only — float(lrs.location) would sync a
            # device scalar mid-pipeline (see the decay note below).
            px_scale = (lr_ref * lr_ref) / float(
                self.runtime.render_resolution_x
                * self.runtime.render_resolution_y
            )
            p = self.project
            lrs = lrs._replace(
                location=jnp.float32(p.lrLocation * px_scale),
                sh=jnp.float32(p.lrSh * px_scale),
                scale=jnp.float32(p.lrScale * px_scale),
                opacity=jnp.float32(p.lrOpacity * px_scale),
                rotation=jnp.float32(p.lrRotation * px_scale),
            )
        decay = getattr(self.runtime, "lr_location_decay", 1.0)
        if decay != 1.0:
            # 3DGS-style exponential location-LR schedule (framework knob;
            # off by default — the reference trains with flat LRs).
            # HOST-side math only: reading a device scalar here would
            # block the host on the in-flight step every iteration.
            lrs = lrs._replace(
                location=jnp.float32(
                    self.project.lrLocation * px_scale
                    * decay ** self.project.iterations
                )
            )
        with jax.profiler.TraceAnnotation("gsplat.train_step"):
            self.model, metrics = self._step(
                self.model, self.truths, self.truth_cams, lrs
            )
        if densify_now:
            dp = DensifyParams.from_project(self.project)
            if px_scale != 1.0:
                # the densify "variance" signal is a pixel-sum gradient
                # magnitude too — scale the trigger inversely so its
                # selectivity matches the lr_resolution_ref recipe
                dp = dp._replace(
                    densify_variance=jnp.float32(
                        self.project.paramDensifyVariance / px_scale
                    )
                )
            vdecay = getattr(self.runtime, "densify_variance_decay", 1.0)
            if vdecay != 1.0:
                # anneal the split/clone trigger over training (framework
                # knob, off by default — the reference threshold is flat):
                # gradients shrink as the fit converges, so a flat threshold
                # stops densifying long before the tail.  Host-side math
                # only, like the LR decay above.
                dp = dp._replace(
                    densify_variance=jnp.float32(
                        self.project.paramDensifyVariance / px_scale
                        * vdecay ** self.project.iterations
                    )
                )
            with jax.profiler.TraceAnnotation("gsplat.densify"):
                if self._model_sharded and self._mesh is not None:
                    # splat-sharded parameters: gather -> exact densify ->
                    # re-shard (parallel/densify.py; the reference's own
                    # densify is a host-side gather at this same cadence,
                    # src/Trainer.cu:433-542)
                    from gaussian_splatterer_tpu.parallel.densify import (
                        densify_sharded,
                    )

                    self.model = densify_sharded(
                        self._mesh, self.model,
                        metrics.var_loc, metrics.avg_grad_loc,
                        dp, self._reshard_model,
                    )
                else:
                    self.model = densify(
                        self.model,
                        metrics.var_loc,
                        metrics.avg_grad_loc,
                        dp,
                    )
            # densify syncs the host anyway — free moment to check binning
            # overflow and grow the duplicate buffer (recompile) if needed
            self.maybe_grow_dup_buffer(metrics)
        reset_iv = getattr(self.runtime, "opacity_reset_interval", 0)
        if reset_iv and self.project.iterations % reset_iv == 0:
            # 3DGS-style opacity reset (framework knob, off by default —
            # no reference equivalent): clamp opacities down so floaters
            # must re-earn their weight or fall to the cull threshold
            self.model = self.model.replace(
                opacities=jnp.minimum(self.model.opacities, jnp.float32(0.01))
            )
        self.last_metrics = metrics
        return metrics

    # ------------------------------------------------------------------
    def binning_stats(self, camera_index: int = 0) -> dict:
        """Duplicate-buffer utilization for one truth camera: num_dup over
        max_dup.  >1.0 means overflow — the deepest duplicates are dropped
        and max_dup should be raised (RuntimeConfig.max_dup)."""
        from gaussian_splatterer_tpu.ops.binning import bin_splats
        from gaussian_splatterer_tpu.ops.transforms import project_splat_components

        if self.truth_cams is None:
            raise RuntimeError("no truth cameras captured")
        i = camera_index
        m = self._gathered_model()
        c = project_splat_components(
            m.means, m.shs, m.scales, m.opacities, m.rotations, m.active_mask(),
            self.truth_cams.view[i], self.truth_cams.proj_view[i],
            self.truth_cams.cam_pos[i], self.truth_cams.tan_fovx[i],
            self.truth_cams.tan_fovy[i],
            self.runtime.render_resolution_x, self.runtime.render_resolution_y,
            self.runtime.sh_degree, 1.0,
            aa=getattr(self.runtime, "mip_antialias", False),
        )
        # bin with the TRAIN path's configured AA: a mismatch here
        # over-reports num_dup (AA fades sub-pixel splats' tile AABBs) and
        # prompts oversizing max_dup
        bins = bin_splats(
            c, self.runtime.render_resolution_x, self.runtime.render_resolution_y,
            self.runtime.tile_px, self.runtime.max_dup,
        )
        num = int(bins.num_dup)
        return {
            "num_dup": num,
            "max_dup": self.runtime.max_dup,
            "utilization": num / self.runtime.max_dup,
            "overflow": num > self.runtime.max_dup,
        }

    # ------------------------------------------------------------------
    def render(
        self,
        camera: Camera,
        width: Optional[int] = None,
        height: Optional[int] = None,
        splat_scale: float = 1.0,
    ) -> jax.Array:
        """Forward-only serve path: black background, aspect-scaled x-FOV
        quirk preserved (src/Trainer.cu:148-216)."""
        w = width or self.runtime.render_resolution_x
        h = height or self.runtime.render_resolution_y
        render = self._render_fn or _default_render(self.renderer, self.row_chunk)
        tan_x, tan_y = camera.tan_fov(w, h, train=False)
        m = self._gathered_model()  # fsdp: one all-gather; else identity
        return render(
            m.means, m.shs, m.scales, m.opacities, m.rotations, m.active_mask(),
            jnp.asarray(camera.get_view()), jnp.asarray(camera.get_proj_view(w / h)),
            jnp.asarray(camera.location), tan_x, tan_y, w, h,
            jnp.zeros(3, jnp.float32), m.sh_degree, splat_scale,
        )
