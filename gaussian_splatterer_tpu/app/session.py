"""Headless application session — the framework equivalent of the wx GUI
orchestrator (reference src/ui/UiFrame.{h,cpp}).

Owns the Project settings, the ray-traced truth scene (RtxHost), the
Trainer, and the current splat model; provides every behavior the GUI
hosted — field initializers, truth capture, auto-training with the
capture/densify cadence, project save/load (settings.json + splats.gobj in
a directory, src/ui/UiFrame.cpp:452-532), and still-image export
(src/ui/tools/UiPanelToolsView.cpp:112-141,227-259)."""

from __future__ import annotations

import os
import random
import time
from typing import Optional

import jax.numpy as jnp
import numpy as np

from gaussian_splatterer_tpu.config import Project, RuntimeConfig
from gaussian_splatterer_tpu.io.gobj import load_gobj, save_gobj
from gaussian_splatterer_tpu.io.image import save_png
from gaussian_splatterer_tpu.models.camera import Camera
from gaussian_splatterer_tpu.models.splats import (
    SplatModelHost,
    init_field_grid,
    init_field_model,
    init_field_mono,
)
from gaussian_splatterer_tpu.rt import RtxHost
from gaussian_splatterer_tpu.train.schedule import auto_train
from gaussian_splatterer_tpu.train.trainer import Trainer
from gaussian_splatterer_tpu.utils.metrics import MetricsLogger

SETTINGS_FILE = "settings.json"
SPLATS_FILE = "splats.gobj"
RUNTIME_FILE = "runtime.json"


class Session:
    """Project + scene + trainer, headless (reference UiFrame)."""

    def __init__(
        self,
        project: Optional[Project] = None,
        runtime: Optional[RuntimeConfig] = None,
        renderer: str = "tiled",
        rng: Optional[random.Random] = None,
    ):
        self.project = project or Project.app_default()
        self.runtime = runtime or RuntimeConfig()
        self.renderer = renderer
        self.rng = rng or random.Random()
        self.rtx = RtxHost(
            roulette_from=getattr(self.runtime, "rt_roulette_from", 0)
        )
        self.logger = MetricsLogger()
        # boot field: the reference starts on the 17^3 grid
        # (src/ui/UiFrame.cpp:67); fall back to mono under tiny capacities
        init = init_field_grid if self.runtime.splats_capacity >= 17**3 else init_field_mono
        model = init(
            self.runtime.splats_capacity, self.runtime.sh_degree, self.runtime.sh_coeffs
        ).to_device()
        self.trainer = Trainer(self.project, self.runtime, model, renderer=renderer)

    @property
    def devices(self):
        """Devices the trainer shards over (None = single device)."""
        return self.trainer.devices

    # -- scene ----------------------------------------------------------
    @property
    def model(self):
        return self.trainer.model

    @model.setter
    def model(self, m):
        self.trainer.model = m

    def load_model_obj(self, path: str, progress=None) -> None:
        self.rtx.load_model(path, progress)
        self.project.pathModel = path

    def load_texture(self, path: str) -> None:
        self.rtx.load_texture_diffuse(path)
        self.project.pathTextureDiffuse = path

    # -- field initializers (reference src/ui/UiFrame.cpp:137-264) ------
    def init_field(self, kind: str) -> None:
        rt = self.runtime
        if kind == "grid":
            host = init_field_grid(rt.splats_capacity, rt.sh_degree, rt.sh_coeffs)
        elif kind == "mono":
            host = init_field_mono(rt.splats_capacity, rt.sh_degree, rt.sh_coeffs)
        elif kind == "model":
            if self.rtx.mesh is None:
                raise RuntimeError("init_field('model') requires a loaded OBJ")
            host = init_field_model(
                self.rtx.mesh.vertices, self.rtx.mesh.triangles,
                rt.splats_capacity, rt.sh_degree, rt.sh_coeffs,
            )
        else:
            raise ValueError(f"unknown field initializer {kind!r}")
        self.model = host.to_device()
        self.project.iterations = 0

    # -- training -------------------------------------------------------
    def capture(self) -> None:
        devices = None
        if getattr(self.runtime, "capture_data_parallel", False):
            import jax

            devices = jax.devices()
        self.trainer.capture_truths(self.rtx, devices=devices)

    def train(self, steps: int = 1, densify: bool = False):
        for _ in range(steps):
            metrics = self.trainer.train(densify_now=densify)
        return metrics

    def auto_train(self, steps: int, on_step=None, rate_limit=None,
                   checkpoint_dir: Optional[str] = None,
                   checkpoint_every: int = 0,
                   snapshot_dir: Optional[str] = None,
                   snapshot_every: int = 0,
                   watch_dir: Optional[str] = None,
                   watch_every: int = 0) -> None:
        """Reference auto-train loop: randomized re-capture every
        intervalCapture iters, densify every intervalDensify.  Optional
        crash-recovery checkpoints (binary .npz, io/checkpoint.py) every
        ``checkpoint_every`` iterations, and a PNG snapshot series every
        ``snapshot_every`` iterations — the headless stand-in for the
        reference's live splat-preview panel
        (src/ui/UiPanelViewOutput.cpp:52-70).

        ``watch_dir``/``watch_every``: live-watch mode — every N
        iterations rewrite ``watch_dir/index.html`` (self-refreshing) +
        ``latest.png`` + ``status.json`` so an open browser tab tracks
        the run (io/watch.py; the closest headless analog of the
        reference's live preview panel)."""
        from gaussian_splatterer_tpu.io.checkpoint import save_checkpoint

        t_start = time.monotonic()
        it_start = self.project.iterations
        watch_history: list = []

        def _advance_preview_clock():
            # advance the free-orbit preview clock by the elapsed wall
            # time, like the reference's per-tick update
            # (src/ui/UiFrame.cpp:272: previewTimer += delta), so the
            # snapshot/watch series orbits the model instead of
            # re-rendering one static view
            now = time.monotonic()
            last = getattr(self, "_last_snapshot_time", None)
            if last is not None:
                self.project.previewTimer += now - last
            self._last_snapshot_time = now

        def log_step(it, metrics):
            if snapshot_dir and snapshot_every and it % snapshot_every == 0:
                os.makedirs(snapshot_dir, exist_ok=True)
                _advance_preview_clock()
                self.export_splats_png(
                    os.path.join(snapshot_dir, f"iter_{it:06d}.png")
                )
            if watch_dir and watch_every and it % watch_every == 0:
                from gaussian_splatterer_tpu.io.watch import write_watch_page

                os.makedirs(watch_dir, exist_ok=True)
                _advance_preview_clock()
                self.export_splats_png(os.path.join(watch_dir, "latest.png"))
                elapsed = time.monotonic() - t_start
                status = {
                    "iteration": it,
                    "loss": f"{float(metrics.loss):.6f}",
                    "splats": f"{int(self.model.count)} / {self.model.capacity}",
                    "steps/s": f"{(it - it_start) / max(elapsed, 1e-9):.2f}",
                    "elapsed": f"{elapsed:.0f}s",
                    "devices": len(self.devices) if self.devices else 1,
                }
                watch_history.append(
                    {"it": it, "loss": round(float(metrics.loss), 6),
                     "splats": int(self.model.count)}
                )
                write_watch_page(watch_dir, status, watch_history)
            # pass device scalars through unconverted: the logger only
            # materializes them on emitting iterations, so the training loop
            # never blocks on a device->host sync just to log
            self.logger.log_step(it, metrics.loss, self.model.count)
            if checkpoint_dir and checkpoint_every and it % checkpoint_every == 0:
                os.makedirs(checkpoint_dir, exist_ok=True)
                save_checkpoint(
                    os.path.join(checkpoint_dir, "latest.npz"),
                    self.model, self.project,
                )
            # binning-overflow auto-recovery at the capture cadence (capture
            # itself syncs the host, so the num_dup read is free); densify
            # steps also check inside Trainer.train.
            # fall back to every 100 iters when BOTH cadences are disabled
            # (e.g. capture-once runs) — otherwise a growing scene could
            # overflow the duplicate buffer with no check ever firing
            check_iv = (
                self.project.intervalCapture
                or self.project.intervalDensify
                or 100
            )
            if it % max(check_iv, 1) == 0:
                self.trainer.maybe_grow_dup_buffer(metrics)
            if on_step is not None:
                on_step(it, metrics)

        capture_devices = None
        if getattr(self.runtime, "capture_data_parallel", False):
            import jax

            capture_devices = jax.devices()
        return auto_train(
            self.trainer, self.rtx, steps, rng=self.rng,
            on_step=log_step, rate_limit=rate_limit,
            capture_devices=capture_devices,
        )

    def resume_from_checkpoint(self, checkpoint_dir: str) -> None:
        from gaussian_splatterer_tpu.io.checkpoint import load_checkpoint

        model, project = load_checkpoint(
            os.path.join(checkpoint_dir, "latest.npz")
        )
        self.model = model
        if project is not None:
            self.project = project
            self.trainer.project = project

    # -- project persistence (reference src/ui/UiFrame.cpp:323-450) -----
    def save_project(self, directory: str) -> None:
        """settings.json + splats.gobj (reference format) + runtime.json
        (framework knobs — the reference keeps EVERYTHING in settings.json,
        src/Project.h:64-73; our RuntimeConfig fields have no reference key
        names, so they persist beside it rather than inside it)."""
        os.makedirs(directory, exist_ok=True)
        self.save_settings(os.path.join(directory, SETTINGS_FILE))
        self.runtime.save(os.path.join(directory, RUNTIME_FILE))
        self.save_splats(os.path.join(directory, SPLATS_FILE))

    def load_project(self, directory: str, runtime: Optional[RuntimeConfig] = None) -> None:
        """Load settings + splats (+ runtime.json when present).  Passing
        ``runtime`` overrides the persisted one (the CLI resolves persisted
        values + flag overrides before constructing the Session)."""
        if runtime is None:
            rt_path = os.path.join(directory, RUNTIME_FILE)
            if os.path.exists(rt_path):
                runtime = RuntimeConfig.load(rt_path)
        if runtime is not None:
            self.apply_runtime(runtime)
        self.load_settings(os.path.join(directory, SETTINGS_FILE))
        self.load_splats(os.path.join(directory, SPLATS_FILE))

    def apply_runtime(self, runtime: RuntimeConfig) -> None:
        """Swap in a new RuntimeConfig and rebuild the trainer around it.
        The current model is re-padded when the capacity changed; callers
        loading a project reload splats right after, so the re-pad only
        matters for standalone use."""
        if runtime == self.runtime:
            return
        model = self.model
        if runtime.splats_capacity != model.capacity:
            from gaussian_splatterer_tpu.models.splats import SplatModel

            host = SplatModelHost.from_device(model)
            n = host.count
            if n == 0:
                model = SplatModel.empty(
                    runtime.splats_capacity, model.sh_degree, model.sh_coeffs
                )
            else:
                model = SplatModelHost.from_arrays(
                    host.means[:n], host.shs[:n], host.scales[:n],
                    host.opacities[:n], host.rotations[:n],
                    capacity=runtime.splats_capacity,
                ).to_device()
        self.runtime = runtime
        self.rtx.roulette_from = getattr(runtime, "rt_roulette_from", 0)
        self.trainer = Trainer(
            self.project, runtime, model, renderer=self.renderer
        )

    def save_settings(self, path: str) -> None:
        self.project.save(path)

    def load_settings(self, path: str) -> None:
        self.project = Project.load(path)
        self.trainer.project = self.project
        # the loaded rig may change 2*num_cameras: re-resolve the training
        # device list (its frame-divisor shrink depends on the rig size)
        self.trainer.refresh_devices()
        if self.project.pathModel and os.path.exists(self.project.pathModel):
            self.load_model_obj(self.project.pathModel)
        if self.project.pathTextureDiffuse and os.path.exists(
            self.project.pathTextureDiffuse
        ):
            self.load_texture(self.project.pathTextureDiffuse)

    def save_splats(self, path: str) -> None:
        save_gobj(SplatModelHost.from_device(self.model), path)

    def save_splats_ply(self, path: str) -> None:
        """Standard 3DGS binary PLY export (io/ply.py) — beyond reference
        parity: drop the trained model straight into ecosystem viewers."""
        from gaussian_splatterer_tpu.io.ply import save_ply

        save_ply(SplatModelHost.from_device(self.model), path)

    def load_splats_ply(self, path: str) -> None:
        from gaussian_splatterer_tpu.io.ply import load_ply

        host = load_ply(path, capacity=self.runtime.splats_capacity)
        self.model = host.to_device()

    def load_splats(self, path: str) -> None:
        host = load_gobj(path, capacity=self.runtime.splats_capacity)
        self.model = host.to_device()

    # -- rendering / export --------------------------------------------
    def preview_camera(self) -> Camera:
        return Camera.get_preview_camera(self.project)

    def render_splats(self, width=None, height=None, camera=None, splat_scale=None):
        cam = camera or self.preview_camera()
        scale = (
            splat_scale if splat_scale is not None else self.project.previewSplatScale
        )
        return self.trainer.render(cam, width, height, scale)

    def render_rtx(self, width=None, height=None, camera=None, samples=None,
                   show_cameras: bool = False):
        cam = camera or self.preview_camera()
        w = width or self.project.renderResX
        h = height or self.project.renderResY
        # the live preview panel renders at previewRtSamples, the static
        # export at rtSamples (reference src/ui/UiPanelViewInput.cpp:46 vs
        # src/ui/tools/UiPanelToolsView.cpp:235); show_cameras marks the
        # preview-panel-equivalent call
        s = samples or (
            self.project.previewRtSamples if show_cameras
            else self.project.rtSamples
        )
        orbs = None
        if show_cameras:
            orbs = [c.location for c in Camera.get_cameras(self.project)]
        return self.rtx.render(cam, (0.0, 0.0, 0.0), s, w, h, splat_cameras=orbs)

    def export_splats_png(self, path: str, width=None, height=None) -> None:
        """Reference 'Render Splats' export (vertically flipped PNG)."""
        w = width or self.project.renderResX
        h = height or self.project.renderResY
        img = self.render_splats(w, h)
        save_png(np.asarray(jnp.clip(img, 0, 1)), path)

    def export_rtx_png(self, path: str, width=None, height=None, samples=None) -> None:
        w = width or self.project.renderResX
        h = height or self.project.renderResY
        img = self.render_rtx(w, h, samples=samples)
        save_png(np.asarray(jnp.clip(img, 0, 1)), path)

    def export_viewer_html(self, path: str) -> None:
        """Self-contained interactive WebGL viewer (the shareable stand-in
        for the reference's live preview panels, io/viewer.py)."""
        from gaussian_splatterer_tpu.io.viewer import export_viewer_html

        export_viewer_html(self.model, path)
