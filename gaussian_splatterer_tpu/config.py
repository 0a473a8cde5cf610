"""Project / runtime configuration.

``Project`` mirrors the reference's single mutable settings struct
(reference src/Project.h:6-75) field-for-field so that ``settings.json``
files round-trip losslessly between the two implementations.  The
reference serializes with nlohmann's intrusive macro using exactly these
key names (src/Project.h:64-73); unknown keys are ignored on load by both
sides, so we may add framework-only keys in a separate file instead.

``RuntimeConfig`` promotes the reference's compile-time constants
(src/Config.h:7-20) — training resolution, splat capacity, SH degree,
auto-train budget — to runtime configuration, as those are hard ``#define``s
in the reference.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass
class CameraSphere:
    """One Fibonacci-sphere camera rig (reference src/Project.h:14-22)."""

    count: int = 16
    distance: float = 10.0
    fovDeg: float = 60.0
    rotX: float = 0.0  # degrees; rotates about the +Y axis (reference quirk, src/Camera.cpp:40)
    rotY: float = 0.0  # degrees; rotates about the +X axis (reference quirk, src/Camera.cpp:41)

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "CameraSphere":
        out = cls()
        for f in dataclasses.fields(cls):
            if f.name in d:
                setattr(out, f.name, d[f.name])
        return out


@dataclass
class Project:
    """Whole-run settings; JSON-compatible with the reference (src/Project.h:64-73)."""

    perspective: str = ""  # opaque UI layout string in the reference; carried for parity

    pathModel: str = ""
    pathTextureDiffuse: str = ""

    sphere1: CameraSphere = field(default_factory=CameraSphere)
    sphere2: CameraSphere = field(default_factory=CameraSphere)

    rtSamples: int = 100

    # Per-feature SGD learning rates (reference src/Project.h:26-30)
    lrLocation: float = 0.00005
    lrSh: float = 0.0001
    lrScale: float = 0.00002
    lrOpacity: float = 0.0001
    lrRotation: float = 0.000025

    paramScaleMax: float = 0.3

    # Densify heuristics (reference src/Project.h:34-41)
    paramCullOpacity: float = 0.005
    paramCullSize: float = 0.004
    paramDensifyVariance: float = 2.0
    paramSplitSize: float = 0.04
    paramSplitDistance: float = 1.5
    paramSplitScale: float = 0.8
    paramCloneDistance: float = 1.6

    iterations: int = 0
    intervalCapture: int = 50
    intervalDensify: int = 200

    # Preview / export state (kept for settings-file parity; the headless
    # pipeline uses previewSplatScale and the free-orbit fields for renders)
    previewTimer: float = 0.0
    previewRtSamples: int = 50
    previewSplatScale: float = 1.0
    previewTruth: bool = False
    previewTruthIndex: int = 0
    previewFreeOrbit: bool = True
    previewFreeOrbitSpeed: float = 0.5
    previewFreeDistance: float = 10.0
    previewFreeFovDeg: float = 60.0
    previewFreeRotX: float = 25.0
    previewFreeRotY: float = 0.0

    renderResX: int = 2048
    renderResY: int = 2048

    # ------------------------------------------------------------------
    @classmethod
    def app_default(cls) -> "Project":
        """The state the reference app boots with (src/ui/UiFrame.cpp:130-135):
        defaults plus an empty second sphere at 30° FOV."""
        p = cls()
        p.sphere2.count = 0
        p.sphere2.fovDeg = 30.0
        return p

    # -- JSON round-trip ------------------------------------------------
    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        return d

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Project":
        p = cls()
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            if f.name in ("sphere1", "sphere2"):
                sub = CameraSphere()
                for sf in dataclasses.fields(CameraSphere):
                    if sf.name in v:
                        setattr(sub, sf.name, v[sf.name])
                setattr(p, f.name, sub)
            else:
                setattr(p, f.name, v)
        return p

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh)

    @classmethod
    def load(cls, path: str) -> "Project":
        with open(path) as fh:
            return cls.from_json(json.load(fh))

    # -- convenience ----------------------------------------------------
    @property
    def num_cameras(self) -> int:
        """Total truth cameras across both rigs (reference src/Camera.cpp:29-31)."""
        return self.sphere1.count + self.sphere2.count


@dataclass
class RuntimeConfig:
    """Framework-level knobs; compile-time constants in the reference (src/Config.h)."""

    render_resolution_x: int = 1024  # truth/training resolution (src/Config.h:13-14)
    render_resolution_y: int = 1024
    splats_capacity: int = 1_000_000  # SPLATS_LIMIT (src/Config.h:17)
    sh_degree: int = 1  # SPLATS_SH_DEGREE (src/Config.h:19)
    sh_coeffs: int = 4  # SPLATS_SH_COEF (src/Config.h:20)
    auto_train_budget: float = 100.0  # max steps/s in auto-train (src/Config.h:10)

    # Framework knobs (no reference equivalent)
    tile_px: int = 16  # rasterizer tile edge: one kernel program per tile
    # (16 measured ~2-4x faster than 32 on the H100, PERF.md)
    max_dup: int = 2**21  # max splat-tile duplicate pairs per frame (binning capacity)
    rt_bounces: int = 50  # path-tracer bounce cap (reference src/rtx/RtxDevice.cu:23)
    # Russian-roulette start bounce for captures (0 = off, reference
    # parity: the reference always marches to the 50-bounce cap).  From
    # bounce N on, each surviving reflected ray is killed with
    # probability 1/2 and survivors carry a boost applied outside the
    # per-sample clamp — unbiased in the MEAN.  CAVEAT: the estimator is
    # heavy-tailed — deep-escaping rays carry 2^k boosts (fireflies), so
    # per-pixel VARIANCE grows a lot at low sample counts, and training
    # truths feed an MSE loss whose floor is exactly that variance.  Use
    # for high-sample offline renders or non-MSE consumers; do NOT use
    # for low-sample training truths.
    rt_roulette_from: int = 0
    # Frames per launch pair of the compositing kernels in a train step
    # (snapped down to a divisor of the step's frames).  On the H100 one
    # pair over all 32 frames fits and is no slower (PERF.md), so this
    # only bounds the transient duplicate buffers; ROADMAP S7 removes it.
    frame_group: int = 8
    # Splats per inner-loop step of the compositing kernels (a power of
    # two: a program holds (tile^2, chunk) tiles of pair state; 8 measured
    # fastest at tile 16 on the H100, PERF.md).
    train_chunk: int = 8
    # Allow maybe_grow_dup_buffer to SHRINK max_dup after sustained low
    # utilization.  Every resize is a fresh kernel compile, and a run that
    # densifies toward a known final scale shrinks early only to re-grow
    # later.  Long scripted runs should pre-size max_dup and set this
    # False; interactive sessions keep the default True so culls reclaim
    # kernel time.
    auto_shrink_buffers: bool = True
    # Mip-splatting-style anti-aliasing (Yu et al. 2023): scale opacity by
    # sqrt(det(cov2d)/det(cov2d + dilation)) so sub-pixel splats fade
    # instead of aliasing into 0.3-px discs.  BEYOND reference parity;
    # off by default (parity tests stay bit-identical).
    mip_antialias: bool = False
    # 3DGS-style periodic opacity reset: every N iterations clamp all
    # opacities to <= 0.01 so accumulated floaters must re-earn their
    # weight or drop below the cull threshold.  0 = off (reference
    # parity: the reference never resets opacity).
    opacity_reset_interval: int = 0
    # Exponential decay of the densify split/clone variance trigger,
    # applied as paramDensifyVariance * decay^iterations.  1.0 = off
    # (reference parity: flat threshold).  Converging fits shrink their
    # gradients, so a flat trigger stops densifying long before the tail;
    # ~0.999 keeps growth alive on long runs.
    densify_variance_decay: float = 1.0
    # 3DGS-style exponential location-LR decay, applied as
    # lrLocation * decay^iterations.  1.0 = off (reference parity: the
    # reference uses flat LRs, src/Trainer.cu:81-101); ~0.9995 closes
    # several dB on long runs by letting positions settle.
    lr_location_decay: float = 1.0
    # Shard truth captures over all local devices (parallel/capture.py):
    # each chip path-traces its share of the 2C truth frames.  Off by
    # default — on one chip it is a no-op, and multi-chip users opt in.
    capture_data_parallel: bool = False
    # Multi-device TRAINING (the product path over parallel/dp.py and
    # parallel/fsdp.py; no reference equivalent — the reference is
    # strictly single-GPU).  train_devices = N > 1 runs every training
    # step sharded over the first N local devices and shards truth
    # (re)captures over the same devices; 0/1 = single-device.  The
    # frame count 2*num_cameras must be divisible by N (the Trainer
    # shrinks N to the largest divisor and warns otherwise).  CLI:
    # ``gsplat-tpu train --devices N``.
    train_devices: int = 0
    # Mesh layout for train_devices > 1:
    #   "dp"   — camera data-parallel (parallel/dp.py): model replicated,
    #            truth frames sharded, one gradient psum per step.  The
    #            right choice up to ~1M splats (grads are ~23 floats/splat).
    #   "fsdp" — splat-sharded parameters (parallel/fsdp.py, ZeRO-3
    #            style) on a 1 x N (camera x splat) mesh: rest-state
    #            model memory is capacity/N per device; densify runs
    #            gathered (parallel/densify.py) at its 200-step cadence.
    train_mesh: str = "dp"
    # Resolution-invariant LR recipes (framework knob, 0 = off/reference
    # parity).  Gradients here are PIXEL SUMS of J^T r (the reference
    # convention, src/Trainer.cu:33-44), so a splat covering 16x more
    # pixels at 1024^2 gets ~16x the gradient it gets at 256^2 — an LR
    # recipe tuned at one resolution overshoots ~(R/R0)^2 at another
    # (the 256^2 lr x8 recipe collapses opacities within 150 iterations at
    # 1024^2).  Setting
    # lr_resolution_ref = R0 multiplies all five LRs by R0^2 / (W*H) and
    # the densify variance trigger by (W*H) / R0^2, making recipes tuned
    # at R0 behave identically at any training resolution.
    lr_resolution_ref: int = 0

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(dataclasses.asdict(self), fh)

    @classmethod
    def load(cls, path: str) -> "RuntimeConfig":
        with open(path) as fh:
            d = json.load(fh)
        out = cls()
        for f in dataclasses.fields(cls):
            if f.name in d:
                setattr(out, f.name, d[f.name])
        return out
