"""Profile the fused training step at the headline config (50k/1024^2).

Times the step pipelined (dispatch N, block once) and optionally captures a
jax.profiler trace, printing the top device ops by total time.  Usage:

    python scripts/profile_train.py [--cams 8] [--res 1024] [--tile 32]
        [--trace /tmp/gsplat_trace] [--batched]
"""

import argparse
import sys
import glob
import gzip
import json
import os
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_splatterer_tpu.config import Project, RuntimeConfig
from gaussian_splatterer_tpu.models.camera import Camera
from gaussian_splatterer_tpu.models.splats import SplatModel
from gaussian_splatterer_tpu.train.trainer import (
    CameraBatch,
    LearningRates,
    Trainer,
)


def build_model(capacity, n_splats, seed=0):
    rng = np.random.default_rng(seed)
    means = np.zeros((capacity, 3), np.float32)
    means[:n_splats] = rng.uniform(-3, 3, (n_splats, 3))
    shs = np.zeros((capacity, 4, 3), np.float32)
    shs[:n_splats] = rng.normal(0, 0.5, (n_splats, 4, 3))
    scales = np.zeros((capacity, 3), np.float32)
    scales[:n_splats] = rng.uniform(0.01, 0.08, (n_splats, 3))
    opac = np.zeros((capacity,), np.float32)
    opac[:n_splats] = rng.uniform(0.2, 1.0, n_splats)
    rot = np.zeros((capacity, 4), np.float32)
    rot[:, 0] = 1.0
    rot[:n_splats] = rng.normal(0, 1, (n_splats, 4))
    return SplatModel(
        means=jnp.asarray(means), shs=jnp.asarray(shs), scales=jnp.asarray(scales),
        opacities=jnp.asarray(opac), rotations=jnp.asarray(rot),
        count=jnp.int32(n_splats),
    )


def summarize_trace(trace_dir, steps=3):
    """Parse the chrome-format device trace and print top ops by per-step
    time with their source attribution."""
    files = glob.glob(
        os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True
    )
    if not files:
        print("no trace json found under", trace_dir)
        return
    with gzip.open(sorted(files)[-1], "rt") as f:
        data = json.load(f)
    by_name = defaultdict(float)
    meta = {}
    total = 0.0
    for ev in data.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        name = ev.get("name", "")
        args = ev.get("args") or {}
        if "long_name" not in args and "tf_op" not in args and not name.startswith(
            ("fusion", "custom-call", "closed_call", "sort", "scatter",
             "gather", "copy", "while", "dynamic", "reduce", "transpose",
             "convert", "iota", "broadcast", "concatenate", "slice",
             "select", "bitcast", "all-", "cumsum")
        ):
            continue
        by_name[name] += ev["dur"] / 1e3  # us -> ms
        total += ev["dur"] / 1e3
        if name not in meta:
            ln = args.get("long_name", "")
            src = (args.get("source") or "").split("/")[-1]
            shape = ln.split(" = ")[1].split(" ")[0] if " = " in ln else ""
            meta[name] = (shape[:48], src[:40])
    print(f"\n-- device ops, ms per step (trace total {total:.1f} ms / "
          f"{steps} steps) --")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:22]:
        shape, src = meta.get(name, ("", ""))
        print(f"{ms/steps:9.2f} ms  {name:22s} {shape:50s} {src}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=8)
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--tile", type=int, default=32)
    ap.add_argument("--splats", type=int, default=50_000)
    ap.add_argument("--capacity", type=int, default=65_536)
    ap.add_argument("--max-dup", type=int, default=2**18)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    project = Project.app_default()
    project.sphere1.count = args.cams
    project.sphere2.count = 0
    runtime = RuntimeConfig()
    runtime.render_resolution_x = runtime.render_resolution_y = args.res
    runtime.tile_px = args.tile
    runtime.max_dup = args.max_dup
    runtime.splats_capacity = args.capacity

    model = build_model(args.capacity, args.splats)
    trainer = Trainer(project, runtime, model, renderer="tiled")

    # synthetic truths, pre-tiled like capture_truths does
    cameras = Camera.get_cameras(project)
    f = len(cameras)
    rng = np.random.default_rng(1)
    truths_img = rng.uniform(0, 1, (2 * f, args.res, args.res, 3)).astype(np.float32)
    from gaussian_splatterer_tpu.ops.raster_tiled import image_to_tiles_cm

    truths = jax.vmap(lambda im: image_to_tiles_cm(im, args.tile))(
        jnp.asarray(truths_img)
    )
    trainer.truths = truths
    trainer.truth_cams = CameraBatch.from_cameras(cameras, args.res, args.res)
    lrs = LearningRates.from_project(project)

    print(f"config: {args.cams} cams -> {2*f} frames, {args.res}^2, "
          f"tile {args.tile}, max_dup {args.max_dup}, platform "
          f"{jax.devices()[0].platform}")

    t0 = time.perf_counter()
    m, metrics = trainer._step(trainer.model, truths, trainer.truth_cams, lrs)
    jax.block_until_ready(m)
    print(f"compile+first step: {time.perf_counter()-t0:.1f} s; "
          f"loss={float(metrics.loss):.5f}")

    # pipelined steps
    t0 = time.perf_counter()
    mm = trainer.model
    outs = []
    for _ in range(args.reps):
        mm, metrics = trainer._step(mm, truths, trainer.truth_cams, lrs)
        outs.append(metrics.loss)
    jax.block_until_ready((mm, outs))
    dt = (time.perf_counter() - t0) / args.reps
    print(f"step: {dt*1e3:.1f} ms  ({dt*1e3/(2*f):.2f} ms/frame, "
          f"{1.0/dt:.2f} steps/s)")

    if args.trace:
        with jax.profiler.trace(args.trace):
            mm2 = trainer.model
            for _ in range(3):
                mm2, met = trainer._step(mm2, truths, trainer.truth_cams, lrs)
            jax.block_until_ready(mm2)
        summarize_trace(args.trace)


if __name__ == "__main__":
    main()
