"""Command-line interface — the headless replacement for the reference GUI.

The reference is a wxWidgets desktop app (SURVEY §2.3: GUI out of scope,
behaviors move into the framework API); this CLI exposes the same workflow:

    gsplat-tpu new PROJECT_DIR [--obj model.obj --texture tex.png]
    gsplat-tpu train PROJECT_DIR --steps N [--renderer tiled|oracle]
    gsplat-tpu render PROJECT_DIR OUT.png [--mode splats|rtx] [--size WxH]
    gsplat-tpu info PROJECT_DIR
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from gaussian_splatterer_tpu.config import Project, RuntimeConfig


def _make_session(args, require: bool = False):
    from gaussian_splatterer_tpu.app.session import RUNTIME_FILE, Session

    directory = args.project
    # runtime knobs persist with the project (runtime.json beside
    # settings.json — the reference keeps everything in one settings file,
    # src/Project.h:64-73); explicit CLI flags override the persisted values
    rt_path = os.path.join(directory, RUNTIME_FILE)
    persisted = os.path.exists(rt_path)
    runtime = RuntimeConfig.load(rt_path) if persisted else RuntimeConfig()
    resized = False
    if getattr(args, "resolution", None):
        runtime.render_resolution_x = runtime.render_resolution_y = args.resolution
        resized = True
    if getattr(args, "capacity", None):
        runtime.splats_capacity = args.capacity
        resized = True
    if getattr(args, "devices", None) is not None:
        # multi-device training (camera-DP by default; see
        # RuntimeConfig.train_mesh).  Persists with the project like every
        # other runtime knob; pass --devices 1 to go back to single-device.
        runtime.train_devices = args.devices
        if args.devices > 1:
            runtime.capture_data_parallel = True
    # generic runtime-knob overrides: --runtime key=value (repeatable),
    # e.g. --runtime lr_location_decay=0.9988 --runtime sh_degree=3
    import dataclasses

    field_types = {f.name: f.type for f in dataclasses.fields(RuntimeConfig)}
    for kv in getattr(args, "runtime", None) or []:
        key, _, val = kv.partition("=")
        if key not in field_types or not _:
            raise SystemExit(
                f"--runtime {kv!r}: unknown key (valid: "
                f"{', '.join(sorted(field_types))})"
            )
        cur = getattr(runtime, key)
        if val.lower() == "none":
            setattr(runtime, key, None)
        elif isinstance(cur, bool):
            setattr(runtime, key, val.lower() in ("1", "true", "yes", "on"))
        elif isinstance(cur, int):
            setattr(runtime, key, int(val))
        elif isinstance(cur, float):
            setattr(runtime, key, float(val))
        else:
            # other fields: numeric if it parses
            try:
                setattr(runtime, key, int(val))
            except ValueError:
                try:
                    setattr(runtime, key, float(val))
                except ValueError:
                    setattr(runtime, key, val)
        resized = resized or key in (
            "render_resolution_x", "render_resolution_y", "splats_capacity"
        )
    if getattr(args, "max_dup", None):
        runtime.max_dup = args.max_dup
    elif not persisted or resized:
        # scale the binning buffer with the scene: ~128 duplicate slots per
        # tile plus one per splat of capacity, rounded up to a power of two
        tiles = (runtime.render_resolution_x // runtime.tile_px) * (
            runtime.render_resolution_y // runtime.tile_px
        )
        want = max(2**12, tiles * 128 + runtime.splats_capacity)
        runtime.max_dup = 1 << (want - 1).bit_length()
    session = Session(runtime=runtime, renderer=getattr(args, "renderer", "tiled"))
    settings = os.path.join(directory, "settings.json")
    if os.path.exists(settings):
        session.load_project(directory, runtime=runtime)
    elif require:
        raise SystemExit(f"no project at {directory} (missing {settings})")
    return session


def cmd_new(args):
    session = _make_session(args)
    if args.obj:
        session.load_model_obj(args.obj)
    if args.texture:
        session.load_texture(args.texture)
    if args.init_field:
        session.init_field(args.init_field)
    session.save_project(args.project)
    print(f"created project at {args.project}")


def cmd_train(args):
    session = _make_session(args, require=True)
    if session.rtx.mesh is None:
        raise SystemExit("project has no OBJ model; run `new --obj` first")
    ckpt_dir = args.checkpoint_dir or os.path.join(args.project, "checkpoints")
    if args.resume:
        latest = os.path.join(ckpt_dir, "latest.npz")
        if os.path.exists(latest):
            session.resume_from_checkpoint(ckpt_dir)
            print(f"resumed from {latest} at iter {session.project.iterations}")
        else:
            print(f"--resume: no checkpoint at {latest}; starting fresh")
    t0 = time.time()
    last = {"it": session.project.iterations, "t": t0}

    def on_step(it, metrics):
        if it % args.log_every == 0:
            # sliding-window rate: a lifetime average would stay dominated
            # by the first step's compile
            now = time.time()
            rate = (it - last["it"]) / max(now - last["t"], 1e-9)
            last["it"], last["t"] = it, now
            # cadence countdowns mirror the reference's train panel
            # (src/ui/tools/UiPanelToolsTrain.cpp:98-107)
            p = session.project
            cadence = "  ".join(
                f"{name} in {iv - (it % iv)}"
                for name, iv in (
                    ("capture", p.intervalCapture),
                    ("densify", p.intervalDensify),
                )
                if iv
            )
            print(
                f"iter {it}  loss {float(metrics.loss):.6f}  "
                f"splats {int(session.model.count)}  {rate:.1f} steps/s"
                + (f"  [{cadence}]" if cadence else ""),
                flush=True,
            )

    watch_dir = os.path.join(args.project, "watch")
    if args.watch:
        print(f"watch: open file://{os.path.abspath(watch_dir)}/index.html "
              "in a browser (auto-refreshes)", flush=True)
    session.auto_train(
        args.steps, on_step=on_step,
        checkpoint_dir=ckpt_dir if args.checkpoint_every else None,
        checkpoint_every=args.checkpoint_every,
        snapshot_dir=args.snapshot_dir or os.path.join(args.project, "snapshots"),
        snapshot_every=args.snapshot_every,
        watch_dir=watch_dir if args.watch else None,
        watch_every=args.watch_every if args.watch else 0,
    )
    session.save_project(args.project)
    print(f"trained {args.steps} steps in {time.time()-t0:.1f}s; saved")


def cmd_render(args):
    session = _make_session(args, require=True)
    w, h = (int(x) for x in args.size.split("x")) if args.size else (None, None)
    if args.mode == "splats":
        if args.samples:
            print(
                "warning: --samples only applies to --mode rtx "
                "(the splat rasterizer is deterministic); ignoring",
                file=sys.stderr,
            )
        session.export_splats_png(args.output, w, h)
    elif args.mode == "viewer":
        session.export_viewer_html(args.output)
    else:
        session.export_rtx_png(args.output, w, h, samples=args.samples)
    print(f"wrote {args.output}")


def cmd_export(args):
    session = _make_session(args, require=True)
    out = args.output
    if out.endswith(".ply"):
        session.save_splats_ply(out)
    elif out.endswith(".html"):
        session.export_viewer_html(out)
    else:
        session.save_splats(out)  # .gobj text (reference-interoperable)
    print(f"wrote {out}")


def cmd_info(args):
    session = _make_session(args, require=True)
    p = session.project
    print(
        json.dumps(
            {
                "iterations": p.iterations,
                "splats": int(session.model.count),
                "capacity": session.model.capacity,
                "cameras": p.num_cameras,
                "model_obj": p.pathModel,
                "texture": p.pathTextureDiffuse,
                "lr": {
                    "location": p.lrLocation,
                    "sh": p.lrSh,
                    "scale": p.lrScale,
                    "opacity": p.lrOpacity,
                    "rotation": p.lrRotation,
                },
            },
            indent=2,
        )
    )


def cmd_doctor(args):
    """Backend health check: numerics gate + a timed micro train step."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    from gaussian_splatterer_tpu.models.splats import init_field_grid
    from gaussian_splatterer_tpu.ops.raster_reference import render_oracle
    from gaussian_splatterer_tpu.ops.raster_tiled import (
        image_to_tiles_cm,
        render_tiled,
    )
    from gaussian_splatterer_tpu.train.trainer import (
        CameraBatch,
        LearningRates,
        make_train_step,
    )
    from gaussian_splatterer_tpu.models.camera import Camera
    from gaussian_splatterer_tpu.config import Project

    devices = jax.devices()
    res, tile, cap = 128, 16, 8192
    host = init_field_grid(cap, 1, 4)  # 17^3 reference grid field
    model = host.to_device()
    cam = Camera(np.array([0.3, -0.2, -8.0], np.float32),
                 np.zeros(3, np.float32), 60.0)
    view = jnp.asarray(cam.get_view())
    pv = jnp.asarray(cam.get_proj_view(1.0))
    tx, ty = cam.tan_fov(res, res, train=True)
    bg = jnp.asarray([0.2, 0.3, 0.4], jnp.float32)
    margs = (model.means, model.shs, model.scales, model.opacities,
             model.rotations, model.active_mask(), view, pv,
             jnp.asarray(cam.location), tx, ty, res, res, bg, 1, 1.0)
    img_t = np.asarray(
        jax.jit(lambda: render_tiled(*margs, tile=tile, max_dup=2**13))()
    )
    with jax.default_matmul_precision("highest"):
        img_o = np.asarray(render_oracle(*margs, row_chunk=16, tile_cull=tile))
    err = float(np.max(np.abs(img_t - img_o)))
    gate_ok = bool(np.isfinite(img_t).all() and err < 2e-2)

    cams = CameraBatch.from_cameras([cam], res, res)
    truths = jnp.zeros((2, res, res, 3), jnp.float32)
    tt = jax.vmap(lambda im: image_to_tiles_cm(im, tile))(truths)
    step = make_train_step(res, res, 1, renderer="tiled", fused=True,
                           fused_opts=dict(tile=tile, max_dup=2**13))
    lrs = LearningRates.from_project(Project())
    out = step(model, tt, cams, lrs)  # compile
    jax.block_until_ready(out[0].means)
    t0 = time.time()
    reps = 20
    outs = [step(model, tt, cams, lrs) for _ in range(reps)]
    jax.block_until_ready([o[0].means for o in outs])
    sps = reps / (time.time() - t0)
    print(json.dumps({
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "numerics_gate": "ok" if gate_ok else f"FAILED (max err {err:.2e})",
        "tiled_vs_oracle_max_err": round(err, 6),
        "micro_step_per_s": round(sps, 2),
        "config": f"{res}^2, {cap} splats, tile {tile}",
    }, indent=2))
    return 0 if gate_ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gsplat-tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_new = sub.add_parser("new", help="create a project directory")
    p_new.add_argument("project")
    p_new.add_argument("--obj", help="OBJ mesh to trace as truth")
    p_new.add_argument("--texture", help="diffuse texture (PNG/TGA/JPG)")
    p_new.add_argument("--init-field", choices=["grid", "mono", "model"],
                       default="grid")
    p_new.add_argument("--resolution", type=int)
    p_new.add_argument("--capacity", type=int)
    p_new.add_argument("--max-dup", type=int, dest="max_dup")
    p_new.add_argument("--runtime", action="append", metavar="KEY=VALUE",
                      help="set any RuntimeConfig field (repeatable), e.g. "
                           "--runtime lr_location_decay=0.9988")
    p_new.set_defaults(fn=cmd_new)

    p_tr = sub.add_parser("train", help="run auto-training")
    p_tr.add_argument("project")
    p_tr.add_argument("--steps", type=int, default=200)
    p_tr.add_argument("--renderer", choices=["tiled", "oracle"], default="tiled")
    p_tr.add_argument("--devices", type=int,
                      help="shard training + recaptures over the first N "
                           "local devices (camera-DP; --runtime "
                           "train_mesh=fsdp for splat-sharded parameters). "
                           "Persists with the project; --devices 1 reverts")
    p_tr.add_argument("--resolution", type=int)
    p_tr.add_argument("--capacity", type=int)
    p_tr.add_argument("--max-dup", type=int, dest="max_dup")
    p_tr.add_argument("--runtime", action="append", metavar="KEY=VALUE",
                      help="set any RuntimeConfig field (repeatable), e.g. "
                           "--runtime lr_location_decay=0.9988")
    p_tr.add_argument("--log-every", type=int, default=10)
    p_tr.add_argument("--checkpoint-every", type=int, default=0,
                      help="crash-recovery .npz checkpoint every N iters")
    p_tr.add_argument("--checkpoint-dir",
                      help="checkpoint directory (default PROJECT/checkpoints)")
    p_tr.add_argument("--resume", action="store_true",
                      help="resume from the latest checkpoint if present")
    p_tr.add_argument("--snapshot-every", type=int, default=0,
                      help="export a splat-render PNG every N iters (the "
                           "headless live-preview equivalent)")
    p_tr.add_argument("--snapshot-dir",
                      help="snapshot directory (default PROJECT/snapshots)")
    p_tr.add_argument("--watch", action="store_true",
                      help="live-watch mode: rewrite PROJECT/watch/"
                           "index.html + latest.png every --watch-every "
                           "iters; open it in a browser to track the run")
    p_tr.add_argument("--watch-every", type=int, default=25)
    p_tr.set_defaults(fn=cmd_train)

    p_re = sub.add_parser("render", help="export a PNG")
    p_re.add_argument("project")
    p_re.add_argument("output")
    p_re.add_argument("--mode", choices=["splats", "rtx", "viewer"],
                      default="splats",
                      help="viewer = self-contained interactive HTML")
    p_re.add_argument("--size", help="WxH, e.g. 1024x1024")
    p_re.add_argument("--samples", type=int)
    p_re.add_argument("--renderer", choices=["tiled", "oracle"], default="tiled")
    p_re.add_argument("--resolution", type=int)
    p_re.add_argument("--capacity", type=int)
    p_re.add_argument("--max-dup", type=int, dest="max_dup")
    p_re.add_argument("--runtime", action="append", metavar="KEY=VALUE",
                      help="set any RuntimeConfig field (repeatable), e.g. "
                           "--runtime lr_location_decay=0.9988")
    p_re.set_defaults(fn=cmd_render)

    p_ex = sub.add_parser(
        "export",
        help="export splats by extension: .ply (standard 3DGS, ecosystem "
             "viewers), .html (self-contained viewer), .gobj (reference)",
    )
    p_ex.add_argument("project")
    p_ex.add_argument("output")
    p_ex.add_argument("--capacity", type=int)
    p_ex.add_argument("--resolution", type=int)
    p_ex.add_argument("--max-dup", type=int, dest="max_dup")
    p_ex.add_argument("--runtime", action="append", metavar="KEY=VALUE",
                      help="set any RuntimeConfig field (repeatable), e.g. "
                           "--runtime lr_location_decay=0.9988")
    p_ex.set_defaults(fn=cmd_export)

    p_in = sub.add_parser("info", help="print project summary")
    p_in.add_argument("project")
    p_in.set_defaults(fn=cmd_info)

    p_dr = sub.add_parser(
        "doctor",
        help="backend health check: tiled-vs-oracle numerics gate + a "
             "timed micro train step on the attached backend",
    )
    p_dr.set_defaults(fn=cmd_doctor)

    args = ap.parse_args(argv)
    rc = args.fn(args)
    return rc if isinstance(rc, int) else 0


if __name__ == "__main__":
    sys.exit(main())
