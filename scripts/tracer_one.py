"""Time one path-tracer configuration and print one line.

Sweep by invoking it repeatedly (one process at a time on a GPU):

    for b in 4096 8192 16384; do
        python scripts/tracer_one.py --bounce-chunk $b
    done

Workload: the north-star capture (32-sample 1024² mushroom from rig
camera 0, ~2% coverage) plus a hit-rich close-up (~13.6% coverage), 3
reps each after a warmup, reference tracer semantics throughout
(src/rtx/RtxDevice.cu:61-158).
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gaussian_splatterer_tpu.config import Project  # noqa: E402
from gaussian_splatterer_tpu.models.camera import Camera  # noqa: E402
import gaussian_splatterer_tpu.rt.tracer as tr  # noqa: E402
from gaussian_splatterer_tpu.rt.scenes import (  # noqa: E402
    mushroom_mesh,
    mushroom_texture,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--samples", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ray-chunk", type=int, default=16384)
    ap.add_argument("--tri-chunk", type=int, default=512)
    ap.add_argument("--bounce-chunk", type=int, default=4096)
    ap.add_argument("--bounce-round", type=int, default=0)
    ap.add_argument("--roulette-from", type=int, default=0,
                    help="russian-roulette start bounce (0 = off/parity)")
    ap.add_argument("--bounces", type=int, default=tr.MAX_BOUNCES)
    ap.add_argument("--mesh-res", type=int, default=32)
    ap.add_argument("--no-mxu-bounce", action="store_true")
    ap.add_argument("--accel-min", type=int, default=2 * 512)
    ap.add_argument("--cams", choices=["ns", "close", "both"], default="both")
    ap.add_argument("--profile", help="write a jax.profiler trace to this dir "
                                      "during the LAST north-star rep")
    args = ap.parse_args()

    mesh = mushroom_mesh(args.mesh_res, max(args.mesh_res // 2, 6))
    proj = Project.app_default()
    proj.sphere1.count = 8
    cam_ns = Camera.get_cameras(proj)[0]
    cam_close = Camera(
        np.array([0.3, -0.2, -4.0], np.float32), np.zeros(3, np.float32), 60.0
    )
    rtx = tr.RtxHost(
        tri_chunk=args.tri_chunk, ray_chunk=args.ray_chunk,
        bounce_chunk=args.bounce_chunk,
        bounce_round=args.bounce_round or None,
        roulette_from=args.roulette_from,
    )
    rtx.load_model(mesh, accel_min=args.accel_min,
                   mxu_bounce=not args.no_mxu_bounce)
    rtx.load_texture_diffuse(mushroom_texture())

    tag = (f"ray={args.ray_chunk} tri={args.tri_chunk} "
           f"bchunk={args.bounce_chunk} K={args.bounce_round} "
           f"mxu={int(not args.no_mxu_bounce)} "
           f"roul={args.roulette_from} B={args.bounces}")
    cams = {"ns": [(cam_ns, "ns-cam")], "close": [(cam_close, "close-cam")],
            "both": [(cam_ns, "ns-cam"), (cam_close, "close-cam")]}[args.cams]
    import jax

    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          flush=True)
    for cam, label in cams:
        im = np.asarray(
            rtx.render(cam, np.zeros(3, np.float32), args.samples,
                       args.res, args.res, bounces=args.bounces)
        )  # warmup + compile
        t0 = time.perf_counter()
        for rep in range(args.reps):
            prof = (
                args.profile and label == "ns-cam" and rep == args.reps - 1
            )
            if prof:
                jax.profiler.start_trace(args.profile)
            img = rtx.render(
                cam, (1.0, 1.0, 1.0) if rep % 2 else (0.0, 0.0, 0.0),
                args.samples, args.res, args.res, bounces=args.bounces,
            )
            im = np.asarray(img)
            if prof:
                jax.profiler.stop_trace()
        dt = (time.perf_counter() - t0) / args.reps
        print(f"{tag} {label}: {dt:.3f}s /{args.samples}-sample "
              f"{args.res}^2 capture ({args.reps} reps) "
              f"mean={im.mean():.4f}", flush=True)


if __name__ == "__main__":
    main()
