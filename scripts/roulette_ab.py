"""A/B: roulette captures at higher sample counts vs exact captures.

Open question: roulette captures are faster per sample, and firefly
variance falls as 1/S — so roulette truths at KxS samples may beat exact
truths at S samples on VARIANCE PER WALL-SECOND.  At EQUAL samples
roulette raises the MSE training-loss floor (its per-pixel variance), so
the only admissible trade is more samples for the same wall.

One process measures ONE candidate config plus the
shared 512-sample exact reference image (noise ~1/16 of the 32-sample
candidates — common to all candidates, so ranking is unaffected), then
prints per-pixel MSE vs that reference and the wall time:

    python scripts/roulette_ab.py --samples 32  --roulette-from 0
    python scripts/roulette_ab.py --samples 32  --roulette-from 4
    python scripts/roulette_ab.py --samples 64  --roulette-from 4
    python scripts/roulette_ab.py --samples 128 --roulette-from 4

The reference is cached to --ref-cache as a npz so later invocations
skip its ~90 s render (delete the file to refresh; the cache stores the
exact mesh/camera config hash inputs in the filename-free fields and is
only valid for the default scene below).
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gaussian_splatterer_tpu.rt.scenes import (  # noqa: E402
    mushroom_mesh,
    mushroom_texture,
)

from gaussian_splatterer_tpu.config import Project  # noqa: E402
from gaussian_splatterer_tpu.models.camera import Camera  # noqa: E402
import gaussian_splatterer_tpu.rt.tracer as tr  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--samples", type=int, default=32)
    ap.add_argument("--roulette-from", type=int, default=0)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--ref-samples", type=int, default=512)
    ap.add_argument("--ref-cache", default="/tmp/roulette_ab_ref.npz")
    ap.add_argument("--mesh-res", type=int, default=32)
    ap.add_argument("--cam", choices=["ns", "close"], default="ns")
    args = ap.parse_args()

    mesh = mushroom_mesh(args.mesh_res, max(args.mesh_res // 2, 6))
    proj = Project.app_default()
    proj.sphere1.count = 8
    cam = (
        Camera.get_cameras(proj)[0]
        if args.cam == "ns"
        else Camera(np.array([0.3, -0.2, -4.0], np.float32),
                    np.zeros(3, np.float32), 60.0)
    )
    bg = np.zeros(3, np.float32)

    rtx = tr.RtxHost(roulette_from=args.roulette_from)
    rtx.load_model(mesh)
    rtx.load_texture_diffuse(mushroom_texture())

    # candidate: warm, then timed reps (fresh seeds per rep via the host
    # seed counter), keeping the LAST rep's image for the MSE
    img = np.asarray(rtx.render(cam, bg, args.samples, args.res, args.res))
    t0 = time.perf_counter()
    for _ in range(args.reps):
        img = np.asarray(rtx.render(cam, bg, args.samples, args.res, args.res))
    dt = (time.perf_counter() - t0) / args.reps

    ref_key = f"{args.cam}_{args.res}_{args.mesh_res}_{args.ref_samples}"
    ref = None
    if os.path.exists(args.ref_cache):
        z = np.load(args.ref_cache)
        if str(z.get("key")) == ref_key:
            ref = z["img"]
    if ref is None:
        rtx_ref = tr.RtxHost(roulette_from=0)  # reference = EXACT tracer
        rtx_ref.load_model(mesh)
        rtx_ref.load_texture_diffuse(mushroom_texture())
        ref = np.asarray(
            rtx_ref.render(cam, bg, args.ref_samples, args.res, args.res,
                           seed=987654)
        )
        np.savez(args.ref_cache, img=ref, key=ref_key)

    mse = float(np.mean((img - ref) ** 2))
    print(
        f"cam={args.cam} S={args.samples} roul={args.roulette_from}: "
        f"{dt:.3f}s/capture (D2H, {args.reps} reps)  "
        f"MSE_vs_ref{args.ref_samples}={mse:.3e}  mean={img.mean():.4f} "
        f"ref_mean={ref.mean():.4f}",
        flush=True,
    )


if __name__ == "__main__":
    main()
