"""Quality harness: train a textured OBJ to N splats, report PSNR + steps/s.

BASELINE configs 2-3: 8-camera truth rig, densify schedule, PSNR measured on
held-out (freshly captured) truth views against the splat render.

Usage:
    python scripts/quality_run.py [--steps 600] [--res 256] [--obj path.obj]
        [--out run_dir]

Without --obj a built-in two-plane cross with a checker texture is used.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from gaussian_splatterer_tpu.app.session import Session
from gaussian_splatterer_tpu.config import Project, RuntimeConfig
from gaussian_splatterer_tpu.io.image import save_png
from gaussian_splatterer_tpu.io.obj import TriangleMesh
from gaussian_splatterer_tpu.models.camera import Camera
from gaussian_splatterer_tpu.rt.scenes import mushroom_mesh, mushroom_texture
from gaussian_splatterer_tpu.utils.metrics import psnr, ssim

CROSS_OBJ_VERTS = np.array(
    [
        [-1.2, -1.2, 0], [1.2, -1.2, 0], [1.2, 1.2, 0], [-1.2, 1.2, 0],
        [0, -1.2, -1.2], [0, 1.2, -1.2], [0, 1.2, 1.2], [0, -1.2, 1.2],
    ],
    np.float32,
)
CROSS_TRIS = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
CROSS_UV = np.array(
    [
        [[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]],
        [[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]],
    ],
    np.float32,
)


def checker_texture(n=64, a=(0.9, 0.3, 0.2), b=(0.2, 0.4, 0.9)):
    t = np.zeros((n, n, 4), np.float32)
    yy, xx = np.mgrid[0:n, 0:n]
    mask = ((xx // 8) + (yy // 8)) % 2 == 0
    t[mask] = (*a, 1.0)
    t[~mask] = (*b, 1.0)
    return t


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--cams", type=int, default=8)
    ap.add_argument("--samples", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=65_536)
    ap.add_argument("--max-dup", type=int, default=2**17)
    ap.add_argument("--obj")
    ap.add_argument("--texture")
    ap.add_argument("--scene", choices=["cross", "mushroom"], default="cross",
                    help="built-in scene when no --obj is given")
    ap.add_argument("--mesh-res", type=int, default=32,
                    help="mushroom mesh resolution (n_theta; tris ~= 2*n*n/2)")
    ap.add_argument("--out", default="/tmp/gsplat_quality")
    ap.add_argument("--densify-variance", type=float,
                    help="override paramDensifyVariance (growth trigger)")
    ap.add_argument("--lr-scale", type=float, default=1.0,
                    help="scale all five per-feature learning rates")
    ap.add_argument("--lr-scale-opacity", type=float, default=None,
                    help="override --lr-scale for the OPACITY rate only "
                         "(a recapture collapse at 1024^2 was "
                         "opacity-driven; default: same as --lr-scale)")
    ap.add_argument("--lr-location-decay", type=float, default=1.0,
                    help="exponential location-LR decay per iteration "
                         "(3DGS-style; 1.0 = reference-parity flat)")
    ap.add_argument("--lr-res-ref", type=int, default=0,
                    help="resolution the LR/densify recipe was tuned at: "
                         "scales LRs by (ref/res)^2 and the densify "
                         "trigger by (res/ref)^2 (gradients are pixel "
                         "sums; 0 = off)")
    ap.add_argument("--spot-alpha", type=float, default=1.0,
                    help="alpha of the mushroom cap spots (<1 exercises "
                         "stochastic transparency end-to-end)")
    ap.add_argument("--mip-aa", action="store_true",
                    help="train AND serve with mip-splatting anti-aliasing "
                         "(RuntimeConfig.mip_antialias)")
    ap.add_argument("--densify-variance-decay", type=float, default=1.0,
                    help="exponential decay of the densify trigger per "
                         "iteration (1.0 = reference-parity flat)")
    ap.add_argument("--sh-degree", type=int, default=1, choices=[1, 2, 3])
    ap.add_argument("--interval-densify", type=int)
    ap.add_argument("--interval-capture", type=int)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="write <out>/ckpt/latest.npz every N iterations "
                         "(crash insurance for long runs)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from <out>/ckpt/latest.npz; trains the "
                         "REMAINING steps up to --steps")
    ap.add_argument("--roulette-from", type=int, default=0,
                    help="russian-roulette start bounce for captures "
                         "(RuntimeConfig.rt_roulette_from; 0 = off/"
                         "reference parity).  WARNING: unbiased mean but "
                         "heavy-tailed (fireflies) — raises the MSE loss "
                         "floor at low-sample truths; not "
                         "recommended for training runs")
    ap.add_argument("--eval-samples", type=int, default=0,
                    help="RT samples for the held-out PSNR truths "
                         "(0 = same as --samples).  Training truths are "
                         "MC-noisy; a cleaner eval ground truth stops "
                         "the metric from being capped by truth noise")
    ap.add_argument("--pin-buffers", action="store_true",
                    help="never shrink the --max-dup duplicate buffer "
                         "mid-run (each resize is a recompile); overflow "
                         "growth stays on")
    args = ap.parse_args()

    proj = Project.app_default()
    proj.sphere1.count = args.cams
    proj.rtSamples = args.samples
    if args.densify_variance is not None:
        proj.paramDensifyVariance = args.densify_variance
    if args.interval_densify is not None:
        proj.intervalDensify = args.interval_densify
    if args.interval_capture is not None:
        proj.intervalCapture = args.interval_capture
    proj.lrLocation *= args.lr_scale
    proj.lrSh *= args.lr_scale
    proj.lrScale *= args.lr_scale
    proj.lrOpacity *= (
        args.lr_scale if args.lr_scale_opacity is None
        else args.lr_scale_opacity
    )
    proj.lrRotation *= args.lr_scale
    runtime = RuntimeConfig(
        render_resolution_x=args.res, render_resolution_y=args.res,
        splats_capacity=args.capacity, max_dup=args.max_dup,
        sh_degree=args.sh_degree, sh_coeffs=(args.sh_degree + 1) ** 2,
        lr_location_decay=args.lr_location_decay,
        lr_resolution_ref=args.lr_res_ref,
        densify_variance_decay=args.densify_variance_decay,
        mip_antialias=args.mip_aa,
        auto_shrink_buffers=not args.pin_buffers,
        rt_roulette_from=args.roulette_from,
    )
    s = Session(project=proj, runtime=runtime, renderer="tiled")
    if args.obj:
        s.load_model_obj(args.obj)
        if args.texture:
            s.load_texture(args.texture)
        s.init_field("model")
    elif args.scene == "mushroom":
        s.rtx.load_model(mushroom_mesh(args.mesh_res, max(args.mesh_res // 2, 6)))
        s.rtx.load_texture_diffuse(mushroom_texture(spot_alpha=args.spot_alpha))
        s.init_field("model")
    else:
        s.rtx.load_model(TriangleMesh(CROSS_OBJ_VERTS, CROSS_TRIS, CROSS_UV))
        s.rtx.load_texture_diffuse(checker_texture())
        s.init_field("model")

    steps_to_run = args.steps
    ckpt_dir = os.path.join(args.out, "ckpt")
    if args.resume:
        s.resume_from_checkpoint(ckpt_dir)
        # the checkpoint restores the SAVED project wholesale (schedule
        # knobs included) — re-apply the explicitly-given CLI schedule
        # overrides so a resumed run can retune them mid-run.  LR scales
        # are already baked into the saved per-feature rates and must NOT
        # re-apply (that would compound them).
        if args.densify_variance is not None:
            s.project.paramDensifyVariance = args.densify_variance
        if args.interval_densify is not None:
            s.project.intervalDensify = args.interval_densify
        if args.interval_capture is not None:
            s.project.intervalCapture = args.interval_capture
        steps_to_run = max(args.steps - s.project.iterations, 0)
        print(f"resumed at iteration {s.project.iterations}; "
              f"{steps_to_run} steps remain "
              f"(densify_variance={s.project.paramDensifyVariance})",
              flush=True)

    t0 = time.time()
    s.capture()
    print(f"capture: {time.time()-t0:.1f}s", flush=True)

    t0 = time.time()
    hist = []
    it0 = s.project.iterations

    def on_step(it, metrics):
        if it % 25 == 0:
            rate = (it - it0) / max(time.time() - t0, 1e-9)
            entry = dict(it=it, loss=float(metrics.loss),
                         splats=int(s.model.count), steps_per_s=rate)
            hist.append(entry)
            print(json.dumps(entry), flush=True)

    schedule_stats = s.auto_train(
        steps_to_run, on_step=on_step,
        checkpoint_dir=ckpt_dir if args.checkpoint_every else None,
        checkpoint_every=args.checkpoint_every,
    )
    train_time = time.time() - t0
    steps_per_s = steps_to_run / max(train_time, 1e-9)

    # PSNR on fresh (held-out rotation) truth views, black background
    from gaussian_splatterer_tpu.train.trainer import randomize_rig_rotations

    randomize_rig_rotations(s.project)
    cams = Camera.get_cameras(s.project)[:4]
    psnrs = []
    ssims = []
    os.makedirs(args.out, exist_ok=True)
    # keep the trained model: re-evaluable without retraining
    from gaussian_splatterer_tpu.io.checkpoint import save_checkpoint

    save_checkpoint(os.path.join(args.out, "final.npz"), s.model, s.project)
    eval_samples = args.eval_samples or args.samples
    for i, cam in enumerate(cams):
        truth = s.rtx.render(cam, (0, 0, 0), eval_samples, args.res, args.res)
        pred = s.trainer.render(cam, args.res, args.res)
        psnrs.append(float(psnr(truth, jnp.clip(pred, 0, 1))))
        ssims.append(float(ssim(truth, jnp.clip(pred, 0, 1))))
        if i == 0:
            save_png(np.asarray(truth), os.path.join(args.out, "truth.png"))
            save_png(np.asarray(jnp.clip(pred, 0, 1)),
                     os.path.join(args.out, "pred.png"))

    result = {
        "steps": args.steps,
        "steps_per_s": round(steps_per_s, 2),
        "final_splats": int(s.model.count),
        "psnr_mean": round(float(np.mean(psnrs)), 2),
        "psnr_per_view": [round(p, 2) for p in psnrs],
        "ssim_mean": round(float(np.mean(ssims)), 4),
        "train_time_s": round(train_time, 1),
        "schedule": schedule_stats,  # capture-vs-train wall split
    }
    with open(os.path.join(args.out, "result.json"), "w") as fh:
        json.dump(result, fh, indent=2)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
