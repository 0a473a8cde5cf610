"""Smoke test of the whole system on a CUDA GPU.

    python chip_smoke.py               # one GPU: device, kernels, main path
    python chip_smoke.py --devices 4   # four GPUs: dp and fsdp loops only

Phases (one process, in this order):

1. Device: JAX must see a GPU; prints the card's name and power limit.
2. Kernels: every compositing kernel, compiled for the card, against the
   plain references at the benchmark scene (50k splats, 1024^2, 8 frames):
   the forward kernel and the train composite (forward kernel, residual,
   backward kernel) against the plain-jnp tiled
   compositor (same per-tile segments, per-duplicate gradients), the full
   forward image against the per-pixel oracle, parameter gradients against
   jax.grad of the oracle on a 256^2 crop with the same splats per tile,
   and kernel-vs-XLA timings.  Then the GPU-only tests
   (tests/test_gpu_kernels.py) and the train step's memory analysis.
3. Main path at the product defaults (RuntimeConfig(), Project.app_default()):
   mesh -> path-traced capture -> auto_train with densify and recapture ->
   2048^2 PNG render -> save_project.

The last line of standard output is one JSON object; any failed check
exits non-zero before it.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

# Tolerances (readings and reasons in PERF.md).  Forward: max |kernel -
# reference| over every pixel and channel; gradients: max deviation over
# each parameter (or duplicate-feature row) divided by that row's max
# magnitude.  Each sits between the kernels' readings and those of a
# control fed TF32-rounded features, which must fail both.
FWD_MAX_ABS = 1e-3
GRAD_REL = 1e-3

BENCH = dict(n_splats=50_000, capacity=65_536, res=1024, frames=8)
MAIN_SAMPLES = 4  # cut from the project's rtSamples=100 to keep the run short


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def timed(fn, *args, reps: int = 5):
    """(result, ms per call): first call compiles, then ``reps`` fenced calls."""
    import jax

    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return out, (time.perf_counter() - t0) * 1e3 / reps


def rel_err(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1e-12, np.max(np.abs(b))))


def abs_errs(a, b):
    import numpy as np

    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()), float(d.mean())


def project_rows(params, active, views, pvs, poss, txs, tys, width, height):
    """Per-frame projection -> ((F, 9, N) feature rows, components)."""
    import jax
    import jax.numpy as jnp

    from gaussian_splatterer_tpu.ops.transforms import project_splat_components

    comps = jax.vmap(
        lambda v, pv, pos, tx, ty: project_splat_components(
            *params, active, v, pv, pos, tx, ty, width, height, 1, 1.0
        )
    )(views, pvs, poss, txs, tys)
    rows = jnp.stack(
        [comps.mx, comps.my, comps.ca, comps.cb, comps.cc,
         comps.cr, comps.cg, comps.cb2, comps.opacity], axis=1,
    )
    return rows, comps


def kernel_phase(card: str, tile: int, chunk: int) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gaussian_splatterer_tpu.ops import raster_tiled as rt
    from gaussian_splatterer_tpu.ops.raster_reference import (
        composite_tiles_reference,
        render_oracle,
    )
    from gaussian_splatterer_tpu.rt.scenes import random_splat_scene

    res, frames = BENCH["res"], BENCH["frames"]
    params, active, views, pvs, poss, txs, tys, cams = random_splat_scene(
        BENCH["n_splats"], BENCH["capacity"], res, res, frames, seed=0
    )
    tx_tiles = res // tile
    num_tiles = tx_tiles * tx_tiles
    p_count = tile * tile

    def prep(max_dup):
        @jax.jit
        def f(params):
            rows, comps = project_rows(
                params, active, views, pvs, poss, txs, tys, res, res
            )
            bins, feat9, ts, te = rt.bin_frames(
                rows, jax.lax.stop_gradient(comps), res, res, tile, max_dup
            )
            return feat9, ts, te, jnp.max(bins.num_dup)

        return f(params)

    num_dup = int(prep(2**20)[3])
    max_dup = -(-int(num_dup * 1.1) // 256) * 256
    feat9, ts, te, _ = prep(max_dup)
    depth = int(np.max(np.asarray(te - ts)))
    print(
        f"kernels: bench scene {BENCH['n_splats']} splats, {res}x{res}, "
        f"{frames} frames, tile {tile}, chunk {chunk}: {num_dup} duplicates "
        f"in the busiest frame (max_dup {max_dup}), deepest tile {depth}",
        flush=True,
    )
    kw = dict(tile=tile, tx_tiles=tx_tiles, tiles_frame=num_tiles)
    rng = np.random.default_rng(1)
    truth = jnp.asarray(
        rng.uniform(0, 1, (frames * num_tiles, 4, p_count)).astype(np.float32)
    ).at[:, 3].set(0.0)
    bg4 = jnp.asarray(
        np.concatenate([rng.uniform(0, 1, (frames, 3)), np.zeros((frames, 1))], 1),
        jnp.float32,
    )
    bg_px = jnp.repeat(bg4[:, :3], num_tiles, axis=0)[:, :, None]  # (T, 3, 1)

    k_fwd = jax.jit(functools.partial(rt.composite_forward, chunk=chunk, **kw))
    k_train = jax.jit(functools.partial(rt.composite_train, chunk=chunk, **kw))
    ref_kw = dict(kw, depth=-(-depth // 64) * 64)

    def ref_fwd(feat9):
        with jax.default_matmul_precision("highest"):
            return composite_tiles_reference(feat9, ts, te, **ref_kw)

    def ref_train(feat9):
        def neg_half_sq(f):
            out = ref_fwd(f)
            r = truth[:, :3] - (out[:, :3] + out[:, 3:4] * bg_px)
            return -0.5 * jnp.sum(jnp.square(r)), jnp.concatenate(
                [r, out[:, 3:4]], axis=1
            )

        (_, resid), grad = jax.value_and_grad(neg_half_sq, has_aux=True)(feat9)
        return resid, grad

    j_ref_fwd, j_ref_train = jax.jit(ref_fwd), jax.jit(ref_train)
    out_k, t_kf = timed(k_fwd, feat9, ts, te)
    (res_k, d_k), t_kt = timed(k_train, feat9, ts, te, truth, bg4)
    out_r, t_rf = timed(j_ref_fwd, feat9, reps=2)
    (res_r, d_r), t_rt = timed(j_ref_train, feat9, reps=2)
    fwd_err = abs_errs(out_k, out_r)
    res_err = abs_errs(res_k, res_r)
    d_k, d_r = np.asarray(d_k), np.asarray(d_r)
    grad_err = max(rel_err(d_k[i], d_r[i]) for i in range(9))
    print(
        f"kernels: serve forward vs plain tiled reference: max-abs "
        f"{fwd_err[0]:.3e} mean-abs {fwd_err[1]:.3e} (tol {FWD_MAX_ABS})",
        flush=True,
    )
    print(
        f"kernels: train composite residual vs reference: max-abs {res_err[0]:.3e} "
        f"mean-abs {res_err[1]:.3e} (tol {FWD_MAX_ABS}); per-duplicate "
        f"gradient rows max rel {grad_err:.3e} (tol {GRAD_REL})",
        flush=True,
    )
    if not (np.isfinite(out_k).all() and np.isfinite(d_k).all()):
        fail("kernel output not finite")
    if max(fwd_err[0], res_err[0]) > FWD_MAX_ABS or grad_err > GRAD_REL:
        fail("kernel parity at the bench scene")
    # controls: the reference itself, fed features rounded as a reduced-
    # precision dot rounds its inputs, in the kernels' place
    for name, mantissa in (("TF32", 10), ("bf16", 7)):
        f_lo = jax.lax.reduce_precision(feat9, exponent_bits=8,
                                        mantissa_bits=mantissa)
        c_fwd = abs_errs(j_ref_fwd(f_lo), out_r)
        c_d = np.asarray(j_ref_train(f_lo)[1])
        c_grad = max(rel_err(c_d[i], d_r[i]) for i in range(9))
        print(
            f"kernels: control, reference on {name}-rounded features: forward "
            f"max-abs {c_fwd[0]:.3e} mean-abs {c_fwd[1]:.3e}; gradient rows "
            f"max rel {c_grad:.3e}",
            flush=True,
        )
        if c_fwd[0] <= FWD_MAX_ABS or c_grad <= GRAD_REL:
            fail(f"the {name} control passes the parity gates")
    print(
        f"kernels [{card}]: compositing stage, {frames} frames: serve forward "
        f"kernel {t_kf:.2f} ms vs XLA {t_rf:.2f} ms; train composite "
        f"{t_kt:.2f} ms vs XLA fwd+vjp {t_rt:.2f} ms",
        flush=True,
    )

    # the whole fwd+bwd step (projection, binning, kernel, reduction, vjp)
    truth_f = truth.reshape(frames, num_tiles, 4, p_count)

    @jax.jit
    def step(params):
        loss, grads, _, _, nd = rt.render_train_grads_batch(
            *params, active, views, pvs, poss, txs, tys, res, res, truth_f,
            bg4[:, :3], 1, tile=tile, chunk=chunk, max_dup=max_dup,
        )
        return loss, grads, nd

    (loss, _, nd), t_step = timed(step, params)
    if not np.isfinite(float(loss)) or int(nd) > max_dup:
        fail("bench step: non-finite loss or duplicate overflow")
    print(
        f"kernels [{card}]: fwd+bwd rasterize step {t_step / frames:.3f} "
        f"ms/frame ({t_step:.2f} ms for {frames} frames)",
        flush=True,
    )

    # full forward image against the per-pixel oracle (tile-granular cull)
    bg = jnp.asarray([0.2, 0.3, 0.4], jnp.float32)
    args = (*params, active, views[0], pvs[0], poss[0], txs[0], tys[0],
            res, res, bg, 1, 1.0)
    img_k = jax.jit(
        lambda: rt.render_tiled(*args, tile=tile, chunk=chunk, max_dup=max_dup)
    )()
    with jax.default_matmul_precision("highest"):
        img_o = jax.jit(
            lambda: render_oracle(*args, row_chunk=2, tile_cull=tile)
        )()
    img_err = abs_errs(img_k, img_o)
    print(
        f"kernels: {res}x{res} forward image vs per-pixel oracle: max-abs "
        f"{img_err[0]:.3e} mean-abs {img_err[1]:.3e} (tol {FWD_MAX_ABS})",
        flush=True,
    )
    if not np.isfinite(np.asarray(img_k)).all() or img_err[0] > FWD_MAX_ABS:
        fail("forward image parity")

    g_err = grad_parity(tile, chunk)
    print(
        f"kernels: parameter gradients vs jax.grad(oracle), {res // 4}^2 crop "
        f"at bench splat density: max rel {g_err:.3e} (tol {GRAD_REL})",
        flush=True,
    )
    if g_err > GRAD_REL:
        fail("parameter gradient parity")
    return dict(
        fwd_err=fwd_err, res_err=res_err, grad_err=grad_err, img_err=img_err,
        param_grad_err=g_err, t_kernel_fwd=t_kf, t_xla_fwd=t_rf,
        t_kernel_train=t_kt, t_xla_train=t_rt, t_step=t_step,
    )


def grad_parity(tile: int, chunk: int) -> float:
    """Max per-parameter relative gradient deviation of the fused train
    path against jax.grad of the oracle, on a crop x crop view of the bench
    scene whose camera is zoomed so each pixel sees what a 1024^2 pixel
    sees (same splats per tile); splats outside the view are dropped."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gaussian_splatterer_tpu.models.camera import Camera
    from gaussian_splatterer_tpu.ops.raster_reference import render_oracle
    from gaussian_splatterer_tpu.ops.raster_tiled import (
        image_to_tiles_cm,
        render_train_grads_batch,
    )
    from gaussian_splatterer_tpu.ops.transforms import project_splat_components
    from gaussian_splatterer_tpu.rt.scenes import random_splat_scene

    crop = BENCH["res"] // 4
    zoom = BENCH["res"] / crop
    fov = float(np.degrees(2 * np.arctan(np.tan(np.radians(30.0)) / zoom)))
    params, active, *_ = random_splat_scene(
        BENCH["n_splats"], BENCH["capacity"], crop, crop, 1, seed=0
    )
    cam = Camera(np.array([0.3, -0.2, -10.0], np.float32), np.zeros(3, np.float32), fov)
    view = jnp.asarray(cam.get_view())
    pv = jnp.asarray(cam.get_proj_view(1.0))
    pos = jnp.asarray(cam.location)
    tx, ty = (jnp.float32(v) for v in cam.tan_fov(crop, crop, train=True))
    comps = project_splat_components(
        *params, active, view, pv, pos, tx, ty, crop, crop, 1, 1.0
    )
    keep = np.asarray(
        comps.valid & (comps.radius > 0)
        & (comps.mx + comps.rx >= 0) & (comps.mx - comps.rx < crop)
        & (comps.my + comps.ry >= 0) & (comps.my - comps.ry < crop)
    )
    idx = np.nonzero(keep)[0]
    sub = tuple(p[idx] for p in params)
    act = jnp.ones((len(idx),), bool)
    truth = jnp.asarray(
        np.random.default_rng(3).uniform(0, 1, (crop, crop, 3)).astype(np.float32)
    )
    bg = jnp.asarray([0.1, 0.5, 0.9], jnp.float32)

    @jax.jit
    def kernel_grads(p):
        _, g, *_ = render_train_grads_batch(
            *p, act, view[None], pv[None], pos[None], tx[None], ty[None],
            crop, crop, image_to_tiles_cm(truth, tile)[None], bg[None], 1,
            tile=tile, chunk=chunk, max_dup=2**20,
        )
        return g

    @jax.jit
    def oracle_grads(p):
        def neg_half_sq(p):
            img = render_oracle(
                *p, act, view, pv, pos, tx, ty, crop, crop, bg, 1, 1.0,
                row_chunk=8, tile_cull=tile,
            )
            return -0.5 * jnp.sum(jnp.square(img - truth))

        with jax.default_matmul_precision("highest"):
            return jax.grad(neg_half_sq)(p)

    g_k = kernel_grads(sub)
    g_o = oracle_grads(sub)
    print(f"kernels: gradient crop holds {len(idx)} splats", flush=True)
    return max(rel_err(a, b) for a, b in zip(g_k, g_o))


def gpu_tests(device) -> int:
    """Run tests/test_gpu_kernels.py's tests on the card; returns the count."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_gpu_kernels.py")
    spec = importlib.util.spec_from_file_location("test_gpu_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    names = sorted(n for n in dir(mod) if n.startswith("test_"))
    for name in names:
        for chunk in mod.CHUNKS:
            getattr(mod, name)(device, chunk)
            print(f"gpu test: {name}[chunk {chunk}] passed", flush=True)
    return len(names) * len(mod.CHUNKS)


def memory_report() -> None:
    """compiled.memory_analysis() of the product-default train step."""
    import jax
    import jax.numpy as jnp

    from gaussian_splatterer_tpu.config import Project, RuntimeConfig
    from gaussian_splatterer_tpu.models.camera import Camera
    from gaussian_splatterer_tpu.models.splats import SplatModel
    from gaussian_splatterer_tpu.train.trainer import (
        CameraBatch,
        LearningRates,
        Trainer,
    )

    project, runtime = Project.app_default(), RuntimeConfig()
    rtc = runtime
    model = SplatModel.empty(rtc.splats_capacity, rtc.sh_degree, rtc.sh_coeffs)
    trainer = Trainer(project, runtime, model, renderer="tiled")
    w, h, tile = rtc.render_resolution_x, rtc.render_resolution_y, rtc.tile_px
    cams = CameraBatch.from_cameras(Camera.get_cameras(project), w, h)
    truths = jax.ShapeDtypeStruct(
        (2 * cams.num_frames, (w // tile) * (h // tile), 4, tile * tile),
        jnp.float32,
    )
    compiled = trainer._step.lower(
        model, truths, cams, LearningRates.from_project(project)
    ).compile()
    print(f"train step memory_analysis: {compiled.memory_analysis()}", flush=True)


def main_phase(card: str) -> dict:
    import jax
    import numpy as np

    from gaussian_splatterer_tpu.app.session import Session
    from gaussian_splatterer_tpu.config import Project, RuntimeConfig
    from gaussian_splatterer_tpu.rt.scenes import mushroom_mesh, mushroom_texture

    project = Project.app_default()
    project.rtSamples = MAIN_SAMPLES
    runtime = RuntimeConfig()
    print(
        f"main: RuntimeConfig() defaults ({runtime.render_resolution_x}x"
        f"{runtime.render_resolution_y}, capacity {runtime.splats_capacity}, "
        f"max_dup {runtime.max_dup}, tile {runtime.tile_px}, chunk "
        f"{runtime.train_chunk}), Project.app_default() ({project.num_cameras} "
        f"cameras = {2 * project.num_cameras} frames per step, capture every "
        f"{project.intervalCapture}, densify every {project.intervalDensify}); "
        f"cut: rtSamples 100 -> {MAIN_SAMPLES}",
        flush=True,
    )
    s = Session(project=project, runtime=runtime, renderer="tiled")
    s.rtx.load_model(mushroom_mesh())
    s.rtx.load_texture_diffuse(mushroom_texture())
    s.init_field("model")
    n0 = int(s.model.count)

    t0 = time.perf_counter()
    s.capture()
    jax.block_until_ready(s.trainer.truths)
    t_capture = time.perf_counter() - t0
    print(f"main [{card}]: first capture {t_capture:.1f} s (compile included)",
          flush=True)

    steps = project.intervalCapture + 1  # densify at 0, recapture at 50
    losses, densify_at = [], []
    train_step = s.trainer.train

    def train_watched(densify_now=False):  # records when densify runs
        if densify_now:
            densify_at.append((s.project.iterations, int(s.model.count)))
        return train_step(densify_now=densify_now)

    s.trainer.train = train_watched
    stamps = []

    def on_step(it, metrics):
        losses.append(float(metrics.loss))  # a host read: fences the step
        stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    sched = s.auto_train(steps, on_step=on_step)
    t_train = time.perf_counter() - t0
    # steady steps: those after the first (compile) without a recapture
    gaps = np.diff(stamps)
    steady = np.median(np.delete(gaps, project.intervalCapture - 1))
    # falling on the first truths: the first step vs the last five before
    # the recapture (new rig rotations change what the loss measures)
    cap = project.intervalCapture
    loss0, loss1 = losses[0], float(np.mean(losses[max(1, cap - 5) : cap]))
    print(
        f"main [{card}]: auto_train {steps} steps in {t_train:.1f} s "
        f"(first step compiles; schedule {sched}); steady step "
        f"{steady * 1e3:.1f} ms (median); densify at (iteration, "
        f"splats before) {densify_at}; splats {n0} -> {int(s.model.count)}; "
        f"loss {loss0:.5f} -> {loss1:.5f}",
        flush=True,
    )
    if not np.isfinite(losses).all() or not loss1 < loss0:
        fail("loss not finite and falling")
    if sched["recaptures"] < 1 or not densify_at:
        fail("auto_train ran no recapture or no densify")

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    t0 = time.perf_counter()
    png = os.path.join(out_dir, "render.png")
    s.export_splats_png(png)
    t_render = time.perf_counter() - t0
    s.save_project(os.path.join(out_dir, "project"))
    from gaussian_splatterer_tpu.io.image import load_png

    img = load_png(png)
    if img.shape != (project.renderResY, project.renderResX, 3) or img.max() <= 0:
        fail(f"render PNG has shape {img.shape} / is black")
    saved = sorted(os.listdir(os.path.join(out_dir, "project")))
    print(
        f"main [{card}]: {project.renderResX}x{project.renderResY} PNG render "
        f"{t_render:.1f} s (compile included); saved project {saved}",
        flush=True,
    )
    return dict(t_capture=t_capture, t_train=t_train, t_render=t_render)


def multi_phase(n: int, card: str) -> None:
    """The dp and fsdp product loops on ``n`` GPUs — auto_train with its
    captures sharded over the same GPUs — each against the single-device
    loop on the same truths (per-frame capture keys do not depend on the
    mesh, parallel/capture.py)."""
    import random

    import jax
    import numpy as np

    from gaussian_splatterer_tpu.app.session import Session
    from gaussian_splatterer_tpu.config import Project, RuntimeConfig
    from gaussian_splatterer_tpu.rt.scenes import mushroom_mesh, mushroom_texture
    from gaussian_splatterer_tpu.train.schedule import auto_train

    steps = 5
    print(
        f"multi: product loops on {n} devices vs 1, RuntimeConfig() defaults, "
        f"Project.app_default(); cut: rtSamples -> {MAIN_SAMPLES}, "
        f"{steps} steps with capture every 2 and densify every 3",
        flush=True,
    )

    def run(devices: int, mesh: str):
        project = Project.app_default()
        project.rtSamples = MAIN_SAMPLES
        project.intervalCapture, project.intervalDensify = 2, 3
        runtime = RuntimeConfig(train_devices=devices, train_mesh=mesh)
        s = Session(project=project, runtime=runtime, renderer="tiled")
        s.rtx.load_model(mushroom_mesh())
        s.rtx.load_texture_diffuse(mushroom_texture())
        s.init_field("model")
        losses = []
        t0 = time.perf_counter()
        sched = auto_train(
            s.trainer, s.rtx, steps, rng=random.Random(0),
            on_step=lambda it, m: losses.append(float(m.loss)),
            capture_devices=None if devices > 1 else jax.devices()[:1],
        )
        dt = time.perf_counter() - t0
        holders = {
            d.id for x in (s.trainer.truths, s.model.means) for d in x.devices()
        }
        in_use = [(d.memory_stats() or {}).get("bytes_in_use", 0)  # None on CPU
                  for d in jax.devices()[:devices]]
        return s.model, losses, dt, sched, sorted(holders), in_use

    ref, l_ref, t_ref, sched, _, _ = run(1, "dp")
    print(f"multi [{card}]: 1 device: losses {l_ref}, {t_ref:.1f} s "
          f"(compile included), schedule {sched}", flush=True)
    for mesh in ("dp", "fsdp"):
        model, losses, dt, sched, holders, in_use = run(n, mesh)
        dev = max(
            rel_err(getattr(model, k), getattr(ref, k))
            for k in ("means", "shs", "scales", "opacities", "rotations")
        )
        print(
            f"multi [{card}]: {mesh} on {n} devices: losses {losses}, {dt:.1f} s "
            f"(compile included), schedule {sched}; truths and means live on "
            f"devices {holders}; bytes in use per device {in_use}; splats "
            f"{int(model.count)} vs {int(ref.count)}; max rel param deviation "
            f"vs 1 device {dev:.3e}",
            flush=True,
        )
        if len(holders) != n or min(in_use) < 0.1 * max(in_use, default=0):
            fail(f"{mesh}: work is not spread over the {n} devices")
        if int(model.count) != int(ref.count) or dev > 1e-3 or not np.allclose(
            losses, l_ref, rtol=1e-4
        ):
            fail(f"{mesh} loop does not match the single-device loop")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="1: device, kernel and main-path phases; N > 1: "
                         "only the N-device dp/fsdp loops vs one device")
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        fail(f"no GPU: JAX platform is {devices[0].platform!r}")
    import gaussian_splatterer_tpu  # noqa: F401  (fails outside the repo)
    from gaussian_splatterer_tpu.config import RuntimeConfig

    card = card_info()
    print(f"device: {card} | jax {jax.__version__}, platform "
          f"{devices[0].platform}, kind {devices[0].device_kind}, "
          f"count {len(devices)}", flush=True)
    if args.devices > 1:
        if len(devices) < args.devices:
            fail(f"--devices {args.devices} but {len(devices)} GPUs")
        multi_phase(args.devices, card)
    else:
        rtc = RuntimeConfig()
        kernel_phase(card, rtc.tile_px, rtc.train_chunk)
        print(f"kernels: {gpu_tests(devices[0])} GPU tests passed", flush=True)
        memory_report()
        main_phase(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices),
    }}))


if __name__ == "__main__":
    main()
