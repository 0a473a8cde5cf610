"""Headline benchmark: fwd+bwd rasterize ms/frame @ 50k splats, 1024x1024.

Prints ONE JSON line.  The reference publishes no numbers (BASELINE.md), so
``vs_baseline`` is measured against the reference's only quantitative
anchor: the 100 steps/s auto-train budget (src/Config.h:10) at its default
16-camera rig = 32 rasterize fwd+bwd frames per step, i.e. a frame budget
of 1000/(100*32) = 0.3125 ms/frame.  vs_baseline = budget / measured
(>1 means faster than the reference's aspirational ceiling).

The measured path is the production training fast path: the frame-BATCHED
train core (binning, forward kernel, signed residual, backward kernel,
duplicate-gradient reduction; ops/raster_tiled.render_train_grads_batch) —
the same code driving Trainer/auto-train.  Before timing, two gates hold the kernels to the
per-pixel oracle on the GPU (reference at "highest" matmul precision): the
forward image and the parameter gradients.  Without a GPU it exits
non-zero.
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_splatterer_tpu.config import RuntimeConfig
from gaussian_splatterer_tpu.ops.raster_tiled import (
    image_to_tiles_cm,
    render_train_grads_batch,
)
from gaussian_splatterer_tpu.rt.scenes import random_splat_scene

W = H = 1024
N_SPLATS = 50_000
CAPACITY = 65_536
TILE = RuntimeConfig.tile_px
CHUNK = RuntimeConfig.train_chunk
MAX_DUP = 2**19  # ~358k duplicates per frame at this scene with tile 16
FRAMES = 8  # frames per kernel launch (the trainer's default frame_group)
REPS = 30
REFERENCE_FRAME_BUDGET_MS = 1000.0 / (100.0 * 32.0)

# Gate tolerances (PERF.md): forward max |tiled - oracle|, and the max
# per-parameter gradient deviation relative to that parameter's largest
# oracle gradient.
NUMERICS_ATOL = 1e-2
GATE_RES = 128
GATE_SPLATS = 150
GRAD_GATE_RTOL = 2e-2


def numerics_gate():
    """Tiled-vs-oracle forward parity on the GPU."""
    from gaussian_splatterer_tpu.ops.raster_reference import render_oracle
    from gaussian_splatterer_tpu.ops.raster_tiled import render_tiled

    params, active, views, pvs, poss, txs, tys, _ = random_splat_scene(
        GATE_SPLATS, 256, GATE_RES, GATE_RES, 1, seed=7
    )
    bg = jnp.asarray([0.2, 0.3, 0.4], jnp.float32)
    args = (*params, active, views[0], pvs[0], poss[0], txs[0], tys[0],
            GATE_RES, GATE_RES, bg, 1, 1.0)
    img_t = np.asarray(
        jax.jit(lambda: render_tiled(*args, tile=TILE, max_dup=2**13))()
    )
    with jax.default_matmul_precision("highest"):
        img_o = np.asarray(render_oracle(*args, row_chunk=16, tile_cull=TILE))
    err = float(np.max(np.abs(img_t - img_o)))
    if not np.isfinite(img_t).all() or err > NUMERICS_ATOL:
        raise SystemExit(
            f"numerics gate FAILED: max|tiled-oracle| = {err:.2e} "
            f"(allowed {NUMERICS_ATOL}) or non-finite output"
        )
    return err


def grad_gate():
    """Tiled-vs-oracle GRADIENT parity on the GPU: the production train
    path against jax.grad of the oracle's negative half squared error — the
    same quantity render_train_grads_batch defines its grads as (J^T
    residual, the reference convention src/Trainer.cu:33-44)."""
    from gaussian_splatterer_tpu.ops.raster_reference import render_oracle

    params, active, views, pvs, poss, txs, tys, _ = random_splat_scene(
        GATE_SPLATS, 256, GATE_RES, GATE_RES, 2, seed=11
    )
    rng = np.random.default_rng(3)
    truths = jnp.asarray(
        rng.uniform(0, 1, (2, GATE_RES, GATE_RES, 3)).astype(np.float32)
    )
    tt = jax.vmap(lambda im: image_to_tiles_cm(im, TILE))(truths)
    bgs = jnp.zeros((2, 3), jnp.float32)
    _, g_t, *_ = jax.jit(
        lambda p, t: render_train_grads_batch(
            *p, active, views, pvs, poss, txs, tys,
            GATE_RES, GATE_RES, t, bgs, 1, tile=TILE, max_dup=2**13,
        )
    )(params, tt)

    def neg_half_sq(p):
        total = jnp.float32(0.0)
        for i in range(2):
            img = render_oracle(
                *p, active, views[i], pvs[i], poss[i], txs[i], tys[i],
                GATE_RES, GATE_RES, bgs[i], 1, 1.0,
                row_chunk=16, tile_cull=TILE,
            )
            total = total - 0.5 * jnp.sum(jnp.square(img - truths[i]))
        return total

    with jax.default_matmul_precision("highest"):
        g_o = jax.grad(neg_half_sq)(params)

    worst = 0.0
    for name, a, b in zip(
        ["means", "shs", "scales", "opacities", "rotations"], g_t, g_o
    ):
        a, b = np.asarray(a), np.asarray(b)
        dev = float(np.max(np.abs(a - b))) / max(1e-3, float(np.max(np.abs(b))))
        if not np.isfinite(a).all() or dev > GRAD_GATE_RTOL:
            raise SystemExit(
                f"grad gate FAILED: {name} gradient deviation {dev:.2e} "
                f"(allowed {GRAD_GATE_RTOL}) or non-finite"
            )
        worst = max(worst, dev)
    return worst


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX platform is {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    gate_err = numerics_gate()
    grad_err = grad_gate()

    params, active, views, pvs, poss, txs, tys, _ = random_splat_scene(
        N_SPLATS, CAPACITY, W, H, FRAMES
    )
    rng = np.random.default_rng(1)
    truths = jnp.asarray(rng.uniform(0, 1, (FRAMES, H, W, 3)).astype(np.float32))
    truth_tiles = jax.vmap(lambda im: image_to_tiles_cm(im, TILE))(truths)
    bgs = jnp.zeros((FRAMES, 3), jnp.float32)

    @jax.jit
    def fwdbwd(p, tt):
        loss, grads, _, _, nd = render_train_grads_batch(
            *p, active, views, pvs, poss, txs, tys, W, H, tt, bgs, 1,
            tile=TILE, max_dup=MAX_DUP, chunk=CHUNK,
        )
        return loss, grads, nd

    out = jax.block_until_ready(fwdbwd(params, truth_tiles))  # compile
    assert int(out[2]) <= MAX_DUP, "bench scene overflows the binning buffer"
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = jax.block_until_ready(fwdbwd(params, truth_tiles))
    ms_per_frame = (time.perf_counter() - t0) * 1e3 / (REPS * FRAMES)

    print(
        json.dumps(
            {
                "metric": "fwd+bwd rasterize ms/frame (50k splats, 1024x1024)",
                "value": ms_per_frame,
                "unit": "ms/frame",
                "vs_baseline": REFERENCE_FRAME_BUDGET_MS / ms_per_frame,
                "numerics_gate_max_err": gate_err,
                "grad_gate_max_err": grad_err,
                "device": {
                    "platform": dev.platform, "kind": dev.device_kind,
                    "count": len(jax.devices()), "card": card,
                },
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
