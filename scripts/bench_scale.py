"""Splat-count scaling bench: fwd+bwd ms/frame at 50k -> 1M active splats
(the reference's SPLATS_LIMIT envelope, src/Config.h:17).

Scene realism: total screen coverage is held roughly constant by shrinking
splat scales ~ sqrt(50k/N) (a converged densified model covers the object
with more, smaller splats — reference README's own recipe trains 0 -> 50k+
by splitting).  Duplicate counts then grow ~linearly with N (every visible
splat owns >= 1 tile), which is exactly the regime that stresses the
D-sized gradient reduction (sorts/cumsums over f x max_dup).

Two-phase per size: a probe run with a generous buffer reads the true
num_dup, then the timed run uses a tightly-sized buffer (the same
discipline long production runs use with pinned buffers).

Run on a GPU: python scripts/bench_scale.py [--sizes 50000,200000,...]
Prints one JSON line per size, each naming the device.
"""

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gaussian_splatterer_tpu.config import RuntimeConfig  # noqa: E402
from gaussian_splatterer_tpu.ops.raster_tiled import (  # noqa: E402
    image_to_tiles_cm,
    render_train_grads_batch,
)
from gaussian_splatterer_tpu.rt.scenes import random_splat_scene  # noqa: E402

W = H = 1024
TILE = RuntimeConfig.tile_px
CHUNK = RuntimeConfig.train_chunk
REPS = 10


def round_up(x: int) -> int:
    return -(-int(x) // 256) * 256


def run_size(n_splats: int, frames: int, verbose: bool = True):
    capacity = max(65_536, -(-n_splats // 4096) * 4096)
    params, active, views, pvs, poss, txs, tys, _ = random_splat_scene(
        n_splats, capacity, W, H, frames
    )
    # constant-coverage scaling: radius ~ sqrt(50k/N)
    shrink = np.sqrt(50_000 / n_splats)
    params = (params[0], params[1], params[2] * shrink, params[3], params[4])
    rng = np.random.default_rng(1)
    truths = jnp.asarray(rng.uniform(0, 1, (frames, H, W, 3)).astype(np.float32))
    tt = jax.vmap(lambda im: image_to_tiles_cm(im, TILE))(truths)
    bgs = jnp.zeros((frames, 3), jnp.float32)

    def make(max_dup, f):
        @jax.jit
        def fwdbwd(p, t):
            loss, grads, var, _, nd = render_train_grads_batch(
                *p, active, views[:f], pvs[:f], poss[:f], txs[:f], tys[:f],
                W, H, t, bgs[:f], 1,
                tile=TILE, max_dup=max_dup, chunk=CHUNK,
            )
            return loss, grads, nd

        return fwdbwd

    # probe with a generous buffer at F=1 to read the true count
    probe_dup = round_up(max(2**18, int(n_splats * 2.5)))
    out = make(probe_dup, 1)(params, tt[:1])
    nd = int(out[2])
    if nd > probe_dup:
        print(f"probe overflowed: {nd} > {probe_dup}", file=sys.stderr)
        probe_dup = round_up(int(nd * 1.25))
        out = make(probe_dup, 1)(params, tt[:1])
        nd = int(out[2])

    max_dup = round_up(int(nd * 1.25))
    if verbose:
        print(f"n={n_splats}: num_dup={nd} -> max_dup={max_dup}",
              file=sys.stderr, flush=True)

    fwdbwd = make(max_dup, frames)
    out = jax.block_until_ready(fwdbwd(params, tt))  # compile
    assert int(out[2]) <= max_dup
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = jax.block_until_ready(fwdbwd(params, tt))
    ms_per_frame = (time.perf_counter() - t0) * 1e3 / (REPS * frames)

    dev = jax.devices()[0]
    row = {
        "device": f"{dev.platform} {dev.device_kind} x{len(jax.devices())}",
        "n_splats": n_splats,
        "capacity": capacity,
        "ms_per_frame": ms_per_frame,
        "num_dup": nd,
        "max_dup": max_dup,
        "frames": frames,
    }
    print(json.dumps(row), flush=True)

    # densify cycle at this capacity (the other scale-sensitive op);
    # guarded so a densify failure still leaves the fwd+bwd row printed
    try:
        from gaussian_splatterer_tpu.config import Project
        from gaussian_splatterer_tpu.models.splats import SplatModel
        from gaussian_splatterer_tpu.train.densify import DensifyParams, densify

        model = SplatModel(
            means=params[0], shs=params[1], scales=params[2],
            opacities=params[3], rotations=params[4],
            count=jnp.asarray(n_splats, jnp.int32), sh_degree=1,
        )
        var = jnp.abs(out[1][0]).sum(-1)
        avg = out[1][0]
        dp = DensifyParams.from_project(Project())
        dfn = jax.jit(lambda m, v, a: densify(m, v, a, dp))
        jax.block_until_ready(dfn(model, var, avg))  # compile
        t0 = time.perf_counter()
        for _ in range(3):
            jax.block_until_ready(dfn(model, var, avg))
        row["densify_ms"] = (time.perf_counter() - t0) * 1e3 / 3
    except Exception as e:  # noqa: BLE001
        row["densify_error"] = f"{type(e).__name__}: {e}"[:160]
    return row


def main():
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"no GPU: JAX platform is {jax.devices()[0].platform!r}")
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="50000,200000,500000,1000000")
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args()
    for s in args.sizes.split(","):
        r = run_size(int(s), args.frames)
        if "densify_ms" in r or "densify_error" in r:
            print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
