"""Sweep the compositing kernels' tile, chunk and warp count on one GPU.

    python scripts/kernel_sweep.py                          # tile 16, chunks 8 16 32
    python scripts/kernel_sweep.py --tiles 16 32 --chunks 16 32 --warps 4 8

At the benchmark scene (50k splats, 1024^2, 8 frames; chip_smoke.BENCH) it
times, per (tile, chunk, warps): the forward kernel, the backward kernel,
the train composite (forward kernel, XLA residual, backward kernel) and the
whole fwd+bwd rasterize step (projection, binning, kernels, per-splat
reduction).  ``--warps`` overrides the kernels' warp rule
(raster_tiled._num_warps); without it the rule's own choice is timed.  This
is the sweep that chose RuntimeConfig.tile_px / train_chunk (PERF.md).
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gaussian_splatterer_tpu.ops import raster_tiled as rt  # noqa: E402
from gaussian_splatterer_tpu.rt.scenes import random_splat_scene  # noqa: E402


def bench_inputs(params, active, cams, res, tile):
    """(feat9, tile_start, tile_end, max_dup) of the bench scene at ``tile``."""

    def prep(max_dup):
        @jax.jit
        def f(params):
            rows, comps = cs.project_rows(params, active, *cams, res, res)
            bins, feat9, ts, te = rt.bin_frames(
                rows, jax.lax.stop_gradient(comps), res, res, tile, max_dup
            )
            return feat9, ts, te, jnp.max(bins.num_dup)

        return f(params)

    max_dup = -(-int(int(prep(2**20)[3]) * 1.1) // 256) * 256
    return (*prep(max_dup)[:3], max_dup)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", type=int, nargs="+", default=[16])
    ap.add_argument("--chunks", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--warps", type=int, nargs="*", default=[],
                    help="warp counts to force (default: the kernels' rule)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        cs.fail(f"no GPU: JAX platform is {jax.devices()[0].platform!r}")

    card = cs.card_info()
    res, frames = cs.BENCH["res"], cs.BENCH["frames"]
    params, active, *cams, _ = random_splat_scene(
        cs.BENCH["n_splats"], cs.BENCH["capacity"], res, res, frames, seed=0
    )
    rule = rt._num_warps
    for tile in args.tiles:
        feat9, ts, te, max_dup = bench_inputs(params, active, cams, res, tile)
        tiles, p_count = frames * (res // tile) ** 2, tile * tile
        rng = np.random.default_rng(1)
        truth = jnp.asarray(
            rng.uniform(0, 1, (tiles, 4, p_count)).astype(np.float32)
        ).at[:, 3].set(0.0)
        bg4 = jnp.asarray(np.concatenate(
            [rng.uniform(0, 1, (frames, 3)), np.zeros((frames, 1))], 1
        ), jnp.float32)
        kw = dict(tile=tile, tx_tiles=res // tile, tiles_frame=(res // tile) ** 2)
        for chunk in args.chunks:
            for warps in args.warps or [None]:
                rt._num_warps = rule if warps is None else (lambda p, c, w=warps: w)
                w_eff = rt._num_warps(p_count, chunk)
                try:
                    kf = jax.jit(functools.partial(rt.composite_forward, chunk=chunk, **kw))
                    out, t_f = cs.timed(kf, feat9, ts, te, reps=args.reps)
                    gin = jnp.concatenate(
                        [truth[:, :3] - out[:, :3], jnp.ones_like(out[:, 3:4])], 1
                    )
                    kb = jax.jit(functools.partial(rt.composite_backward, chunk=chunk, **kw))
                    _, t_b = cs.timed(kb, feat9, ts, te, out, gin, reps=args.reps)
                    kt = jax.jit(functools.partial(rt.composite_train, chunk=chunk, **kw))
                    _, t_t = cs.timed(kt, feat9, ts, te, truth, bg4, reps=args.reps)

                    @jax.jit
                    def step(params, chunk=chunk, tile=tile, max_dup=max_dup):
                        loss, grads, *_ = rt.render_train_grads_batch(
                            *params, active, *cams, res, res,
                            truth.reshape(frames, -1, 4, p_count), bg4[:, :3], 1,
                            tile=tile, chunk=chunk, max_dup=max_dup,
                        )
                        return loss, grads

                    _, t_s = cs.timed(step, params, reps=args.reps)
                    print(
                        f"sweep [{card}] tile {tile} chunk {chunk} warps {w_eff}: "
                        f"fwd kernel {t_f:.3f} ms, bwd kernel {t_b:.3f} ms, train "
                        f"composite {t_t:.3f} ms, full step {t_s:.3f} ms / "
                        f"{frames} frames (max_dup {max_dup})",
                        flush=True,
                    )
                except Exception as e:  # a config the compiler refuses
                    print(f"sweep tile {tile} chunk {chunk} warps {w_eff}: "
                          f"FAILED {type(e).__name__}: {str(e)[:300]}", flush=True)
    rt._num_warps = rule


if __name__ == "__main__":
    main()
