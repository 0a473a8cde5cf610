"""Camera-data-parallel truth capture: shard the path tracer over devices.

The reference re-captures all truth views every ``intervalCapture=50``
iterations live (src/ui/UiFrame.cpp:283-298) because OptiX RT cores make
a capture cheap.  Here the tracer is plain XLA, and on one device its time
cannot hide behind training.  Captures are embarrassingly parallel over
cameras, so they shard over a camera mesh like training does: N devices
recapture N times faster.

``capture_images_sharded`` renders 2C frames (every camera against white
AND black backgrounds — the dual-background supervision of
src/Trainer.cu:218-250) with frames sharded over a 1-D device mesh.
Per-frame results are placement-independent: the per-frame PRNG stream
derives from the FRAME index, not the device, so any mesh size (and a
direct per-frame ``render_rtx_sums`` call with the same key) produces
bit-identical frames — asserted in tests/test_parallel.py."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gaussian_splatterer_tpu.parallel.dp import CAMERA_AXIS
from gaussian_splatterer_tpu.rt.tracer import (
    MAX_BOUNCES,
    finish_rtx,
    render_rtx_sums,
)


def capture_images_sharded(
    rtx,
    cameras: Sequence,
    samples: int,
    width: int,
    height: int,
    devices=None,
    seed: int = 0,
    bounces: int = MAX_BOUNCES,
):
    """Render every camera against white AND black backgrounds, frames
    sharded over a 1-D camera mesh.  Returns (2C, H, W, 3) float32 in
    the ``Trainer.capture_truths`` frame order (all whites, then all
    blacks).  2C must divide the device count evenly or vice versa (the
    mesh is shrunk to a divisor of 2C when devices don't divide).

    ``rtx`` is an RtxHost with a loaded model (its scene arrays and
    chunk tuning are reused; with no model the reference renders black,
    src/rtx/RtxHost.cpp:220 — handled here the same way)."""
    c = len(cameras)
    if rtx._tris is None:
        return jnp.zeros((2 * c, height, width, 3), jnp.float32)
    devices = list(devices if devices is not None else jax.devices())
    f = 2 * c
    n_dev = len(devices)
    while f % n_dev:
        n_dev -= 1  # largest divisor of the frame count
    mesh = Mesh(np.asarray(devices[:n_dev]), (CAMERA_AXIS,))

    inv_pvs = jnp.asarray(
        np.stack(
            [
                np.linalg.inv(
                    cam.get_proj_view(width / height).astype(np.float64)
                ).astype(np.float32)
                for cam in cameras
            ]
        )
    )
    locs = jnp.asarray(np.stack([np.asarray(cam.location, np.float32)
                                 for cam in cameras]))
    inv_pvs = jnp.concatenate([inv_pvs, inv_pvs], 0)
    locs = jnp.concatenate([locs, locs], 0)
    bgs = jnp.concatenate(
        [jnp.ones((c, 3), jnp.float32), jnp.zeros((c, 3), jnp.float32)], 0
    )
    # per-frame keys from the frame index: device placement can't change
    # the sample stream (serial-capture parity)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i))(
        jnp.arange(f, dtype=jnp.int32)
    )

    tris, texture, env = rtx._tris, rtx._texture, rtx._env
    rc, tc, bc, br = (
        rtx.ray_chunk, rtx.tri_chunk, rtx.bounce_chunk, rtx.bounce_round
    )
    roul = getattr(rtx, "roulette_from", 0)

    def frame_fn(loc, inv_pv, bg, key):
        color_sum, _ = render_rtx_sums(
            tris, texture, loc, inv_pv, width=width, height=height,
            samples=samples, background=bg, key=key, splat_cameras=None,
            bounces=bounces, ray_chunk=rc, tri_chunk=tc, env=env,
            bounce_chunk=bc, bounce_round=br, roulette_from=roul,
        )
        return color_sum  # (n_pix, 3)

    def local_frames(locs, inv_pvs, bgs, keys):
        return jax.lax.map(
            lambda args: frame_fn(*args), (locs, inv_pvs, bgs, keys)
        )

    shard_fn = jax.jit(
        jax.shard_map(
            local_frames,
            mesh=mesh,
            in_specs=(P(CAMERA_AXIS),) * 4,
            out_specs=P(CAMERA_AXIS),
            check_vma=False,
        )
    )

    sums = shard_fn(
        jax.device_put(locs, NamedSharding(mesh, P(CAMERA_AXIS))),
        jax.device_put(inv_pvs, NamedSharding(mesh, P(CAMERA_AXIS))),
        jax.device_put(bgs, NamedSharding(mesh, P(CAMERA_AXIS))),
        jax.device_put(keys, NamedSharding(mesh, P(CAMERA_AXIS))),
    )  # (2C, n_pix, 3)
    imgs = jax.vmap(
        lambda s: finish_rtx(s, jnp.zeros((s.shape[0],), bool), samples,
                             width, height)
    )(sums)
    return imgs
