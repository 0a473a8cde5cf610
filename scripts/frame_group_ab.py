"""Time the product train step at several RuntimeConfig.frame_group values.

    python scripts/frame_group_ab.py                  # frame_group 8, 16, 32
    python scripts/frame_group_ab.py --groups 8 32 --reps 10

Product defaults (RuntimeConfig(): 1024^2, capacity 1M, max_dup 2^21, tile
16; a 16-camera rig = 32 frames per step) with the benchmark's 50k-splat
random cloud seen by 16 bench cameras.  For each group size it prints the
compiled step's temporary memory (memory_analysis) and its time per step.
frame_group = 32 is one launch pair over all frames.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gaussian_splatterer_tpu.config import Project, RuntimeConfig  # noqa: E402
from gaussian_splatterer_tpu.models.splats import SplatModel  # noqa: E402
from gaussian_splatterer_tpu.rt.scenes import random_splat_scene  # noqa: E402
from gaussian_splatterer_tpu.train.trainer import (  # noqa: E402
    CameraBatch,
    LearningRates,
    Trainer,
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        cs.fail(f"no GPU: JAX platform is {jax.devices()[0].platform!r}")

    card = cs.card_info()
    project = Project.app_default()
    base = RuntimeConfig()
    w, h, tile = base.render_resolution_x, base.render_resolution_y, base.tile_px
    n_cams = project.num_cameras
    params, _, *_, cams = random_splat_scene(
        cs.BENCH["n_splats"], base.splats_capacity, w, h, n_cams, seed=0
    )
    model = SplatModel(*params, count=jnp.int32(cs.BENCH["n_splats"]),
                       sh_degree=base.sh_degree)
    batch = CameraBatch.from_cameras(cams, w, h)
    truths = jax.random.uniform(
        jax.random.key(0), (2 * n_cams, (w // tile) * (h // tile), 4, tile * tile)
    ).at[:, :, 3].set(0.0)
    lrs = LearningRates.from_project(project)
    for group in args.groups:
        runtime = RuntimeConfig(frame_group=group)
        trainer = Trainer(project, runtime, model, renderer="tiled")
        step = trainer._step.lower(model, truths, batch, lrs).compile()
        temp = step.memory_analysis().temp_size_in_bytes
        _, ms = cs.timed(step, model, truths, batch, lrs, reps=args.reps)
        out, metrics = step(model, truths, batch, lrs)
        loss = float(metrics.loss)
        if not np.isfinite(loss):
            cs.fail(f"frame_group {group}: non-finite loss")
        print(
            f"frame_group [{card}] {group} of {2 * n_cams} frames: step "
            f"{ms:.2f} ms, temporaries {temp / 2**30:.2f} GiB, loss {loss:.6f}",
            flush=True,
        )


if __name__ == "__main__":
    main()
