"""Worker process for the 2-process multi-host simulation test.

Each process owns 4 virtual CPU devices and joins a jax.distributed
coordinator (our NCCL/MPI equivalent — SURVEY §2.4: the reference has no
distributed backend at all); the camera-DP train step then runs over the
8-device GLOBAL mesh spanning both processes, with truth frames sharded
across process boundaries.  Run as:

    python tests/multihost_runner.py PORT PROCESS_ID NUM_PROCESSES OUT_DIR

Writes OUT_DIR/out_{PROCESS_ID}.json with the step's loss and a model
checksum for the parent test to compare against the single-controller step.
"""

import json
import os
import sys

# Spawned as `python tests/multihost_runner.py ...`, which puts tests/ (not
# the repo root) on sys.path — make the package importable without requiring
# a pip install.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LOCAL_DEVICES = 4
RES = 64
TILE = 16
N_CAMS = 4  # 8 frames over 8 global devices


def build_scene_np(seed=0, sh_degree=1):
    """Deterministic numpy scene — identical on every process."""
    import numpy as np

    from gaussian_splatterer_tpu.config import Project
    from gaussian_splatterer_tpu.models.camera import Camera

    sh_coeffs = (sh_degree + 1) ** 2
    rng = np.random.default_rng(seed)
    n, cap = 24, 64
    means = np.zeros((cap, 3), np.float32)
    means[:n] = rng.uniform(-1.5, 1.5, (n, 3))
    shs = np.zeros((cap, sh_coeffs, 3), np.float32)
    shs[:n] = rng.normal(0, 0.3, (n, sh_coeffs, 3))
    scales = np.zeros((cap, 3), np.float32)
    scales[:n] = rng.uniform(0.1, 0.4, (n, 3))
    opac = np.zeros((cap,), np.float32)
    opac[:n] = rng.uniform(0.3, 1.0, n)
    rot = np.zeros((cap, 4), np.float32)
    rot[:, 0] = 1.0
    proj = Project()
    proj.sphere1.count = N_CAMS
    proj.sphere2.count = 0
    cameras = Camera.get_cameras(proj)
    views = np.stack([c.get_view() for c in cameras]).astype(np.float32)
    pvs = np.stack([c.get_proj_view(1.0) for c in cameras]).astype(np.float32)
    poss = np.stack([c.location for c in cameras]).astype(np.float32)
    tans = np.array([c.tan_fov(RES, RES, train=True) for c in cameras], np.float32)
    truths = rng.uniform(0, 1, (2 * N_CAMS, RES, RES, 3)).astype(np.float32)
    return (
        dict(means=means, shs=shs, scales=scales, opacities=opac,
             rotations=rot, count=np.int32(n)),
        dict(view=views, proj_view=pvs, cam_pos=poss,
             tan_fovx=tans[:, 0], tan_fovy=tans[:, 1]),
        truths,
    )


def tile_truths_np(truths):
    """Channel-major (f, T, 4, P) truth tiles (image_to_tiles_cm in numpy
    — this runner avoids jax before distributed init)."""
    import numpy as np

    f, h, w, c = truths.shape
    ty, tx = h // TILE, w // TILE
    pm = (
        truths.reshape(f, ty, TILE, tx, TILE, c)
        .transpose(0, 1, 3, 5, 2, 4)
        .reshape(f, ty * tx, c, TILE * TILE)
    )
    out = np.zeros((f, ty * tx, 4, TILE * TILE), pm.dtype)
    out[:, :, :c] = pm
    return out


def main():
    port, pid, nproc, outdir = sys.argv[1:5]
    pid, nproc = int(pid), int(nproc)
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gaussian_splatterer_tpu.config import Project, RuntimeConfig
    from gaussian_splatterer_tpu.models.splats import SplatModel
    from gaussian_splatterer_tpu.ops import raster_tiled
    from gaussian_splatterer_tpu.parallel import init_distributed
    from gaussian_splatterer_tpu.parallel.dp import (
        CAMERA_AXIS,
        make_camera_mesh,
        make_dp_train_step,
    )
    from gaussian_splatterer_tpu.train.trainer import CameraBatch, LearningRates

    raster_tiled.set_interpret(True)  # CPU processes: interpreted kernels
    n_global = init_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert n_global == LOCAL_DEVICES * nproc, (n_global, LOCAL_DEVICES * nproc)
    assert jax.process_count() == nproc

    model_np, cams_np, truths = build_scene_np()
    truth_tiles = tile_truths_np(truths)

    mesh = make_camera_mesh(jax.devices())  # GLOBAL mesh over both processes

    model = SplatModel(
        means=as_global2(mesh, model_np["means"], P()),
        shs=as_global2(mesh, model_np["shs"], P()),
        scales=as_global2(mesh, model_np["scales"], P()),
        opacities=as_global2(mesh, model_np["opacities"], P()),
        rotations=as_global2(mesh, model_np["rotations"], P()),
        count=as_global2(mesh, model_np["count"], P()),
        sh_degree=1,
    )
    cams = CameraBatch(**{k: as_global2(mesh, v, P()) for k, v in cams_np.items()})
    truths_g = as_global2(mesh, truth_tiles, P(CAMERA_AXIS))
    lrs = LearningRates(
        location=np.float32(5e-5), sh=np.float32(1e-4), scale=np.float32(2e-5),
        opacity=np.float32(1e-4), rotation=np.float32(2.5e-5),
        scale_max=np.float32(0.3),
    )

    runtime = RuntimeConfig()
    runtime.tile_px = TILE
    runtime.max_dup = 2**12
    step = make_dp_train_step(mesh, RES, RES, 1, runtime=runtime)
    new_model, metrics = step(model, truths_g, cams, lrs)
    jax.block_until_ready((new_model, metrics))

    loss = float(metrics.loss)  # fully replicated -> addressable everywhere
    means_sum = float(jnp_sum_replicated(new_model.means))

    # --- same scene through the full 3-axis ('camera','tile','splat') mesh
    # spanning both processes: camera x tile x splat = 2 x 2 x 2, so every
    # collective class (frame psum, band psum, splat all-gather /
    # reduce-scatter) crosses the process boundary somewhere.
    from gaussian_splatterer_tpu.parallel.mesh3 import (
        make_3d_mesh,
        make_3d_train_step,
    )
    from gaussian_splatterer_tpu.parallel.fsdp import SPLAT_AXIS
    from gaussian_splatterer_tpu.parallel.tp import TILE_AXIS

    mesh3 = make_3d_mesh(2, 2, 2, jax.devices())
    model3 = SplatModel(
        means=as_global2(mesh3, model_np["means"], P(SPLAT_AXIS)),
        shs=as_global2(mesh3, model_np["shs"], P(SPLAT_AXIS)),
        scales=as_global2(mesh3, model_np["scales"], P(SPLAT_AXIS)),
        opacities=as_global2(mesh3, model_np["opacities"], P(SPLAT_AXIS)),
        rotations=as_global2(mesh3, model_np["rotations"], P(SPLAT_AXIS)),
        count=as_global2(mesh3, model_np["count"], P()),
        sh_degree=1,
    )
    cams3 = CameraBatch(
        **{k: as_global2(mesh3, v, P()) for k, v in cams_np.items()}
    )
    truths3 = as_global2(
        mesh3, truth_tiles, P((CAMERA_AXIS, SPLAT_AXIS), TILE_AXIS)
    )
    step3 = make_3d_train_step(mesh3, RES, RES, 1, runtime=runtime)
    new3, metrics3 = step3(model3, truths3, cams3, lrs)
    jax.block_until_ready((new3, metrics3))
    loss3 = float(metrics3.loss)
    means3_repl = jax.jit(
        lambda x: x, out_shardings=NamedSharding(mesh3, P())
    )(new3.means)
    means_sum3 = float(jnp_sum_replicated(means3_repl))

    # --- sharded checkpoint across the process boundary: every process
    # saves its own shards (collective), then restores into the same
    # sharding and must see the identical global model
    from gaussian_splatterer_tpu.io.checkpoint import (
        load_checkpoint_sharded,
        save_checkpoint_sharded,
    )

    ckpt_dir = os.path.join(outdir, "sharded_ckpt")
    save_checkpoint_sharded(ckpt_dir, new3)
    back, _ = load_checkpoint_sharded(ckpt_dir, like=new3)
    back_repl = jax.jit(
        lambda x: x, out_shardings=NamedSharding(mesh3, P())
    )(back.means)
    ckpt_means_sum = float(jnp_sum_replicated(back_repl))

    out = {
        "process": pid,
        "global_devices": n_global,
        "loss": loss,
        "means_sum": means_sum,
        "loss_mesh3": loss3,
        "means_sum_mesh3": means_sum3,
        "ckpt_means_sum": ckpt_means_sum,
    }
    with open(os.path.join(outdir, f"out_{pid}.json"), "w") as fh:
        json.dump(out, fh)
    print(f"process {pid}: loss={loss:.6f} over {n_global} devices", flush=True)


def jnp_sum_replicated(x):
    """Sum a fully-replicated global array via its addressable shard."""
    import numpy as np

    return np.asarray(x.addressable_data(0)).sum()


def as_global2(mesh, arr, spec):
    """Global array over ``mesh`` from an identical-everywhere numpy value."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding

    arr = np.asarray(arr)
    return jax.make_array_from_callback(
        arr.shape, NamedSharding(mesh, spec), lambda idx: arr[idx]
    )


if __name__ == "__main__":
    main()
