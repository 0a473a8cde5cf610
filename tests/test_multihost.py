"""Multi-host execution, SIMULATED: two coordinator-connected processes
(4 virtual CPU devices each) run the camera-DP fused train step over one
8-device global mesh, with the truth-frame axis sharded ACROSS the process
boundary — exercising jax.distributed.initialize + cross-process
collectives for real (SURVEY §2.4; BASELINE config 5's software half — real
scaling numbers remain hardware-blocked)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "multihost_runner.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_dp_matches_single_controller(tmp_path):
    port = _free_port()
    env = os.environ.copy()
    # the runner forces its own CPU/device-count config; drop this test
    # process's virtual-device flags so they don't conflict
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, RUNNER, str(port), str(i), "2", str(tmp_path)],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=420)[0].decode() for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"process {i} failed:\n{outs[i]}"

    results = []
    for i in range(2):
        with open(tmp_path / f"out_{i}.json") as fh:
            results.append(json.load(fh))
    assert results[0]["global_devices"] == 8
    # both controllers observe the identical replicated result
    assert results[0]["loss"] == pytest.approx(results[1]["loss"], rel=1e-6)
    assert results[0]["means_sum"] == pytest.approx(
        results[1]["means_sum"], rel=1e-6
    )

    # reference: same scene, single-controller fused step on this process's
    # 8 virtual devices (conftest)
    import jax
    import jax.numpy as jnp

    from gaussian_splatterer_tpu.config import RuntimeConfig
    from gaussian_splatterer_tpu.models.splats import SplatModel
    from gaussian_splatterer_tpu.train.trainer import (
        CameraBatch,
        LearningRates,
        make_train_step,
    )
    from tests.multihost_runner import (
        RES,
        TILE,
        build_scene_np,
        tile_truths_np,
    )

    model_np, cams_np, truths = build_scene_np()
    model = SplatModel(
        means=jnp.asarray(model_np["means"]),
        shs=jnp.asarray(model_np["shs"]),
        scales=jnp.asarray(model_np["scales"]),
        opacities=jnp.asarray(model_np["opacities"]),
        rotations=jnp.asarray(model_np["rotations"]),
        count=jnp.asarray(model_np["count"]),
        sh_degree=1,
    )
    cams = CameraBatch(**{k: jnp.asarray(v) for k, v in cams_np.items()})
    truth_tiles = jnp.asarray(tile_truths_np(truths))
    lrs = LearningRates(
        location=jnp.float32(5e-5), sh=jnp.float32(1e-4),
        scale=jnp.float32(2e-5), opacity=jnp.float32(1e-4),
        rotation=jnp.float32(2.5e-5), scale_max=jnp.float32(0.3),
    )
    step = make_train_step(
        RES, RES, 1, renderer="tiled", fused=True,
        fused_opts=dict(tile=TILE, max_dup=2**12,
                        chunk=RuntimeConfig().train_chunk),
    )
    new_model, metrics = step(model, truth_tiles, cams, lrs)
    ref_loss = float(metrics.loss)
    ref_means_sum = float(np.asarray(new_model.means).sum())

    assert results[0]["loss"] == pytest.approx(ref_loss, rel=1e-5)
    assert results[0]["means_sum"] == pytest.approx(ref_means_sum, rel=1e-4)

    # the full 3-axis (camera x tile x splat) step ran over the same two
    # processes — every collective class crossed the process boundary —
    # and must produce the same training step
    for r in results:
        assert r["loss_mesh3"] == pytest.approx(ref_loss, rel=1e-5)
        assert r["means_sum_mesh3"] == pytest.approx(ref_means_sum, rel=1e-4)
        # the sharded orbax checkpoint round-tripped collectively across
        # both processes and restored the identical global model
        assert r["ckpt_means_sum"] == pytest.approx(
            r["means_sum_mesh3"], rel=1e-6
        )
