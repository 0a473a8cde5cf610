"""Multi-device training as a PRODUCT path.

The parallel step builders are exactness-tested elsewhere
(tests/test_parallel*.py); these tests exercise the wiring ABOVE step
level: a Trainer constructed with train_devices > 1 must run the full
capture -> train -> densify -> recapture -> train loop and land on the
SAME model as the single-device Trainer — including densify under
splat-sharded parameters (parallel/densify.py gather->densify->reshard)
and the CLI flag that turns it on.

Reference anchors: the loop is src/ui/UiFrame.cpp:266-298; the exactness
of frame-order-independent gradient means is src/Trainer.cu:416-419.
"""

import random

import jax
import numpy as np
import pytest

from gaussian_splatterer_tpu.config import Project, RuntimeConfig
from gaussian_splatterer_tpu.models.splats import SplatModelHost
from gaussian_splatterer_tpu.train.schedule import auto_train
from gaussian_splatterer_tpu.train.trainer import Trainer

RES, TILE, CAP, CAMS = 32, 16, 128, 4  # 2F=8 divides the 8-device mesh


class StubRtx:
    """Deterministic 'photograph': a smooth function of camera location
    and background — no _tris attribute, so Trainer.capture_truths takes
    the serial path and both trainers see IDENTICAL truths."""

    def render(self, camera, background, samples, width, height):
        yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
        loc = np.asarray(camera.location, np.float32)
        img = np.stack(
            [
                0.5 + 0.4 * np.sin(xx / 7.0 + loc[0]),
                0.5 + 0.4 * np.cos(yy / 9.0 + loc[1]),
                np.full_like(xx, 0.3) + 0.05 * loc[2] % 0.4,
            ],
            -1,
        )
        bg = np.asarray(background, np.float32)
        mask = ((xx // 8) + (yy // 8)) % 2 == 0
        return np.where(mask[..., None], img, bg).astype(np.float32)


def make_trainer(n_devices=0, mesh="dp"):
    proj = Project()
    proj.sphere1.count = CAMS
    proj.sphere2.count = 0
    proj.rtSamples = 1
    proj.intervalCapture = 3
    proj.intervalDensify = 2
    proj.paramDensifyVariance = 1e-6  # trigger splits/clones at toy scale
    runtime = RuntimeConfig(
        render_resolution_x=RES, render_resolution_y=RES,
        splats_capacity=CAP, max_dup=2**10, tile_px=TILE,
        train_devices=n_devices, train_mesh=mesh,
    )
    rng = np.random.default_rng(7)
    host = SplatModelHost(CAP)
    for _ in range(24):
        host.push_back(
            rng.uniform(-1.2, 1.2, 3), rng.normal(0, 0.3, (4, 3)),
            rng.uniform(0.05, 0.3, 3), rng.uniform(0.3, 1.0), [1, 0, 0, 0],
        )
    return Trainer(proj, runtime, host.to_device(), renderer="tiled")


def run_loop(trainer, steps=6):
    """The reference auto-train loop: recapture every 3, densify every 2."""
    stats = auto_train(
        trainer, StubRtx(), steps, rng=random.Random(0), capture_first=True
    )
    return stats


def assert_models_match(a, b, atol=2e-5):
    assert int(a.count) == int(b.count)
    for name in ("means", "shs", "scales", "opacities", "rotations"):
        va, vb = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        np.testing.assert_allclose(va, vb, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def single_device_loop():
    t = make_trainer(0)
    run_loop(t)
    return t


def test_dp_product_loop_matches_single_device(single_device_loop):
    t_dp = make_trainer(8, "dp")
    assert t_dp.devices is not None and len(t_dp.devices) == 8
    run_loop(t_dp)
    assert t_dp.project.iterations == single_device_loop.project.iterations
    assert_models_match(t_dp.model, single_device_loop.model)
    # densify actually fired (iterations 2 and 4) and grew the model
    assert int(t_dp.model.count) > 24


def test_fsdp_product_loop_matches_single_device(single_device_loop):
    """Splat-sharded parameters + gathered densify (parallel/densify.py)."""
    t_f = make_trainer(8, "fsdp")
    assert t_f._model_sharded
    run_loop(t_f)
    assert_models_match(t_f.model, single_device_loop.model)
    # rest-state sharding survives the loop: capacity axis is split 8 ways
    shard_shapes = {
        s.data.shape for s in t_f.model.means.addressable_shards
    }
    assert shard_shapes == {(CAP // 8, 3)}


def test_devices_shrink_to_frame_divisor():
    """5 devices can't split 8 frames evenly -> shrink to 4 with a warning."""
    proj = Project()
    proj.sphere1.count = CAMS
    proj.sphere2.count = 0
    runtime = RuntimeConfig(
        render_resolution_x=RES, render_resolution_y=RES,
        splats_capacity=CAP, max_dup=2**10, tile_px=TILE,
    )
    host = SplatModelHost(CAP)
    host.push_back([0, 0, 0], np.zeros((4, 3)), [0.1] * 3, 0.5, [1, 0, 0, 0])
    with pytest.warns(UserWarning, match="not divisible"):
        t = Trainer(
            proj, runtime, host.to_device(), renderer="tiled",
            devices=jax.devices()[:5],
        )
    assert len(t.devices) == 4


def test_cli_devices_flag(tmp_path):
    """gsplat-tpu train --devices N end-to-end on the virtual mesh."""
    from gaussian_splatterer_tpu.app.cli import main as cli_main

    obj = tmp_path / "quad.obj"
    obj.write_text(
        "v -1.5 -1.5 0\nv 1.5 -1.5 0\nv 1.5 1.5 0\nv -1.5 1.5 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nf 1/1 2/2 3/3 4/4\n"
    )
    proj_dir = tmp_path / "proj"
    common = ["--resolution", "32", "--capacity", "256",
              "--max-dup", "1024", "--runtime", "tile_px=16"]
    assert cli_main(["new", str(proj_dir), "--obj", str(obj),
                     "--init-field", "mono", *common]) == 0
    # shrink the rig for test speed: 4 cameras -> 8 frames on 8 devices
    import json

    settings = json.loads((proj_dir / "settings.json").read_text())
    settings["sphere1"]["count"] = 4
    settings["sphere2"]["count"] = 0
    settings["rtSamples"] = 2
    settings["intervalCapture"] = 0
    settings["intervalDensify"] = 0
    (proj_dir / "settings.json").write_text(json.dumps(settings))
    assert cli_main([
        "train", str(proj_dir), "--steps", "2", "--devices", "8",
        "--log-every", "1", *common,
    ]) == 0
    rt = json.loads((proj_dir / "runtime.json").read_text())
    assert rt["train_devices"] == 8
    assert rt["capture_data_parallel"] is True
