"""Headless app session + CLI: project lifecycle, training, export."""

import json
import os

import numpy as np
import pytest

from gaussian_splatterer_tpu.app.cli import main as cli_main
from gaussian_splatterer_tpu.app.session import Session
from gaussian_splatterer_tpu.config import Project, RuntimeConfig

OBJ = """\
v -1.5 -1.5 0
v 1.5 -1.5 0
v 1.5 1.5 0
v -1.5 1.5 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
f 1/1 2/2 3/3 4/4
"""


@pytest.fixture()
def obj_path(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text(OBJ)
    return str(p)


def tiny_session(renderer="tiled"):
    proj = Project.app_default()
    proj.sphere1.count = 2
    proj.rtSamples = 4
    runtime = RuntimeConfig(
        render_resolution_x=32, render_resolution_y=32,
        splats_capacity=256, max_dup=2**10, tile_px=16,
    )
    return Session(project=proj, runtime=runtime, renderer=renderer)


def test_session_end_to_end(obj_path, tmp_path):
    s = tiny_session()
    s.load_model_obj(obj_path)
    s.init_field("mono")
    s.capture()
    # tile-space fast path stores truths channel-major as (2F, T, 4, P)
    assert s.trainer.truths.shape[0] == 4
    assert s.trainer.truths.shape[2] == 4
    assert int(np.prod(s.trainer.truths.shape[1:])) == 32 * 32 * 4
    m0 = s.train(1)
    loss0 = float(m0.loss)
    m1 = s.train(5)
    assert np.isfinite(float(m1.loss))
    assert float(m1.loss) <= loss0 * 1.5  # training is stable

    out = tmp_path / "proj"
    s.save_project(str(out))
    assert (out / "settings.json").exists()
    assert (out / "splats.gobj").exists()

    s2 = tiny_session()
    s2.load_project(str(out))
    assert int(s2.model.count) == int(s.model.count)
    assert s2.project.pathModel == obj_path

    png = tmp_path / "render.png"
    s.export_splats_png(str(png), 32, 32)
    assert png.exists()


def test_watch_mode(obj_path, tmp_path):
    """--watch live page: index.html + latest.png + status.json rewritten
    at the watch cadence (io/watch.py; the headless live-preview analog of
    src/ui/UiPanelViewOutput.cpp:52-70)."""
    s = tiny_session()
    s.load_model_obj(obj_path)
    s.init_field("mono")
    s.capture()
    wd = tmp_path / "watch"
    s.auto_train(2, watch_dir=str(wd), watch_every=1)
    assert (wd / "index.html").exists()
    assert (wd / "latest.png").exists()
    status = json.loads((wd / "status.json").read_text())
    assert status["iteration"] == 2
    assert "splats" in status
    html = (wd / "index.html").read_text()
    assert "http-equiv=\"refresh\"" in html and "latest.png?it=2" in html


def test_init_field_model(obj_path):
    s = tiny_session()
    s.load_model_obj(obj_path)
    s.init_field("model")
    assert int(s.model.count) == 2  # quad -> two triangles


def test_cli_workflow(obj_path, tmp_path):
    proj_dir = str(tmp_path / "cliproj")
    cli_main([
        "new", proj_dir, "--obj", obj_path, "--init-field", "mono",
        "--resolution", "32", "--capacity", "256",
    ])
    assert os.path.exists(os.path.join(proj_dir, "settings.json"))

    # shrink the camera rig for speed, as a user would edit settings.json
    sfile = os.path.join(proj_dir, "settings.json")
    cfg = json.load(open(sfile))
    cfg["sphere1"]["count"] = 2
    cfg["sphere2"]["count"] = 0
    cfg["rtSamples"] = 2
    cfg["intervalCapture"] = 0
    cfg["intervalDensify"] = 0
    json.dump(cfg, open(sfile, "w"))

    cli_main([
        "train", proj_dir, "--steps", "2", "--resolution", "32",
        "--capacity", "256",
    ])
    out = json.load(open(sfile))
    assert out["iterations"] == 2

    png = str(tmp_path / "out.png")
    cli_main([
        "render", proj_dir, png, "--mode", "splats", "--size", "32x32",
        "--resolution", "32", "--capacity", "256",
    ])
    assert os.path.exists(png)

    # splat export by extension: standard 3DGS PLY round-trips the model
    ply = str(tmp_path / "out.ply")
    cli_main(["export", proj_dir, ply, "--capacity", "256"])
    from gaussian_splatterer_tpu.io.ply import load_ply

    back = load_ply(ply)
    assert back.count >= 1 and back.sh_coeffs == 4


def test_auto_train_checkpointing(obj_path, tmp_path):
    s = tiny_session()
    s.load_model_obj(obj_path)
    s.init_field("mono")
    ckdir = str(tmp_path / "ck")
    s.auto_train(3, checkpoint_dir=ckdir, checkpoint_every=1)
    assert os.path.exists(os.path.join(ckdir, "latest.npz"))

    s2 = tiny_session()
    s2.resume_from_checkpoint(ckdir)
    assert s2.project.iterations >= 2
    assert int(s2.model.count) == int(s.model.count)


def test_binning_stats(obj_path):
    s = tiny_session()
    s.load_model_obj(obj_path)
    s.init_field("mono")
    s.capture()
    stats = s.trainer.binning_stats()
    assert 0 <= stats["num_dup"] <= stats["max_dup"]
    assert not stats["overflow"]


@pytest.mark.slow  # deselected by default (pyproject addopts); run with -m slow
def test_cli_checkpoint_resume_and_snapshots(obj_path, tmp_path):
    """CLI crash-recovery surface: --checkpoint-every / --resume /
    --snapshot-every (reference live-preview stand-in)."""
    proj_dir = str(tmp_path / "ckproj")
    cli_main([
        "new", proj_dir, "--obj", obj_path, "--init-field", "mono",
        "--resolution", "32", "--capacity", "256",
    ])
    sfile = os.path.join(proj_dir, "settings.json")
    cfg = json.load(open(sfile))
    cfg["sphere1"]["count"] = 2
    cfg["sphere2"]["count"] = 0
    cfg["rtSamples"] = 2
    cfg["intervalCapture"] = 0
    cfg["intervalDensify"] = 0
    json.dump(cfg, open(sfile, "w"))

    cli_main([
        "train", proj_dir, "--steps", "3", "--resolution", "32",
        "--capacity", "256", "--checkpoint-every", "1",
        "--snapshot-every", "2",
    ])
    assert os.path.exists(os.path.join(proj_dir, "checkpoints", "latest.npz"))
    snaps = os.listdir(os.path.join(proj_dir, "snapshots"))
    assert any(f.endswith(".png") for f in snaps)

    # resume continues the iteration counter from the checkpoint
    cli_main([
        "train", proj_dir, "--steps", "2", "--resolution", "32",
        "--capacity", "256", "--resume",
    ])
    out = json.load(open(sfile))
    assert out["iterations"] == 5


def test_cli_runtime_persistence(obj_path, tmp_path):
    """RuntimeConfig persists with the project (runtime.json): `new
    --resolution 32 --capacity 512` followed by a flag-less `train` must
    keep 32^2/512 instead of silently reverting to the 1024^2/1M defaults
    (the reference keeps all settings in settings.json,
    src/Project.h:64-73)."""
    proj_dir = str(tmp_path / "rtproj")
    cli_main([
        "new", proj_dir, "--obj", obj_path, "--init-field", "mono",
        "--resolution", "32", "--capacity", "512",
    ])
    rt_file = os.path.join(proj_dir, "runtime.json")
    assert os.path.exists(rt_file)
    rt = RuntimeConfig.load(rt_file)
    assert rt.render_resolution_x == 32 and rt.splats_capacity == 512

    sfile = os.path.join(proj_dir, "settings.json")
    cfg = json.load(open(sfile))
    cfg["sphere1"]["count"] = 2
    cfg["sphere2"]["count"] = 0
    cfg["rtSamples"] = 2
    cfg["intervalCapture"] = 0
    cfg["intervalDensify"] = 0
    json.dump(cfg, open(sfile, "w"))

    # no --resolution/--capacity flags: the persisted runtime must be used
    cli_main(["train", proj_dir, "--steps", "2"])
    assert json.load(open(sfile))["iterations"] == 2
    rt2 = RuntimeConfig.load(rt_file)
    assert rt2.render_resolution_x == 32 and rt2.splats_capacity == 512

    # an explicit flag overrides the persisted value and re-persists
    cli_main(["train", proj_dir, "--steps", "1", "--capacity", "1024"])
    rt3 = RuntimeConfig.load(rt_file)
    assert rt3.splats_capacity == 1024
    assert rt3.render_resolution_x == 32  # untouched fields persist


@pytest.mark.slow  # deselected by default (pyproject addopts); run with -m slow
def test_snapshot_series_orbits_preview(obj_path, tmp_path):
    """The snapshot series advances the free-orbit preview clock like the
    reference's per-tick update (src/ui/UiFrame.cpp:272), so successive
    snapshots orbit the model instead of repeating one static view."""
    s = tiny_session()
    s.load_model_obj(obj_path)
    s.init_field("mono")
    assert s.project.previewFreeOrbit
    t0 = s.project.previewTimer
    s.auto_train(3, snapshot_dir=str(tmp_path / "snaps"), snapshot_every=1)
    assert s.project.previewTimer > t0


def test_cli_doctor(capsys):
    """gsplat-tpu doctor: numerics gate + micro step benchmark on the
    attached backend."""
    import json as _json

    from gaussian_splatterer_tpu.app.cli import main

    rc = main(["doctor"])
    out = _json.loads(capsys.readouterr().out)
    assert rc == 0
    assert out["numerics_gate"] == "ok"
    assert out["micro_step_per_s"] > 0


@pytest.mark.slow  # deselected by default (pyproject addopts); run with -m slow
def test_eval_model_script(tmp_path, capsys, monkeypatch):
    """scripts/eval_model.py re-scores a saved final.npz checkpoint against
    freshly captured truths (run in-process, so it shares the suite's
    CPU backend and interpret-mode kernels)."""
    import importlib.util
    import sys as _sys

    from gaussian_splatterer_tpu.io.checkpoint import save_checkpoint
    from gaussian_splatterer_tpu.models.splats import SplatModelHost

    h = SplatModelHost(16, 1, 4)
    h.push_back([0, 0, 0], np.zeros((4, 3), np.float32), [0.3] * 3, 0.8,
                [1, 0, 0, 0])
    p = Project.app_default()
    p.sphere1.count = 4
    save_checkpoint(os.path.join(tmp_path, "final.npz"), h.to_device(), p)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "eval_model", os.path.join(root, "scripts", "eval_model.py")
    )
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setattr(_sys, "argv", [
        "eval_model.py", str(tmp_path), "--samples", "2", "--views", "2",
        "--res", "32", "--scene", "cross",
    ])
    spec.loader.exec_module(mod)  # runs main() via __main__ guard? no —
    mod.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["splats"] == 1
    assert np.isfinite(out["psnr_mean"])
