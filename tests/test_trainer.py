import numpy as np
import jax.numpy as jnp
import pytest

from gaussian_splatterer_tpu.config import Project, RuntimeConfig
from gaussian_splatterer_tpu.models.camera import Camera
from gaussian_splatterer_tpu.models.splats import SplatModelHost
from gaussian_splatterer_tpu.ops.raster_reference import render_oracle_model
from gaussian_splatterer_tpu.ops.transforms import SH_C0
from gaussian_splatterer_tpu.train import (
    CameraBatch,
    LearningRates,
    Trainer,
    auto_train,
    make_train_step,
    randomize_rig_rotations,
)

RES = 32


class OracleRtx:
    """Truth-source surrogate: photographs a *target* splat model with the
    oracle renderer (stands in for the path tracer in trainer tests)."""

    def __init__(self, target_model, res=RES):
        self.target = target_model
        self.res = res

    def render(self, camera, background, samples):
        return render_oracle_model(
            self.target, camera, self.res, self.res, jnp.asarray(background), row_chunk=16
        )


def rgb_sh(rgb):
    sh = np.zeros((4, 3), np.float32)
    sh[0] = (np.asarray(rgb) - 0.5) / SH_C0
    return sh


def target_model():
    h = SplatModelHost(16, 1, 4)
    h.push_back([0.5, 0, 0], rgb_sh([0.9, 0.2, 0.1]), [0.4] * 3, 0.9, [1, 0, 0, 0])
    h.push_back([-0.5, 0.3, 0], rgb_sh([0.1, 0.8, 0.3]), [0.35] * 3, 0.8, [1, 0, 0, 0])
    return h.to_device()


def student_model():
    h = SplatModelHost(16, 1, 4)
    h.push_back([0.3, 0.1, 0.1], rgb_sh([0.5, 0.5, 0.5]), [0.35] * 3, 0.7, [1, 0, 0, 0])
    h.push_back([-0.3, 0.2, -0.1], rgb_sh([0.5, 0.5, 0.5]), [0.4] * 3, 0.7, [1, 0, 0, 0])
    return h.to_device()


def small_project():
    p = Project.app_default()
    p.sphere1.count = 4
    p.sphere1.distance = 5.0
    # boosted LRs so a short test converges
    p.lrLocation = 1e-2
    p.lrSh = 2.5e-2
    p.lrScale = 5e-3
    p.lrOpacity = 2.5e-2
    p.lrRotation = 5e-3
    return p


def runtime():
    return RuntimeConfig(render_resolution_x=RES, render_resolution_y=RES)


def test_train_step_decreases_loss():
    p = small_project()
    trainer = Trainer(p, runtime(), student_model(), row_chunk=16)
    trainer.capture_truths(OracleRtx(target_model()))
    first = trainer.train()
    for _ in range(29):
        last = trainer.train()
    assert p.iterations == 30
    assert float(last.loss) < 0.5 * float(first.loss), (
        f"loss should drop: first={float(first.loss)}, last={float(last.loss)}"
    )


def test_train_requires_truth():
    trainer = Trainer(small_project(), runtime(), student_model(), row_chunk=16)
    with pytest.raises(RuntimeError, match="no truth data"):
        trainer.train()


def test_perfect_model_has_near_zero_loss_and_small_grads():
    p = small_project()
    t = target_model()
    trainer = Trainer(p, runtime(), t, row_chunk=16)
    trainer.capture_truths(OracleRtx(target_model()))
    m = trainer.train()
    assert float(m.loss) < 1e-10
    assert float(jnp.abs(m.avg_grad_loc).max()) < 1e-4


def test_lr_resolution_ref_scales_rates():
    """lr_resolution_ref=R0 at resolution R must equal training with all
    five LRs pre-multiplied by (R0/R)^2 and the knob off (gradients are
    pixel sums, so this makes recipes resolution-invariant — config.py)."""
    # knob ON: ref 2*RES at RES -> px_scale = 4
    p1 = small_project()
    rt1 = RuntimeConfig(render_resolution_x=RES, render_resolution_y=RES,
                        lr_resolution_ref=2 * RES)
    t1 = Trainer(p1, rt1, student_model(), row_chunk=16)
    t1.capture_truths(OracleRtx(target_model()))
    t1.train()

    # knob OFF, LRs pre-scaled by the same factor
    p2 = small_project()
    for f in ("lrLocation", "lrSh", "lrScale", "lrOpacity", "lrRotation"):
        setattr(p2, f, getattr(p2, f) * 4.0)
    t2 = Trainer(p2, runtime(), student_model(), row_chunk=16)
    t2.capture_truths(OracleRtx(target_model()))
    t2.train()

    for a, b in zip(
        (t1.model.means, t1.model.shs, t1.model.scales,
         t1.model.opacities, t1.model.rotations),
        (t2.model.means, t2.model.shs, t2.model.scales,
         t2.model.opacities, t2.model.rotations),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_sgd_clamps_scale_and_opacity():
    p = small_project()
    p.lrScale = 1e6  # force the clamp
    p.lrOpacity = 1e6
    p.paramScaleMax = 0.3
    trainer = Trainer(p, runtime(), student_model(), row_chunk=16)
    trainer.capture_truths(OracleRtx(target_model()))
    trainer.train()
    scales = np.asarray(trainer.model.scales)
    opac = np.asarray(trainer.model.opacities)
    assert scales.min() >= 0.0 and scales.max() <= 0.3 + 1e-6
    assert opac.min() >= 0.0 and opac.max() <= 1.0


def test_truth_capture_shapes_and_backgrounds():
    p = small_project()
    trainer = Trainer(p, runtime(), student_model(), row_chunk=16)
    trainer.capture_truths(OracleRtx(target_model()))
    assert trainer.truths.shape == (8, RES, RES, 3)  # 4 cameras x {white, black}
    # corners: white set ~1.0, black set ~0.0
    whites = np.asarray(trainer.truths[:4, 0, 0])
    blacks = np.asarray(trainer.truths[4:, 0, 0])
    assert whites.min() > 0.9
    assert blacks.max() < 0.1
    assert trainer.truth_cams.num_frames == 4


def test_randomize_rig_rotations():
    import random

    p = Project()
    rng = random.Random(0)
    randomize_rig_rotations(p, rng)
    vals = [p.sphere1.rotX, p.sphere1.rotY, p.sphere2.rotX, p.sphere2.rotY]
    assert all(0.0 <= v < 360.0 for v in vals)
    assert len(set(vals)) == 4


def test_auto_train_schedule_captures_and_densifies():
    p = small_project()
    p.intervalCapture = 5
    p.intervalDensify = 7
    p.paramDensifyVariance = 1e9  # keep densify a no-op structurally
    trainer = Trainer(p, runtime(), student_model(), row_chunk=16)

    captures = []
    orig_capture = trainer.capture_truths

    def counting_capture(rtx):
        captures.append(p.iterations)
        orig_capture(rtx)

    trainer.capture_truths = counting_capture
    rtx = OracleRtx(target_model())
    stats = auto_train(trainer, rtx, num_steps=12)
    # initial capture at iter 0 + re-captures at iterations 5 and 10
    assert captures == [0, 5, 10]
    assert p.iterations == 12
    # capture-vs-train wall accounting (round-4): 2 re-captures (the
    # initial one is attributed to capture_s but not recaptures)
    assert stats["recaptures"] == 2
    assert 0.0 < stats["capture_s"] < stats["total_s"]
    assert 0.0 < stats["capture_frac"] < 1.0


def test_densify_step_in_training_loop():
    p = small_project()
    p.paramDensifyVariance = -1.0  # everything volatile -> guaranteed densify
    p.paramSplitSize = 0.01
    trainer = Trainer(p, runtime(), student_model(), row_chunk=16)
    trainer.capture_truths(OracleRtx(target_model()))
    n0 = int(trainer.model.count)
    trainer.train(densify_now=True)
    assert int(trainer.model.count) == 2 * n0  # both splats split


def test_overflow_auto_recovery_grows_dup_buffer():
    """A deliberately-undersized duplicate buffer overflows; the trainer
    must report it (TrainMetrics.num_dup), auto-grow max_dup (recompile),
    and keep training (the reference cannot truncate — src/Trainer.cu:334;
    we must not silently drop splats either)."""
    res, tile = 64, 16
    runtime = RuntimeConfig()
    runtime.render_resolution_x = runtime.render_resolution_y = res
    runtime.tile_px = tile
    runtime.max_dup = 128  # one chunk: guaranteed overflow for wide splats
    runtime.splats_capacity = 16

    # fat splats covering many tiles each (16 splats x up to 16 tiles > 128;
    # sized for the tight opacity-aware AABB culling, which bins ~half the
    # duplicates the old circular 3-sigma box did)
    h = SplatModelHost(16, 1, 4)
    for i in range(16):
        h.push_back(
            [0.1 * i - 0.75, 0.05 * i - 0.4, 0.05 * i],
            rgb_sh([0.6, 0.4, 0.3]), [2.5] * 3, 0.95, [1, 0, 0, 0],
        )
    p = small_project()
    p.paramScaleMax = 3.0  # keep the fat splats fat after the SGD clamp
    trainer = Trainer(p, runtime, h.to_device(), renderer="tiled")
    trainer.capture_truths(OracleRtx(target_model(), res=res))

    m1 = trainer.train()
    assert int(m1.num_dup) > 128, "test scene must overflow the buffer"
    grew = trainer.maybe_grow_dup_buffer(m1)
    assert grew and runtime.max_dup >= int(m1.num_dup)

    # training continues on the grown buffer and no longer overflows
    m2 = trainer.train()
    assert np.isfinite(float(m2.loss))
    assert int(m2.num_dup) <= runtime.max_dup
    assert not trainer.maybe_grow_dup_buffer(m2)

    # the densify path performs the same check implicitly
    runtime.max_dup = 128
    trainer._build_step()
    trainer.train(densify_now=True)
    assert runtime.max_dup > 128


def test_opacity_reset_interval():
    """opacity_reset_interval clamps opacities down on its cadence (3DGS
    floater control, off by default for reference parity)."""
    res, tile = 64, 16
    runtime = RuntimeConfig()
    runtime.render_resolution_x = runtime.render_resolution_y = res
    runtime.tile_px = tile
    runtime.max_dup = 2**12
    runtime.splats_capacity = 16
    runtime.opacity_reset_interval = 2

    h = SplatModelHost(16, 1, 4)
    for i in range(8):
        h.push_back(
            [0.1 * i - 0.4, 0.0, 0.05 * i],
            rgb_sh([0.6, 0.4, 0.3]), [0.3] * 3, 0.9, [1, 0, 0, 0],
        )
    trainer = Trainer(small_project(), runtime, h.to_device(), renderer="tiled")
    trainer.capture_truths(OracleRtx(target_model(), res=res))

    trainer.train()  # iteration 1: no reset
    op1 = np.asarray(trainer.model.opacities[:8])
    assert float(op1.max()) > 0.01
    trainer.train()  # iteration 2: reset fires
    op2 = np.asarray(trainer.model.opacities[:8])
    assert float(op2.max()) <= 0.01 + 1e-7

    runtime.opacity_reset_interval = 0  # off: opacities free to recover
    trainer.train()
    assert np.isfinite(float(trainer.last_metrics.loss))


def test_buffer_auto_shrink_after_sustained_low_utilization():
    """After densify culls drop duplicate-buffer utilization below 40% for
    three consecutive sync-point checks, maybe_grow_dup_buffer shrinks
    max_dup back down (every D-sized gradient-reduction op scales with
    max_dup).  One or two low readings must NOT shrink (hysteresis: each
    resize is a recompile)."""
    from gaussian_splatterer_tpu.train.trainer import TrainMetrics

    res, tile = 64, 16
    runtime = RuntimeConfig()
    runtime.render_resolution_x = runtime.render_resolution_y = res
    runtime.tile_px = tile
    runtime.max_dup = 2**14  # oversized for the scene
    runtime.splats_capacity = 16

    h = SplatModelHost(16, 1, 4)
    for i in range(4):
        h.push_back(
            [0.1 * i - 0.2, 0.0, 0.05 * i],
            rgb_sh([0.6, 0.4, 0.3]), [0.2] * 3, 0.9, [1, 0, 0, 0],
        )
    trainer = Trainer(small_project(), runtime, h.to_device(), renderer="tiled")

    def fake_metrics(nd):
        z = jnp.zeros(())
        return TrainMetrics(z, z, z, jnp.int32(nd))

    def check(m):
        # one check per iteration (densify + session cadences dedupe)
        trainer.project.iterations += 1
        return trainer.maybe_grow_dup_buffer(m)

    low = fake_metrics(300)  # under 40% of the buffer
    assert not check(low)
    # a REPEATED reading on the same iteration must not advance the streak
    assert not trainer.maybe_grow_dup_buffer(low)
    assert not trainer.maybe_grow_dup_buffer(low)
    assert not check(low)
    assert runtime.max_dup == 2**14  # two lows: no shrink yet
    assert check(low)  # third consecutive low
    assert runtime.max_dup == max(-(-int(300 * 2.0) // 256) * 256, 4 * 256)

    # a high reading resets the streak
    runtime.max_dup = 2**14
    trainer._build_step()
    busy = fake_metrics(2**13)
    assert not check(busy)
    assert not check(low)
    assert not check(low)
    assert runtime.max_dup == 2**14

    # training still works on the shrunk buffers
    assert check(low)
    trainer.capture_truths(OracleRtx(target_model(), res=res))
    m = trainer.train()
    assert np.isfinite(float(m.loss))


def test_densify_variance_decay_anneals_trigger():
    """densify_variance_decay lowers the split/clone trigger over time so
    late-training (small-gradient) splats still densify; 1.0 keeps the
    flat reference threshold."""
    res, tile = 64, 16
    runtime = RuntimeConfig()
    runtime.render_resolution_x = runtime.render_resolution_y = res
    runtime.tile_px = tile
    runtime.max_dup = 2**12
    runtime.splats_capacity = 64
    runtime.densify_variance_decay = 0.5  # aggressive for the test

    h = SplatModelHost(64, 1, 4)
    for i in range(8):
        h.push_back(
            [0.15 * i - 0.5, 0.1 * i - 0.3, 0.05 * i],
            rgb_sh([0.6, 0.4, 0.3]), [0.25] * 3, 0.9, [1, 0, 0, 0],
        )
    p = small_project()
    # a trigger no real gradient reaches un-annealed
    p.paramDensifyVariance = 1e6
    trainer = Trainer(p, runtime, h.to_device(), renderer="tiled")
    trainer.capture_truths(OracleRtx(target_model(), res=res))

    n0 = trainer.model.count
    trainer.train(densify_now=True)  # it=1: trigger 5e5 — still unreachable
    assert int(trainer.model.count) == int(n0)
    for _ in range(60):  # 0.5^60 * 1e6 ~ 1e-12: everything densifies
        trainer.project.iterations += 1
    trainer.train(densify_now=True)
    assert int(trainer.model.count) > int(n0)

    # decay off: the same huge flat trigger never densifies
    runtime.densify_variance_decay = 1.0
    trainer2 = Trainer(p, runtime, h.to_device(), renderer="tiled")
    trainer2.capture_truths(OracleRtx(target_model(), res=res))
    trainer2.train(densify_now=True)
    assert int(trainer2.model.count) <= int(n0) + 0


def test_ssim_matches_naive_reference():
    """ssim (separable jnp convolutions) against a direct sliding-window
    NumPy evaluation of the Wang et al. formula, plus the standard
    sanity properties."""
    from gaussian_splatterer_tpu.utils.metrics import ssim

    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (20, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.08, a.shape), 0, 1).astype(np.float32)

    win, sigma = 11, 1.5
    r = np.arange(win) - (win - 1) / 2.0
    g = np.exp(-0.5 * (r / sigma) ** 2)
    g /= g.sum()
    w = np.outer(g, g)  # (11, 11)

    def naive(x, y):
        h, wd, c = x.shape
        vals = []
        for ch in range(c):
            for i in range(h - win + 1):
                for j in range(wd - win + 1):
                    pa = x[i : i + win, j : j + win, ch]
                    pb = y[i : i + win, j : j + win, ch]
                    mu_a = (w * pa).sum()
                    mu_b = (w * pb).sum()
                    va = (w * pa * pa).sum() - mu_a**2
                    vb = (w * pb * pb).sum() - mu_b**2
                    cov = (w * pa * pb).sum() - mu_a * mu_b
                    c1, c2 = 0.01**2, 0.03**2
                    vals.append(
                        ((2 * mu_a * mu_b + c1) * (2 * cov + c2))
                        / ((mu_a**2 + mu_b**2 + c1) * (va + vb + c2))
                    )
        return float(np.mean(vals))

    np.testing.assert_allclose(float(ssim(a, b)), naive(a, b), atol=1e-5)
    assert float(ssim(a, a)) == pytest.approx(1.0, abs=1e-6)
    big = np.clip(a + rng.normal(0, 0.3, a.shape), 0, 1).astype(np.float32)
    assert float(ssim(a, b)) > float(ssim(a, big))


def test_serve_renderer_follows_buffer_resize():
    """Regression: Trainer.render's partial bakes max_dup at build time;
    maybe_grow_dup_buffer must rebuild it, or post-grow previews/PSNR
    evals silently drop the deepest duplicates."""
    from gaussian_splatterer_tpu.train.trainer import TrainMetrics

    runtime = RuntimeConfig()
    runtime.render_resolution_x = runtime.render_resolution_y = 64
    runtime.tile_px = 16
    runtime.max_dup = 256
    runtime.splats_capacity = 16
    h = SplatModelHost(16, 1, 4)
    h.push_back([0, 0, 0], rgb_sh([0.5, 0.5, 0.5]), [0.2] * 3, 0.9,
                [1, 0, 0, 0])
    trainer = Trainer(small_project(), runtime, h.to_device(), renderer="tiled")
    assert trainer._render_fn.keywords["max_dup"] == 256

    z = jnp.zeros(())
    trainer.project.iterations += 1
    grew = trainer.maybe_grow_dup_buffer(
        TrainMetrics(z, z, z, jnp.int32(1000))
    )
    assert grew and runtime.max_dup >= 1000
    assert trainer._render_fn.keywords["max_dup"] == runtime.max_dup


@pytest.mark.parametrize("knobs", [
    dict(mip_antialias=True, opacity_reset_interval=5),
    dict(train_chunk=8, lr_location_decay=0.99, densify_variance_decay=0.99),
    dict(mip_antialias=True, train_chunk=64, frame_group=1),
])
def test_training_soak_stays_finite(knobs):
    """Mini-soak: real multi-step training (capture, densify, SGD, all
    optional knobs) must keep loss/params finite.  Parity tests never
    evolve params into degenerate states — the mip-AA sqrt-NaN (a
    collapsed scale after an SGD clamp) only surfaced under training."""
    rt = RuntimeConfig(render_resolution_x=RES, render_resolution_y=RES,
                       splats_capacity=32, max_dup=2048, **knobs)
    rt.tile_px = 16
    p = small_project()
    p.intervalDensify = 4
    p.paramDensifyVariance = 1e-4
    # aggressive LRs to push params into clamps quickly
    p.lrScale = 5e-2
    p.lrOpacity = 1e-1
    trainer = Trainer(p, rt, student_model(), renderer="tiled")
    trainer.capture_truths(OracleRtx(target_model()))
    for i in range(12):
        m = trainer.train(densify_now=(i % 4 == 3))
        assert np.isfinite(float(m.loss)), f"loss NaN at step {i} ({knobs})"
    for leaf in (trainer.model.means, trainer.model.scales,
                 trainer.model.opacities, trainer.model.rotations):
        assert np.isfinite(np.asarray(leaf)).all(), f"param NaN ({knobs})"


def test_pinned_buffers_never_shrink():
    """auto_shrink_buffers=False (long scripted runs with a pre-sized
    buffer): sustained low utilization must NOT shrink max_dup (each
    resize is a recompile), while overflow GROWTH stays armed."""
    from gaussian_splatterer_tpu.train.trainer import TrainMetrics

    res, tile = 64, 16
    runtime = RuntimeConfig()
    runtime.render_resolution_x = runtime.render_resolution_y = res
    runtime.tile_px = tile
    runtime.max_dup = 2**14
    runtime.splats_capacity = 16
    runtime.auto_shrink_buffers = False

    h = SplatModelHost(16, 1, 4)
    h.push_back([0.0, 0.0, 0.0], rgb_sh([0.6, 0.4, 0.3]), [0.2] * 3, 0.9,
                [1, 0, 0, 0])
    trainer = Trainer(small_project(), runtime, h.to_device(), renderer="tiled")

    def fake_metrics(nd):
        z = jnp.zeros(())
        return TrainMetrics(z, z, z, jnp.int32(nd))

    low = fake_metrics(300)
    for _ in range(5):
        trainer.project.iterations += 1
        assert not trainer.maybe_grow_dup_buffer(low)
    assert runtime.max_dup == 2**14

    # growth safety still fires on overflow
    trainer.project.iterations += 1
    assert trainer.maybe_grow_dup_buffer(fake_metrics(2**15))
    assert runtime.max_dup >= 2**15
