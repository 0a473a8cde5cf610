"""Camera-DP train step on the 8-virtual-device CPU mesh (SURVEY §4
'Distributed'): sharded step must agree with the single-device step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from functools import partial

from gaussian_splatterer_tpu.config import Project
from gaussian_splatterer_tpu.models.camera import Camera
from gaussian_splatterer_tpu.models.splats import SplatModelHost
from gaussian_splatterer_tpu.ops.raster_reference import render_oracle
from gaussian_splatterer_tpu.parallel.dp import (
    make_camera_mesh,
    make_dp_train_step,
    shard_truths,
)
from gaussian_splatterer_tpu.train.trainer import (
    CameraBatch,
    LearningRates,
    make_train_step,
)

W = H = 32


def build_scene(n_splats=24, cap=64, n_cams=4, seed=0):
    rng = np.random.default_rng(seed)
    m = SplatModelHost(cap)
    for _ in range(n_splats):
        m.push_back(
            rng.uniform(-1.5, 1.5, 3), rng.normal(0, 0.3, (4, 3)),
            rng.uniform(0.1, 0.4, 3), rng.uniform(0.3, 1.0), [1, 0, 0, 0],
        )
    model = m.to_device()
    proj = Project()
    proj.sphere1.count = n_cams
    proj.sphere2.count = 0
    cameras = Camera.get_cameras(proj)
    cams = CameraBatch.from_cameras(cameras, W, H)
    truths = jnp.asarray(
        rng.uniform(0, 1, (2 * n_cams, H, W, 3)).astype(np.float32)
    )
    return model, cams, truths


def test_dp_matches_single_device():
    assert jax.device_count() >= 8, "conftest should provide 8 virtual devices"
    model, cams, truths = build_scene()
    lrs = LearningRates.from_project(Project())

    render = partial(render_oracle, row_chunk=8)
    single = make_train_step(W, H, 1, render_fn=render, row_chunk=8)
    m1, met1 = single(model, truths, cams, lrs)

    mesh = make_camera_mesh(jax.devices()[:8])
    dp = make_dp_train_step(mesh, W, H, 1, render_fn=render)
    truths_sharded = shard_truths(mesh, truths)
    m2, met2 = dp(model, truths_sharded, cams, lrs)

    np.testing.assert_allclose(np.asarray(met1.loss), np.asarray(met2.loss), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(m1), jax.tree.leaves(m2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_dp_tiled_renderer_runs():
    """Sharded step with the tiled renderer (interpreted kernels)."""
    from gaussian_splatterer_tpu.ops.raster_tiled import render_tiled

    model, cams, truths = build_scene(n_splats=12, cap=32, n_cams=4)
    lrs = LearningRates.from_project(Project())
    mesh = make_camera_mesh(jax.devices()[:8])
    render = partial(render_tiled, max_dup=2**10, interpret=True)
    dp = make_dp_train_step(mesh, W, H, 1, render_fn=render)
    m2, met2 = dp(model, shard_truths(mesh, truths), cams, lrs)
    assert np.isfinite(float(met2.loss))
    assert np.all(np.isfinite(np.asarray(m2.means)))


def test_fsdp_2d_matches_single_device():
    """('camera','splat') 2x4 mesh: sharded-parameter step == single-device."""
    from gaussian_splatterer_tpu.parallel.fsdp import (
        make_2d_mesh,
        make_fsdp_train_step,
        shard_model,
        shard_truths_2d,
    )

    model, cams, truths = build_scene(n_splats=24, cap=64, n_cams=4)
    lrs = LearningRates.from_project(Project())
    render = partial(render_oracle, row_chunk=8)

    single = make_train_step(W, H, 1, render_fn=render, row_chunk=8)
    m1, met1 = single(model, truths, cams, lrs)

    mesh = make_2d_mesh(2, 4)
    fsdp = make_fsdp_train_step(mesh, W, H, 1, render_fn=render)
    m2, met2 = fsdp(
        shard_model(mesh, model), shard_truths_2d(mesh, truths), cams, lrs
    )

    np.testing.assert_allclose(np.asarray(met1.loss), np.asarray(met2.loss), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(met1.var_loc), np.asarray(met2.var_loc), atol=1e-5
    )
    for a, b in zip(jax.tree.leaves(m1), jax.tree.leaves(m2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def build_scene_fused(n_splats=24, cap=64, n_cams=4, seed=0, sh_degree=1,
                      res=64, tile=16):
    """Scene with PRE-TILED truths for the fused fast path."""
    from gaussian_splatterer_tpu.ops.raster_tiled import image_to_tiles_cm

    sh_coeffs = (sh_degree + 1) ** 2
    rng = np.random.default_rng(seed)
    m = SplatModelHost(cap, sh_degree, sh_coeffs)
    for _ in range(n_splats):
        m.push_back(
            rng.uniform(-1.5, 1.5, 3), rng.normal(0, 0.3, (sh_coeffs, 3)),
            rng.uniform(0.1, 0.4, 3), rng.uniform(0.3, 1.0), [1, 0, 0, 0],
        )
    model = m.to_device()
    proj = Project()
    proj.sphere1.count = n_cams
    proj.sphere2.count = 0
    cameras = Camera.get_cameras(proj)
    cams = CameraBatch.from_cameras(cameras, res, res)
    truths = jnp.asarray(
        rng.uniform(0, 1, (2 * n_cams, res, res, 3)).astype(np.float32)
    )
    truth_tiles = jax.vmap(lambda im: image_to_tiles_cm(im, tile))(truths)
    return model, cams, truth_tiles


@pytest.mark.parametrize("sh_degree", [1, 3])
def test_dp_fused_matches_single_device(sh_degree):
    """Camera-DP on the FUSED tile-space fast path (the path production
    multi-chip training uses) == the single-device fused step, at SH
    degree 1 and 3 (round-1 FSDP was silently degree-1 only)."""
    from gaussian_splatterer_tpu.config import RuntimeConfig

    res, tile = 64, 16
    model, cams, truth_tiles = build_scene_fused(sh_degree=sh_degree,
                                                 res=res, tile=tile)
    lrs = LearningRates.from_project(Project())
    runtime = RuntimeConfig()
    runtime.tile_px = tile
    runtime.max_dup = 2**12

    single = make_train_step(
        res, res, sh_degree, renderer="tiled", fused=True,
        fused_opts=dict(tile=tile, max_dup=2**12,
                        chunk=runtime.train_chunk),
    )
    m1, met1 = single(model, truth_tiles, cams, lrs)

    mesh = make_camera_mesh(jax.devices()[:8])
    dp = make_dp_train_step(mesh, res, res, sh_degree, renderer="tiled",
                            runtime=runtime)
    m2, met2 = dp(model, shard_truths(mesh, truth_tiles), cams, lrs)

    np.testing.assert_allclose(
        np.asarray(met1.loss), np.asarray(met2.loss), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(met1.var_loc), np.asarray(met2.var_loc), atol=1e-5
    )
    for a, b in zip(jax.tree.leaves(m1), jax.tree.leaves(m2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("sh_degree", [1, 3])
def test_fsdp_fused_matches_single_device(sh_degree):
    """('camera','splat') mesh on the fused fast path, degree 1 and 3."""
    from gaussian_splatterer_tpu.config import RuntimeConfig
    from gaussian_splatterer_tpu.parallel.fsdp import (
        make_2d_mesh,
        make_fsdp_train_step,
        shard_model,
        shard_truths_2d,
    )

    res, tile = 64, 16
    model, cams, truth_tiles = build_scene_fused(sh_degree=sh_degree,
                                                 res=res, tile=tile)
    lrs = LearningRates.from_project(Project())
    runtime = RuntimeConfig()
    runtime.tile_px = tile
    runtime.max_dup = 2**12

    single = make_train_step(
        res, res, sh_degree, renderer="tiled", fused=True,
        fused_opts=dict(tile=tile, max_dup=2**12,
                        chunk=runtime.train_chunk),
    )
    m1, met1 = single(model, truth_tiles, cams, lrs)

    mesh = make_2d_mesh(2, 4)
    fsdp = make_fsdp_train_step(mesh, res, res, sh_degree, renderer="tiled",
                                runtime=runtime)
    m2, met2 = fsdp(
        shard_model(mesh, model), shard_truths_2d(mesh, truth_tiles), cams, lrs
    )

    np.testing.assert_allclose(
        np.asarray(met1.loss), np.asarray(met2.loss), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(met1.var_loc), np.asarray(met2.var_loc), atol=1e-5
    )
    for a, b in zip(jax.tree.leaves(m1), jax.tree.leaves(m2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (4, 2)])
def test_tp_band_matches_single_device(mesh_shape):
    """Tile-axis (image-band) parallelism == the single-device fused step:
    each device rasterizes a horizontal band of its frames (SURVEY §5
    'tile sharding when cameras < chips'); gradients, the nonlinear
    densify-variance signal, and the loss must all match."""
    from gaussian_splatterer_tpu.config import RuntimeConfig
    from gaussian_splatterer_tpu.parallel.tp import (
        make_tile_mesh,
        make_tp_train_step,
        shard_truths_tp,
    )

    res, tile = 128, 16  # 8 tile rows: supports up to 8 bands
    model, cams, truth_tiles = build_scene_fused(res=res, tile=tile)
    lrs = LearningRates.from_project(Project())
    runtime = RuntimeConfig()
    runtime.tile_px = tile
    runtime.max_dup = 2**12

    single = make_train_step(
        res, res, 1, renderer="tiled", fused=True,
        fused_opts=dict(tile=tile, max_dup=2**12,
                        chunk=runtime.train_chunk),
    )
    m1, met1 = single(model, truth_tiles, cams, lrs)

    mesh = make_tile_mesh(*mesh_shape, devices=jax.devices()[:8])
    tp = make_tp_train_step(mesh, res, res, 1, runtime=runtime)
    m2, met2 = tp(model, shard_truths_tp(mesh, truth_tiles), cams, lrs)

    np.testing.assert_allclose(
        np.asarray(met1.loss), np.asarray(met2.loss), rtol=1e-5
    )
    # band-split psums reassociate float additions: ~1e-7 relative noise
    np.testing.assert_allclose(
        np.asarray(met1.var_loc), np.asarray(met2.var_loc), atol=5e-5
    )
    for a, b in zip(jax.tree.leaves(m1), jax.tree.leaves(m2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_3d_mesh_matches_single_device():
    """The full ('camera','tile','splat') composition — camera DP x image
    bands x ZeRO-3 splat sharding — must equal the single-device fused
    step exactly (grads, loss, densify-variance)."""
    from gaussian_splatterer_tpu.config import RuntimeConfig
    from gaussian_splatterer_tpu.parallel.mesh3 import (
        make_3d_mesh,
        make_3d_train_step,
        shard_model_3d,
        shard_truths_3d,
    )

    res, tile = 128, 16
    model, cams, truth_tiles = build_scene_fused(res=res, tile=tile)
    lrs = LearningRates.from_project(Project())
    runtime = RuntimeConfig()
    runtime.tile_px = tile
    runtime.max_dup = 2**12

    single = make_train_step(
        res, res, 1, renderer="tiled", fused=True,
        fused_opts=dict(tile=tile, max_dup=2**12,
                        chunk=runtime.train_chunk),
    )
    m1, met1 = single(model, truth_tiles, cams, lrs)

    mesh = make_3d_mesh(2, 2, 2, devices=jax.devices()[:8])
    step = make_3d_train_step(mesh, res, res, 1, runtime=runtime)
    m2, met2 = step(
        shard_model_3d(mesh, model), shard_truths_3d(mesh, truth_tiles),
        cams, lrs,
    )

    np.testing.assert_allclose(
        np.asarray(met1.loss), np.asarray(met2.loss), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(met1.var_loc), np.asarray(met2.var_loc), atol=5e-5
    )
    for a, b in zip(jax.tree.leaves(m1), jax.tree.leaves(m2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_routed3_matches_single_device():
    """SUB-TRANSIENT ('camera','tile','splat') step (parallel/routed3.py):
    projected rows ROUTED to their band/frame owners, gradients routed
    back — no device ever materializes the full model — must equal the
    single-device fused step to reassociation noise, including the
    densify-variance signal (exact per-frame norms by construction)."""
    from gaussian_splatterer_tpu.config import RuntimeConfig
    from gaussian_splatterer_tpu.parallel.mesh3 import (
        make_3d_mesh,
        shard_model_3d,
        shard_truths_3d,
    )
    from gaussian_splatterer_tpu.parallel.routed3 import (
        make_routed3_train_step,
    )

    res, tile = 128, 16
    model, cams, truth_tiles = build_scene_fused(res=res, tile=tile)
    lrs = LearningRates.from_project(Project())
    runtime = RuntimeConfig()
    runtime.tile_px = tile
    runtime.max_dup = 2**12

    single = make_train_step(
        res, res, 1, renderer="tiled", fused=True,
        fused_opts=dict(tile=tile, max_dup=2**12,
                        chunk=runtime.train_chunk),
    )
    m1, met1 = single(model, truth_tiles, cams, lrs)

    mesh = make_3d_mesh(2, 2, 2, devices=jax.devices()[:8])
    step = make_routed3_train_step(
        mesh, res, res, 1, runtime=runtime,
        route_cap1=256, route_cap2=256, virt_cap=256,
    )
    m2, met2, stats = step(
        shard_model_3d(mesh, model), shard_truths_3d(mesh, truth_tiles),
        cams, lrs,
    )
    # no overflow at this scale: the telemetry must agree
    assert int(stats.route1_max) <= 256
    assert int(stats.route2_max) <= 256
    assert int(stats.frame_max) <= 256

    np.testing.assert_allclose(
        np.asarray(met1.loss), np.asarray(met2.loss), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(met1.var_loc), np.asarray(met2.var_loc), atol=5e-5
    )
    for a, b in zip(jax.tree.leaves(m1), jax.tree.leaves(m2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_sharded_capture_matches_direct_render():
    """Camera-DP truth capture (parallel/capture.py): frames sharded over
    the virtual mesh must be BIT-IDENTICAL to direct per-frame tracer
    calls with the same keys (placement-independent PRNG), in the
    capture_truths frame order (whites then blacks)."""
    from gaussian_splatterer_tpu.io.obj import TriangleMesh
    from gaussian_splatterer_tpu.models.camera import Camera as Cam
    from gaussian_splatterer_tpu.parallel.capture import (
        capture_images_sharded,
    )
    from gaussian_splatterer_tpu.rt.tracer import (
        RtxHost,
        finish_rtx,
        render_rtx_sums,
    )

    res, samples = 32, 2
    verts = np.array(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32
    )
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.array(
        [[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]], np.float32
    )
    rtx = RtxHost(tri_chunk=8, ray_chunk=256, bounce_chunk=256)
    rtx.load_model(TriangleMesh(verts, tris, uv))
    cameras = [
        Cam(np.array([0, 0, -4.0], np.float32), np.zeros(3, np.float32), 60.0),
        Cam(np.array([1, 0.5, -4.0], np.float32), np.zeros(3, np.float32), 60.0),
    ]
    imgs = capture_images_sharded(
        rtx, cameras, samples, res, res, devices=jax.devices()[:8], seed=7
    )
    assert imgs.shape == (4, res, res, 3)

    for i, (cam, bg) in enumerate(
        [(c, (1.0, 1.0, 1.0)) for c in cameras]
        + [(c, (0.0, 0.0, 0.0)) for c in cameras]
    ):
        inv_pv = jnp.asarray(
            np.linalg.inv(
                cam.get_proj_view(1.0).astype(np.float64)
            ).astype(np.float32)
        )
        key = jax.random.fold_in(jax.random.PRNGKey(7), i)
        cs, _ = render_rtx_sums(
            rtx._tris, rtx._texture, jnp.asarray(cam.location, jnp.float32),
            inv_pv, width=res, height=res, samples=samples,
            background=jnp.asarray(bg, jnp.float32), key=key,
            ray_chunk=256, tri_chunk=8, bounce_chunk=256,
        )
        want = finish_rtx(cs, jnp.zeros((res * res,), bool), samples, res, res)
        np.testing.assert_array_equal(np.asarray(imgs[i]), np.asarray(want))


def test_routed3_overflow_reported():
    """Undersized route buckets must be REPORTED via RouteStats, never
    silently corrupt (the max_dup overflow contract)."""
    from gaussian_splatterer_tpu.config import RuntimeConfig
    from gaussian_splatterer_tpu.parallel.mesh3 import (
        make_3d_mesh,
        shard_model_3d,
        shard_truths_3d,
    )
    from gaussian_splatterer_tpu.parallel.routed3 import (
        make_routed3_train_step,
    )

    res, tile = 128, 16
    model, cams, truth_tiles = build_scene_fused(res=res, tile=tile)
    lrs = LearningRates.from_project(Project())
    runtime = RuntimeConfig()
    runtime.tile_px = tile
    runtime.max_dup = 2**12

    mesh = make_3d_mesh(2, 2, 2, devices=jax.devices()[:8])
    step = make_routed3_train_step(
        mesh, res, res, 1, runtime=runtime,
        route_cap1=2, route_cap2=256, virt_cap=256,
    )
    _, _, stats = step(
        shard_model_3d(mesh, model), shard_truths_3d(mesh, truth_tiles),
        cams, lrs,
    )
    assert int(stats.route1_max) > 2, "overflow must be visible in stats"
