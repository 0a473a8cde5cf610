"""Sharded steps at a REALISTIC duplicate-buffer shape.

tests/test_parallel.py proves exactness at toy scale (24 splats / 128²);
this file re-proves it at the headline bench scene's splat count — 50k
random splats, ~75k tile duplicates, multi-chunk tiles, uneven per-band
duplicate concentration — where band sharding's per-band buffer sizing and
the frame-flattened tile grid could plausibly mis-split.  Resolution is
256² rather than 1024²: the kernels run in interpret mode on the CPU
backend, and 1024² interpret steps take minutes each; every shape-class
that differs between toy and production — duplicate counts beyond one
chunk per tile, band-imbalanced binning — is already exercised at 256².

One single-device reference step is shared by all three mesh tests
(session fixture) to bound runtime.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_splatterer_tpu.rt.scenes import random_splat_scene as build_scene
from gaussian_splatterer_tpu.config import Project, RuntimeConfig
from gaussian_splatterer_tpu.models.splats import SplatModel
from gaussian_splatterer_tpu.ops.raster_tiled import image_to_tiles_cm
from gaussian_splatterer_tpu.train.trainer import (
    CameraBatch,
    LearningRates,
    make_train_step,
)

RES = 256
TILE = 32
N_SPLATS = 50_000
CAPACITY = 65_536
MAX_DUP = 98_304  # ~75k true dups at this scene (1.3x headroom)
CHUNK = 128  # wide chunks: fewer interpreted loop steps per deep tile
N_CAMS = 4  # 8 frames: divisible by the 8-device camera axis


def _runtime():
    rt = RuntimeConfig()
    rt.render_resolution_x = rt.render_resolution_y = RES
    rt.splats_capacity = CAPACITY
    rt.tile_px = TILE
    rt.max_dup = MAX_DUP
    rt.train_chunk = CHUNK
    return rt


@pytest.fixture(scope="module")
def scene():
    params, active, views, pvs, poss, txs, tys, _ = build_scene(
        N_SPLATS, CAPACITY, RES, RES, N_CAMS
    )
    model = SplatModel(
        means=params[0], shs=params[1], scales=params[2],
        opacities=params[3], rotations=params[4],
        count=jnp.asarray(N_SPLATS, jnp.int32), sh_degree=1,
    )
    cams = CameraBatch(
        view=views, proj_view=pvs, cam_pos=poss, tan_fovx=txs, tan_fovy=tys
    )
    rng = np.random.default_rng(3)
    truths = jnp.asarray(
        rng.uniform(0, 1, (2 * N_CAMS, RES, RES, 3)).astype(np.float32)
    )
    truth_tiles = jax.vmap(lambda im: image_to_tiles_cm(im, TILE))(truths)
    return model, cams, truth_tiles


@pytest.fixture(scope="module")
def single_ref(scene):
    model, cams, truth_tiles = scene
    lrs = LearningRates.from_project(Project())
    # fused_opts must match what the parallel builders derive from
    # RuntimeConfig (fused_kw_from_runtime) — in particular the chunk: a
    # different chunk regroups the in-kernel prefix sums (rounding
    # differences that would read as a sharding bug)
    single = make_train_step(
        RES, RES, 1, renderer="tiled", fused=True,
        fused_opts=dict(tile=TILE, max_dup=MAX_DUP,
                        chunk=CHUNK),
    )
    m1, met1 = single(model, truth_tiles, cams, lrs)
    jax.block_until_ready(m1.means)
    return m1, met1


def _check(m1, met1, m2, met2, var_atol=5e-3):
    np.testing.assert_allclose(
        np.asarray(met1.loss), np.asarray(met2.loss), rtol=1e-5
    )
    # frame-batched (F=8 one launch) vs per-frame (F=1 per device)
    # execution reassociates ~75k-duplicate float reductions: ~6e-5
    # RELATIVE noise on gradient sums at this scene — var_loc elements
    # reach ~4.7, so exactness holds
    # to ~1e-3 absolute, not the toy tests' 5e-5.  Parameter updates
    # absorb the learning rates (~5e-5) and stay inside 1e-5.
    np.testing.assert_allclose(
        np.asarray(met1.var_loc), np.asarray(met2.var_loc), atol=var_atol
    )
    for a, b in zip(jax.tree.leaves(m1), jax.tree.leaves(m2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_dp_realistic_shape(scene, single_ref):
    """Camera-DP at 50k splats / ~75k duplicates == single device."""
    from gaussian_splatterer_tpu.parallel.dp import (
        make_camera_mesh,
        make_dp_train_step,
        shard_truths,
    )

    model, cams, truth_tiles = scene
    m1, met1 = single_ref
    lrs = LearningRates.from_project(Project())
    mesh = make_camera_mesh(jax.devices()[:8])
    dp = make_dp_train_step(mesh, RES, RES, 1, renderer="tiled",
                            runtime=_runtime())
    m2, met2 = dp(model, shard_truths(mesh, truth_tiles), cams, lrs)
    _check(m1, met1, m2, met2)


@pytest.mark.slow  # deselected by default (pyproject addopts); run with -m slow
def test_band_realistic_shape(scene, single_ref):
    """(1, 8) image-band sharding at a band-IMBALANCED duplicate
    distribution (the bench scene concentrates splats centrally, so
    central bands hold several times the edge bands' duplicates) ==
    single device — per-band buffer sizing must not drop duplicates."""
    from gaussian_splatterer_tpu.parallel.tp import (
        make_tile_mesh,
        make_tp_train_step,
        shard_truths_tp,
    )

    model, cams, truth_tiles = scene
    m1, met1 = single_ref
    lrs = LearningRates.from_project(Project())
    mesh = make_tile_mesh(1, 8, devices=jax.devices()[:8])
    tp = make_tp_train_step(mesh, RES, RES, 1, runtime=_runtime())
    m2, met2 = tp(model, shard_truths_tp(mesh, truth_tiles), cams, lrs)
    _check(m1, met1, m2, met2)


def test_3d_mesh_realistic_shape(scene, single_ref):
    """camera x tile x splat (2, 2, 2) at 50k splats == single device."""
    from gaussian_splatterer_tpu.parallel.mesh3 import (
        make_3d_mesh,
        make_3d_train_step,
        shard_model_3d,
        shard_truths_3d,
    )

    model, cams, truth_tiles = scene
    m1, met1 = single_ref
    lrs = LearningRates.from_project(Project())
    mesh = make_3d_mesh(2, 2, 2, devices=jax.devices()[:8])
    step = make_3d_train_step(mesh, RES, RES, 1, runtime=_runtime())
    m2, met2 = step(
        shard_model_3d(mesh, model), shard_truths_3d(mesh, truth_tiles),
        cams, lrs,
    )
    _check(m1, met1, m2, met2)


def test_routed3_realistic_shape(scene, single_ref):
    """SUB-TRANSIENT routed step at 50k splats / ~75k duplicates ==
    single device, with realistic ragged routing: ~25k visible splats per
    frame crossing 2 bands (band-imbalanced — central bands receive
    several times the edge bands' records), 25k-per-shard projection,
    and the full two-hop gradient return.  No device materializes the
    full model; RouteStats must certify zero dropped records."""
    from gaussian_splatterer_tpu.parallel.mesh3 import (
        make_3d_mesh,
        shard_model_3d,
        shard_truths_3d,
    )
    from gaussian_splatterer_tpu.parallel.routed3 import (
        make_routed3_train_step,
    )

    model, cams, truth_tiles = scene
    m1, met1 = single_ref
    lrs = LearningRates.from_project(Project())
    mesh = make_3d_mesh(2, 2, 2, devices=jax.devices()[:8])
    cap1, cap2, vcap = 40_960, 40_960, 49_152
    step = make_routed3_train_step(
        mesh, RES, RES, 1, runtime=_runtime(),
        route_cap1=cap1, route_cap2=cap2, virt_cap=vcap,
    )
    m2, met2, stats = step(
        shard_model_3d(mesh, model), shard_truths_3d(mesh, truth_tiles),
        cams, lrs,
    )
    assert int(stats.route1_max) <= cap1, "route hop 1 dropped records"
    assert int(stats.route2_max) <= cap2, "route hop 2 dropped records"
    assert int(stats.frame_max) <= vcap, "frame re-bucket dropped records"
    _check(m1, met1, m2, met2)
