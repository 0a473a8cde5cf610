"""The compositing kernels compiled for a CUDA GPU (no interpreter) against
the plain references at a moderate scene.  Every test takes the
``gpu_device`` fixture, which skips where there is no GPU; chip_smoke.py
runs them on the card by calling each test with the device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_splatterer_tpu.config import RuntimeConfig
from gaussian_splatterer_tpu.ops import raster_tiled as rt
from gaussian_splatterer_tpu.ops.binning import bin_splats
from gaussian_splatterer_tpu.ops.raster_reference import (
    composite_tiles_reference,
    render_oracle,
)
from gaussian_splatterer_tpu.ops.transforms import project_splat_components
from gaussian_splatterer_tpu.rt.scenes import random_splat_scene

RES, N, TILE = 256, 3000, 16
# the product default and the widest chunk the H100 sweep kept (PERF.md)
CHUNKS = sorted({RuntimeConfig().train_chunk, 32})


def _scene():
    params, active, views, pvs, poss, txs, tys, _ = random_splat_scene(
        N, N, RES, RES, 1, seed=2
    )
    cam = (views[0], pvs[0], poss[0], txs[0], tys[0])
    proj = project_splat_components(*params, active, *cam, RES, RES, 1, 1.0)
    bins = bin_splats(proj, RES, RES, TILE, 2**16)
    feat9 = jnp.stack([proj.mx, proj.my, proj.ca, proj.cb, proj.cc,
                       proj.cr, proj.cg, proj.cb2, proj.opacity])[:, bins.gather_idx]
    kw = dict(tile=TILE, tx_tiles=RES // TILE, tiles_frame=(RES // TILE) ** 2)
    depth = -(-int(jnp.max(bins.tile_end - bins.tile_start)) // 32) * 32
    return params, active, cam, feat9, bins.tile_start, bins.tile_end, kw, depth


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return max(
        float(np.max(np.abs(a[k] - b[k]))) / max(1e-9, float(np.max(np.abs(b[k]))))
        for k in range(a.shape[0])
    )


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", CHUNKS)
def test_gpu_forward_matches_reference(gpu_device, chunk):
    with jax.default_device(gpu_device):
        _, _, _, feat9, ts, te, kw, depth = _scene()
        out = jax.jit(lambda f: rt.composite_forward(f, ts, te, chunk=chunk, **kw))(feat9)
        with jax.default_matmul_precision("highest"):
            ref = composite_tiles_reference(feat9, ts, te, depth=depth, **kw)
        assert float(jnp.max(jnp.abs(out - ref))) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", CHUNKS)
def test_gpu_train_and_backward_match_reference(gpu_device, chunk):
    with jax.default_device(gpu_device):
        _, _, _, feat9, ts, te, kw, depth = _scene()
        truth = jax.random.uniform(jax.random.key(0), (ts.shape[0], 4, TILE * TILE))
        truth = truth.at[:, 3].set(0.0)
        bg4 = jnp.asarray([[0.2, 0.5, 0.8, 0.0]], jnp.float32)
        res, d = jax.jit(
            lambda f: rt.composite_train(f, ts, te, truth, bg4, chunk=chunk, **kw)
        )(feat9)

        def neg_half_sq(f):
            out = composite_tiles_reference(f, ts, te, depth=depth, **kw)
            r = truth[:, :3] - (out[:, :3] + out[:, 3:4] * bg4[0, :3, None])
            return -0.5 * jnp.sum(jnp.square(r)), r

        with jax.default_matmul_precision("highest"):
            (_, r_ref), d_ref = jax.value_and_grad(neg_half_sq, has_aux=True)(feat9)
        assert float(jnp.max(jnp.abs(res[:, :3] - r_ref))) < 1e-4
        assert _rel(d, d_ref) < 1e-3

        out = rt.composite_forward(feat9, ts, te, chunk=chunk, **kw)
        gin = jax.random.normal(jax.random.key(1), out.shape)
        d_bwd = jax.jit(
            lambda f: rt.composite_backward(f, ts, te, out, gin, chunk=chunk, **kw)
        )(feat9)
        with jax.default_matmul_precision("highest"):
            _, pull = jax.vjp(
                lambda f: composite_tiles_reference(f, ts, te, depth=depth, **kw), feat9
            )
        assert _rel(d_bwd, pull(gin)[0]) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", CHUNKS)
def test_gpu_render_matches_oracle(gpu_device, chunk):
    with jax.default_device(gpu_device):
        params, active, cam, *_ = _scene()
        args = (*params, active, *cam, RES, RES, jnp.asarray([0.3, 0.3, 0.3]), 1, 1.0)
        img = jax.jit(lambda: rt.render_tiled(*args, tile=TILE, chunk=chunk, max_dup=2**16))()
        with jax.default_matmul_precision("highest"):
            ref = render_oracle(*args, row_chunk=16, tile_cull=TILE)
        assert np.isfinite(np.asarray(img)).all()
        assert float(jnp.max(jnp.abs(img - ref))) < 1e-3
