"""The Triton compositing kernels in the Pallas interpreter, against the
plain references: the per-pixel oracle (raster_reference.render_oracle with
the tile-granular cull) and the plain-jnp tiled compositor
(raster_reference.composite_tiles_reference, same per-tile segments); plus
the pieces around them that the CPU can check — wrapper shapes, the
no-kernel error, the compile-cache rule, the PNG codec and the model
pytree."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_splatterer_tpu.models.camera import Camera
from gaussian_splatterer_tpu.ops import raster_tiled as rt
from gaussian_splatterer_tpu.ops.binning import bin_splats
from gaussian_splatterer_tpu.ops.raster_reference import (
    composite_tiles_reference,
    render_oracle,
)
from gaussian_splatterer_tpu.ops.transforms import project_splat_components

W = H = 64


def scene(n, seed=0, cap=None, scale=(0.05, 0.45), opacity=(0.2, 1.0)):
    rng = np.random.default_rng(seed)
    cap = cap or max(n, 1)
    means = np.zeros((cap, 3), np.float32)
    means[:n] = rng.uniform(-2.5, 2.5, (n, 3))
    shs = np.zeros((cap, 4, 3), np.float32)
    shs[:n] = rng.normal(0, 0.5, (n, 4, 3))
    scales = np.zeros((cap, 3), np.float32)
    scales[:n] = rng.uniform(*scale, (n, 3))
    opac = np.zeros((cap,), np.float32)
    opac[:n] = rng.uniform(*opacity, n)
    rot = np.zeros((cap, 4), np.float32)
    rot[:, 0] = 1.0
    rot[:n] = rng.normal(0, 1, (n, 4))
    return (
        tuple(map(jnp.asarray, (means, shs, scales, opac, rot))),
        jnp.asarray(np.arange(cap) < n),
    )


def camera(w=W, h=H, dist=8.0):
    cam = Camera(np.array([0.3, -0.2, -dist], np.float32), np.zeros(3, np.float32), 60.0)
    tx, ty = cam.tan_fov(w, h, train=True)
    return (jnp.asarray(cam.get_view()), jnp.asarray(cam.get_proj_view(w / h)),
            jnp.asarray(cam.location), tx, ty)


def binned(params, active, tile, w=W, h=H, max_dup=2**12, dist=8.0):
    """(feat9, tile_start, tile_end, kernel kwargs) for one frame."""
    view, pv, pos, tx, ty = camera(w, h, dist)
    proj = project_splat_components(*params, active, view, pv, pos, tx, ty, w, h, 1, 1.0)
    bins = bin_splats(proj, w, h, tile, max_dup)
    feat9 = jnp.stack([proj.mx, proj.my, proj.ca, proj.cb, proj.cc,
                       proj.cr, proj.cg, proj.cb2, proj.opacity])[:, bins.gather_idx]
    tx_tiles = -(-w // tile)
    kw = dict(tile=tile, tx_tiles=tx_tiles, tiles_frame=tx_tiles * -(-h // tile))
    return feat9, bins.tile_start, bins.tile_end, kw


def reference_train(feat9, ts, te, truth, bg, depth, **kw):
    """Residual rows and per-duplicate J^T residual from the plain tiled
    compositor (the train kernel's definition)."""
    def neg_half_sq(f):
        out = composite_tiles_reference(f, ts, te, depth=depth, batch=8, **kw)
        r = truth[:, :3] - (out[:, :3] + out[:, 3:4] * bg[:3, None])
        return -0.5 * jnp.sum(jnp.square(r)), jnp.concatenate([r, out[:, 3:4]], 1)

    (_, res), grad = jax.value_and_grad(neg_half_sq, has_aux=True)(feat9)
    return res, grad


def assert_rows_close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    for k in range(a.shape[0]):
        scale = max(1e-6, float(np.max(np.abs(b[k]))))
        np.testing.assert_allclose(a[k] / scale, b[k] / scale, atol=rtol,
                                   err_msg=f"row {k}")


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("n", [1, 60, 300])
def test_forward_matches_oracle(n, tile):
    params, active = scene(n, seed=n)
    args = (*params, active, *camera(), W, H, jnp.asarray([0.1, 0.2, 0.3]), 1, 1.0)
    img_k = rt.render_tiled(*args, tile=tile, max_dup=2**13)
    img_o = render_oracle(*args, row_chunk=16, tile_cull=tile)
    np.testing.assert_allclose(np.asarray(img_k), np.asarray(img_o), atol=2e-6)


@pytest.mark.parametrize("tile", [16, 32])
def test_train_grads_match_oracle_grad(tile):
    """render_train_grads (fused kernel + duplicate reduction + projection
    vjp) == jax.grad of the oracle's negative half squared error."""
    params, active = scene(50, seed=5)
    view, pv, pos, tx, ty = camera()
    truth = jnp.asarray(np.random.default_rng(1).uniform(0, 1, (H, W, 3)), jnp.float32)
    bg = jnp.asarray([0.4, 0.1, 0.7], jnp.float32)
    loss, g_k, _ = rt.render_train_grads(
        *params, active, view, pv, pos, tx, ty, W, H,
        rt.image_to_tiles_cm(truth, tile), bg, 1, tile=tile, max_dup=2**12,
    )

    def neg_half_sq(p):
        img = render_oracle(*p, active, view, pv, pos, tx, ty, W, H, bg, 1, 1.0,
                            row_chunk=16, tile_cull=tile)
        return -0.5 * jnp.sum(jnp.square(img - truth)), jnp.mean(jnp.square(img - truth))

    (_, mse), g_o = jax.value_and_grad(neg_half_sq, has_aux=True)(params)
    np.testing.assert_allclose(float(loss), float(mse), rtol=1e-5)
    for a, b in zip(g_k, g_o):
        scale = max(1e-3, float(jnp.max(jnp.abs(b))))
        np.testing.assert_allclose(np.asarray(a) / scale, np.asarray(b) / scale, atol=5e-5)


def test_segment_spanning_many_chunks():
    """A tile whose depth-sorted segment spans many chunks (chunk 8 over
    ~100-deep tiles) carries T and alive across chunks exactly: forward,
    residual and every per-duplicate gradient row match the plain tiled
    compositor."""
    params, active = scene(120, seed=3, opacity=(0.05, 0.3))
    feat9, ts, te, kw = binned(params, active, 16)
    depth = int(np.max(np.asarray(te - ts)))
    assert depth > 8 * 8, "scene too shallow to span many chunks"
    truth = jax.random.uniform(jax.random.key(0), (ts.shape[0], 4, 256)).at[:, 3].set(0)
    bg4 = jnp.asarray([[0.3, 0.6, 0.9, 0.0]], jnp.float32)
    out = rt.composite_forward(feat9, ts, te, chunk=8, **kw)
    res, d = rt.composite_train(feat9, ts, te, truth, bg4, chunk=8, **kw)
    ref_out = composite_tiles_reference(feat9, ts, te, depth=depth, batch=8, **kw)
    ref_res, ref_d = reference_train(feat9, ts, te, truth, bg4[0], depth, **kw)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref_out), atol=2e-6)
    np.testing.assert_allclose(np.asarray(res), np.asarray(ref_res), atol=2e-6)
    assert_rows_close(d, ref_d, 1e-5)


def test_empty_tiles_composite_to_background():
    """Tiles with no duplicates keep C = 0, T = 1: the serve output is
    (0, 0, 0, 1), the train residual is truth - bg, and the gradient
    buffer stays zero."""
    params, active = scene(0, cap=8)
    feat9, ts, te, kw = binned(params, active, 16)
    assert int(jnp.max(te - ts)) == 0
    out = rt.composite_forward(feat9, ts, te, chunk=32, **kw)
    np.testing.assert_array_equal(
        np.asarray(out), np.broadcast_to([[0.0], [0.0], [0.0], [1.0]], out.shape)
    )
    truth = jax.random.uniform(jax.random.key(1), (ts.shape[0], 4, 256)).at[:, 3].set(0)
    bg4 = jnp.asarray([[0.25, 0.5, 0.75, 0.0]], jnp.float32)
    res, d = rt.composite_train(feat9, ts, te, truth, bg4, chunk=32, **kw)
    np.testing.assert_allclose(
        np.asarray(res[:, :3]), np.asarray(truth[:, :3] - bg4[0, :3, None]), atol=1e-7
    )
    np.testing.assert_array_equal(np.asarray(res[:, 3]), 1.0)
    assert not np.asarray(d).any()


def test_early_termination_skips_later_chunks():
    """Opaque splats saturate every pixel of the deep tiles well before
    their segments end (T_final at the INRIA cutoff, ~1e-4 to 1e-2); the
    kernels' early exit is exact: results match the reference, and the
    duplicates behind the saturation point get exactly zero gradient."""
    params, active = scene(200, seed=9, scale=(0.6, 1.2), opacity=(0.95, 1.0))
    feat9, ts, te, kw = binned(params, active, 16, dist=6.0)
    seg = np.asarray(te - ts)
    depth = int(seg.max())
    out = rt.composite_forward(feat9, ts, te, chunk=8, **kw)
    deep = seg > 64
    assert deep.any() and (np.asarray(out[:, 3])[deep] < 1e-2).all()
    ref = composite_tiles_reference(feat9, ts, te, depth=depth, batch=8, **kw)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-6)
    truth = jax.random.uniform(jax.random.key(5), (ts.shape[0], 4, 256)).at[:, 3].set(0)
    bg4 = jnp.asarray([[0.5, 0.5, 0.5, 0.0]], jnp.float32)
    _, d = rt.composite_train(feat9, ts, te, truth, bg4, chunk=8, **kw)
    _, d_ref = reference_train(feat9, ts, te, truth, bg4[0], depth, **kw)
    assert_rows_close(d, d_ref, 1e-5)
    t = int(np.argmax(seg))
    cols = np.abs(np.asarray(d_ref)[:, int(ts[t]) : int(te[t])]).max(axis=0)
    live = int(np.nonzero(cols)[0].max()) + 1  # last duplicate with gradient
    assert seg[t] - live >= 16, "deepest tile does not saturate early"
    assert not np.asarray(d)[:, int(ts[t]) + live : int(te[t])].any()


def test_serve_backward_matches_reference_vjp():
    """composite_backward == jax.vjp of the plain tiled compositor for an
    arbitrary output cotangent (colour rows and T_final)."""
    params, active = scene(100, seed=17)
    feat9, ts, te, kw = binned(params, active, 16)
    depth = int(np.max(np.asarray(te - ts)))
    gin = jax.random.normal(jax.random.key(3), (ts.shape[0], 4, 256))
    out = rt.composite_forward(feat9, ts, te, chunk=32, **kw)
    d = rt.composite_backward(feat9, ts, te, out, gin, chunk=32, **kw)
    _, pull = jax.vjp(
        lambda f: composite_tiles_reference(f, ts, te, depth=depth, batch=8, **kw), feat9
    )
    assert_rows_close(d, pull(gin)[0], 1e-5)


@pytest.mark.parametrize("w,h", [(72, 40), (50, 66)])
def test_resolution_not_divisible_by_tile(w, h):
    """Edge tiles hang off the image: the serve path renders them whole and
    crops, matching the oracle on every real pixel."""
    params, active = scene(80, seed=w)
    args = (*params, active, *camera(w, h), w, h, jnp.asarray([0.5, 0.5, 0.5]), 1, 1.0)
    img_k = rt.render_tiled(*args, tile=16, max_dup=2**13)
    img_o = render_oracle(*args, row_chunk=h // 2 if h % 2 == 0 else 1, tile_cull=16)
    assert img_k.shape == (h, w, 3)
    np.testing.assert_allclose(np.asarray(img_k), np.asarray(img_o), atol=2e-6)


def test_no_kernel_for_platform_raises():
    """Without an explicit interpret request, a platform with no compiled
    kernel (here the CPU) raises an error that names it."""
    params, active = scene(10)
    feat9, ts, te, kw = binned(params, active, 16)
    rt.set_interpret(False)
    try:
        with pytest.raises(RuntimeError, match="platform 'cpu'"):
            rt.composite_forward(feat9, ts, te, chunk=32, **kw)
        # an explicit per-call request still works
        out = rt.composite_forward(feat9, ts, te, chunk=32, interpret=True, **kw)
        assert out.shape == (ts.shape[0], 4, 256)
    finally:
        rt.set_interpret(True)


def test_wrapper_shapes_and_warps():
    """Output shapes of the three launchers; warps scale with the
    (pixels x chunk) pair tile and stay within 4..16."""
    params, active = scene(30, seed=4)
    feat9, ts, te, kw = binned(params, active, 32)
    t = ts.shape[0]
    out = rt.composite_forward(feat9, ts, te, chunk=16, **kw)
    assert out.shape == (t, 4, 1024) and out.dtype == jnp.float32
    truth = jnp.zeros((t, 4, 1024), jnp.float32)
    res, d = rt.composite_train(feat9, ts, te, truth, jnp.zeros((1, 4)), chunk=16, **kw)
    assert res.shape == (t, 4, 1024) and d.shape == feat9.shape
    assert rt._num_warps(256, 8) == 4
    assert rt._num_warps(256, 16) == 8
    assert rt._num_warps(256, 4) == 4
    assert rt._num_warps(1024, 64) == 16


def test_dup_grads_to_rows_matches_scatter_add():
    """The scatter-free duplicate reduction == a plain segment sum of the
    per-duplicate gradient columns by splat id, per frame."""
    from gaussian_splatterer_tpu.ops.binning import bin_splats_batch

    params, active = scene(40, seed=21, cap=48)
    view, pv, pos, tx, ty = camera()
    comps = jax.vmap(
        lambda v: project_splat_components(*params, active, v, pv, pos, tx, ty, W, H, 1, 1.0)
    )(jnp.stack([view, view]))
    max_dup = 2**10
    bins = bin_splats_batch(comps, W, H, 16, max_dup)
    d_feat9 = jax.random.normal(jax.random.key(4), (9, 2 * max_dup))
    valid = np.arange(max_dup)[None, :] < np.minimum(np.asarray(bins.num_dup), max_dup)[:, None]
    d_feat9 = d_feat9 * jnp.asarray(valid.reshape(-1), jnp.float32)
    rows = rt._dup_grads_to_rows(d_feat9, bins, 2, 48, max_dup)
    ids = np.asarray(bins.gather_flat)
    expect = jax.ops.segment_sum(d_feat9.T, jnp.asarray(ids), num_segments=2 * 48)
    expect = jnp.moveaxis(expect.reshape(2, 48, 9), 2, 1)
    np.testing.assert_allclose(np.asarray(rows), np.asarray(expect), atol=1e-4)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_rule(env_set, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; otherwise the
    cache goes to the fixed gitignored path in the checkout."""
    from gaussian_splatterer_tpu.utils import compile_cache as cc

    before = jax.config.jax_compilation_cache_dir
    try:
        env = {cc.ENV_VAR: str(tmp_path)} if env_set else {}
        got = cc.enable_compile_cache(env)
        if env_set:
            assert got == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert got == os.path.join(root, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
            with open(os.path.join(root, ".gitignore")) as fh:
                assert ".jax_cache/" in fh.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trip(channels, tmp_path):
    from gaussian_splatterer_tpu.io.image import (
        load_png,
        load_texture_rgba,
        read_png_u8,
        save_png,
        write_png_u8,
    )

    rng = np.random.default_rng(channels)
    arr = rng.integers(0, 256, (21, 34, channels), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    write_png_u8(path, arr)
    np.testing.assert_array_equal(read_png_u8(path), arr)
    tex = load_texture_rgba(path)
    assert tex.shape == (21, 34, 4)
    np.testing.assert_allclose(tex[..., :channels] * 255.0, arr, atol=1e-3)
    img = rng.uniform(0, 1, (9, 13, 3)).astype(np.float32)
    save_png(img, path)
    back = load_png(path)
    np.testing.assert_allclose(back, img, atol=1.0 / 255.0 + 1e-6)


def test_splat_model_pytree_and_replace():
    from gaussian_splatterer_tpu.models.splats import SplatModel

    m = SplatModel.empty(8, sh_degree=2, sh_coeffs=9)
    leaves, treedef = jax.tree_util.tree_flatten(m)
    assert len(leaves) == 6  # sh_degree is static metadata, not a leaf
    m2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert m2.sh_degree == 2 and m2.capacity == 8
    moved = m.replace(means=m.means + 1.0)
    assert moved.sh_degree == 2 and float(moved.means[0, 0]) == 1.0
    assert float(m.means[0, 0]) == 0.0  # immutable: original unchanged
    out = jax.jit(lambda x: x.replace(count=x.count + 3))(m)
    assert int(out.count) == 3 and out.sh_degree == 2
    with pytest.raises(Exception):
        m.means = m.means  # frozen
