"""Tiled rasterizer (Triton kernels, interpreted) vs oracle: forward allclose + backward gradients.

BASELINE config 1 analog: small splat sets, small images, CPU (interpret
mode), exact numerics against the oracle with tile-granular culling enabled
(the binned fast path's semantic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_splatterer_tpu.models.camera import Camera
from gaussian_splatterer_tpu.ops.raster_reference import render_oracle
from gaussian_splatterer_tpu.ops.raster_tiled import render_tiled

W = H = 64
TILE = 16


def random_splats(n, seed=0, cap=None):
    rng = np.random.default_rng(seed)
    cap = cap or n
    means = np.zeros((cap, 3), np.float32)
    means[:n] = rng.uniform(-2.5, 2.5, (n, 3))
    shs = np.zeros((cap, 4, 3), np.float32)
    shs[:n] = rng.normal(0, 0.5, (n, 4, 3))
    scales = np.zeros((cap, 3), np.float32)
    scales[:n] = rng.uniform(0.05, 0.45, (n, 3))
    opac = np.zeros((cap,), np.float32)
    opac[:n] = rng.uniform(0.2, 1.0, n)
    rot = np.zeros((cap, 4), np.float32)
    rot[:, 0] = 1.0
    rot[:n] = rng.normal(0, 1, (n, 4))
    active = np.arange(cap) < n
    return (
        jnp.asarray(means), jnp.asarray(shs), jnp.asarray(scales),
        jnp.asarray(opac), jnp.asarray(rot), jnp.asarray(active),
    )


def cam_args(fov=60.0, dist=8.0):
    cam = Camera(
        np.array([0.3, -0.2, -dist], np.float32),
        np.zeros(3, np.float32),
        fov,
    )
    view = jnp.asarray(cam.get_view())
    pv = jnp.asarray(cam.get_proj_view(W / H))
    tx, ty = cam.tan_fov(W, H, train=True)
    return view, pv, jnp.asarray(cam.location), tx, ty


def both_renders(n_splats, seed, bg, max_dup=2**13):
    params = random_splats(n_splats, seed)
    view, pv, pos, tx, ty = cam_args()
    bg = jnp.asarray(bg, jnp.float32)
    img_o = render_oracle(
        *params, view, pv, pos, tx, ty, W, H, bg, 1, 1.0,
        row_chunk=16, tile_cull=TILE,
    )
    img_t = render_tiled(
        *params, view, pv, pos, tx, ty, W, H, bg, 1, 1.0,
        tile=TILE, chunk=128, max_dup=max_dup, interpret=True,
    )
    return img_o, img_t


@pytest.mark.parametrize("n,seed", [(1, 0), (7, 1), (64, 2), (200, 3)])
def test_forward_allclose(n, seed):
    img_o, img_t = both_renders(n, seed, (0.0, 0.0, 0.0))
    np.testing.assert_allclose(np.asarray(img_t), np.asarray(img_o), atol=1e-5)


@pytest.mark.parametrize("tile", [8, 32])
def test_forward_allclose_other_tile_sizes(tile):
    params = random_splats(80, 4)
    view, pv, pos, tx, ty = cam_args()
    bg = jnp.zeros(3, jnp.float32)
    img_o = render_oracle(
        *params, view, pv, pos, tx, ty, W, H, bg, 1, 1.0,
        row_chunk=16, tile_cull=tile,
    )
    img_t = render_tiled(
        *params, view, pv, pos, tx, ty, W, H, bg, 1, 1.0,
        tile=tile, chunk=128, max_dup=2**13, interpret=True,
    )
    np.testing.assert_allclose(np.asarray(img_t), np.asarray(img_o), atol=1e-5)


def test_forward_white_bg():
    img_o, img_t = both_renders(50, 5, (1.0, 1.0, 1.0))
    np.testing.assert_allclose(np.asarray(img_t), np.asarray(img_o), atol=1e-5)


def test_empty_model_is_background():
    params = random_splats(0, 0, cap=8)
    view, pv, pos, tx, ty = cam_args()
    bg = jnp.asarray([0.25, 0.5, 0.75], jnp.float32)
    img = render_tiled(
        *params, view, pv, pos, tx, ty, W, H, bg, 1, 1.0,
        tile=TILE, max_dup=2**10, interpret=True,
    )
    np.testing.assert_allclose(np.asarray(img), np.broadcast_to(bg, (H, W, 3)), atol=1e-6)


def test_gradients_match_oracle():
    means, shs, scales, opac, rot, active = random_splats(40, 7)
    view, pv, pos, tx, ty = cam_args()
    bg = jnp.asarray([0.0, 0.0, 0.0], jnp.float32)
    residual = jnp.asarray(
        np.random.default_rng(11).normal(0, 1, (H, W, 3)), jnp.float32
    )

    def loss_with(render, **kw):
        def f(p):
            means_, shs_, scales_, opac_, rot_ = p
            img = render(
                means_, shs_, scales_, opac_, rot_, active,
                view, pv, pos, tx, ty, W, H, bg, 1, 1.0, **kw,
            )
            return jnp.sum(img * residual)
        return jax.grad(f)((means, shs, scales, opac, rot))

    g_o = loss_with(render_oracle, row_chunk=16, tile_cull=TILE)
    g_t = loss_with(render_tiled, tile=TILE, max_dup=2**13, interpret=True)
    names = ["means", "shs", "scales", "opacities", "rotations"]
    for name, a, b in zip(names, g_t, g_o):
        scale = max(1e-3, float(jnp.max(jnp.abs(b))))
        np.testing.assert_allclose(
            np.asarray(a) / scale, np.asarray(b) / scale,
            atol=5e-5, err_msg=f"gradient mismatch: {name}",
        )


def test_gradient_background():
    params = random_splats(20, 9)
    view, pv, pos, tx, ty = cam_args()

    def f_t(bg):
        return jnp.mean(
            render_tiled(*params, view, pv, pos, tx, ty, W, H, bg, 1, 1.0,
                         tile=TILE, max_dup=2**12, interpret=True)
        )

    def f_o(bg):
        return jnp.mean(
            render_oracle(*params, view, pv, pos, tx, ty, W, H, bg, 1, 1.0,
                          row_chunk=16, tile_cull=TILE)
        )

    bg = jnp.asarray([0.3, 0.6, 0.9], jnp.float32)
    np.testing.assert_allclose(
        np.asarray(jax.grad(f_t)(bg)), np.asarray(jax.grad(f_o)(bg)), atol=1e-5
    )


def test_overflow_reported():
    """Duplicate-buffer overflow drops trailing (deepest) splats but stays sound."""
    params = random_splats(200, 3)
    view, pv, pos, tx, ty = cam_args()
    bg = jnp.zeros(3, jnp.float32)
    img = render_tiled(
        *params, view, pv, pos, tx, ty, W, H, bg, 1, 1.0,
        tile=TILE, max_dup=128, interpret=True,
    )
    assert np.all(np.isfinite(np.asarray(img)))


def test_tile_roundtrip():
    from gaussian_splatterer_tpu.ops.raster_tiled import image_to_tiles, tiles_to_image

    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 1, (64, 96, 3)).astype(np.float32))
    tiles = image_to_tiles(img, 16)
    assert tiles.shape == (4 * 6, 256, 3)
    back = tiles_to_image(tiles, 96, 64, 16)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(img))


def test_tiles_match_image_render():
    from gaussian_splatterer_tpu.ops.raster_tiled import (
        render_tiled_tiles,
        tiles_to_image,
    )

    params = random_splats(30, 12)
    view, pv, pos, tx, ty = cam_args()
    bg = jnp.asarray([0.1, 0.2, 0.3], jnp.float32)
    img = render_tiled(*params, view, pv, pos, tx, ty, W, H, bg, 1, 1.0,
                       tile=TILE, max_dup=2**12, interpret=True)
    tiles = render_tiled_tiles(*params, view, pv, pos, tx, ty, W, H, bg, 1, 1.0,
                               tile=TILE, max_dup=2**12, interpret=True)
    np.testing.assert_array_equal(
        np.asarray(tiles_to_image(tiles, W, H, TILE)), np.asarray(img)
    )


def test_fused_train_grads_match_vjp_path():
    """The fused per-tile fwd+residual+bwd kernel == jax.vjp of the tiles
    renderer with the signed-residual cotangent (the training semantics)."""
    from gaussian_splatterer_tpu.ops.raster_tiled import (
        image_to_tiles,
        image_to_tiles_cm,
        render_tiled_tiles,
        render_train_grads,
    )

    params = random_splats(40, 21)[:5]
    active = random_splats(40, 21)[5]
    view, pv, pos, tx, ty = cam_args()
    bg = jnp.asarray([0.3, 0.1, 0.2], jnp.float32)
    rng = np.random.default_rng(3)
    truth = jnp.asarray(rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
    truth_tiles = image_to_tiles(truth, TILE)

    # reference path: render tiles, vjp with residual cotangent
    def render_fn(p):
        return render_tiled_tiles(
            *p, active, view, pv, pos, tx, ty, W, H, bg, 1, 1.0,
            tile=TILE, max_dup=2**12, interpret=True,
        )

    img_tiles, pull = jax.vjp(render_fn, params)
    residual = truth_tiles - img_tiles
    g_ref = pull(residual)[0]
    loss_ref = jnp.mean(jnp.square(residual))

    loss_f, g_fused, res4 = render_train_grads(
        *params, active, view, pv, pos, tx, ty, W, H,
        image_to_tiles_cm(truth, TILE), bg, 1,
        tile=TILE, max_dup=2**12, interpret=True,
    )

    np.testing.assert_allclose(float(loss_f), float(loss_ref), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(res4[:, 0:3, :]),
        np.asarray(residual).transpose(0, 2, 1),
        atol=1e-5,
    )
    names = ["means", "shs", "scales", "opacities", "rotations"]
    for name, a, b in zip(names, g_fused, g_ref):
        scale = max(1e-3, float(jnp.max(jnp.abs(b))))
        np.testing.assert_allclose(
            np.asarray(a) / scale, np.asarray(b) / scale, atol=5e-5,
            err_msg=f"fused gradient mismatch: {name}",
        )


@pytest.mark.slow  # deselected by default (pyproject addopts); run with -m slow
def test_batched_train_grads_match_per_frame():
    """The frame-batched fused kernel == per-frame fused calls summed:
    same losses, same gradient sums, same per-frame residuals and
    per-frame location-gradient norms (densify variance signal)."""
    from gaussian_splatterer_tpu.ops.raster_tiled import (
        image_to_tiles_cm,
        render_train_grads,
        render_train_grads_batch,
    )

    params = random_splats(40, 31)[:5]
    active = random_splats(40, 31)[5]
    rng = np.random.default_rng(5)

    cams = []
    for i, dist in enumerate([8.0, 7.0, 9.0]):
        cam = Camera(
            np.array([0.3 * (i + 1), -0.2, -dist], np.float32),
            np.zeros(3, np.float32), 60.0,
        )
        cams.append(cam)
    views = jnp.stack([jnp.asarray(c.get_view()) for c in cams])
    pvs = jnp.stack([jnp.asarray(c.get_proj_view(W / H)) for c in cams])
    poss = jnp.stack([jnp.asarray(c.location) for c in cams])
    tans = np.array([c.tan_fov(W, H, train=True) for c in cams], np.float32)
    txs, tys = jnp.asarray(tans[:, 0]), jnp.asarray(tans[:, 1])
    bgs = jnp.asarray(rng.uniform(0, 1, (3, 3)).astype(np.float32))
    truths = jnp.asarray(rng.uniform(0, 1, (3, H, W, 3)).astype(np.float32))
    truth_tiles = jax.vmap(lambda im: image_to_tiles_cm(im, TILE))(truths)

    loss_b, g_b, var_b, res_b, num_dup = render_train_grads_batch(
        *params, active, views, pvs, poss, txs, tys, W, H,
        truth_tiles, bgs, 1, tile=TILE, max_dup=2**12, interpret=True,
    )

    assert int(num_dup) > 0
    loss_s = 0.0
    g_s = None
    var_s = jnp.zeros((params[0].shape[0],), jnp.float32)
    for i in range(3):
        li, gi, ri = render_train_grads(
            *params, active, views[i], pvs[i], poss[i], txs[i], tys[i],
            W, H, truth_tiles[i], bgs[i], 1,
            tile=TILE, max_dup=2**12, interpret=True,
        )
        loss_s = loss_s + li
        g_s = gi if g_s is None else jax.tree.map(jnp.add, g_s, gi)
        var_s = var_s + jnp.linalg.norm(gi[0], axis=-1)
        np.testing.assert_allclose(
            np.asarray(res_b[i]), np.asarray(ri), atol=1e-6,
            err_msg=f"residual mismatch frame {i}",
        )

    np.testing.assert_allclose(float(loss_b), float(loss_s), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(var_b), np.asarray(var_s), atol=1e-6, rtol=1e-5
    )
    names = ["means", "shs", "scales", "opacities", "rotations"]
    for name, a, b in zip(names, g_b, g_s):
        scale = max(1e-3, float(jnp.max(jnp.abs(b))))
        # 3e-5: the scatter-free duplicate reduction sums via a GLOBAL
        # cumsum whose prefix crosses frame boundaries in the batch —
        # prefix-difference rounding differs from the per-frame runs by
        # O(prefix * 2^-24), far below the MC truth noise training sees
        np.testing.assert_allclose(
            np.asarray(a) / scale, np.asarray(b) / scale, atol=3e-5,
            err_msg=f"batched gradient mismatch: {name}",
        )


@pytest.mark.slow  # deselected by default (pyproject addopts); run with -m slow
def test_fused_train_grads_mid_scale():
    """Mid-scale parity (5k splats, 256^2, tile 32): every tile's segment
    spans many chunks, exercising the per-tile chunk loop, the direct
    gradient-column writes and the packed-cummax binning (binning.py) at
    depths the 64^2 toy cases never reach."""
    from gaussian_splatterer_tpu.ops.raster_tiled import (
        image_to_tiles,
        image_to_tiles_cm,
        render_tiled_tiles,
        render_train_grads,
    )

    w = h = 256
    tile = 32
    n = 5000
    params_all = random_splats(n, seed=17, cap=n + 120)  # padded capacity
    params, active = params_all[:5], params_all[5]
    cam = Camera(
        np.array([0.4, -0.3, -7.0], np.float32), np.zeros(3, np.float32), 60.0
    )
    view = jnp.asarray(cam.get_view())
    pv = jnp.asarray(cam.get_proj_view(w / h))
    tx, ty = cam.tan_fov(w, h, train=True)
    pos = jnp.asarray(cam.location)
    bg = jnp.asarray([0.2, 0.4, 0.1], jnp.float32)
    truth = jnp.asarray(
        np.random.default_rng(8).uniform(0, 1, (h, w, 3)).astype(np.float32)
    )
    truth_tiles = image_to_tiles(truth, tile)
    max_dup = 2**15

    def render_fn(p):
        return render_tiled_tiles(
            *p, active, view, pv, pos, tx, ty, w, h, bg, 1, 1.0,
            tile=tile, max_dup=max_dup, interpret=True,
        )

    img_tiles, pull = jax.vjp(render_fn, params)
    residual = truth_tiles - img_tiles
    g_ref = pull(residual)[0]
    loss_ref = jnp.mean(jnp.square(residual))

    loss_f, g_fused, res4 = render_train_grads(
        *params, active, view, pv, pos, tx, ty, w, h,
        image_to_tiles_cm(truth, tile), bg, 1,
        tile=tile, max_dup=max_dup, interpret=True,
    )

    # sanity: the scene must actually be deep enough to multi-chunk
    from gaussian_splatterer_tpu.ops.binning import bin_splats
    from gaussian_splatterer_tpu.ops.transforms import project_splat_components

    proj = project_splat_components(
        *params, active, view, pv, pos, tx, ty, w, h, 1, 1.0
    )
    bins = bin_splats(proj, w, h, tile, max_dup)
    per_tile = np.asarray(bins.tile_end - bins.tile_start)
    assert int(per_tile.max()) > 256, "scene too shallow for a mid-scale case"

    np.testing.assert_allclose(float(loss_f), float(loss_ref), rtol=1e-5)
    # 2e-3 abs on residuals: at ~500-deep tiles a handful of pixels sit on
    # the T_EPS early-termination knife edge, where one-ulp cumsum rounding
    # differences flip the last kept splat between the two paths
    np.testing.assert_allclose(
        np.asarray(res4[:, 0:3, :]),
        np.asarray(residual).transpose(0, 2, 1),
        atol=2e-3,
    )
    names = ["means", "shs", "scales", "opacities", "rotations"]
    for name, a, b in zip(names, g_fused, g_ref):
        scale = max(1e-3, float(jnp.max(jnp.abs(b))))
        np.testing.assert_allclose(
            np.asarray(a) / scale, np.asarray(b) / scale, atol=2e-4,
            err_msg=f"mid-scale fused gradient mismatch: {name}",
        )


def test_tile_cm_roundtrip():
    from gaussian_splatterer_tpu.ops.raster_tiled import (
        image_to_tiles_cm,
        tiles_cm_to_image,
    )

    rng = np.random.default_rng(2)
    img = jnp.asarray(rng.uniform(0, 1, (64, 96, 3)).astype(np.float32))
    tiles = image_to_tiles_cm(img, 16)
    assert tiles.shape == (4 * 6, 4, 256)
    assert float(jnp.abs(tiles[:, 3:, :]).max()) == 0.0
    back = tiles_cm_to_image(tiles, 96, 64, 16)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(img))


def test_mip_antialias_option():
    """aa=True (mip-splatting compensation, BEYOND reference parity) keeps
    tiled == oracle, fades sub-pixel splats, and leaves large splats and
    the default path untouched."""
    params = random_splats(40, 7)
    view, pv, pos, tx, ty = cam_args()
    bg = jnp.zeros(3, jnp.float32)

    base = render_tiled(*params, view, pv, pos, tx, ty, W, H, bg, 1, 1.0,
                        tile=TILE, max_dup=2**13, interpret=True)
    img_aa = render_tiled(*params, view, pv, pos, tx, ty, W, H, bg, 1, 1.0,
                          tile=TILE, max_dup=2**13, interpret=True, aa=True)
    oracle_aa = render_oracle(*params, view, pv, pos, tx, ty, W, H, bg, 1,
                              1.0, row_chunk=16, tile_cull=TILE, aa=True)
    np.testing.assert_allclose(
        np.asarray(img_aa), np.asarray(oracle_aa), atol=1e-5
    )
    # default path unchanged by the new code path
    base2 = render_tiled(*params, view, pv, pos, tx, ty, W, H, bg, 1, 1.0,
                         tile=TILE, max_dup=2**13, interpret=True, aa=False)
    np.testing.assert_array_equal(np.asarray(base), np.asarray(base2))

    # a sub-pixel splat (tiny world scale) must fade under aa
    means, shs, scales, opac, rot, active = random_splats(1, 0)
    tiny = (means, shs, jnp.full_like(scales, 1e-3), jnp.ones_like(opac),
            rot, active)
    on = render_tiled(*tiny[:5], tiny[5], view, pv, pos, tx, ty, W, H, bg,
                      1, 1.0, tile=TILE, max_dup=2**10, interpret=True,
                      aa=True)
    off = render_tiled(*tiny[:5], tiny[5], view, pv, pos, tx, ty, W, H, bg,
                       1, 1.0, tile=TILE, max_dup=2**10, interpret=True)
    assert float(jnp.max(on)) < 0.5 * max(float(jnp.max(off)), 1e-6)


def test_all_train_options_compose():
    """band + mip AA + a small chunk together: the two half-image bands'
    gradient sums equal the full-image run with the default chunk (option
    interactions guard: each knob is tested alone elsewhere)."""
    from gaussian_splatterer_tpu.ops.raster_tiled import (
        image_to_tiles_cm,
        render_train_grads_batch,
    )

    W2 = H2 = 64
    params = random_splats(50, 17)[:5]
    active = random_splats(50, 17)[5]
    rng = np.random.default_rng(4)
    view, pv, pos, tx, ty = cam_args()
    views, pvs, poss = view[None], pv[None], jnp.asarray(pos)[None]
    txs = jnp.asarray(tx, jnp.float32)[None]
    tys = jnp.asarray(ty, jnp.float32)[None]
    bgs = jnp.asarray([[0.3, 0.2, 0.1]], jnp.float32)
    truths = jnp.asarray(rng.uniform(0, 1, (1, H2, W2, 3)).astype(np.float32))
    tt_full = jax.vmap(lambda im: image_to_tiles_cm(im, TILE))(truths)
    t_per_row = W2 // TILE

    def run_banded(y0, rows, **kw):
        lo = (int(y0) // TILE) * t_per_row
        hi = lo + (rows // TILE) * t_per_row
        return render_train_grads_batch(
            *params, active, views, pvs, poss, txs, tys, W2, H2,
            tt_full[:, lo:hi], bgs, 1, tile=TILE, max_dup=2**12,
            interpret=True, band=(jnp.float32(y0), rows), **kw,
        )

    full = render_train_grads_batch(
        *params, active, views, pvs, poss, txs, tys, W2, H2, tt_full, bgs, 1,
        tile=TILE, max_dup=2**12, interpret=True, aa=True,
    )
    bands = [run_banded(y0, H2 // 2, aa=True, chunk=8) for y0 in (0.0, H2 / 2)]
    summed = jax.tree.map(lambda a, b: a + b, bands[0][1], bands[1][1])
    np.testing.assert_allclose(
        float(bands[0][0] + bands[1][0]) / 2, float(full[0]), rtol=1e-5
    )
    for a, c in zip(jax.tree.leaves(full[1]), jax.tree.leaves(summed)):
        scale = max(1e-3, float(jnp.max(jnp.abs(a))))
        np.testing.assert_allclose(
            np.asarray(c) / scale, np.asarray(a) / scale, atol=5e-5
        )


def test_mip_aa_zero_scale_gradients_finite():
    """Regression: a splat whose scale the SGD clamp collapsed to 0 makes
    the AA compensation's det_raw exactly 0; sqrt(clip(x)) there
    backpropagates inf * 0 = NaN and poisoned whole --mip-aa training
    runs.  Gradients must stay finite (the degenerate splat fades with
    zero gradient)."""
    from gaussian_splatterer_tpu.ops.raster_tiled import (
        image_to_tiles_cm,
        render_train_grads_batch,
    )

    params = list(random_splats(8, 21)[:5])
    active = random_splats(8, 21)[5]
    params[2] = params[2].at[3].set(0.0)  # one fully-collapsed splat
    rng = np.random.default_rng(1)
    view, pv, pos, tx, ty = cam_args()
    views, pvs, poss = view[None], pv[None], jnp.asarray(pos)[None]
    txs = jnp.asarray(tx, jnp.float32)[None]
    tys = jnp.asarray(ty, jnp.float32)[None]
    bgs = jnp.asarray([[0.1, 0.2, 0.3]], jnp.float32)
    truths = jnp.asarray(rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32))
    tt = jax.vmap(lambda im: image_to_tiles_cm(im, TILE))(truths)

    loss, grads, var, _, _ = render_train_grads_batch(
        *params, active, views, pvs, poss, txs, tys, W, H, tt, bgs, 1,
        tile=TILE, max_dup=2**12, interpret=True, aa=True,
    )
    assert np.isfinite(float(loss))
    for g in jax.tree.leaves(grads):
        assert np.isfinite(np.asarray(g)).all(), "NaN gradient with aa=True"
    assert np.isfinite(np.asarray(var)).all()


@pytest.mark.parametrize("seed", [11, 23, 37])
def test_fused_path_random_config_fuzz(seed):
    """Config-space fuzz: random (tile, chunk, max_dup, sh_degree, splat
    count, camera) draws must keep the fused frame-batched path in
    agreement with the per-frame render + jax.vjp path.  Fixed combos are
    tested elsewhere; this guards the corners the grid misses (chunk >
    segment sizes, tiny dup buffers, degree-2 SH, off-center cameras)."""
    from gaussian_splatterer_tpu.ops.raster_tiled import (
        image_to_tiles,
        image_to_tiles_cm,
        render_tiled_tiles,
        render_train_grads_batch,
    )

    rng = np.random.default_rng(seed)
    tile = int(rng.choice([8, 16, 32]))
    chunk = int(rng.choice([32, 64, 128]))
    max_dup = int(rng.choice([512, 1024, 4096]))
    degree = int(rng.choice([1, 2]))
    n = int(rng.integers(5, 40))
    res = 64

    k = (degree + 1) ** 2
    cap = 64
    means = np.zeros((cap, 3), np.float32)
    means[:n] = rng.uniform(-2.5, 2.5, (n, 3))
    shs = np.zeros((cap, k, 3), np.float32)
    shs[:n] = rng.normal(0, 0.4, (n, k, 3))
    scales = np.zeros((cap, 3), np.float32)
    scales[:n] = rng.uniform(0.03, 0.5, (n, 3))
    opac = np.zeros((cap,), np.float32)
    opac[:n] = rng.uniform(0.2, 1.0, n)
    rot = np.zeros((cap, 4), np.float32)
    rot[:, 0] = 1.0
    rot[:n] = rng.normal(0, 1, (n, 4))
    active = jnp.asarray(np.arange(cap) < n)
    params = tuple(map(jnp.asarray, (means, shs, scales, opac, rot)))

    cam = Camera(
        rng.uniform(-1, 1, 3).astype(np.float32)
        + np.array([0, 0, -7], np.float32),
        rng.uniform(-0.3, 0.3, 3).astype(np.float32),
        float(rng.uniform(40, 80)),
    )
    view = jnp.asarray(cam.get_view())
    pv = jnp.asarray(cam.get_proj_view(1.0))
    tx, ty = cam.tan_fov(res, res, train=True)
    truth = jnp.asarray(rng.uniform(0, 1, (res, res, 3)).astype(np.float32))
    tt = image_to_tiles_cm(truth, tile)
    bg = jnp.asarray(rng.uniform(0, 1, 3).astype(np.float32))

    loss_f, grads_f, _, _, nd = render_train_grads_batch(
        *params, active, view[None], pv[None], jnp.asarray(cam.location)[None],
        jnp.asarray(tx, jnp.float32)[None], jnp.asarray(ty, jnp.float32)[None],
        res, res, tt[None], bg[None], degree,
        tile=tile, chunk=chunk, max_dup=max_dup, interpret=True,
    )
    assert int(nd) <= max_dup, "fuzz draw overflowed; shrink the scene"

    # reference: tile-space render + jax.vjp with residual cotangent
    def render_fn(p):
        return render_tiled_tiles(
            *p, active, view, pv, jnp.asarray(cam.location), tx, ty,
            res, res, bg, degree, 1.0,
            tile=tile, chunk=chunk, max_dup=max_dup, interpret=True,
        )

    img_tiles, pull = jax.vjp(render_fn, params)
    residual = image_to_tiles(truth, tile) - img_tiles
    grads_r = pull(residual)[0]
    loss_r = jnp.mean(jnp.square(residual))
    np.testing.assert_allclose(float(loss_f), float(loss_r), rtol=1e-4)
    for a, b in zip(jax.tree.leaves(grads_f), jax.tree.leaves(grads_r)):
        scale = max(1e-3, float(jnp.max(jnp.abs(b))))
        np.testing.assert_allclose(
            np.asarray(a) / scale, np.asarray(b) / scale, atol=2e-4,
            err_msg=f"config tile={tile} chunk={chunk} max_dup={max_dup} "
                    f"degree={degree} n={n}",
        )
