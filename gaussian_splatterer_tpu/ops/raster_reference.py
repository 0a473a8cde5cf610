"""Oracle rasterizer: slow, exact, per-pixel, fully differentiable.

Every pixel evaluates every splat (depth-sorted), so this is the numerical
ground truth for the tiled fast path (BASELINE config 1: "1k splats,
256x256, CPU, allclose").  It replaces the sequential front-to-back alpha
loop of a CUDA rasterizer with a **scan-free** formulation in plain jnp:

    T_k   = prod_{j<k} (1 - a_j)       == exp(cumsum(log1p(-a)))
    out   = sum_k  c_k * a_k * T_k  +  bg * T_final

with the INRIA-compatible masking rules (skip when power > 0, alpha below
1/255; terminate the pixel when transmittance would drop below 1e-4).
The early-termination test is exact: a splat whose contribution would push
T below the threshold is dropped *and* freezes T, which is reproduced by
masking alphas with the cumulative trigger before re-accumulating.

Because the whole function is pure jnp, ``jax.grad`` provides the backward
pass with exactly these semantics (masked splats contribute no gradient,
clamped SH colors have zero gradient, etc.).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gaussian_splatterer_tpu.ops.transforms import (
    ALPHA_MAX,
    ALPHA_MIN,
    T_EPS,
    ProjectedSplats,
    project_splats,
)


def composite_pixels(
    pix_xy: jax.Array,  # (P, 2) float pixel coordinates
    splats: ProjectedSplats,  # depth-sorted, padded
    background: jax.Array,  # (3,)
    tile_cull: int = 0,
) -> jax.Array:
    """Alpha-composite all splats into P pixels over ``background``; see
    composite_pixels_ct."""
    color, t_final = composite_pixels_ct(pix_xy, splats, tile_cull)
    return color + t_final[:, None] * background[None, :]


def composite_pixels_ct(
    pix_xy: jax.Array,  # (P, 2) float pixel coordinates
    splats: ProjectedSplats,  # depth-sorted, padded
    tile_cull: int = 0,
):
    """(P, 3) composited colour and (P,) final transmittance of P pixels.
    Splats MUST be sorted front-to-back (ascending depth) with invalid
    entries pushed to the end.

    ``tile_cull > 0`` emulates the tile-granular splat cutoff of the binned
    fast path (a splat only touches pixels whose tile intersects its
    radius-based tile AABB) — the INRIA-reference semantic."""
    d = pix_xy[:, None, :] - splats.mean2d[None, :, :]  # (P, N, 2)
    dx, dy = d[..., 0], d[..., 1]
    conic = splats.conic
    power = (
        -0.5 * (conic[None, :, 0] * dx * dx + conic[None, :, 2] * dy * dy)
        - conic[None, :, 1] * dx * dy
    )
    alpha = jnp.minimum(ALPHA_MAX, splats.opacity[None, :] * jnp.exp(power))
    contrib = (power <= 0.0) & (alpha >= ALPHA_MIN) & splats.valid[None, :]
    if tile_cull:
        from gaussian_splatterer_tpu.ops.binning import tile_aabb

        big = 1 << 20  # unclipped tile grid; clipping happens via pixel coords
        x0, y0, x1, y1 = tile_aabb(
            jax.lax.stop_gradient(splats.mean2d[:, 0]),
            jax.lax.stop_gradient(splats.mean2d[:, 1]),
            jax.lax.stop_gradient(splats.rx),
            jax.lax.stop_gradient(splats.ry),
            tile_cull, big, big,
        )
        ptx = (pix_xy[:, 0:1] // tile_cull).astype(jnp.int32)  # (P, 1)
        pty = (pix_xy[:, 1:2] // tile_cull).astype(jnp.int32)
        contrib = contrib & (
            (ptx >= x0[None, :]) & (ptx < x1[None, :])
            & (pty >= y0[None, :]) & (pty < y1[None, :])
        )
    a = jnp.where(contrib, alpha, 0.0)

    logs = jnp.log1p(-a)
    t_excl = jnp.exp(jnp.cumsum(logs, axis=1) - logs)  # exclusive cumprod
    trigger = t_excl * (1.0 - a) < T_EPS
    keep = ~jax.lax.cummax(trigger.astype(jnp.int32), axis=1).astype(bool)
    a_eff = a * keep

    logs_eff = jnp.log1p(-a_eff)
    cum = jnp.cumsum(logs_eff, axis=1)
    t_excl_eff = jnp.exp(cum - logs_eff)
    w = a_eff * t_excl_eff  # (P, N)
    # full f32 even where the default matmul precision is TF32
    color = jnp.dot(w, splats.color, precision=jax.lax.Precision.HIGHEST)
    t_final = jnp.exp(cum[:, -1])
    return color, t_final


def sort_splats_front_to_back(splats: ProjectedSplats) -> ProjectedSplats:
    depth_key = jnp.where(splats.valid, splats.depth, jnp.inf)
    order = jnp.argsort(depth_key)
    return jax.tree.map(lambda x: x[order], splats)


def render_oracle(
    means,
    shs,
    scales,
    opacities,
    rotations,
    active,
    view,
    proj_view,
    cam_pos,
    tan_fovx,
    tan_fovy,
    width: int,
    height: int,
    background,
    sh_degree: int,
    scale_mod=1.0,
    row_chunk: int = 32,
    tile_cull: int = 0,
    aa: bool = False,
) -> jax.Array:
    """Render (H, W, 3) float32. Differentiable w.r.t. all splat params.

    ``row_chunk`` rows of pixels are processed per scan step to bound the
    (P, N) intermediate to row_chunk*W*N floats.  ``tile_cull`` emulates the
    fast path's tile-granular cutoff (see composite_pixels).
    """
    splats = project_splats(
        means, shs, scales, opacities, rotations, active,
        view, proj_view, cam_pos, tan_fovx, tan_fovy,
        width, height, sh_degree, scale_mod, aa=aa,
    )
    splats = sort_splats_front_to_back(splats)
    background = jnp.asarray(background, jnp.float32)

    assert height % row_chunk == 0, "row_chunk must divide image height"
    xs = jnp.arange(width, dtype=jnp.float32)

    def render_rows(y0):
        ys = y0 + jnp.arange(row_chunk, dtype=jnp.float32)
        gx, gy = jnp.meshgrid(xs, ys)  # (row_chunk, W)
        pix = jnp.stack([gx.ravel(), gy.ravel()], -1)
        return composite_pixels(pix, splats, background, tile_cull).reshape(
            row_chunk, width, 3
        )

    y0s = jnp.arange(0, height, row_chunk, dtype=jnp.float32)
    rows = jax.lax.map(render_rows, y0s)  # (H/rc, rc, W, 3)
    return rows.reshape(height, width, 3)


def render_oracle_model(model, camera, width, height, background, scale_mod=1.0,
                        train_fov: bool = True, row_chunk: int = 32):
    """Convenience wrapper taking a SplatModel + Camera (host-side matrices)."""
    view = jnp.asarray(camera.get_view())
    proj_view = jnp.asarray(camera.get_proj_view(width / height))
    tan_fovx, tan_fovy = camera.tan_fov(width, height, train=train_fov)
    return render_oracle(
        model.means, model.shs, model.scales, model.opacities, model.rotations,
        model.active_mask(), view, proj_view, jnp.asarray(camera.location),
        tan_fovx, tan_fovy, width, height, background, model.sh_degree, scale_mod,
        row_chunk=row_chunk,
    )


def composite_tiles_reference(
    feat9,  # (9, D) duplicate features, rows [mx, my, ca, cb, cc, r, g, b, op]
    tile_start,  # (T,) global first duplicate of each tile
    tile_end,  # (T,) one past its last
    *,
    tile: int,
    tx_tiles: int,
    tiles_frame: int,
    depth: int,
    batch: int = 64,
):
    """Plain-jnp tiled compositor with the compositing kernels' interface:
    every tile composites its own depth-ordered segment, padded to a static
    ``depth`` (segments longer than ``depth`` are cut, so pass at least the
    deepest tile's length).  Returns (T, 4, P) rows [r, g, b, T_final].

    The per-tile math is composite_pixels' exact front-to-back form, so
    this is both the kernels' numerical reference at real segment depths
    and what XLA alone makes of the compositing stage (its gradient w.r.t.
    ``feat9`` comes from jax autodiff)."""
    num_tiles = tile_start.shape[0]
    p = jnp.arange(tile * tile, dtype=jnp.int32)
    lane = jnp.arange(depth, dtype=jnp.int32)
    pad = -num_tiles % batch

    def one_tile(t, start, end):
        t_img = t % tiles_frame
        px = ((t_img % tx_tiles) * tile + p % tile).astype(jnp.float32)
        py = ((t_img // tx_tiles) * tile + p // tile).astype(jnp.float32)
        idx = start + lane
        ok = idx < end
        f = feat9[:, jnp.clip(idx, 0, feat9.shape[1] - 1)]
        splats = ProjectedSplats(
            mean2d=f[0:2].T, conic=f[2:5].T, color=f[5:8].T, opacity=f[8],
            depth=jnp.zeros((depth,), jnp.float32),
            radius=jnp.zeros((depth,), jnp.float32),
            rx=jnp.zeros((depth,), jnp.float32),
            ry=jnp.zeros((depth,), jnp.float32), valid=ok,
        )
        rgb, t_fin = composite_pixels_ct(jnp.stack([px, py], axis=-1), splats)
        return jnp.concatenate([rgb.T, t_fin[None, :]], axis=0)  # (4, P)

    ts = jnp.concatenate([tile_start, jnp.zeros((pad,), tile_start.dtype)])
    te = jnp.concatenate([tile_end, jnp.zeros((pad,), tile_end.dtype)])
    ids = jnp.arange(num_tiles + pad, dtype=jnp.int32)
    # rematerialized per batch: a gradient through the map then keeps one
    # batch of (P, depth) intermediates alive, not all of them
    out = jax.lax.map(
        jax.checkpoint(lambda xs: jax.vmap(one_tile)(*xs)),
        (ids.reshape(-1, batch), ts.reshape(-1, batch), te.reshape(-1, batch)),
    )
    return out.reshape(num_tiles + pad, 4, tile * tile)[:num_tiles]
