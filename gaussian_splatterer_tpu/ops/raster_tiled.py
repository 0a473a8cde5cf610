"""Tiled differentiable rasterizer: Triton compositing kernels (Pallas).

GPU replacement for the INRIA ``CudaRasterizer::Rasterizer::forward/
backward`` pair the reference links against (call sites
src/Trainer.cu:334-412).  Pipeline:

  project_splat_components (dense jnp, transforms.py)
    -> bin_splats / bin_splats_batch (depth sort + stable tile sort, binning.py)
    -> feature gather: (9, D) duplicate columns in per-tile depth order
       (differentiable on the serve path; its transpose is the scatter-add
       that accumulates duplicate gradients back per splat)
    -> Pallas kernel on the Triton route, ONE PROGRAM PER (frame, tile): the
       program reads its own [tile_start, tile_end) duplicate segment and
       walks it front to back in chunks of ``chunk`` splats, leaving the loop
       once every pixel of the tile is saturated — the shape of the public
       CUDA rasterizer (one block per tile, splats batched through fast
       memory, early exit).

Compositing math (identical to the oracle, ops/raster_reference.py):
    T_k = prod_{j<k} (1 - a_j);  out = sum_k c_k a_k T_k + bg * T_final
with INRIA masking: skip when power > 0 or alpha < 1/255, clamp alpha at
0.99, and permanently terminate a pixel when T would drop below 1e-4.
Inside a chunk the product is exp(cumsum(log1p(-a))) along the splat axis,
carried across chunks as the per-pixel entry transmittance.

The backward pass is an analytic forward-order replay (no per-splat state
saved):  with S_k = sum_{j>k} c_j a_j T_j = C_total - C_{<=k},
    dL/dc_k     = g * a_k T_k
    dL/da_k     = sum_ch g_ch (c_k T_k - S_k/(1-a_k)) - g_T T_N/(1-a_k)
then chain to opacity / conic / mean2d.  Every pixel sum is a plain f32
reduction (no dot, so no TF32 rounding).  Each duplicate column belongs to
exactly one (frame, tile), so the replay writes its gradient columns
directly; the per-splat reduction of those columns is plain XLA
(_dup_grads_to_rows).

One kernel pair serves everything: _fwd_kernel/_bwd_kernel behind a
custom VJP for renders, previews and evaluation, and the same pair around
an XLA residual for training (composite_train).  A single fused
forward + residual + replay program measured slower on the H100 (the
split pair keeps fewer values live per thread; PERF.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gaussian_splatterer_tpu.ops.binning import bin_splats, bin_splats_batch
from gaussian_splatterer_tpu.ops.transforms import (
    ALPHA_MAX,
    ALPHA_MIN,
    T_EPS,
    project_splat_components,
)

# feature row layout of the packed (9, D) duplicate array
_F_MX, _F_MY, _F_CA, _F_CB, _F_CC, _F_CR, _F_CG, _F_CB2, _F_OP = range(9)
_F_ROWS = 9
_C_ROWS = 4  # channel-major truth/residual tiles (T, 4, P): rgb in rows
# 0-2 (truth; row 3 zero) / rgb + t_final (residual, serve output)

_interpret_all = False


def set_interpret(on: bool) -> None:
    """Process-wide switch: run every compositing kernel in the Pallas
    interpreter.  Only the CPU test suite sets it (tests/conftest.py)."""
    global _interpret_all
    _interpret_all = bool(on)


def _use_interpret(interpret: bool) -> bool:
    """Interpret mode only on explicit request; otherwise the platform must
    have the compiled kernels (CUDA GPUs, Triton route)."""
    if interpret or _interpret_all:
        return True
    platform = jax.default_backend()
    if platform != "gpu":
        raise RuntimeError(
            f"no compositing kernel for platform {platform!r}: the "
            "rasterizer's kernels are Pallas Triton kernels for CUDA GPUs "
            "(tests run them in the interpreter via interpret=True or "
            "raster_tiled.set_interpret(True))"
        )
    return False


def _num_warps(p_count: int, chunk: int) -> int:
    """Warps per program: ~16 (pixel, splat) pairs per thread, 4..16 (the
    fastest ratio measured on the H100, PERF.md)."""
    return int(min(16, max(4, (p_count * chunk) // 512)))


def _tile_pixels(t_img, tile: int, tx_tiles: int):
    """(P,) f32 pixel-center coordinates of tile ``t_img``, row-major."""
    p = jax.lax.broadcasted_iota(jnp.int32, (tile * tile,), 0)
    ox = (t_img % tx_tiles) * tile
    oy = (t_img // tx_tiles) * tile
    px = (ox + p % tile).astype(jnp.float32)
    py = (oy + p // tile).astype(jnp.float32)
    return px, py


def _load_chunk(feat_ref, off, ok, chunk: int):
    """The nine (chunk,) feature rows of duplicates [off, off + chunk);
    columns outside the segment (``ok`` False) read as zero."""
    return tuple(
        plgpu.load(feat_ref.at[k, pl.ds(off, chunk)], mask=ok, other=0.0)
        for k in range(_F_ROWS)
    )


def _chunk_alpha(f, px, py, ok):
    """(P, C) per-(pixel, splat) alpha with the INRIA masks, plus what the
    gradient replay needs."""
    mx, my, ca, cb, cc = (r[None, :] for r in f[_F_MX : _F_CC + 1])
    op = f[_F_OP][None, :]
    dx = px[:, None] - mx
    dy = py[:, None] - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    expp = jnp.exp(power)
    alpha_raw = op * expp
    alpha = jnp.minimum(ALPHA_MAX, alpha_raw)
    contrib = (power <= 0.0) & (alpha >= ALPHA_MIN) & ok[None, :]
    a = jnp.where(contrib, alpha, 0.0)
    return a, contrib, alpha_raw, expp, dx, dy


def _composite_chunk(a, t_in, alive, last):
    """Front-to-back compositing of one chunk given the (P,) entry
    transmittance ``t_in`` and alive mask.

    The INRIA termination test at splat k is T_k (1 - a_k) >= eps with T
    non-increasing, so the first failure ends the pixel and ``keep`` is a
    prefix mask: on it the raw prefix transmittance is the effective one.
    Returns (weight, t_excl, a_eff, keep, t_out, alive_out)."""
    logs = jnp.log1p(-a)
    cum = jnp.cumsum(logs, axis=1)
    t_excl = t_in[:, None] * jnp.exp(cum - logs)
    t_incl = t_excl * (1.0 - a)
    keep = (t_incl >= T_EPS) & (alive[:, None] > 0.0)
    a_eff = jnp.where(keep, a, 0.0)
    weight = a_eff * t_excl
    # terminal T: raw T at the last kept splat (t_in when none kept)
    t_out = jnp.min(jnp.where(keep, t_incl, t_in[:, None]), axis=1)
    t_last = jnp.sum(jnp.where(last[None, :], t_incl, 0.0), axis=1)
    alive_out = jnp.where((t_last >= T_EPS) & (alive > 0.0), 1.0, 0.0)
    return weight, t_excl, a_eff, keep, t_out, alive_out


def _forward_segment(feat_ref, start, end, px, py, chunk: int):
    """Composite the segment [start, end) into (P,) colour and T_final,
    stopping once no pixel of the tile is alive."""
    p_count = px.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (chunk,), 0)
    last = lane == chunk - 1
    n_chunks = (end - start + chunk - 1) // chunk

    def cond(carry):
        return (carry[0] < n_chunks) & (carry[-1] > 0)

    def body(carry):
        i, c_r, c_g, c_b, t, alive, _ = carry
        off = start + i * chunk
        ok = off + lane < end
        f = _load_chunk(feat_ref, off, ok, chunk)
        a = _chunk_alpha(f, px, py, ok)[0]
        weight, _, _, _, t_out, alive_out = _composite_chunk(a, t, alive, last)
        c_r = c_r + jnp.sum(weight * f[_F_CR][None, :], axis=1)
        c_g = c_g + jnp.sum(weight * f[_F_CG][None, :], axis=1)
        c_b = c_b + jnp.sum(weight * f[_F_CB2][None, :], axis=1)
        any_alive = (jnp.max(alive_out) > 0.0).astype(jnp.int32)
        return i + 1, c_r, c_g, c_b, t_out, alive_out, any_alive

    zeros = jnp.zeros((p_count,), jnp.float32)
    ones = jnp.ones((p_count,), jnp.float32)
    _, c_r, c_g, c_b, t_n, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), zeros, zeros, zeros, ones, ones, jnp.int32(1))
    )
    return c_r, c_g, c_b, t_n


def _replay_segment(feat_ref, dfeat_ref, start, end, px, py, g, g_t, g_ctot,
                    t_n, chunk: int):
    """Gradient replay of the segment [start, end) for the per-pixel colour
    gradient ``g`` = (g_r, g_g, g_b) and T_final gradient ``g_t``; writes the
    (9, chunk) gradient columns of every visited chunk into ``dfeat_ref``.
    Chunks after the tile saturates have zero gradient and are skipped
    (the output buffer arrives zeroed)."""
    g_r, g_g, g_b = g
    p_count = px.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (chunk,), 0)
    last = lane == chunk - 1
    n_chunks = (end - start + chunk - 1) // chunk
    g_tn = g_t * t_n

    def cond(carry):
        return (carry[0] < n_chunks) & (carry[-1] > 0)

    def body(carry):
        i, gc_in, t, alive, _ = carry
        off = start + i * chunk
        ok = off + lane < end
        f = _load_chunk(feat_ref, off, ok, chunk)
        a, contrib, alpha_raw, expp, dx, dy = _chunk_alpha(f, px, py, ok)
        weight, t_k, a_eff, keep, t_out, alive_out = _composite_chunk(
            a, t, alive, last
        )
        # S_k = C_total - C_{<=k}: the pixel gradient is constant per pixel,
        # so sum_ch g_ch S_k,ch is ONE prefix sum of g . (weight * c)
        gc = (
            g_r[:, None] * f[_F_CR][None, :]
            + g_g[:, None] * f[_F_CG][None, :]
            + g_b[:, None] * f[_F_CB2][None, :]
        )
        gwc = weight * gc
        g_s = g_ctot[:, None] - (gc_in[:, None] + jnp.cumsum(gwc, axis=1))
        d_alpha = gc * t_k - (g_s + g_tn[:, None]) / (1.0 - a_eff)
        grad_mask = keep & contrib & (alpha_raw < ALPHA_MAX)
        d_alpha = jnp.where(grad_mask, d_alpha, 0.0)
        d_power = d_alpha * alpha_raw
        # power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy with dx = px - mx
        s_x = jnp.sum(d_power * dx, axis=0)
        s_y = jnp.sum(d_power * dy, axis=0)
        ca, cb, cc = f[_F_CA], f[_F_CB], f[_F_CC]
        rows = (
            ca * s_x + cb * s_y,  # d mx
            cc * s_y + cb * s_x,  # d my
            -0.5 * jnp.sum(d_power * dx * dx, axis=0),  # d ca
            -jnp.sum(d_power * dx * dy, axis=0),  # d cb
            -0.5 * jnp.sum(d_power * dy * dy, axis=0),  # d cc
            jnp.sum(g_r[:, None] * weight, axis=0),  # d cr
            jnp.sum(g_g[:, None] * weight, axis=0),  # d cg
            jnp.sum(g_b[:, None] * weight, axis=0),  # d cb2
            jnp.sum(d_alpha * expp, axis=0),  # d opacity
        )
        for k, row in enumerate(rows):
            plgpu.store(dfeat_ref.at[k, pl.ds(off, chunk)], row, mask=ok)
        gc_in = gc_in + jnp.sum(gwc, axis=1)
        any_alive = (jnp.max(alive_out) > 0.0).astype(jnp.int32)
        return i + 1, gc_in, t_out, alive_out, any_alive

    zeros = jnp.zeros((p_count,), jnp.float32)
    ones = jnp.ones((p_count,), jnp.float32)
    jax.lax.while_loop(
        cond, body, (jnp.int32(0), zeros, ones, ones, jnp.int32(1))
    )


def _fwd_kernel(ts_ref, te_ref, feat_ref, out_ref, *, tile, tx_tiles,
                tiles_frame, chunk):
    """Serve forward: out rows [r, g, b, T_final] (background not applied)."""
    t = pl.program_id(0)
    px, py = _tile_pixels(t % tiles_frame, tile, tx_tiles)
    outs = _forward_segment(feat_ref, ts_ref[t], te_ref[t], px, py, chunk)
    for ch, v in enumerate(outs):
        out_ref[t, ch, :] = v


def _bwd_kernel(ts_ref, te_ref, feat_ref, gin_ref, fwd_ref, _dz_ref,
                dfeat_ref, *, tile, tx_tiles, tiles_frame, chunk):
    """Serve backward: gin rows [d r, d g, d b, d T_final] against the
    forward output rows [r, g, b, T_final]."""
    t = pl.program_id(0)
    px, py = _tile_pixels(t % tiles_frame, tile, tx_tiles)
    g = tuple(gin_ref[t, ch, :] for ch in range(3))
    c_tot = tuple(fwd_ref[t, ch, :] for ch in range(3))
    g_ctot = g[0] * c_tot[0] + g[1] * c_tot[1] + g[2] * c_tot[2]
    _replay_segment(
        feat_ref, dfeat_ref, ts_ref[t], te_ref[t], px, py, g,
        gin_ref[t, 3, :], g_ctot, fwd_ref[t, 3, :], chunk,
    )


def _launch(kernel, out_shape, args, *, p_count, chunk, interpret, aliases,
            **kw):
    return pl.pallas_call(
        functools.partial(kernel, chunk=chunk, **kw),
        out_shape=out_shape,
        grid=(args[0].shape[0],),
        input_output_aliases=aliases,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(p_count, chunk), num_stages=1
        ),
        interpret=interpret,
        name=kernel.__name__.lstrip("_"),
    )(*args)


def composite_forward(feat9, tile_start, tile_end, *, tile, tx_tiles,
                      tiles_frame, chunk, interpret=False):
    """(9, D) features + global per-tile [start, end) -> (T, 4, P) rows
    [r, g, b, T_final] for every tile of the flattened (frame, tile) grid."""
    p_count = tile * tile
    return _launch(
        _fwd_kernel,
        jax.ShapeDtypeStruct((tile_start.shape[0], _C_ROWS, p_count), jnp.float32),
        (tile_start, tile_end, feat9),
        p_count=p_count, chunk=chunk, interpret=_use_interpret(interpret),
        aliases={}, tile=tile, tx_tiles=tx_tiles, tiles_frame=tiles_frame,
    )


def composite_backward(feat9, tile_start, tile_end, out, gin, *, tile,
                       tx_tiles, tiles_frame, chunk, interpret=False):
    """Per-duplicate (9, D) gradients for the (T, 4, P) output gradient
    ``gin`` of composite_forward's output ``out``."""
    p_count = tile * tile
    return _launch(
        _bwd_kernel,
        jax.ShapeDtypeStruct(feat9.shape, jnp.float32),
        (tile_start, tile_end, feat9, gin, out, jnp.zeros_like(feat9)),
        p_count=p_count, chunk=chunk, interpret=_use_interpret(interpret),
        aliases={5: 0}, tile=tile, tx_tiles=tx_tiles, tiles_frame=tiles_frame,
    )


def composite_train(feat9, tile_start, tile_end, truth_tiles, bg4, *, tile,
                    tx_tiles, tiles_frame, chunk, interpret=False):
    """Training composite over the flattened (frame, tile) grid: serve
    forward kernel, the signed residual truth - render against each
    frame's background in XLA (reference semantics src/Trainer.cu:33-44),
    then the backward kernel with the residual as the pixel gradient (the
    negative L2 gradient).

    truth_tiles (T, 4, P) channel-major, bg4 (F, 4) per-frame background.
    Returns (res (T, 4, P) rows [residual rgb, T_final], d_feat9 (9, D))."""
    kw = dict(tile=tile, tx_tiles=tx_tiles, tiles_frame=tiles_frame,
              chunk=chunk, interpret=interpret)
    out = composite_forward(feat9, tile_start, tile_end, **kw)
    bg = jnp.repeat(bg4[:, :3], tiles_frame, axis=0)[:, :, None]  # (T, 3, 1)
    res = truth_tiles[:, :3] - (out[:, :3] + out[:, 3:4] * bg)
    gin = jnp.concatenate([res, jnp.sum(res * bg, axis=1, keepdims=True)], 1)
    d_feat9 = composite_backward(feat9, tile_start, tile_end, out, gin, **kw)
    return jnp.concatenate([res, out[:, 3:4]], axis=1), d_feat9


def _dup_grads_to_rows(d_feat9, bins, f, n_cap, max_dup):
    """Scatter-free duplicate-gradient reduction: (9, F*D) per-tile-sorted
    duplicate gradients -> (F, 9, N) per-splat row gradients.

    d_feat9 is per TILE-SORTED duplicate; carry it back to depth/presort
    order (where each splat's duplicates are CONTIGUOUS) as PAYLOADS of a
    batched key sort, cumsum per frame, take per-splat segment differences,
    and gather back to original row order."""
    d_3d = d_feat9.reshape(9, f, max_dup)  # tile-sorted per frame
    sorted_ops = jax.lax.sort(
        (bins.presort_pos,) + tuple(d_3d[k] for k in range(9)),
        num_keys=1,
        is_stable=False,  # keys are a permutation of 0..D-1: unique
    )
    d_pre9 = jnp.stack(sorted_ops[1:])  # (9, F, D)
    # PER-FRAME cumsums: a single global cumsum over the concatenated F*D
    # axis would make late frames' segment differences subtract two large
    # running sums (measured 5.5e-3 absolute noise on the densify variance
    # signal at 8 frames x 75k duplicates); per frame, single-device and
    # camera-sharded steps agree to reassociation noise.
    cs9 = jnp.cumsum(d_pre9, axis=2).reshape(9, f * max_dup)
    fD = f * max_dup
    # a segment starting at its OWN frame's first dup column has zero
    # prefix (frame-local cumsum).  The frame must come from the slot id,
    # not from seg_start % max_dup: when a frame's duplicates exactly
    # fill max_dup, its empty tail slots start at (j+1)*max_dup — a
    # modulo test would zero their prefix and dump the whole frame sum
    # onto the last slot's splat.
    slot_frame = jnp.arange(f * n_cap, dtype=jnp.int32) // n_cap
    frame_first = bins.seg_start_g == slot_frame * max_dup
    lo9 = jnp.where(
        ~frame_first[None, :],
        cs9[:, jnp.clip(bins.seg_start_g - 1, 0, fD - 1)],
        0.0,
    )
    # Depth-order segments tile the dup axis CONTIGUOUSLY (offs_excl[k+1]
    # == offs[k]; overflow-gated and empty segments collapse to equal
    # boundaries, and the cumsum is constant over each frame's tail slack
    # because out-of-range dup columns are exactly zero), so hi9[k] ==
    # lo9[k+1] — a shift replaces a second gather — EXCEPT each frame's
    # LAST depth slot, whose hi is its own frame's cumsum total.
    hi9 = jnp.concatenate([lo9[:, 1:], jnp.zeros((9, 1), jnp.float32)], axis=1)
    frame_totals = cs9.reshape(9, f, max_dup)[:, :, max_dup - 1]  # (9, F)
    hi9 = hi9.at[:, n_cap - 1 :: n_cap].set(frame_totals)
    seg9 = hi9 - lo9  # (9, F*N) per global depth slot
    d_rows9 = seg9[:, bins.inv_depth_flat]  # per original row id
    return jnp.moveaxis(d_rows9.reshape(9, f, n_cap), 0, 1)  # (F, 9, N)


def bin_frames(rows, comps_sg, width: int, height: int, tile: int,
               max_dup: int):
    """Bin F frames of projected splats and gather their duplicate
    features: (F, 9, N) rows + stop-gradient components ->
    (bins, feat9 (9, F*D), tile_start (F*T,), tile_end (F*T,)) with tile
    ranges global over the flattened (frame, duplicate) axis."""
    f, _, n_cap = rows.shape
    bins = bin_splats_batch(comps_sg, width, height, tile, max_dup)
    rows9 = jnp.moveaxis(rows, 0, 1).reshape(9, f * n_cap)
    feat9 = rows9[:, bins.gather_flat]  # (9, F*D) flat column gather
    dup_off = jnp.arange(f, dtype=jnp.int32)[:, None] * max_dup
    return (
        bins, feat9,
        (bins.tile_start + dup_off).reshape(-1),
        (bins.tile_end + dup_off).reshape(-1),
    )


def _composite_frames(rows, comps_sg, truth_tiles, backgrounds, width,
                      bin_height, tile, chunk, max_dup, interpret):
    """Shared core of the batched training entry points: bin the (F, 9, N)
    projected rows, composite every (frame, tile) against its truth, and
    reduce per-duplicate gradients to per-row ones.

    Returns (loss_sum, d_rows (F, 9, N), res (F, T, 4, P), num_dup)."""
    f, _, n_cap = rows.shape
    tx_tiles = -(-width // tile)
    num_tiles = tx_tiles * -(-bin_height // tile)
    p_count = tile * tile
    bins, feat9, tile_start, tile_end = bin_frames(
        rows, comps_sg, width, bin_height, tile, max_dup
    )
    bg4 = jnp.zeros((f, 4), jnp.float32).at[:, :3].set(
        jnp.asarray(backgrounds, jnp.float32)
    )
    res, d_feat9 = composite_train(
        feat9, tile_start, tile_end,
        truth_tiles.reshape(f * num_tiles, _C_ROWS, p_count),
        bg4,
        tile=tile, tx_tiles=tx_tiles, tiles_frame=num_tiles, chunk=chunk,
        interpret=interpret,
    )
    d_rows = _dup_grads_to_rows(d_feat9, bins, f, n_cap, max_dup)
    res_frames = res.reshape(f, num_tiles, _C_ROWS, p_count)
    loss_sum = jnp.sum(
        jnp.mean(jnp.square(res_frames[:, :, 0:3, :]), axis=(1, 2, 3))
    )
    return loss_sum, d_rows, res_frames, jnp.max(bins.num_dup)


def render_train_grads_batch(
    means, shs, scales, opacities, rotations, active,
    views, proj_views, cam_posns, tan_fovxs, tan_fovys,  # (F, ...) stacks
    width: int, height: int,
    truth_tiles,  # (F, T, 4, P) channel-major pre-tiled truths
    backgrounds,  # (F, 3)
    sh_degree: int,
    *,
    tile: int = 16,
    chunk: int = 8,
    max_dup: int = 2**18,
    interpret: bool = False,
    band: tuple | None = None,
    frame_loc_grads: bool = False,
    aa: bool = False,
):
    """Frame-BATCHED training core: bin all F frames with one batched pass
    and composite them with one forward and one backward kernel launch over
    the flattened (frame, tile) grid (the reference's per-frame loop is
    src/Trainer.cu:311-425; here the whole truth batch is one device
    program).

    ``band=(y_offset_px, band_height)`` restricts rasterization to the
    horizontal image band [y_offset_px, y_offset_px + band_height): the
    projection stays full-image, the projected centers are shifted by
    -y_offset_px (a traced scalar — under shard_map it can derive from
    ``lax.axis_index``), and binning/compositing run on the
    ``band_height``-tall local tile grid.  ``truth_tiles`` must then hold
    ONLY the band's tiles, (F, T_band, 4, P).  Tile-axis model parallelism
    (parallel/tp.py) builds on this; band_height must be tile-aligned.

    Returns (loss_sum, grads, var_loc, res, num_dup) where
      loss_sum = sum over frames of per-frame mean squared residual,
      grads    = per-parameter SUMS over frames of J^T residual (the
                 reference's negative-L2 convention, src/Trainer.cu:33-44),
      var_loc  = (C,) sum over frames of per-frame |location-grad| norms
                 (the densify "variance" signal, src/Trainer.cu:52-54),
      res      = (F, T, 4, P) channel-major rows [residual rgb, t_final],
      num_dup  = () int32 MAX duplicates generated by any frame's binning —
                 > max_dup means the deepest splats were dropped (the
                 reference radix-sorts the exact count and cannot truncate,
                 src/Trainer.cu:334-360; callers should grow max_dup).
    """
    if band is not None:
        y_off, bin_height = band
        y_off = jnp.asarray(y_off, jnp.float32)
    else:
        y_off, bin_height = None, height

    # Differentiable feature build.  means are broadcast to (F, C, 3) so the
    # pullback returns PER-FRAME location gradients — the densify variance
    # signal needs per-frame norms, not just the sum (src/Trainer.cu:52-54).
    # The vjp covers ONLY the projection; the duplicate gather's transpose
    # is the scatter-free reduction in _dup_grads_to_rows.
    f = views.shape[0]
    means_b = jnp.broadcast_to(means, (f,) + means.shape)

    def project_all(means_b, shs_, scales_, opac_, rot_):
        def one(mb, view, pv, pos, tx, ty):
            pr = project_splat_components(
                mb, shs_, scales_, opac_, rot_, active,
                view, pv, pos, tx, ty, width, height, sh_degree, 1.0, aa=aa,
            )
            return pr if y_off is None else pr._replace(my=pr.my - y_off)

        return jax.vmap(one)(
            means_b, views, proj_views, cam_posns, tan_fovxs, tan_fovys
        )

    def build_rows(*p):
        pr = project_all(*p)
        return jnp.stack(
            [pr.mx, pr.my, pr.ca, pr.cb, pr.cc,
             pr.cr, pr.cg, pr.cb2, pr.opacity], axis=1,
        )  # (F, 9, N)

    params = (means_b, shs, scales, opacities, rotations)
    # binning on the stop-gradient projection (integer bookkeeping only)
    comps_sg = jax.lax.stop_gradient(project_all(*params))
    rows, pull_rows = jax.vjp(build_rows, *params)
    loss_sum, d_rows, res, num_dup = _composite_frames(
        rows, comps_sg, truth_tiles, backgrounds, width, bin_height, tile,
        min(chunk, max_dup), max_dup, interpret,
    )
    d_means_b, d_shs, d_scales, d_opac, d_rot = pull_rows(d_rows)
    g_means = jnp.sum(d_means_b, axis=0)
    # densify "variance" signal = sum of per-frame |location-grad| norms
    # (src/Trainer.cu:52-54).  The norm is nonlinear, so band-sharded
    # callers (parallel/tp.py) need the RAW per-frame gradients to psum
    # over bands BEFORE the norm — frame_loc_grads returns them instead.
    var_loc = (
        d_means_b
        if frame_loc_grads
        else jnp.sum(jnp.sqrt(jnp.sum(jnp.square(d_means_b), axis=-1)), axis=0)
    )
    return (
        loss_sum, (g_means, d_shs, d_scales, d_opac, d_rot), var_loc, res,
        num_dup,
    )


def render_train_grads_rows(
    comps,  # SplatComponents, every field (F, M) — PRE-PROJECTED splats
    width: int,
    height: int,
    truth_tiles,  # (F, T, 4, P) channel-major tiles for the local grid
    backgrounds,  # (F, 3)
    *,
    tile: int = 16,
    chunk: int = 8,
    max_dup: int = 2**18,
    interpret: bool = False,
):
    """Composite-stage-only training core: bin + rasterize + backward
    from PRE-PROJECTED screen-space components, returning gradients w.r.t.
    the nine differentiable feature rows instead of model parameters.

    This is the receiving half of sub-transient distributed binning
    (parallel/routed3.py): a tile/band shard receives only the projected
    rows of splats that actually touch its band (routed via
    parallel/route.bucket_route), composites them, and routes the returned
    ``d_rows`` back to the splat shards that own the parameters.

    ``comps`` fields are (F, M): M "virtual splats" per local frame —
    projected rows with GRID-LOCAL ``my`` (callers subtract the band's
    y-offset before calling; ``width``/``height`` describe the local bin
    grid, e.g. (W, band_height)).  Invalid slots (bucket padding) must
    have ``valid=False``.

    Returns (loss_sum, d_rows (F, 9, M), res (F, T, 4, P), num_dup) —
    d_rows rows are ordered [mx, my, ca, cb, cc, cr, cg, cb2, opacity]."""
    rows = jnp.stack(
        [comps.mx, comps.my, comps.ca, comps.cb, comps.cc,
         comps.cr, comps.cg, comps.cb2, comps.opacity], axis=1,
    )  # (F, 9, M)
    return _composite_frames(
        rows, jax.lax.stop_gradient(comps), truth_tiles, backgrounds, width,
        height, tile, min(chunk, max_dup), max_dup, interpret,
    )


def render_train_grads(
    means, shs, scales, opacities, rotations, active,
    view, proj_view, cam_pos, tan_fovx, tan_fovy,
    width: int, height: int, truth_tiles, background, sh_degree: int,
    **kw,
):
    """Fused training step core for ONE frame: returns
    (loss_mean, grads tuple, residual_tiles (T, 4, P) channel-major).

    grads follow the reference convention (J^T residual — the *negative*
    L2 gradient, applied with += by the SGD step, src/Trainer.cu:81-101).
    Thin wrapper over render_train_grads_batch with F=1."""
    loss, grads, _var, res, _nd = render_train_grads_batch(
        means, shs, scales, opacities, rotations, active,
        view[None], proj_view[None], jnp.asarray(cam_pos)[None],
        jnp.asarray(tan_fovx, jnp.float32)[None],
        jnp.asarray(tan_fovy, jnp.float32)[None],
        width, height, truth_tiles[None],
        jnp.asarray(background, jnp.float32)[None],
        sh_degree, **kw,
    )
    return loss, grads, res[0]


def _make_composite(tile_start, tile_end, **kw):
    """Custom-VJP compositing op over the packed (9, D) feature array:
    feat9 -> (T, 4, P) rows [r, g, b, t_final] (background applied by the
    caller)."""

    @jax.custom_vjp
    def composite(feat9):
        return composite_forward(feat9, tile_start, tile_end, **kw)

    def composite_fwd(feat9):
        out = composite_forward(feat9, tile_start, tile_end, **kw)
        return out, (feat9, out)

    def composite_bwd(saved, gin):
        feat9, out = saved
        return (composite_backward(feat9, tile_start, tile_end, out, gin, **kw),)

    composite.defvjp(composite_fwd, composite_bwd)
    return composite


def image_to_tiles(img: jax.Array, tile: int) -> jax.Array:
    """(H, W, 3) -> (T, tile*tile, 3) in the kernel's tile-major pixel order.

    Requires tile | H and tile | W."""
    h, w, c = img.shape
    ty, txx = h // tile, w // tile
    return (
        img.reshape(ty, tile, txx, tile, c)
        .transpose(0, 2, 1, 3, 4)
        .reshape(ty * txx, tile * tile, c)
    )


def image_to_tiles_cm(img: jax.Array, tile: int) -> jax.Array:
    """(H, W, 3) -> (T, 4, tile*tile) CHANNEL-MAJOR truth tiles: rgb in
    rows 0-2, row 3 zero (see _C_ROWS).  Requires tile | H and tile | W."""
    h, w, c = img.shape
    ty, txx = h // tile, w // tile
    pm = (
        img.reshape(ty, tile, txx, tile, c)
        .transpose(0, 2, 4, 1, 3)
        .reshape(ty * txx, c, tile * tile)
    )
    return jnp.concatenate(
        [pm, jnp.zeros((ty * txx, _C_ROWS - c, tile * tile), pm.dtype)], axis=1
    )


def tiles_cm_to_image(
    tiles_cm: jax.Array, width: int, height: int, tile: int, rows: int = 3
) -> jax.Array:
    """(T, 4, tile*tile) channel-major -> (H, W, rows) (inverse of
    image_to_tiles_cm, cropping tile padding; rows=4 recovers t_final
    from residual tiles)."""
    tx_tiles = -(-width // tile)
    ty_tiles = -(-height // tile)
    img = (
        tiles_cm[:, :rows, :]
        .reshape(ty_tiles, tx_tiles, rows, tile, tile)
        .transpose(0, 3, 1, 4, 2)
        .reshape(ty_tiles * tile, tx_tiles * tile, rows)
    )
    return img[:height, :width, :]


def tiles_to_image(img_tiles: jax.Array, width: int, height: int, tile: int) -> jax.Array:
    """(T, tile*tile, 3) -> (H, W, 3) (inverse of image_to_tiles, cropping
    any tile padding)."""
    tx_tiles = -(-width // tile)
    ty_tiles = -(-height // tile)
    img = (
        img_tiles.reshape(ty_tiles, tx_tiles, tile, tile, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(ty_tiles * tile, tx_tiles * tile, 3)
    )
    return img[:height, :width, :]


def render_tiled_tiles(
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
    *,
    tile: int = 16,
    chunk: int = 8,
    max_dup: int = 2**19,
    interpret: bool = False,
    aa: bool = False,
):
    """Tile-space render: (T, tile*tile, 3) image tiles, background applied.

    ``aa`` enables mip-splat anti-aliasing
    (transforms.project_splat_components)."""
    tx_tiles = -(-width // tile)
    ty_tiles = -(-height // tile)
    num_tiles = tx_tiles * ty_tiles

    proj = project_splat_components(
        means, shs, scales, opacities, rotations, active,
        view, proj_view, cam_pos, tan_fovx, tan_fovy,
        width, height, sh_degree, scale_mod, aa=aa,
    )
    bins = bin_splats(jax.lax.stop_gradient(proj), width, height, tile, max_dup)

    feat_rows = jnp.stack(
        [proj.mx, proj.my, proj.ca, proj.cb, proj.cc,
         proj.cr, proj.cg, proj.cb2, proj.opacity],
    )  # (9, N)
    feat9 = feat_rows[:, bins.gather_idx]  # (9, D); transpose = scatter-add

    composite = _make_composite(
        bins.tile_start, bins.tile_end, tile=tile, tx_tiles=tx_tiles,
        tiles_frame=num_tiles, chunk=min(chunk, max_dup), interpret=interpret,
    )
    out = composite(feat9)  # (T, 4, P)

    background = jnp.asarray(background, jnp.float32)
    rgb = out[:, 0:3, :] + out[:, 3:4, :] * background[None, :, None]
    return jnp.transpose(rgb, (0, 2, 1))


def render_tiled(
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
    **kw,
):
    """Render (H, W, 3) float32 with the tiled kernel path.

    Differentiable w.r.t. all splat parameters and the background; numerics
    match render_oracle(tile_cull=tile) (tile-granular splat cutoff is the
    INRIA-reference semantic — SURVEY §7 hard part 5).  Keywords as
    render_tiled_tiles (tile, chunk, max_dup, interpret, aa)."""
    img_tiles = render_tiled_tiles(
        means, shs, scales, opacities, rotations, active,
        view, proj_view, cam_pos, tan_fovx, tan_fovy,
        width, height, background, sh_degree, scale_mod, **kw,
    )
    return tiles_to_image(img_tiles, width, height, kw.get("tile", 16))


def render_tiled_model(
    model, camera, width, height, background, scale_mod=1.0,
    train_fov: bool = True, **kw
):
    """Convenience wrapper taking a SplatModel + Camera (host-side matrices)."""
    view = jnp.asarray(camera.get_view())
    proj_view = jnp.asarray(camera.get_proj_view(width / height))
    tan_fovx, tan_fovy = camera.tan_fov(width, height, train=train_fov)
    return render_tiled(
        model.means, model.shs, model.scales, model.opacities, model.rotations,
        model.active_mask(), view, proj_view, jnp.asarray(camera.location),
        tan_fovx, tan_fovy, width, height, background, model.sh_degree, scale_mod,
        **kw,
    )
