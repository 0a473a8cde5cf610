"""Tile binning: screen-space splats -> per-tile depth-ordered ranges.

This replaces the INRIA rasterizer's duplicate-with-keys + radix sort +
per-tile ranges stages (reference call site
src/Trainer.cu:334-360; SURVEY §2.3 pins the upstream pipeline).  Instead of
a 64-bit (tileID|depth) radix sort we:

  1. depth-sort the splats once (N keys, stable argsort),
  2. enumerate (splat, covered-tile) duplicate pairs *in depth order* into a
     fixed-capacity buffer (static shapes for XLA).  The pair -> splat
     mapping is a scatter of each splat's first-duplicate position followed
     by a cummax — O(D) instead of a D-wide searchsorted,
  3. stable-sort the pairs by tile id only — stability preserves the depth
     order within each tile, so one cheap int32 single-key sort replaces the
     packed 64-bit sort,
  4. compute per-tile [start, end) ranges by binary search (T queries);
     the compositing kernel runs one program per tile over that range.

Layout rule (see SplatComponents): every per-splat/per-duplicate quantity is
a flat vector.  Integer div/mod on wide vectors is done in f32 (exact
below 2^24).

Everything here is integer bookkeeping — gradients flow only through the
feature gather done by the caller.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gaussian_splatterer_tpu.ops.transforms import SplatComponents


class TileBins(NamedTuple):
    """Static-shape binning result.

    D = max_dup (duplicate capacity), T = number of tiles.
    """

    gather_idx: jax.Array  # (D,) int32 original splat id per sorted duplicate
    tile_start: jax.Array  # (T,) int32 first duplicate index of each tile
    tile_end: jax.Array  # (T,) int32 one-past-last duplicate index
    num_dup: jax.Array  # () int32 total duplicates generated (may exceed D!)


class BatchBins(NamedTuple):
    """Flat-native multi-frame binning (see bin_splats_batch).

    F frames, N splat capacity, D = max_dup, T tiles per frame.  Indices
    marked _g / _flat are GLOBAL over the frame-flattened axes (row id
    = f*N + local, dup id = f*D + local, tile id = f*T + local)."""

    gather_flat: jax.Array  # (F*D,) global feature-row id per sorted dup
    presort_pos: jax.Array  # (F, D) LOCAL presort (depth) position per
    # tile-sorted dup slot — the sort key that carries per-dup gradient rows
    # back to depth order (a payload sort instead of an inverse-permutation
    # gather)
    tile_start: jax.Array  # (F, T) local dup ranges per tile
    tile_end: jax.Array  # (F, T)
    seg_start_g: jax.Array  # (F*N,) global presort dup start per depth slot
    inv_depth_flat: jax.Array  # (F*N,) global depth slot per original row id
    num_dup: jax.Array  # (F,) true duplicate totals (saturated, may > D)


def bin_splats_batch(
    comps: SplatComponents,  # every field (F, N)
    width: int,
    height: int,
    tile: int,
    max_dup: int,
) -> BatchBins:
    """Multi-frame binning with NO batched gathers/scatters.

    jax.vmap(bin_splats) turns the hand-tuned (K, N)[:, idx] column gathers
    into batched gathers/scatters — so the batch path flattens
    the frame axis into the data instead: per-frame sorts stay batched
    (fast), every lookup is ONE flat column gather, and the seed/cummax
    duplicate fill runs once over the global buffer with frame-monotone
    seed values."""
    f, n = comps.mx.shape
    tx_tiles = -(-width // tile)
    ty_tiles = -(-height // tile)
    num_tiles = tx_tiles * ty_tiles
    i32 = jnp.int32
    fN = f * n
    fD = f * max_dup
    f_rows = jnp.arange(f, dtype=i32)[:, None] * n  # (F, 1) row offsets
    f_dups = jnp.arange(f, dtype=i32)[:, None] * max_dup

    # 1. per-frame depth order (batched argsort: fast)
    order = jnp.argsort(
        jnp.where(comps.valid, comps.depth, jnp.inf), axis=-1
    ).astype(i32)  # (F, N) local ids
    order_g = (order + f_rows).reshape(-1)  # (F*N,)

    # 2. depth-ordered geometry: ONE flat column gather
    tab = jnp.stack(
        [
            comps.mx.reshape(-1),
            comps.my.reshape(-1),
            comps.rx.reshape(-1),
            comps.ry.reshape(-1),
            comps.valid.reshape(-1).astype(jnp.float32),
        ]
    )  # (5, F*N)
    g5 = tab[:, order_g]
    mx = g5[0].reshape(f, n)
    my = g5[1].reshape(f, n)
    rxs = g5[2].reshape(f, n)
    rys = g5[3].reshape(f, n)
    vld = g5[4].reshape(f, n) > 0.5

    # 3. covered-tile counts + per-frame prefix offsets
    x0, y0, x1, y1 = tile_aabb(mx, my, rxs, rys, tile, tx_tiles, ty_tiles)
    spans_x = jnp.maximum(x1 - x0, 0)
    ntiles = jnp.where(vld, spans_x * jnp.maximum(y1 - y0, 0), 0)
    offs = jnp.cumsum(ntiles, axis=-1)  # (F, N) int32 per frame
    offs_excl = offs - ntiles
    offs_f = jnp.cumsum(ntiles.astype(jnp.float32), axis=-1)  # overflow gate
    num_dup = jnp.minimum(offs_f[:, -1], jnp.float32(2**31 - 2**8)).astype(i32)

    # 4.+5. per-dup splat attributes WITHOUT a (5, F*D) gather: bit-pack each
    # depth-ordered splat's (spans_x, x0, y0, orig) under a monotone carrier
    # (its depth slot + 1), scatter the packed words at the splats' first-
    # duplicate positions, and fill the gaps with a batched per-frame
    # cummax — monotone carriers make cummax pick the latest seed, and the
    # packed low bits ride along.  offs_excl is itself monotone at seed
    # positions, so it travels as its own un-packed word.

    carrier_bits = n.bit_length()  # slot_local + 1 <= n
    payload_bits = 31 - carrier_bits
    if payload_bits < 4:
        raise ValueError(
            f"splat capacity {n} leaves {payload_bits} packing bits; "
            "the packed-cummax binning supports capacities < 2^27"
        )
    fields = [
        ("wdt", spans_x, max(1, tx_tiles.bit_length())),
        ("gx0", x0, max(1, tx_tiles.bit_length())),
        ("gy0", y0, max(1, ty_tiles.bit_length())),
        ("orig", order, max(1, (n - 1).bit_length())),
    ]
    # first-fit packing, splitting fields across words when needed; each
    # segment records (word, shift-in-word, bits, position-in-field)
    segments: dict[str, list[tuple[int, int, int, int]]] = {f0: [] for f0, _, _ in fields}
    word_exprs: list[jax.Array] = []
    cur = jnp.zeros((f, n), i32)
    room = payload_bits
    for name, val, bits in fields:
        pos = bits  # unconsumed high bits of this field
        while pos > 0:
            if room == 0:
                word_exprs.append(cur)
                cur = jnp.zeros((f, n), i32)
                room = payload_bits
            take = min(pos, room)
            chunk_val = (val >> (pos - take)) & ((1 << take) - 1)
            room -= take
            pos -= take
            segments[name].append((len(word_exprs), room, take, pos))
            cur = cur | (chunk_val << room)
    word_exprs.append(cur)

    slot_local = jnp.arange(n, dtype=i32)[None, :] + jnp.zeros((f, 1), i32)
    carrier = (slot_local + 1) << payload_bits
    seeds = jnp.stack(
        [offs_excl + 1] + [carrier | wv for wv in word_exprs]
    )  # (W, F, N); word 0 = offs_excl + 1 (its own monotone carrier)
    n_words = seeds.shape[0]
    # Seed positions are the UNGATED offs_excl: non-decreasing, so each of
    # these per-frame scatters carries indices_are_sorted=True (a batched
    # 2-D scatter would have dynamic indices and no sortedness hint).
    # Collisions (an empty
    # splat shares offs_excl with the NEXT non-empty one) resolve correctly
    # under max: the true owner has the highest depth slot, hence the
    # largest carrier.  Overflow starts (>= max_dup) drop via OOB; trailing
    # empty splats seed the gated slack region, which dup_valid discards.
    # One (W, D) scatter per frame — the W word rows share the frame's
    # indices, so they ride a single scatter op's window dim
    rows = []
    for fr in range(f):
        rows.append(
            jnp.zeros((n_words, max_dup), i32)
            .at[:, offs_excl[fr]]
            .max(seeds[:, fr, :], mode="drop", indices_are_sorted=True)
        )
    seeded = jnp.stack(rows, axis=1).reshape(n_words, fD)
    # barrier: keep the scatters out of the cummax fusion
    seeded = jax.lax.optimization_barrier(seeded)
    filled = jax.lax.cummax(
        seeded.reshape(n_words, f, max_dup), axis=2
    ).reshape(n_words, fD)
    oe = filled[0] - 1  # -1 before the first seed: gated by dup_valid

    def unpack(name: str) -> jax.Array:
        out = jnp.zeros((fD,), i32)
        for word, shift, bits, pos in segments[name]:
            out = out | (
                ((filled[1 + word] >> shift) & ((1 << bits) - 1)) << pos
            )
        return out

    wdt, gx0, gy0, orig_local = (
        unpack("wdt"), unpack("gx0"), unpack("gy0"), unpack("orig")
    )

    d_flat = jnp.arange(fD, dtype=i32)
    d_local = d_flat % max_dup
    frame_of = d_flat // max_dup
    local = (d_local - oe).astype(jnp.float32)
    wf = jnp.maximum(wdt, 1).astype(jnp.float32)
    row = jnp.floor(local * (1.0 / wf))
    col = local - row * wf
    under = col >= wf  # reciprocal-multiply undershoot correction (exact)
    row = row + under.astype(jnp.float32)
    col = col - jnp.where(under, wf, 0.0)
    tyv = gy0 + row.astype(i32)
    txv = gx0 + col.astype(i32)
    total_of = num_dup[frame_of]
    dup_valid = d_local < jnp.minimum(total_of, max_dup)
    tid = jnp.where(dup_valid, tyv * tx_tiles + txv, num_tiles).astype(i32)

    # 6. per-frame stable tile sort (batched sort: fast), carrying the
    # GLOBAL original row id and GLOBAL presort position as payloads
    orig_g = orig_local + frame_of * n
    tid_2d = tid.reshape(f, max_dup)
    orig_2d = orig_g.reshape(f, max_dup)
    dpre_2d = d_flat.reshape(f, max_dup)
    tid_s, gather_2d, dup_presort_2d = jax.lax.sort(
        (tid_2d, orig_2d, dpre_2d), num_keys=1, is_stable=True
    )
    gather_flat = gather_2d.reshape(-1)
    pre_local_2d = dup_presort_2d - f_dups

    # 7. per-frame tile ranges: binary search of every tile id in the
    # sorted tids (log2(D) passes of T-wide gathers; a dense (T, D)
    # compare would cost T*D per frame)
    tids = jnp.arange(num_tiles, dtype=i32)

    def ranges(ts):
        return (
            jnp.searchsorted(ts, tids, side="left").astype(i32),
            jnp.searchsorted(ts, tids, side="right").astype(i32),
        )

    tile_start, tile_end = jax.vmap(ranges)(tid_s)

    # 8. per-depth-slot presort segments (for the scatter-free gradient
    # reduction) and the depth inverse (original row -> global depth slot)
    gate = offs_f - ntiles.astype(jnp.float32) < max_dup
    seg_start_g = (
        jnp.where(gate, jnp.clip(offs_excl, 0, max_dup), max_dup) + f_dups
    ).reshape(-1)
    iota_n = jnp.arange(n, dtype=i32)[None, :] + jnp.zeros((f, 1), i32)
    _, inv_depth_2d = jax.lax.sort(
        (order, iota_n + f_rows), num_keys=1, is_stable=True
    )
    inv_depth_flat = inv_depth_2d.reshape(-1)

    return BatchBins(
        gather_flat=gather_flat,
        presort_pos=pre_local_2d,
        tile_start=tile_start,
        tile_end=tile_end,
        seg_start_g=seg_start_g,
        inv_depth_flat=inv_depth_flat,
        num_dup=num_dup,
    )


def tile_aabb(mx, my, rx, ry, tile: int, tx_tiles: int, ty_tiles: int):
    """Per-splat covered tile rectangle [x0, x1) x [y0, y1), INRIA getRect
    semantics (floor((p - r)/tile) .. floor((p + r + tile - 1)/tile),
    clipped) over per-axis half-extents (rx, ry) — the tight
    opacity-aware ellipse AABB from project_splat_components (pass the
    same value for both to reproduce the reference's circular box).

    All args/results are flat (N,) vectors."""
    ftile = jnp.float32(tile)
    x0 = jnp.clip(jnp.floor((mx - rx) / ftile), 0, tx_tiles).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor((my - ry) / ftile), 0, ty_tiles).astype(jnp.int32)
    x1 = jnp.clip(jnp.floor((mx + rx + ftile - 1.0) / ftile), 0, tx_tiles).astype(
        jnp.int32
    )
    y1 = jnp.clip(jnp.floor((my + ry + ftile - 1.0) / ftile), 0, ty_tiles).astype(
        jnp.int32
    )
    return x0, y0, x1, y1


def bin_splats(
    comps: SplatComponents,
    width: int,
    height: int,
    tile: int,
    max_dup: int,
) -> TileBins:
    n = comps.mx.shape[0]
    tx_tiles = -(-width // tile)
    ty_tiles = -(-height // tile)
    num_tiles = tx_tiles * ty_tiles
    i32 = jnp.int32

    # 1. depth order (invalid splats last; stable for deterministic ties)
    order = jnp.argsort(jnp.where(comps.valid, comps.depth, jnp.inf)).astype(i32)
    mx = comps.mx[order]
    my = comps.my[order]
    rxs = comps.rx[order]
    rys = comps.ry[order]
    vld = comps.valid[order]

    # 2. duplicate enumeration in depth order
    x0, y0, x1, y1 = tile_aabb(mx, my, rxs, rys, tile, tx_tiles, ty_tiles)
    spans_x = jnp.maximum(x1 - x0, 0)
    ntiles = jnp.where(vld, spans_x * jnp.maximum(y1 - y0, 0), 0)
    offs = jnp.cumsum(ntiles)  # inclusive, int32
    offs_excl = offs - ntiles
    # The int32 cumsum can wrap past 2^31 duplicates (wide splats x many
    # tiles).  A parallel f32 cumsum is monotone and accurate to ~2^-24
    # relative, so it gates which prefixes are trusted: splats whose true
    # start is < max_dup have an exact (un-wrapped) int32 prefix; everything
    # past max_dup is dropped anyway.  num_dup telemetry saturates instead
    # of wrapping negative.
    offs_f = jnp.cumsum(ntiles.astype(jnp.float32))
    total = jnp.minimum(offs_f[-1], jnp.float32(2**31 - 2**8)).astype(i32)

    # pair d -> depth-ordered splat: scatter each non-empty splat's index+1 at
    # its first duplicate position, then a running max fills the gaps.
    splat_idx = jnp.arange(n, dtype=i32)
    nonempty = (ntiles > 0) & (offs_f - ntiles.astype(jnp.float32) < max_dup)
    starts = jnp.where(nonempty, offs_excl, max_dup)  # dropped when == max_dup
    seed = (
        jnp.zeros((max_dup,), i32).at[starts].max(splat_idx + 1, mode="drop")
    )
    sid = jax.lax.cummax(seed) - 1  # (D,) in [-1, n-1]
    sid_c = jnp.maximum(sid, 0)

    # ONE batched row-gather for all per-splat lookup tables instead of five
    # 1-D int gathers.
    tables = jnp.stack([offs_excl, spans_x, x0, y0, order])  # (5, N)
    g = tables[:, sid_c]  # (5, D)
    oe, wdt, gx0, gy0, orig = g[0], g[1], g[2], g[3], g[4]

    d = jnp.arange(max_dup, dtype=i32)
    local = (d - oe).astype(jnp.float32)
    wf = jnp.maximum(wdt, 1).astype(jnp.float32)
    # reciprocal-multiply floor can undershoot by exactly 1 at exact
    # multiples (e.g. floor(41 * f32(1/41)) == 0); it can never overshoot
    # for local < 2^24 and row < 2^16, so one conditional correction after
    # computing the remainder makes the quotient exact.
    row = jnp.floor(local * (1.0 / wf))
    col = local - row * wf
    under = col >= wf
    row = row + under.astype(jnp.float32)
    col = col - jnp.where(under, wf, 0.0)
    tyv = gy0 + row.astype(i32)
    txv = gx0 + col.astype(i32)
    dup_valid = d < jnp.minimum(total, max_dup)
    tid = jnp.where(dup_valid, tyv * tx_tiles + txv, num_tiles).astype(i32)

    # 3. stable single-key sort by tile id (depth order preserved within
    #    tile)
    tid_sorted, gather_idx = jax.lax.sort((tid, orig), num_keys=1, is_stable=True)

    # 4. per-tile ranges
    tids = jnp.arange(num_tiles, dtype=i32)
    tile_start = jnp.searchsorted(tid_sorted, tids, side="left").astype(i32)
    tile_end = jnp.searchsorted(tid_sorted, tids, side="right").astype(i32)
    return TileBins(
        gather_idx=gather_idx,
        tile_start=tile_start,
        tile_end=tile_end,
        num_dup=total.astype(i32),
    )
