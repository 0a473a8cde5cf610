"""Data-dependent record routing across mesh shards (ragged all-to-all).

The missing primitive for SUB-TRANSIENT distributed binning: today
``parallel/mesh3.py`` shards splat parameters at rest but all-gathers the
full (9, N) projected rows transiently every step — bounded by device
memory.
The fix is to route each (splat, tile) DUPLICATE from the splat shard
that projects it to the tile/band shard that composites it, so no device
ever materializes the full model:

  device (band b, splat s)
    1. projects ITS splat shard for its frames (dense local math)
    2. enumerates duplicates + destination band per duplicate
    3. ``bucket_route`` along the TILE axis: dup records for band d go to
       device (d, s)                                    <- THIS PRIMITIVE
    4. a small all-gather along the SPLAT axis assembles band d's full
       duplicate list (post-routing size: ~D/S_tile per device, not N)
    5. local binning sort + the band kernel proceed unchanged

``jax.lax.all_to_all`` exchanges EQUAL-SIZED blocks only, so the ragged
exchange is emulated with fixed-capacity per-destination buckets built
scatter-free (sort by destination + rank arithmetic + one column
gather), exchanged with one dense all_to_all, and overflow is DETECTED
rather than prevented — the caller grows the bucket capacity and
recompiles, exactly the max_dup overflow contract
(trainer.maybe_grow_dup_buffer).

Capacity math: with D duplicates per frame spread over S destination
shards, a balanced scene needs cap ~= D / (S_src * S_dst); skewed scenes
(every splat in one band) need up to D / S_src.  The overflow telemetry
makes the trade explicit instead of silently wrong.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def bucket_local(dst: jax.Array, payload: jax.Array, n_dst: int, cap: int):
    """Pack local records into (n_dst, cap) fixed buckets, scatter-free.

    dst: (L,) int32 destination shard id in [0, n_dst) (or any value >=
    n_dst / < 0 to drop the record).  payload: (K, L) float rows.

    Returns (buckets (n_dst, K, cap), valid (n_dst, cap), max_count ()):
    records beyond ``cap`` for a destination are DROPPED and reported via
    max_count (> cap means overflow).  Deterministic: records keep their
    local order within each destination bucket (stable sort)."""
    k, l = payload.shape
    i32 = jnp.int32
    iota = jnp.arange(l, dtype=i32)
    in_range = (dst >= 0) & (dst < n_dst)
    key = jnp.where(in_range, dst, n_dst).astype(i32)
    skey, order = jax.lax.sort_key_val(key, iota, is_stable=True)
    sorted_payload = payload[:, order]  # (K, L) one column gather
    # per-destination counts + exclusive offsets without scatter:
    # counts[d] = #records with key < d+1  -  #records with key < d
    below = jnp.sum(skey[None, :] < jnp.arange(n_dst + 1, dtype=i32)[:, None], axis=1)
    offsets = below[:-1]  # (n_dst,) exclusive start of each dst run
    counts = below[1:] - below[:-1]
    # slot (d, i) pulls sorted record offsets[d] + i when i < counts[d]
    ii = jnp.arange(cap, dtype=i32)[None, :]
    rec = offsets[:, None] + ii  # (n_dst, cap)
    valid = ii < jnp.minimum(counts, cap)[:, None]
    rec = jnp.clip(rec, 0, l - 1).reshape(-1)
    buckets = jnp.moveaxis(
        sorted_payload[:, rec].reshape(k, n_dst, cap), 1, 0
    )  # (n_dst, K, cap)
    buckets = jnp.where(valid[:, None, :], buckets, 0.0)
    return buckets, valid, jnp.max(counts)


def _pack_perm(dst: jax.Array, n_dst: int, cap: int):
    """The deterministic permutation bucket_local applies: for each record,
    which (destination, in-bucket rank) slot it landed in.

    Returns (order, run, rank): sorted position p holds original record
    ``order[p]``, destined to bucket ``run[p]`` at rank ``rank[p]``
    (rank >= cap or run >= n_dst means the record was dropped)."""
    l = dst.shape[0]
    i32 = jnp.int32
    iota = jnp.arange(l, dtype=i32)
    in_range = (dst >= 0) & (dst < n_dst)
    key = jnp.where(in_range, dst, n_dst).astype(i32)
    skey, order = jax.lax.sort_key_val(key, iota, is_stable=True)
    below = jnp.sum(
        skey[None, :] < jnp.arange(n_dst + 1, dtype=i32)[:, None], axis=1
    )
    offsets = below[:-1]
    rank = iota - jnp.where(
        skey < n_dst, offsets[jnp.clip(skey, 0, n_dst - 1)], 0
    )
    return order, skey, rank


def unbucket_local(dst: jax.Array, buckets: jax.Array, cap: int) -> jax.Array:
    """Inverse of bucket_local's packing: per-SLOT values (n_dst, K, cap)
    -> per-RECORD values (K, L) in the records' original order.

    ``dst`` must be the same destination vector the forward bucket_local
    saw (the permutation is recomputed, not stored).  Records that were
    dropped in the forward pass (out-of-range dst, bucket overflow) get
    zeros — for gradient return routes that is exactly 'no contribution'."""
    n_dst, k, _ = buckets.shape
    order, run, rank = _pack_perm(dst, n_dst, cap)
    ok = (run < n_dst) & (rank < cap)
    flat = jnp.clip(run, 0, n_dst - 1) * cap + jnp.clip(rank, 0, cap - 1)
    bk = jnp.moveaxis(buckets, 1, 0).reshape(k, n_dst * cap)
    g_sorted = jnp.where(ok[None, :], bk[:, flat], 0.0)  # sorted-record order
    # sorted position p carries record order[p]; un-sort with the inverse
    # permutation (one argsort + column gather, scatter-free)
    inv = jnp.argsort(order)
    return g_sorted[:, inv]


def route_back(dst: jax.Array, grads_recv: jax.Array, cap: int,
               axis_name: str) -> jax.Array:
    """Return per-record values to their senders: the inverse exchange of
    bucket_route (the gradient return route of parallel/routed3.py).

    ``grads_recv`` (n_src, K, cap) must be laid out like bucket_route's
    ``recv`` on the receiver — grads_recv[s] holds values for the records
    received FROM source s, in slot order.  Each sender gets back (K, L)
    rows aligned with its original records (zeros for dropped ones)."""
    back = jax.lax.all_to_all(
        grads_recv, axis_name, split_axis=0, concat_axis=0
    )
    # back[d] = the values destination d computed for OUR records
    return unbucket_local(dst, back, cap)


def bucket_route(dst: jax.Array, payload: jax.Array, cap: int,
                 axis_name: str):
    """Route local records to the shards named by ``dst`` along
    ``axis_name`` (must be called inside shard_map over that axis).

    Returns (recv (n_src, K, cap), recv_valid (n_src, cap), max_count):
    recv[s] holds the records THIS shard received from source shard s, in
    the sender's local order; max_count is the LOCAL max bucket fill
    before the exchange (psum_max it for a global overflow check)."""
    n_dst = jax.lax.axis_size(axis_name)
    buckets, valid, max_count = bucket_local(dst, payload, n_dst, cap)
    # all_to_all: destination-major axis 0 splits across shards; the
    # received blocks stack on the same leading (now source-major) axis
    recv = jax.lax.all_to_all(buckets, axis_name, split_axis=0, concat_axis=0)
    recv_valid = (
        jax.lax.all_to_all(
            valid.astype(jnp.float32), axis_name, split_axis=0, concat_axis=0
        )
        > 0.5
    )
    return recv, recv_valid, max_count
