"""Batched JAX Monte-Carlo path tracer — the truth-photograph generator.

Plain-XLA replacement for the reference's OptiX/OWL ray tracer
(src/rtx/RtxDevice.cu + src/rtx/RtxHost.cpp).  Instead of a BVH +
divergent per-ray traversal this evaluates Möller-Trumbore intersection as
dense (ray-chunk x triangle-chunk) component planes with a lax.scan
min-reduction over triangle chunks and a bounce while-loop that exits as
soon as every ray in the chunk has terminated.

The PRIMARY pass (every ray shares the eye origin — the bulk of all
intersection work once misses terminate at bounce 0) is a matmul:
shared-origin Möller-Trumbore collapses to one (R, 3) x (3, 3*Tc) matmul
per triangle chunk (_intersect_shared).  Scattered bounce rays use the
general-origin matmul form, the component form, or Morton-chunk AABB
culling (_intersect_culled).

Semantics preserved from the reference device program:
  * primary rays: sub-pixel jitter ``pixel + rand2 + 0.5``, NDC point at
    the far plane pushed through the inverse proj-view matrix
    (src/rtx/RtxDevice.cu:75-82)
  * up to 50 bounces; exceeding the cap returns black (:23,57)
  * stochastic alpha transparency: the surface is hit when
    ``texture.w > rand()``, otherwise the ray passes through unchanged
    with color attenuation 1 (:128-143)
  * lambertian scatter ``normal + randomUnitSphere()`` (reflectivity
    constant is 0, so the mirror branch never runs) (:8-14,130-133)
  * flat shading from the raw triangle cross-product normal (:113-114)
  * nearest-neighbor diffuse texture lookup with flipped V (:119-123)
  * miss: white/gray sky ``min(1, 1 + dir.y)``; a primary ray that never
    reflected returns the background color instead (:50,149-158)
  * truth-camera indicator orbs: a primary ray passing within 0.025 of a
    camera location (not occluded by a nearer hit) inverts the final
    averaged pixel color (:36-47,97)
  * per-sample clamp to [0, 1], then average (:85-95)
"""

from __future__ import annotations

from typing import Optional

import os

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_splatterer_tpu.io.image import blank_texture, load_texture_rgba
from gaussian_splatterer_tpu.io.obj import TriangleMesh, load_obj
from gaussian_splatterer_tpu.models.camera import Camera

SPLAT_CAMERA_DOT_SIZE = 0.025  # reference src/rtx/RtxDevice.cuh:8
RAY_TMIN = 1e-3  # bounce ray offset (src/rtx/RtxDevice.cu:53)
MAX_BOUNCES = 50  # src/rtx/RtxDevice.cu:23


def _intersect_chunked(ox, oy, oz, dx, dy, dz, tris, tri_chunk: int):
    """Möller-Trumbore over all triangles for a flat ray batch.

    Rays as (R,) component vectors; ``tris`` is a dict of (Tc_total,)
    per-triangle component vectors padded to a multiple of tri_chunk.
    Returns (t, tri_idx, bu, bv) per ray; t = inf for misses.
    """
    r = ox.shape[0]
    n_chunks = tris["ax"].shape[0] // tri_chunk

    def chunk_body(carry, ck):
        best_t, best_i, best_u, best_v = carry
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, ck * tri_chunk, tri_chunk)
        ax, ay, az = sl(tris["ax"]), sl(tris["ay"]), sl(tris["az"])
        e1x, e1y, e1z = sl(tris["e1x"]), sl(tris["e1y"]), sl(tris["e1z"])
        e2x, e2y, e2z = sl(tris["e2x"]), sl(tris["e2y"]), sl(tris["e2z"])
        valid = sl(tris["valid"])

        # broadcast rays (R, 1) against triangles (1, Tc): one shared
        # Möller-Trumbore predicate for both intersectors
        t, u, v = _mt_hit(
            ox[:, None], oy[:, None], oz[:, None],
            dx[:, None], dy[:, None], dz[:, None],
            ax[None], ay[None], az[None],
            e1x[None], e1y[None], e1z[None],
            e2x[None], e2y[None], e2z[None],
            valid[None],
        )
        tj, uj, vj, j = _best_lane(t, u, v, ck * tri_chunk)
        closer = tj < best_t
        best_t = jnp.where(closer, tj, best_t)
        best_i = jnp.where(closer, j, best_i)
        best_u = jnp.where(closer, uj, best_u)
        best_v = jnp.where(closer, vj, best_v)
        return (best_t, best_i, best_u, best_v), None

    init = (
        jnp.full((r,), jnp.inf, jnp.float32),
        jnp.zeros((r,), jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
    )
    (t, i, u, v), _ = jax.lax.scan(
        chunk_body, init, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return t, i, u, v


def _best_lane(t, u, v, idx_base):
    """Per-row argmin of t plus the winning u/v/global-index, GATHER-FREE.

    A one-hot masked reduction replaces ``t[rr, j]``-style take-along
    element gathers.  argmin
    returns the FIRST minimum, so the one-hot is built from the index —
    exact and deterministic even under ties.  ``idx_base`` may be a traced
    scalar (the culled march passes per-ray chunk offsets as a column)."""
    tc = t.shape[1]
    j = jnp.argmin(t, axis=1).astype(jnp.int32)  # (R,)
    onehot = jnp.arange(tc, dtype=jnp.int32)[None, :] == j[:, None]
    tj = jnp.sum(jnp.where(onehot, t, 0.0), axis=1)
    uj = jnp.sum(jnp.where(onehot, u, 0.0), axis=1)
    vj = jnp.sum(jnp.where(onehot, v, 0.0), axis=1)
    return tj, uj, vj, idx_base + j


def _mt_hit(ox, oy, oz, dx, dy, dz, ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z,
            valid):
    """Möller-Trumbore for (R, Tc) ray x triangle component planes."""
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    tx = ox - ax
    ty = oy - ay
    tz = oz - az
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > RAY_TMIN)
    return jnp.where(hit, t, jnp.inf), u, v


def _intersect_culled(ox, oy, oz, dx, dy, dz, tris, tri_chunk: int):
    """Acceleration-structure intersection: Morton-ordered triangle chunks
    with AABBs, visited per ray in entry-distance order with early exit.

    No divergent BVH stacks — instead every ray slab-tests all chunk AABBs
    at once (cheap (R, NC) planes), sorts its passing chunks by t_entry,
    and the batch marches the sorted lists in lockstep, stopping when every
    ray's best hit precedes its next chunk entry.  The chunk data loads are
    per-ray row gathers.
    """
    r = ox.shape[0]
    nc = tris["bb_minx"].shape[0]

    invx = 1.0 / jnp.where(jnp.abs(dx) < 1e-12, 1e-12, dx)
    invy = 1.0 / jnp.where(jnp.abs(dy) < 1e-12, 1e-12, dy)
    invz = 1.0 / jnp.where(jnp.abs(dz) < 1e-12, 1e-12, dz)

    def slab(mn, mx, o, inv):
        t0 = (mn[None, :] - o[:, None]) * inv[:, None]
        t1 = (mx[None, :] - o[:, None]) * inv[:, None]
        return jnp.minimum(t0, t1), jnp.maximum(t0, t1)

    ax0, ax1 = slab(tris["bb_minx"], tris["bb_maxx"], ox, invx)
    ay0, ay1 = slab(tris["bb_miny"], tris["bb_maxy"], oy, invy)
    az0, az1 = slab(tris["bb_minz"], tris["bb_maxz"], oz, invz)
    t_enter = jnp.maximum(jnp.maximum(ax0, ay0), jnp.maximum(az0, jnp.float32(RAY_TMIN)))
    t_exit = jnp.minimum(jnp.minimum(ax1, ay1), az1)
    key = jnp.where(t_enter <= t_exit, t_enter, jnp.inf)  # (R, NC)
    key_sorted, order = jax.lax.sort_key_val(
        key, jnp.broadcast_to(jnp.arange(nc, dtype=jnp.int32), (r, nc)), dimension=1
    )

    li = jnp.arange(tri_chunk, dtype=jnp.int32)[None, :]  # (1, Tc)

    def cond(state):
        s, best_t, *_ = state
        se = jnp.where(s < nc, key_sorted[:, jnp.minimum(s, nc - 1)], jnp.inf)
        return (s < nc) & jnp.any(se < best_t)

    def body(state):
        s, best_t, best_i, best_u, best_v = state
        sc = jnp.minimum(s, nc - 1)
        se = key_sorted[:, sc]  # (R,) this step's chunk entry distance
        ck = order[:, sc]  # (R,) chunk id per ray
        idx = ck[:, None] * tri_chunk + li  # (R, Tc) triangle indices
        # ONE batched (10, R*Tc) column gather for all geometry fields
        # instead of ten separate (R, Tc) element gathers
        g10 = tris["geo10"][:, idx.reshape(-1)].reshape(10, r, tri_chunk)
        t, u, v = _mt_hit(
            ox[:, None], oy[:, None], oz[:, None],
            dx[:, None], dy[:, None], dz[:, None],
            g10[0], g10[1], g10[2],
            g10[3], g10[4], g10[5],
            g10[6], g10[7], g10[8],
            g10[9] > 0.5,
        )
        # rays whose best hit already precedes this chunk skip it
        useful = se < best_t
        t = jnp.where(useful[:, None], t, jnp.inf)
        tj, uj, vj, j = _best_lane(t, u, v, ck * tri_chunk)
        closer = tj < best_t
        best_t = jnp.where(closer, tj, best_t)
        best_i = jnp.where(closer, j, best_i)
        best_u = jnp.where(closer, uj, best_u)
        best_v = jnp.where(closer, vj, best_v)
        return s + 1, best_t, best_i, best_u, best_v

    state = (
        jnp.int32(0),
        jnp.full((r,), jnp.inf, jnp.float32),
        jnp.zeros((r,), jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
    )
    _, t, i, u, v = jax.lax.while_loop(cond, body, state)
    return t, i, u, v


def _intersect_shared(o3, dx, dy, dz, tris, tri_chunk: int):
    """Möller-Trumbore for a SHARED-origin ray batch (the primary pass:
    every camera ray starts at the eye) as one matmul per tri chunk.

    With a common origin the four MT quantities are all 3-term dots of the
    ray DIRECTION against per-triangle vectors (w = o - a; cyclic triple
    products):
        det   = e1 . (d x e2) = d . (e2 x e1)
        u_num = w  . (d x e2) = d . (e2 x w)
        v_num = d  . (w x e1)
        t_num = e2 . (w x e1)          (per-triangle scalar: no ray term)
    so one (R, 3) x (3, 3*Tc) matmul evaluates det/u_num/v_num for every
    (ray, triangle) pair — ~40 ops/pair in the component form collapse to
    18 matmul FLOPs/pair + a ~12-op epilogue.  The cancellation-sensitive
    t_num = e2.((o-a) x e1) stays in exact per-triangle f32 (same
    conditioning as the component path), and the matmul runs at
    precision=HIGHEST — reduced-precision (TF32/bf16) matmul input rounding
    is poison for geometry.

    Returns (t, tri_idx, bu, bv) per ray; t = inf on miss — the same
    contract as _intersect_chunked, with u/v/t differing only by f32
    rounding between algebraically equal formulas."""
    r = dx.shape[0]
    n_chunks = tris["ax"].shape[0] // tri_chunk

    wx = o3[0] - tris["ax"]
    wy = o3[1] - tris["ay"]
    wz = o3[2] - tris["az"]
    e1x, e1y, e1z = tris["e1x"], tris["e1y"], tris["e1z"]
    e2x, e2y, e2z = tris["e2x"], tris["e2y"], tris["e2z"]
    # column blocks of the (3, 3T) feature matrix: [e2 x e1 | e2 x w | w x e1]
    fdx = e2y * e1z - e2z * e1y
    fdy = e2z * e1x - e2x * e1z
    fdz = e2x * e1y - e2y * e1x
    fux = e2y * wz - e2z * wy
    fuy = e2z * wx - e2x * wz
    fuz = e2x * wy - e2y * wx
    fvx = wy * e1z - wz * e1y
    fvy = wz * e1x - wx * e1z
    fvz = wx * e1y - wy * e1x
    t_num = e2x * fvx + e2y * fvy + e2z * fvz
    feats = jnp.stack(
        [fdx, fux, fvx, fdy, fuy, fvy, fdz, fuz, fvz]
    )  # (9, T): three rows (d component) x three column blocks
    d_mat = jnp.stack([dx, dy, dz], axis=1)  # (R, 3)

    def chunk_body(carry, ck):
        best_t, best_i, best_u, best_v = carry
        g9 = jax.lax.dynamic_slice_in_dim(
            feats, ck * tri_chunk, tri_chunk, axis=1
        )  # (9, Tc)
        g = g9.reshape(3, 3 * tri_chunk)
        tn = jax.lax.dynamic_slice_in_dim(t_num, ck * tri_chunk, tri_chunk)
        valid = jax.lax.dynamic_slice_in_dim(
            tris["valid"], ck * tri_chunk, tri_chunk
        )
        nums = jax.lax.dot_general(
            d_mat, g, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )  # (R, 3Tc): [det | u_num | v_num] column blocks
        det = nums[:, 0:tri_chunk]
        u_num = nums[:, tri_chunk : 2 * tri_chunk]
        v_num = nums[:, 2 * tri_chunk :]
        inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
        u = u_num * inv_det
        v = v_num * inv_det
        t = tn[None, :] * inv_det
        hit = (
            valid[None, :]
            & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > RAY_TMIN)
        )
        t = jnp.where(hit, t, jnp.inf)
        tj, uj, vj, j = _best_lane(t, u, v, ck * tri_chunk)
        closer = tj < best_t
        best_t = jnp.where(closer, tj, best_t)
        best_i = jnp.where(closer, j, best_i)
        best_u = jnp.where(closer, uj, best_u)
        best_v = jnp.where(closer, vj, best_v)
        return (best_t, best_i, best_u, best_v), None

    init = (
        jnp.full((r,), jnp.inf, jnp.float32),
        jnp.zeros((r,), jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
    )
    (t, i, u, v), _ = jax.lax.scan(
        chunk_body, init, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return t, i, u, v


def _intersect_mxu_general(ox, oy, oz, dx, dy, dz, tris, tri_chunk: int):
    """Möller-Trumbore for ARBITRARY-origin rays (the bounce pass) as one
    matmul per triangle chunk.

    All four MT quantities are linear in the 10-wide ray feature vector
    r = [d, o x d, o, 1] (c := o x d; triple-product rotations):
        det   = d . (e2 x e1)                       = d . fdet
        u_num = (o-a).(d x e2) = c . e2 + d.(a x e2)
        v_num = d.((o-a) x e1) = -c . e1 - d.(a x e1)
        t_num = e2.((o-a) x e1) = a . fdet - o . fdet
    so one (R, 10) x (10, 4*Tc) matmul at precision=HIGHEST (geometry on a
    reduced-precision matmul is poison) evaluates every (ray, triangle)
    pair; the epilogue is ~12 ops/pair — the same shape as the
    shared-origin primary pass.  The per-triangle feature matrix is
    precomputed at scene load (RtxHost.load_model, "feat10") — building it
    per call would put O(T) work inside every bounce chunk-step.

    t_num's cancellation ((a - o).fdet with bounce origins ON the mesh) is
    bounded by the HIGHEST-precision matmul: absolute error ~1e-7 x
    |o||fdet| against t_num >= RAY_TMIN*det — worst case ~1e-4 relative on
    t, absorbed by the same RAY_TMIN offset that exists for exactly this
    class of self-intersection noise.

    Keep R * 4*Tc moderate so XLA can fuse the matmul output into the
    epilogue + argmin: the win is never materializing the (R, 4Tc)
    plane."""
    r = dx.shape[0]
    n_chunks = tris["ax"].shape[0] // tri_chunk
    feats = tris["feat10"]  # (10, 4*T), chunk-contiguous column groups

    cx = oy * dz - oz * dy
    cy = oz * dx - ox * dz
    cz = ox * dy - oy * dx
    r10 = jnp.stack(
        [dx, dy, dz, cx, cy, cz, ox, oy, oz, jnp.ones_like(dx)], axis=1
    )  # (R, 10)

    def chunk_body(carry, ck):
        best_t, best_i, best_u, best_v = carry
        g = jax.lax.dynamic_slice_in_dim(
            feats, ck * (4 * tri_chunk), 4 * tri_chunk, axis=1
        )  # (10, 4*Tc)
        valid = jax.lax.dynamic_slice_in_dim(
            tris["valid"], ck * tri_chunk, tri_chunk
        )
        nums = jax.lax.dot_general(
            r10, g, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )  # (R, 4*Tc): [det | u_num | v_num | t_num] column BLOCKS —
        # quantity-major so every slice below is contiguous
        det = nums[:, 0:tri_chunk]
        inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
        u = nums[:, tri_chunk : 2 * tri_chunk] * inv_det
        v = nums[:, 2 * tri_chunk : 3 * tri_chunk] * inv_det
        t = nums[:, 3 * tri_chunk :] * inv_det
        hit = (
            valid[None, :]
            & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > RAY_TMIN)
        )
        t = jnp.where(hit, t, jnp.inf)
        tj, uj, vj, j = _best_lane(t, u, v, ck * tri_chunk)
        closer = tj < best_t
        best_t = jnp.where(closer, tj, best_t)
        best_i = jnp.where(closer, j, best_i)
        best_u = jnp.where(closer, uj, best_u)
        best_v = jnp.where(closer, vj, best_v)
        return (best_t, best_i, best_u, best_v), None

    init = (
        jnp.full((r,), jnp.inf, jnp.float32),
        jnp.zeros((r,), jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
    )
    (t, i, u, v), _ = jax.lax.scan(
        chunk_body, init, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return t, i, u, v


def _intersect(ox, oy, oz, dx, dy, dz, tris, tri_chunk: int):
    if "bb_minx" in tris:
        return _intersect_culled(ox, oy, oz, dx, dy, dz, tris, tri_chunk)
    if "feat10" in tris:
        return _intersect_mxu_general(ox, oy, oz, dx, dy, dz, tris, tri_chunk)
    return _intersect_chunked(ox, oy, oz, dx, dy, dz, tris, tri_chunk)


def _unit_sphere(key, shape):
    """Uniform sample inside the unit ball (gaussian direction x cbrt radius;
    same distribution as the reference's rejection loop, vectorized)."""
    kd, kr = jax.random.split(key)
    g = jax.random.normal(kd, shape + (3,))
    g = g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True), 1e-12)
    rad = jax.random.uniform(kr, shape) ** (1.0 / 3.0)
    return g * rad[..., None]


def _bounce_step(tris, tex_cm, background, env, tri_chunk: int,
                 ox, oy, oz, dx, dy, dz, atten, result, alive, reflected,
                 key, shared_origin=None, roulette_from: int = 0,
                 bounce_i=None):
    """One path-tracing bounce for a flat ray batch (the reference device
    loop body, RtxDevice.cu:105-158).  Returns the updated state tuple plus
    this step's raw intersection distance (inf on miss — the primary pass
    uses it for the orb overlay).

    ``tex_cm``: diffuse texture CHANNEL-MAJOR (4, th, tw) so the texel
    lookup is one 2-D column gather instead of an element-rate (R, 4) row
    gather.

    ``env``: optional (He, We, 3) equirectangular environment map replacing
    the reference's hard-coded white-gradient sky for BOUNCED miss rays
    (the RtxDevice.cu:155 TODO; primary misses keep the background color
    per the reference semantic).  Nearest-neighbor lookup."""
    r = ox.shape[0]
    th, tw = tex_cm.shape[1], tex_cm.shape[2]
    if roulette_from:
        # third stream only when roulette is on: the off path must keep
        # the exact reference-parity sample stream bit-for-bit
        kalpha, kscatter, kroul = jax.random.split(key, 3)
    else:
        kalpha, kscatter = jax.random.split(key)
    if shared_origin is not None:
        # primary pass: all rays share the eye — matmul intersector
        t, tri, bu, bv = _intersect_shared(
            shared_origin, dx, dy, dz, tris, tri_chunk
        )
    else:
        t, tri, bu, bv = _intersect(ox, oy, oz, dx, dy, dz, tris, tri_chunk)
    hit = alive & jnp.isfinite(t)

    # miss: sky color; never-reflected primary rays get the background
    if env is None:
        sky = jnp.minimum(1.0, 1.0 + dy)[:, None]
    else:
        eh, ew = env.shape[0], env.shape[1]
        u = jnp.arctan2(dz, dx) * (0.5 / jnp.pi) + 0.5
        v = jnp.arccos(jnp.clip(dy, -1.0, 1.0)) * (1.0 / jnp.pi)
        exi = jnp.clip((u * ew).astype(jnp.int32), 0, ew - 1)
        eyi = jnp.clip((v * eh).astype(jnp.int32), 0, eh - 1)
        sky = env[eyi, exi]
    # ``reflected`` carries the roulette boost as a float: 0 = never
    # reflected (miss -> background), >= 1 = reflected with survival
    # boost B (miss -> B * atten * sky).  The physical throughput
    # ``atten`` stays <= 1 per component, so the reference's per-sample
    # clamp is a no-op on it; the boost multiplies AFTER, keeping the
    # estimator unbiased through the clamp (a boost folded into atten
    # would bias the mean brightness down via clipping).  With roulette
    # off, reflected is exactly 0/1 and this is the reference semantic.
    refl_b = jnp.maximum(reflected, 1.0)[:, None]
    miss_color = atten * sky * refl_b
    miss_out = jnp.where(
        (reflected > 0.0)[:, None], miss_color, background[None, :]
    )
    missed = alive & ~jnp.isfinite(t)
    result = jnp.where(missed[:, None], miss_out, result)

    # surface data at the hit — ONE batched (9, R) column gather for all
    # per-triangle attributes (uv corners + normal); nine separate 1-D
    # gathers ran at element rate and dominated the bounce loop
    att = tris["attr9"][:, tri]  # (9, R)
    uvx = (1.0 - bu - bv) * att[0] + bu * att[2] + bv * att[4]
    uvy = (1.0 - bu - bv) * att[1] + bu * att[3] + bv * att[5]
    # nearest-neighbor, wrap addressing, flipped V
    px = jnp.mod(jnp.floor(uvx * tw), tw).astype(jnp.int32)
    py = jnp.mod(jnp.floor((1.0 - uvy) * th), th).astype(jnp.int32)
    texel = tex_cm.reshape(4, th * tw)[:, py * tw + px]  # (4, R)

    # stochastic alpha: texture.w > rand -> material hit
    u_alpha = jax.random.uniform(kalpha, (r,))
    solid = hit & (texel[3] > u_alpha)

    scatter = jnp.stack([att[6], att[7], att[8]], -1) + _unit_sphere(kscatter, (r,))

    tsafe = jnp.where(jnp.isfinite(t), t, 0.0)
    ox = jnp.where(hit, ox + tsafe * dx, ox)
    oy = jnp.where(hit, oy + tsafe * dy, oy)
    oz = jnp.where(hit, oz + tsafe * dz, oz)
    dx = jnp.where(solid, scatter[:, 0], dx)
    dy = jnp.where(solid, scatter[:, 1], dy)
    dz = jnp.where(solid, scatter[:, 2], dz)
    atten = jnp.where(solid[:, None], atten * jnp.transpose(texel[0:3]), atten)
    reflected = jnp.maximum(reflected, solid.astype(jnp.float32))
    alive = alive & hit  # miss rays are done; hit rays continue

    if roulette_from:
        # Russian roulette (OPT-IN; framework deviation from the
        # reference, which always marches to the 50-bounce cap,
        # src/rtx/RtxDevice.cu:23).  From bounce ``roulette_from`` on,
        # each REFLECTED surviving ray is killed with probability 1/2
        # and survivors double their boost factor (carried in the
        # ``reflected`` row; applied after the clamp-safe throughput at
        # miss — see the miss-path note above).  Unreflected rays are
        # never killed: they must still return the background color.
        # Killed rays contribute black exactly like rays exceeding the
        # cap.  Motivation is the trapped-ray tail: rays scattered into
        # a closed mesh's interior otherwise pin their bounce chunks
        # for all 50 iterations.  Max-component roulette (survival =
        # throughput) barely shortens the tail at albedo ~0.9; the flat
        # 1/2 actually cuts it.
        u_roul = jax.random.uniform(kroul, (r,))
        gate = (bounce_i >= roulette_from) & (reflected > 0.0)
        kill = alive & gate & (u_roul >= 0.5)
        boost = alive & gate & ~kill
        reflected = jnp.where(boost, reflected * 2.0, reflected)
        alive = alive & ~kill

    return (ox, oy, oz, dx, dy, dz, atten, result, alive, reflected), t


def trace_rays(tris, texture, origins, dirs, bounces, background, key,
               tri_chunk: int, env=None, roulette_from: int = 0):
    """Trace one batch of primary rays to completion.

    origins/dirs: (R, 3).  Returns (color (R, 3), primary_t (R,)) where
    primary_t is the first-hit distance (inf on miss) for the orb overlay.

    The production capture path (render_rtx_sums) instead traces primaries
    for the WHOLE frame, compacts the surviving rays, and only bounce-loops
    the compacted chunks — same math, ~an order of magnitude less device
    work when most primaries miss or terminate early."""
    r = origins.shape[0]
    texture = jnp.moveaxis(jnp.asarray(texture, jnp.float32), -1, 0)  # (4, th, tw)
    background = jnp.asarray(background, jnp.float32)
    state = (
        origins[:, 0], origins[:, 1], origins[:, 2],
        dirs[:, 0], dirs[:, 1], dirs[:, 2],
        jnp.ones((r, 3), jnp.float32),   # atten
        jnp.zeros((r, 3), jnp.float32),  # result
        jnp.ones((r,), bool),            # alive
        jnp.zeros((r,), jnp.float32),    # reflected (0 / roulette boost)
    )
    primary_t = jnp.full((r,), jnp.inf, jnp.float32)

    def cond(s):
        i, state, _, _ = s
        return (i < bounces) & jnp.any(state[8])

    def body(s):
        i, state, primary_t, key = s
        key, kb = jax.random.split(key)
        state, t = _bounce_step(
            tris, texture, background, env, tri_chunk, *state, kb,
            roulette_from=roulette_from, bounce_i=i,
        )
        primary_t = jnp.where((i == 0) & jnp.isfinite(t), t, primary_t)
        return i + 1, state, primary_t, key

    _, state, primary_t, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), state, primary_t, key)
    )
    result, alive = state[7], state[8]
    # rays still alive after the bounce cap return black (already zeros)
    result = jnp.where(alive[:, None], 0.0, result)
    return result, primary_t


def render_rtx_sums(
    tris,
    texture,
    cam_location,
    inv_proj_view,
    width: int,
    height: int,
    samples: int,
    background,
    key,
    splat_cameras: Optional[jax.Array] = None,
    bounces: int = MAX_BOUNCES,
    ray_chunk: int = 16384,
    tri_chunk: int = 512,
    env: Optional[jax.Array] = None,
    bounce_chunk: int = 4096,
    bounce_round: Optional[int] = None,
    roulette_from: int = 0,
):
    """One dispatch of ``samples`` paths per pixel: returns the flat
    (n_pix, 3) color SUM and (n_pix,) orb-overlay mask (sums, so captures
    can also be split across dispatches and added)."""
    background = jnp.asarray(background, jnp.float32)
    cam_location = jnp.asarray(cam_location, jnp.float32)
    # channel-major texture: the bounce texel lookup becomes one 2-D
    # column gather (one cheap transpose per dispatch)
    texture = jnp.moveaxis(jnp.asarray(texture, jnp.float32), -1, 0)
    n_pix = width * height
    # pad the flat pixel list to a chunk multiple (odd resolutions would
    # otherwise need a pathological chunk size); pad rays re-trace pixel 0
    # and are cropped on return
    n_pad = -(-n_pix // ray_chunk) * ray_chunk
    if ray_chunk % bounce_chunk:
        bounce_chunk = ray_chunk  # bounce chunks must tile the pad

    pix = jnp.minimum(jnp.arange(n_pad, dtype=jnp.int32), n_pix - 1)
    pxi = (pix % width).astype(jnp.float32)
    pyi = (pix // width).astype(jnp.float32)

    n_chunks = n_pad // ray_chunk

    def sample_pass(carry, k):
        """One path-traced sample for every pixel, in two phases:

        1. PRIMARY: generate + intersect camera rays for all chunks (one
           bounce step each — no loop; the shared eye origin rides the
           matmul intersector).
        2. BOUNCE: compact the surviving rays to the front of the frame
           (stable sort on the dead flag — deterministic, so the culled
           and brute-force intersectors still agree bit-for-bit), then
           run the bounce while-loop per bounce_chunk-sized chunk.
           All-dead chunks exit their loop at iteration 0, so the
           tail-latency cost of "march every chunk until its LAST ray
           dies" is only paid by the few chunks that still hold live
           rays (typically <10% of rays survive the primary bounce:
           misses die immediately)."""
        color_acc, orb_acc = carry
        kj, kt, kb = jax.random.split(k, 3)

        def primary_chunk(c):
            px = jax.lax.dynamic_slice_in_dim(pxi, c * ray_chunk, ray_chunk)
            py = jax.lax.dynamic_slice_in_dim(pyi, c * ray_chunk, ray_chunk)
            kk = jax.random.fold_in(kj, c)
            j = jax.random.uniform(kk, (ray_chunk, 2))
            fx = px + j[:, 0] + 0.5
            fy = py + j[:, 1] + 0.5
            nx = fx * 2.0 / width - 1.0
            ny = fy * 2.0 / height - 1.0
            # component-wise 4x4 apply at z=w=1: a jnp matmul here may run
            # at reduced (TF32/bf16) default precision, and the projective
            # w (~near/far cancellation, e.g. 4.995 - 5.005) cancels to
            # garbage -> inf/NaN ray directions.  FMA chains stay f32.
            m = inv_proj_view
            fwx = m[0, 0] * nx + m[0, 1] * ny + m[0, 2] + m[0, 3]
            fwy = m[1, 0] * nx + m[1, 1] * ny + m[1, 2] + m[1, 3]
            fwz = m[2, 0] * nx + m[2, 1] * ny + m[2, 2] + m[2, 3]
            fww = m[3, 0] * nx + m[3, 1] * ny + m[3, 2] + m[3, 3]
            inv_w = 1.0 / fww
            dx = fwx * inv_w - cam_location[0]
            dy = fwy * inv_w - cam_location[1]
            dz = fwz * inv_w - cam_location[2]
            dn = 1.0 / jnp.maximum(jnp.sqrt(dx * dx + dy * dy + dz * dz), 1e-12)
            d = jnp.stack([dx * dn, dy * dn, dz * dn], -1)
            o = jnp.broadcast_to(cam_location, (ray_chunk, 3))
            state = (
                o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                jnp.ones((ray_chunk, 3), jnp.float32),
                jnp.zeros((ray_chunk, 3), jnp.float32),
                jnp.ones((ray_chunk,), bool),
                jnp.zeros((ray_chunk,), jnp.float32),  # reflected/boost
            )
            state, primary_t = _bounce_step(
                tris, texture, background, env, tri_chunk, *state,
                jax.random.fold_in(kt, c), shared_origin=cam_location,
                roulette_from=roulette_from, bounce_i=jnp.int32(0),
            )
            (sox, soy, soz, sdx, sdy, sdz, atten, result, alive, refl) = state
            rows = jnp.stack([
                sox, soy, soz, sdx, sdy, sdz,
                atten[:, 0], atten[:, 1], atten[:, 2],
                alive.astype(jnp.float32), refl,  # refl row IS the boost
            ])  # (11, ray_chunk)
            # orb overlay: primary ray passes near a truth camera, not occluded
            if splat_cameras is not None and splat_cameras.shape[0] > 0:
                rel = splat_cameras[None, :, :] - o[:, None, :]  # (R, K, 3)
                tproj = jnp.sum(d[:, None, :] * rel, -1)  # (R, K)
                closest = o[:, None, :] + d[:, None, :] * tproj[..., None]
                delta = splat_cameras[None, :, :] - closest
                near = jnp.sum(delta * delta, -1) < SPLAT_CAMERA_DOT_SIZE**2
                # orbs only IN FRONT of the eye: a rig camera at the eye
                # itself (previewTruth) gives tproj = 0 / delta = 0 for
                # every ray and would invert the whole image; cameras
                # behind the eye would draw phantom dots on the ray's
                # backward extension
                visible = (tproj > 1e-6) & (tproj <= primary_t[:, None])
                orb = jnp.any(near & visible, axis=1)
            else:
                orb = jnp.zeros((ray_chunk,), bool)
            return rows, jnp.transpose(result), orb

        rows_c, pres_c, orbs = jax.lax.map(
            primary_chunk, jnp.arange(n_chunks, dtype=jnp.int32)
        )  # (NC, 11, R), (NC, 3, R), (NC, R)
        rows = jnp.moveaxis(rows_c, 0, 1).reshape(11, n_pad)
        pres = jnp.moveaxis(pres_c, 0, 1).reshape(3, n_pad)
        alive_primary = rows[9] > 0.5

        # ---- bounce phase: PHASED alive re-compaction -------------------
        # State rows: [o(3), d(3), atten(3), alive, refl, result(3)] = 14
        # float rows + a separate int32 ray-id vector (permuted alongside;
        # integer so ids stay exact past f32's 2^24 on huge renders).
        # Each phase runs the per-chunk bounce while-loops for at most
        # bounce_round bounces (bounce_chunk <= ray_chunk chunks; all-dead
        # chunks exit at trip 0), then STABLE-sorts survivors back to the
        # front.  Without re-compaction a handful of trapped rays (e.g.
        # scattered into a closed mesh's interior, bouncing to the 50-cap)
        # pin EVERY chunk they occupy for the full 50 iterations.  The
        # phase loop is a while_loop
        # that exits as soon as every ray is dead.
        iota = jnp.arange(n_pad, dtype=jnp.int32)
        nbc = n_pad // bounce_chunk
        st0 = jnp.concatenate([rows, jnp.zeros((3, n_pad), jnp.float32)])

        def compact(st, ids):
            alive = st[9] > 0.5
            _, perm = jax.lax.sort_key_val(
                (~alive).astype(jnp.int32), iota, is_stable=True
            )
            return st[:, perm], ids[perm]

        st0, ids0 = compact(st0, iota)
        # bounce_round=None (default): ONE phase.  Re-compaction phases
        # trade a full compaction per phase for tail savings; the knob is
        # for trap-heavy scenes where the tail dominates.
        rnd = bounce_round if bounce_round else max(bounces - 1, 1)
        n_phases = max(1, -(-(bounces - 1) // rnd)) if bounces > 1 else 1

        def run_phase(st, kp, start, stop):
            """Early-exit chunk march over [start, stop) bounces.

            Survivors are COMPACTED to the front of ``st`` (compact()
            before every phase), so chunks are alive-prefix ordered: the
            first all-dead chunk proves every later chunk is dead too.
            A while_loop over the chunk INDEX therefore visits only the
            ~ceil(alive / bounce_chunk) live chunks instead of paying a
            step for ALL n_pad/bounce_chunk chunks.  The in-place
            dynamic_update_slice donates the (14, n_pad) carry, and the
            per-chunk math is bit-identical to the map version (same
            fold_in(kp, c) RNG stream)."""

            # compacted => alive rays are a PREFIX: the number of live
            # chunks is one reduction, computed once per phase, so the
            # march cond is a scalar compare (not a per-chunk slice+any)
            n_live = jnp.minimum(
                (jnp.sum((st[9] > 0.5).astype(jnp.int32)) + bounce_chunk - 1)
                // bounce_chunk,
                nbc,
            )

            def cond(sc):
                c, s, _ = sc
                return c < n_live

            def march(sc):
                c, s, kk = sc
                blk = jax.lax.dynamic_slice(
                    s, (0, c * bounce_chunk), (14, bounce_chunk)
                )
                state = (
                    blk[0], blk[1], blk[2], blk[3], blk[4], blk[5],
                    jnp.transpose(blk[6:9]),
                    jnp.transpose(blk[11:14]),
                    blk[9] > 0.5,
                    blk[10],  # reflected/boost row stays float
                )

                def bcond(si):
                    i, state, _ = si
                    return (i < stop) & jnp.any(state[8])

                def bbody(si):
                    i, state, k3 = si
                    k3, k2 = jax.random.split(k3)
                    state, _ = _bounce_step(
                        tris, texture, background, env, tri_chunk, *state, k2,
                        roulette_from=roulette_from, bounce_i=i,
                    )
                    return i + 1, state, k3

                _, state, _ = jax.lax.while_loop(
                    bcond, bbody,
                    (jnp.int32(0) + start, state, jax.random.fold_in(kk, c)),
                )
                (ox, oy, oz, dx, dy, dz, atten, result, alive, refl) = state
                out = jnp.concatenate([
                    jnp.stack([ox, oy, oz, dx, dy, dz]),
                    jnp.transpose(atten),
                    jnp.stack([alive.astype(jnp.float32), refl]),
                    jnp.transpose(result),
                ])  # (14, bounce_chunk)
                s = jax.lax.dynamic_update_slice(s, out, (0, c * bounce_chunk))
                return c + 1, s, kk

            _, st, _ = jax.lax.while_loop(cond, march, (jnp.int32(0), st, kp))
            return st

        # phases 0..n-2 run in a while_loop (map + compact each); the
        # FINAL phase runs outside it with no trailing compact, so
        # n_phases == 1 (the default) is exactly the compact-once shape.
        def phase_cond(s):
            p, st, ids, key = s
            return (p < n_phases - 1) & jnp.any(st[9] > 0.5)

        def phase_body(s):
            p, st, ids, key = s
            key, kp = jax.random.split(key)
            start = 1 + p * rnd
            st = run_phase(st, kp, start, start + rnd)
            st, ids = compact(st, ids)
            return p + 1, st, ids, key

        p, st, ids, key = jax.lax.while_loop(
            phase_cond, phase_body, (jnp.int32(0), st0, ids0, kb)
        )
        st = run_phase(st, jax.random.split(key)[1], 1 + p * rnd,
                       jnp.int32(bounces))
        # rays alive past the bounce cap return black (reference :57)
        bres_c = jnp.where((st[9] > 0.5)[None, :], 0.0, st[11:14])
        # un-permute via one unstable sort on the unique ray ids
        _, order = jax.lax.sort_key_val(ids, iota, is_stable=False)
        bres = bres_c[:, order]
        color = jnp.where(alive_primary[None, :], bres, pres)
        if roulette_from:
            # roulette results are (clamp-safe throughput) x boost: the
            # per-sample estimate may exceed 1 by design; clipping it
            # would re-introduce the bias the boost construction avoids.
            color = jnp.maximum(jnp.transpose(color), 0.0)  # (n_pad, 3)
        else:
            color = jnp.clip(jnp.transpose(color), 0.0, 1.0)  # (n_pad, 3)
        return (
            color_acc + color[:n_pix],
            orb_acc | orbs.reshape(n_pad)[:n_pix],
        ), None

    keys = jax.random.split(key, samples)
    (color, orb), _ = jax.lax.scan(
        sample_pass,
        (jnp.zeros((n_pix, 3), jnp.float32), jnp.zeros((n_pix,), bool)),
        keys,
    )
    return color, orb


def finish_rtx(color_sum, orb, samples: int, width: int, height: int):
    """Combine (possibly multi-dispatch) sample sums into the final image."""
    color = color_sum / samples
    color = jnp.where(orb[:, None], 1.0 - color, color)
    return color.reshape(height, width, 3)


def render_rtx(*args, samples: int = None, width: int = None,
               height: int = None, **kwargs):
    """Render one truth photograph: (H, W, 3) float32 in [0, 1].

    Single-dispatch convenience over render_rtx_sums + finish_rtx (the
    RtxHost production path batches dispatches instead)."""
    if samples is None or width is None or height is None:
        raise TypeError("render_rtx requires width=, height=, samples=")
    color_sum, orb = render_rtx_sums(
        *args, width=width, height=height, samples=samples, **kwargs
    )
    return finish_rtx(color_sum, orb, samples, width, height)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _morton3(q: np.ndarray) -> np.ndarray:
    """(T, 3) int64 coords in [0, 1024) -> interleaved Morton codes."""
    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


class RtxHost:
    """Host-side scene owner: mesh + texture upload, render dispatch.

    Mirror of the reference RtxHost (src/rtx/RtxHost.{h,cpp}): owns the
    scene, rebuilds device buffers when geometry or texture changes, renders
    black with no model loaded, mid-gray fallback texture."""

    def __init__(self, tri_chunk: int = 512, ray_chunk: int = 16384,
                 bounce_chunk: int = 4096, bounce_round: Optional[int] = None,
                 roulette_from: int = 0):
        self.tri_chunk = tri_chunk
        self.ray_chunk = ray_chunk
        # bounce-phase chunk width: smaller than ray_chunk so per-chunk
        # while-loops track the geometric decay of live rays at finer
        # granularity (must divide ray_chunk; falls back to it), and the
        # matmul intersector's (R, 4*Tc) plane stays fusion-friendly
        self.bounce_chunk = bounce_chunk
        # bounces per phase between alive re-compactions (render_rtx_sums)
        self.bounce_round = bounce_round
        # Russian-roulette start bounce (0 = off, reference parity —
        # see _bounce_step; opt-in speed/variance trade for captures)
        self.roulette_from = roulette_from
        self.mesh: Optional[TriangleMesh] = None
        self._tris = None
        self._texture = jnp.asarray(blank_texture())
        self._env = None  # optional equirect sky (load_environment)
        self._render = jax.jit(
            render_rtx_sums,
            static_argnames=("width", "height", "samples", "bounces",
                            "ray_chunk", "tri_chunk", "bounce_chunk",
                            "bounce_round", "roulette_from"),
        )
        self._seed = 0

    # -- scene management (reference RtxHost::loadModel / loadTextureDiffuse)
    def load_model(self, source, progress=None, accel_min: int = 2 * 512,
                   mxu_bounce: bool = True) -> None:
        """``accel_min``: triangle count past which the Morton-chunk AABB
        march replaces brute force.  ``mxu_bounce``: on brute-force scenes,
        precompute the feature matrix that routes BOUNCE rays through the
        general-origin matmul intersector (same math up to f32 rounding;
        False keeps the component form for exact A/B)."""
        mesh = source if isinstance(source, TriangleMesh) else load_obj(source, progress)
        self.mesh = mesh
        t = mesh.num_triangles
        tc = max(self.tri_chunk, _round_up(t, self.tri_chunk))
        v = mesh.vertices
        tri = mesh.triangles
        tri_uv_src = mesh.tri_uv
        # Morton-order the triangles so fixed-size chunks are spatially
        # coherent; per-chunk AABBs then cull most chunks per ray (the BVH
        # substitute — SURVEY §7 hard part 4)
        use_accel = t >= accel_min
        if use_accel and t > 0:
            cent = (v[tri[:, 0]] + v[tri[:, 1]] + v[tri[:, 2]]) / 3.0
            lo, hi = cent.min(0), cent.max(0)
            q = np.clip(
                ((cent - lo) / np.maximum(hi - lo, 1e-12) * 1023.0), 0, 1023
            ).astype(np.int64)
            order = np.argsort(_morton3(q), kind="stable")
            tri = tri[order]
            tri_uv_src = tri_uv_src[order]
        a = np.zeros((tc, 3), np.float32)
        e1 = np.zeros((tc, 3), np.float32)
        e2 = np.zeros((tc, 3), np.float32)
        a[:t] = v[tri[:, 0]]
        e1[:t] = v[tri[:, 1]] - v[tri[:, 0]]
        e2[:t] = v[tri[:, 2]] - v[tri[:, 0]]
        n = np.cross(e1[:t], e2[:t])
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        nrm = np.zeros((tc, 3), np.float32)
        nrm[:t] = n
        uv = np.zeros((tc, 3, 2), np.float32)
        uv[:t] = tri_uv_src
        valid = np.zeros((tc,), bool)
        valid[:t] = True
        self._tris = {
            "ax": jnp.asarray(a[:, 0]), "ay": jnp.asarray(a[:, 1]), "az": jnp.asarray(a[:, 2]),
            "e1x": jnp.asarray(e1[:, 0]), "e1y": jnp.asarray(e1[:, 1]), "e1z": jnp.asarray(e1[:, 2]),
            "e2x": jnp.asarray(e2[:, 0]), "e2y": jnp.asarray(e2[:, 1]), "e2z": jnp.asarray(e2[:, 2]),
            "valid": jnp.asarray(valid),
            # batched surface-attribute table: [uv0 uv1 uv2 (xy each), n]
            # — one (9, R) column gather per bounce replaces nine 1-D
            # element gathers (_bounce_step)
            "attr9": jnp.asarray(np.stack([
                uv[:, 0, 0], uv[:, 0, 1], uv[:, 1, 0], uv[:, 1, 1],
                uv[:, 2, 0], uv[:, 2, 1], nrm[:, 0], nrm[:, 1], nrm[:, 2],
            ])),
        }
        if use_accel:
            nc = tc // self.tri_chunk
            corners = np.stack([a, a + e1, a + e2])  # (3, tc, 3)
            big = np.float32(np.inf)
            mn = np.where(valid[None, :, None], corners, big).min(0)
            mx = np.where(valid[None, :, None], corners, -big).max(0)
            mn = mn.reshape(nc, self.tri_chunk, 3).min(1)
            mx = mx.reshape(nc, self.tri_chunk, 3).max(1)
            self._tris.update({
                "bb_minx": jnp.asarray(mn[:, 0]), "bb_miny": jnp.asarray(mn[:, 1]),
                "bb_minz": jnp.asarray(mn[:, 2]),
                "bb_maxx": jnp.asarray(mx[:, 0]), "bb_maxy": jnp.asarray(mx[:, 1]),
                "bb_maxz": jnp.asarray(mx[:, 2]),
                # batched geometry table for the culled march: one
                # (10, R*Tc) column gather per step instead of ten
                # element-rate (R, Tc) gathers
                "geo10": jnp.asarray(np.concatenate([
                    a.T, e1.T, e2.T, valid[None].astype(np.float32),
                ])),
            })
        elif mxu_bounce:
            # general-origin matmul intersector feature matrix (10, 4*tc):
            # per-chunk column blocks [det | u_num | v_num | t_num], each
            # linear in the ray features [d, o x d, o, 1]
            # (_intersect_mxu_general).  Quantity-MAJOR within each chunk
            # so the epilogue slices are contiguous, chunk-contiguous
            # overall so the per-chunk fetch is one dynamic_slice.
            fdet = np.cross(e2, e1)
            featq = np.zeros((4, tc, 10), np.float32)
            featq[0, :, 0:3] = fdet
            featq[1, :, 0:3] = np.cross(a, e2)
            featq[1, :, 3:6] = e2
            featq[2, :, 0:3] = -np.cross(a, e1)
            featq[2, :, 3:6] = -e1
            featq[3, :, 6:9] = -fdet
            featq[3, :, 9] = np.sum(a * fdet, axis=-1)
            ncb = tc // self.tri_chunk
            f10 = (
                featq.reshape(4, ncb, self.tri_chunk, 10)
                .transpose(3, 1, 0, 2)
                .reshape(10, 4 * tc)
            )
            self._tris["feat10"] = jnp.asarray(np.ascontiguousarray(f10))

    def load_texture_diffuse(self, source) -> None:
        tex = source if isinstance(source, np.ndarray) else load_texture_rgba(source)
        self._texture = jnp.asarray(tex, jnp.float32)

    def load_environment(self, source) -> None:
        """Equirectangular sky map for bounced miss rays (None resets to
        the reference's white-gradient sky): (H, W, 3) float array in
        [0, 1] or an image path."""
        if source is None:
            self._env = None
            return
        if isinstance(source, (str, bytes)):
            rgba = load_texture_rgba(source)
            self._env = jnp.asarray(rgba[..., :3], jnp.float32)
        else:
            self._env = jnp.asarray(source, jnp.float32)

    def reset(self) -> None:
        self.mesh = None
        self._tris = None
        self._texture = jnp.asarray(blank_texture())
        self._env = None

    # -- render (reference RtxHost::render) -----------------------------
    def render(
        self,
        camera: Camera,
        background,
        samples: int,
        width: int = 1024,
        height: int = 1024,
        splat_cameras=None,
        bounces: int = MAX_BOUNCES,
        seed: Optional[int] = None,
    ):
        if self._tris is None:
            return jnp.zeros((height, width, 3), jnp.float32)  # no model: black
        inv_pv = jnp.asarray(
            np.linalg.inv(camera.get_proj_view(width / height).astype(np.float64))
            .astype(np.float32)
        )
        if seed is None:
            self._seed += 1
            seed = self._seed
        cams = None
        if splat_cameras is not None and len(splat_cameras):
            cams = jnp.asarray(np.stack([np.asarray(c, np.float32) for c in splat_cameras]))
        color_sum, orb = self._render(
            self._tris, self._texture, camera.location, inv_pv,
            width=width, height=height, samples=samples,
            background=jnp.asarray(background, jnp.float32),
            key=jax.random.PRNGKey(seed), splat_cameras=cams,
            bounces=bounces, ray_chunk=self.ray_chunk,
            tri_chunk=self.tri_chunk, env=self._env,
            bounce_chunk=self.bounce_chunk, bounce_round=self.bounce_round,
            roulette_from=self.roulette_from,
        )
        # the final image is returned lazily: callers consume it through
        # ordinary JAX ops (stacking truths, tiling) and block when they
        # actually need the values — cross-camera pipelining for free
        return finish_rtx(color_sum, orb, samples, width, height)
