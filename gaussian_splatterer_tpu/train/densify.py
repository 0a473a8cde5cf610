"""Densification: split / clone / cull, as a jitted masked transform.

The reference does this on the CPU with dynamic arrays and per-insert
capacity checks (src/Trainer.cu:437-542).  Here it is a pure function on
the fixed-capacity padded model: appends are rank-ordered GATHERS into the
slots past ``count`` (scatter-free) and culling is a stable masked
compaction — no reallocation, no host round-trip.

Semantics preserved from the reference:
  * classification on the *pre-split* model (src/Trainer.cu:448-456):
      - cull when opacity <= paramCullOpacity or |scale| < paramCullSize
      - else volatile when var(|grad_loc|) - |mean grad_loc| > paramDensifyVariance
        -> split when |scale| > paramSplitSize else clone
  * split (src/Trainer.cu:459-496): offset along the splat's largest scale
    axis rotated by its quaternion; both halves scaled by paramSplitScale;
    original moved +offset/2, the appended copy -offset/2
  * clone (src/Trainer.cu:499-521): appended copy offset by
    (R(q) @ scale) * normalize(grad_loc) * paramCloneDistance (componentwise)
  * splits append before clones; appends stop at capacity
    (src/Trainer.cu:460,500)
  * cull is a stable compaction (src/Trainer.cu:524-534)

Deviation: the reference iterates unordered_sets (nondeterministic order
when capacity is tight); we process in index order, deterministically.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gaussian_splatterer_tpu.models.splats import SplatModel
from gaussian_splatterer_tpu.ops.transforms import quat_to_rotmat


class DensifyParams(NamedTuple):
    cull_opacity: jnp.float32
    cull_size: jnp.float32
    densify_variance: jnp.float32
    split_size: jnp.float32
    split_distance: jnp.float32
    split_scale: jnp.float32
    clone_distance: jnp.float32

    @classmethod
    def from_project(cls, project) -> "DensifyParams":
        return cls(
            cull_opacity=jnp.float32(project.paramCullOpacity),
            cull_size=jnp.float32(project.paramCullSize),
            densify_variance=jnp.float32(project.paramDensifyVariance),
            split_size=jnp.float32(project.paramSplitSize),
            split_distance=jnp.float32(project.paramSplitDistance),
            split_scale=jnp.float32(project.paramSplitScale),
            clone_distance=jnp.float32(project.paramCloneDistance),
        )


@partial(jax.jit, donate_argnums=(0,))
def densify(
    model: SplatModel,
    var_loc: jax.Array,  # (C,) mean |per-frame location grad|
    avg_grad_loc: jax.Array,  # (C, 3) mean location grad
    params: DensifyParams,
) -> SplatModel:
    cap = model.capacity
    idx = jnp.arange(cap, dtype=jnp.int32)
    active = idx < model.count

    size_mag = jnp.linalg.norm(model.scales, axis=-1)
    grad_mag = jnp.linalg.norm(avg_grad_loc, axis=-1)

    remove = active & (
        (model.opacities <= params.cull_opacity) | (size_mag < params.cull_size)
    )
    volatile = active & ~remove & ((var_loc - grad_mag) > params.densify_variance)
    split = volatile & (size_mag > params.split_size)
    clone = volatile & ~split

    # ---- appends: splits first, then clones, both capped at capacity ----
    free = cap - model.count
    split_rank = jnp.cumsum(split.astype(jnp.int32)) - 1  # rank among splits
    split_ok = split & (split_rank < free)
    n_split = jnp.sum(split_ok.astype(jnp.int32))
    clone_rank = jnp.cumsum(clone.astype(jnp.int32)) - 1
    clone_ok = clone & (clone_rank < free - n_split)
    n_clone = jnp.sum(clone_ok.astype(jnp.int32))

    rot = quat_to_rotmat(model.rotations)  # (C, 3, 3)

    # split offset: largest scale axis, rotated (src/Trainer.cu:466-479)
    sx, sy, sz = model.scales[:, 0], model.scales[:, 1], model.scales[:, 2]
    is_x = (sx > sy) & (sx > sz)
    is_y = ~is_x & (sy > sz)
    axis_scale = jnp.stack(
        [
            jnp.where(is_x, sx, 0.0),
            jnp.where(is_y, sy, 0.0),
            jnp.where(~(is_x | is_y), sz, 0.0),
        ],
        -1,
    )
    split_offset = jnp.einsum("nij,nj->ni", rot, axis_scale) * (
        params.split_distance * 0.5
    )
    split_scales = model.scales * params.split_scale

    # clone offset: (R @ scale) * dir(grad) * cloneDistance, componentwise
    # (src/Trainer.cu:506-511)
    dir_grad = avg_grad_loc / jnp.maximum(grad_mag, 1e-12)[:, None]
    clone_offset = (
        jnp.einsum("nij,nj->ni", rot, model.scales) * dir_grad * params.clone_distance
    )

    # ---- appends as GATHERS, not scatters: a stable argsort puts the
    # split/clone sources first IN ORIGINAL ORDER (= rank order), so append
    # slot count+k reads source split_src[k] / clone_src[k'] with one row
    # gather per parameter array.
    split_src = jnp.argsort(~split_ok, stable=True)  # (C,) rank -> source
    clone_src = jnp.argsort(~clone_ok, stable=True)
    k = idx - model.count  # append rank per slot (< 0 for original slots)
    is_app_split = (k >= 0) & (k < n_split)
    kc = k - n_split
    is_app_clone = (kc >= 0) & (kc < n_clone)
    app_src = jnp.where(
        is_app_split,
        split_src[jnp.clip(k, 0, cap - 1)],
        clone_src[jnp.clip(kc, 0, cap - 1)],
    )
    src = jnp.where(k < 0, idx, app_src)  # originals read themselves

    # means: original split half moves +offset, appended half -offset,
    # appended clone +clone_offset (all offsets gathered at the source)
    split_ok_g = split_ok[src]
    split_coef = jnp.where(
        is_app_split, -1.0, jnp.where((k < 0) & split_ok_g, 1.0, 0.0)
    )
    means = (
        model.means[src]
        + split_coef[:, None] * split_offset[src]
        + jnp.where(is_app_clone, 1.0, 0.0)[:, None] * clone_offset[src]
    )
    scales = jnp.where(
        (is_app_split | ((k < 0) & split_ok_g))[:, None],
        split_scales[src],
        model.scales[src],
    )
    shs = model.shs[src]
    opacities = model.opacities[src]
    rotations = model.rotations[src]

    count_after_append = model.count + n_split + n_clone

    # ---- stable compaction of culled splats -----------------------------
    keep = (idx < count_after_append) & ~remove  # appends are never culled
    order = jnp.argsort(~keep, stable=True)  # kept splats first, original order
    new_count = jnp.sum(keep.astype(jnp.int32))

    # zero out the tail so padded slots stay inert
    tail = jnp.arange(cap, dtype=jnp.int32) >= new_count
    means = jnp.where(tail[:, None], 0.0, means[order])
    shs = jnp.where(tail[:, None, None], 0.0, shs[order])
    scales = jnp.where(tail[:, None], 0.0, scales[order])
    opacities = jnp.where(tail, 0.0, opacities[order])
    rotations = jnp.where(
        tail[:, None], jnp.array([1.0, 0, 0, 0], jnp.float32), rotations[order]
    )

    return SplatModel(
        means=means,
        shs=shs,
        scales=scales,
        opacities=opacities,
        rotations=rotations,
        count=new_count.astype(jnp.int32),
        sh_degree=model.sh_degree,
    )
