"""Densify under sharded parameters: gather -> densify -> re-shard.

The reference densifies on the HOST every ``intervalDensify=200``
iterations (src/Trainer.cu:433-542) — i.e. densification is already a
gather-to-one-place operation at a slow cadence in the reference design.
The equivalent for splat-sharded models (fsdp / mesh3 / routed3) keeps
that shape: all-gather the shard-resident parameters to a replicated copy
(one fused all-gather, ~50 MB at 1M splats — cheap at a 200-step
cadence), run the exact single-device ``densify`` transform
(train/densify.py, itself a jitted scatter-free gather program), and
re-shard the result with the caller's model sharder.

Camera-DP models are replicated and never need this; ``Trainer`` calls
``densify`` directly for them.

Semantics: identical to single-device densify by construction — the
gathered arrays ARE the single-device arrays (asserted in
tests/test_product_parallel.py and the driver's dryrun loop).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gaussian_splatterer_tpu.models.splats import SplatModel
from gaussian_splatterer_tpu.train.densify import DensifyParams, densify


def _replicate(mesh: Mesh, x):
    if getattr(x, "ndim", None) is None:
        return x  # static field (sh_degree)
    return jax.device_put(x, NamedSharding(mesh, P()))


def densify_sharded(
    mesh: Mesh,
    model: SplatModel,
    var_loc: jax.Array,
    avg_grad_loc: jax.Array,
    params: DensifyParams,
    reshard_model,
) -> SplatModel:
    """Densify a splat-sharded model exactly as a single device would.

    ``reshard_model(mesh, model) -> model`` re-applies the rest-state
    sharding (parallel.fsdp.shard_model / parallel.mesh3.shard_model_3d).
    ``var_loc`` / ``avg_grad_loc`` may arrive shard-placed (the fsdp and
    mesh3 steps emit them P(splat)); they are gathered alongside the
    model.
    """
    model_r = jax.tree.map(lambda x: _replicate(mesh, x), model)
    var_r = _replicate(mesh, var_loc)
    grad_r = _replicate(mesh, avg_grad_loc)
    new_model = densify(model_r, var_r, grad_r, params)
    return reshard_model(mesh, new_model)
