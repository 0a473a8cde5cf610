"""Gaussian-splat model state.

The reference keeps splats as SoA float arrays with an explicit
``capacity``/``count`` pair (src/ModelSplatsHost.h:11-21) and reuploads the
whole model whenever the count changes (src/ModelSplatsDevice.cpp:24-40).
Here we keep the same SoA layout but as a **fixed-capacity padded pytree**:
XLA wants static shapes, so ``capacity`` is the array length and ``count``
is a device scalar; all kernels mask on ``index < count``.  Densify then
never reallocates — it is a masked gather/scatter within capacity.

Quaternion convention: ``rotations[:, 0] = w`` (scalar part first), which is
the order the INRIA-style rasterizer consumes (it reads ``q.r = rot[0]``).
The reference's host code has a storage quirk — glm::quat memory order is
(x, y, z, w) while its constructor takes (w, x, y, z), so some reference
code paths write scrambled components (e.g. src/ModelSplatsHost.cpp:74,
src/Trainer.cu:493-494).  We do not replicate the scramble; we store
consistently scalar-first.  ``.gobj`` files carry the raw 4 floats either
way, so interop is unaffected.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["means", "shs", "scales", "opacities", "rotations", "count"],
    meta_fields=["sh_degree"],
)
@dataclasses.dataclass(frozen=True)
class SplatModel:
    """Fixed-capacity padded splat set (device pytree).

    Shapes (C = capacity, K = SH coefficient count):
      means      (C, 3)   world-space centers
      shs        (C, K, 3) spherical-harmonics color coefficients
      scales     (C, 3)   per-axis standard deviations
      opacities  (C,)     in [0, 1]
      rotations  (C, 4)   quaternions, scalar-first [w, x, y, z]
      count      ()       int32 number of live splats (<= C)
    """

    means: jax.Array
    shs: jax.Array
    scales: jax.Array
    opacities: jax.Array
    rotations: jax.Array
    count: jax.Array
    sh_degree: int = 1  # static: part of the treedef, not a leaf

    def replace(self, **changes) -> "SplatModel":
        """Copy with the given fields changed (the model is immutable)."""
        return dataclasses.replace(self, **changes)

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def sh_coeffs(self) -> int:
        return self.shs.shape[1]

    def active_mask(self) -> jax.Array:
        return jnp.arange(self.capacity, dtype=jnp.int32) < self.count

    @classmethod
    def empty(cls, capacity: int, sh_degree: int = 1, sh_coeffs: int = 4) -> "SplatModel":
        z = jnp.zeros
        return cls(
            means=z((capacity, 3), jnp.float32),
            shs=z((capacity, sh_coeffs, 3), jnp.float32),
            scales=z((capacity, 3), jnp.float32),
            opacities=z((capacity,), jnp.float32),
            rotations=z((capacity, 4), jnp.float32).at[:, 0].set(1.0),
            count=jnp.zeros((), jnp.int32),
            sh_degree=sh_degree,
        )


def quat_identity() -> np.ndarray:
    return np.array([1.0, 0.0, 0.0, 0.0], dtype=np.float32)


def quat_from_axis_angle(axis: np.ndarray, angle_rad: float) -> np.ndarray:
    """Unit quaternion [w, x, y, z] from a (possibly unnormalized) axis.

    glm::angleAxis assumes a pre-normalized axis; the reference's
    triangle-field initializer passes an unnormalized cross product
    (src/ui/UiFrame.cpp:254-257), silently producing non-unit quaternions.
    We normalize, implementing the intended rotation.
    """
    axis = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return quat_identity()
    axis = axis / n
    h = angle_rad * 0.5
    return np.array(
        [math.cos(h), *(math.sin(h) * axis)],
        dtype=np.float32,
    )


class SplatModelHost:
    """Host-side (numpy) mutable splat builder, mirror of the device model.

    Equivalent of the reference's ModelSplatsHost (src/ModelSplatsHost.{h,cpp})
    with the same capacity/count semantics; used for initializers and file I/O.
    """

    def __init__(self, capacity: int, sh_degree: int = 1, sh_coeffs: int = 4):
        self.capacity = int(capacity)
        self.sh_degree = int(sh_degree)
        self.sh_coeffs = int(sh_coeffs)
        self.count = 0
        self.means = np.zeros((capacity, 3), np.float32)
        self.shs = np.zeros((capacity, sh_coeffs, 3), np.float32)
        self.scales = np.zeros((capacity, 3), np.float32)
        self.opacities = np.zeros((capacity,), np.float32)
        self.rotations = np.zeros((capacity, 4), np.float32)
        self.rotations[:, 0] = 1.0

    # -- construction ----------------------------------------------------
    @classmethod
    def from_arrays(
        cls,
        means: np.ndarray,
        shs: np.ndarray,
        scales: np.ndarray,
        opacities: np.ndarray,
        rotations: np.ndarray,
        capacity: Optional[int] = None,
    ) -> "SplatModelHost":
        """Build from flat arrays; capacity autogrows x10 from 1e6 like the
        reference (src/ModelSplatsHost.cpp:31-37); SH degree is inferred from
        the coefficient count."""
        means = np.asarray(means, np.float32).reshape(-1, 3)
        n = means.shape[0]
        if n == 0:
            # reshape(0, -1, 3) can't infer a dimension from a size-0
            # array: an empty model round-trips as the default layout
            return cls(capacity or 1, sh_degree=1, sh_coeffs=4)
        shs = np.asarray(shs, np.float32).reshape(n, -1, 3)
        k = shs.shape[1]
        sh_degree = int(math.isqrt(k)) - 1 if math.isqrt(k) ** 2 == k else (k - 1) // 3
        if capacity is None:
            capacity = 1_000_000
            while capacity < n:
                capacity *= 10
        # a too-small explicit capacity grows to fit (same autogrow
        # semantic as the PLY loader; a broadcast crash helps nobody)
        capacity = max(capacity, n)
        m = cls(capacity, sh_degree=sh_degree, sh_coeffs=k)
        m.count = n
        m.means[:n] = means
        m.shs[:n] = shs
        m.scales[:n] = np.asarray(scales, np.float32).reshape(n, 3)
        m.opacities[:n] = np.asarray(opacities, np.float32).reshape(n)
        m.rotations[:n] = np.asarray(rotations, np.float32).reshape(n, 4)
        return m

    @classmethod
    def from_device(cls, model: SplatModel) -> "SplatModelHost":
        m = cls(model.capacity, model.sh_degree, model.sh_coeffs)
        m.count = int(model.count)
        m.means[:] = np.asarray(model.means)
        m.shs[:] = np.asarray(model.shs)
        m.scales[:] = np.asarray(model.scales)
        m.opacities[:] = np.asarray(model.opacities)
        m.rotations[:] = np.asarray(model.rotations)
        return m

    def to_device(self) -> SplatModel:
        return SplatModel(
            means=jnp.asarray(self.means),
            shs=jnp.asarray(self.shs),
            scales=jnp.asarray(self.scales),
            opacities=jnp.asarray(self.opacities),
            rotations=jnp.asarray(self.rotations),
            count=jnp.asarray(self.count, jnp.int32),
            sh_degree=self.sh_degree,
        )

    # -- mutation ----------------------------------------------------------
    def push_back(self, mean, shs, scale, opacity, rotation) -> None:
        if self.count >= self.capacity:
            raise RuntimeError("Model ran out of capacity!")
        i = self.count
        self.means[i] = np.asarray(mean, np.float32)
        self.shs[i] = np.asarray(shs, np.float32).reshape(self.sh_coeffs, 3)
        self.scales[i] = np.asarray(scale, np.float32)
        self.opacities[i] = np.float32(opacity)
        self.rotations[i] = np.asarray(rotation, np.float32)
        self.count += 1

    def copy(self, index_to: int, index_from: int) -> None:
        if not (0 <= index_to < self.count and 0 <= index_from < self.count):
            raise RuntimeError("Can't copy splat in model, incorrect bounds!")
        for arr in (self.means, self.shs, self.scales, self.opacities, self.rotations):
            arr[index_to] = arr[index_from]


# ---------------------------------------------------------------------------
# Field initializers (reference src/ui/UiFrame.cpp:137-264)
# ---------------------------------------------------------------------------

def init_field_grid(
    capacity: int = 1_000_000, sh_degree: int = 1, sh_coeffs: int = 4
) -> SplatModelHost:
    """17^3 grid of splats over [-4, 4]^3, spacing 0.5, scale 0.05
    (reference src/ui/UiFrame.cpp:137-160)."""
    m = SplatModelHost(capacity, sh_degree, sh_coeffs)
    # np.arange with float step accumulates error; use integer steps.
    coords = (np.arange(17, dtype=np.float32) * 0.5 - 4.0).astype(np.float32)
    xs, ys, zs = np.meshgrid(coords, coords, coords, indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], axis=-1)
    # Capacities below 17^3 keep the first slice of the grid (the reference
    # always has room — SPLATS_LIMIT is 1M, src/Config.h:17; tiny-capacity
    # runs are this framework's test/CLI convenience, not a parity case).
    n = min(pts.shape[0], capacity)
    pts = pts[:n]
    m.means[:n] = pts
    m.scales[:n] = 0.05
    m.opacities[:n] = 1.0
    m.rotations[:n] = quat_identity()
    m.count = n
    return m


def init_field_mono(
    capacity: int = 1_000_000, sh_degree: int = 1, sh_coeffs: int = 4
) -> SplatModelHost:
    """One 0.3-scale splat at the origin (reference src/ui/UiFrame.cpp:162-176)."""
    m = SplatModelHost(capacity, sh_degree, sh_coeffs)
    m.scales[0] = 0.3
    m.opacities[0] = 1.0
    m.rotations[0] = quat_identity()
    m.count = 1
    return m


def init_field_model(
    vertices: np.ndarray,
    triangles: np.ndarray,
    capacity: int = 1_000_000,
    sh_degree: int = 1,
    sh_coeffs: int = 4,
) -> SplatModelHost:
    """One thin splat per mesh triangle, oriented to the face normal
    (reference src/ui/UiFrame.cpp:178-264).

    vertices: (V, 3) float; triangles: (T, 3) int indices.
    """
    m = SplatModelHost(capacity, sh_degree, sh_coeffs)
    v0 = vertices[triangles[:, 0]]
    v1 = vertices[triangles[:, 1]]
    v2 = vertices[triangles[:, 2]]
    n = triangles.shape[0]
    m.means[:n] = (v0 + v1 + v2) / 3.0
    e1, e2 = v1 - v0, v2 - v0
    scales = np.stack(
        [
            np.linalg.norm(e1, axis=-1),
            np.linalg.norm(e2, axis=-1),
            np.full(n, 0.005, np.float32),
        ],
        axis=-1,
    )
    m.scales[:n] = scales * 0.2
    m.opacities[:n] = 1.0
    up = np.array([0.0, 0.0, 1.0])
    normals = np.cross(e1, e2)
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = normals / np.maximum(norm, 1e-12)
    for i in range(n):
        axis = np.cross(up, normals[i])
        angle = math.acos(float(np.clip(np.dot(up, normals[i]), -1.0, 1.0)))
        m.rotations[i] = quat_from_axis_angle(axis, angle)
    m.count = n
    return m
