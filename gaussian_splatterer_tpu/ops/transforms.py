"""Per-splat rasterization math: SH color, covariance, EWA projection.

These are the vectorized (N-splat) building blocks shared by the oracle
rasterizer and the tiled fast path.  Semantics follow the INRIA
diff-gaussian-rasterization pipeline that the reference links as
`CudaRasterizer::Rasterizer::forward/backward` (call sites
src/Trainer.cu:334-412; the submodule itself is not checked out — SURVEY
§2.3 pins the public semantics: EWA projection with 0.3-pixel dilation,
3-sigma radius, SH->RGB with +0.5 offset and zero clamp, near cull at
view-space depth 0.2).

Everything is pure jnp on static shapes; gradients come from jax.grad.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Real spherical-harmonics basis constants (bands 0-3).
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

NEAR_CULL_Z = 0.2  # view-space near cull
DILATION = 0.3  # screen-space covariance dilation (anti-aliasing floor)
ALPHA_MIN = 1.0 / 255.0  # contribution threshold
ALPHA_MAX = 0.99  # per-splat alpha clamp
T_EPS = 1e-4  # transmittance early-termination threshold


def quat_to_rotmat(q: jax.Array) -> jax.Array:
    """(..., 4) scalar-first quaternion -> (..., 3, 3) rotation matrix.

    Quaternions are normalized here; the reference app never renormalizes
    after SGD (src/Trainer.cu:97-99) and relies on the rasterizer doing it.
    """
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = jnp.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1
    )
    row1 = jnp.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1
    )
    row2 = jnp.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1
    )
    return jnp.stack([row0, row1, row2], -2)


def build_cov3d(scales: jax.Array, rotations: jax.Array, scale_mod) -> jax.Array:
    """(N, 3) scales + (N, 4) quats -> (N, 3, 3) world covariance R S^2 R^T."""
    R = quat_to_rotmat(rotations)
    s2 = jnp.square(scales * scale_mod)  # (N, 3)
    return jnp.einsum("nij,nj,nkj->nik", R, s2, R)


def sh_to_rgb(shs: jax.Array, dirs: jax.Array, sh_degree: int) -> jax.Array:
    """Evaluate SH color: (N, K, 3) coeffs, (N, 3) unit view dirs -> (N, 3).

    Matches the INRIA computeColorFromSH semantics: band sum + 0.5,
    clamped at zero (clamp kills the gradient, which jax.grad reproduces).
    """
    return jnp.maximum(sh_eval_linear(shs, dirs, sh_degree) + 0.5, 0.0)


def sh_eval_linear(shs, dirs, sh_degree: int):
    """Raw SH band sum (no +0.5 offset, no clamp) — the linear part shared
    by sh_to_rgb and partial evaluations (e.g. the HTML viewer baking
    bands >= 2 at a nominal direction).  Works on numpy or jnp inputs."""
    x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    c = SH_C0 * shs[:, 0]
    if sh_degree >= 1:
        c = c - SH_C1 * y * shs[:, 1] + SH_C1 * z * shs[:, 2] - SH_C1 * x * shs[:, 3]
    if sh_degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        c = (
            c
            + SH_C2[0] * xy * shs[:, 4]
            + SH_C2[1] * yz * shs[:, 5]
            + SH_C2[2] * (2.0 * zz - xx - yy) * shs[:, 6]
            + SH_C2[3] * xz * shs[:, 7]
            + SH_C2[4] * (xx - yy) * shs[:, 8]
        )
    if sh_degree >= 3:
        c = (
            c
            + SH_C3[0] * y * (3.0 * xx - yy) * shs[:, 9]
            + SH_C3[1] * xy * z * shs[:, 10]
            + SH_C3[2] * y * (4.0 * zz - xx - yy) * shs[:, 11]
            + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * shs[:, 12]
            + SH_C3[4] * x * (4.0 * zz - xx - yy) * shs[:, 13]
            + SH_C3[5] * z * (xx - yy) * shs[:, 14]
            + SH_C3[6] * x * (xx - yy) * shs[:, 15]
        )
    return c


class ProjectedSplats(NamedTuple):
    """Screen-space splats, padded to N with ``valid`` masking."""

    mean2d: jax.Array  # (N, 2) pixel coordinates
    conic: jax.Array  # (N, 3) inverse 2D covariance (a, b, c): ax^2+2bxy+cy^2
    color: jax.Array  # (N, 3)
    opacity: jax.Array  # (N,)
    depth: jax.Array  # (N,) view-space z (positive in front)
    radius: jax.Array  # (N,) float 3-sigma pixel radius (0 when culled)
    rx: jax.Array  # (N,) tight per-axis half-extents (opacity-aware
    ry: jax.Array  # ellipse AABB; see project_splat_components)
    valid: jax.Array  # (N,) bool


class SplatComponents(NamedTuple):
    """Component-wise (structure-of-(N,)-vectors) screen-space splats.

    Layout note: every field is a flat (N,) vector so the splat axis is the
    contiguous one; (N, 3)-shaped intermediates would make every
    elementwise op stride over the small feature axis.
    """

    mx: jax.Array  # pixel x
    my: jax.Array  # pixel y
    ca: jax.Array  # conic a
    cb: jax.Array  # conic b
    cc: jax.Array  # conic c
    cr: jax.Array  # color r
    cg: jax.Array  # color g
    cb2: jax.Array  # color b
    opacity: jax.Array
    depth: jax.Array
    radius: jax.Array  # 3-sigma_max circle (reference convention; kept
    # for diagnostics) — binning uses the tight rx/ry box
    rx: jax.Array
    ry: jax.Array
    valid: jax.Array  # bool


def _sh_to_rgb_channels(shs, dx, dy, dz, sh_degree: int):
    """Component-wise SH evaluation; shs (N, K, 3), dirs as (N,) vectors.

    Returns (r, g, b) each (N,).  Same math as sh_to_rgb."""
    out = []
    for ch in range(3):
        c = SH_C0 * shs[:, 0, ch]
        if sh_degree >= 1:
            c = (
                c
                - SH_C1 * dy * shs[:, 1, ch]
                + SH_C1 * dz * shs[:, 2, ch]
                - SH_C1 * dx * shs[:, 3, ch]
            )
        if sh_degree >= 2:
            xx, yy, zz = dx * dx, dy * dy, dz * dz
            c = (
                c
                + SH_C2[0] * dx * dy * shs[:, 4, ch]
                + SH_C2[1] * dy * dz * shs[:, 5, ch]
                + SH_C2[2] * (2.0 * zz - xx - yy) * shs[:, 6, ch]
                + SH_C2[3] * dx * dz * shs[:, 7, ch]
                + SH_C2[4] * (xx - yy) * shs[:, 8, ch]
            )
        if sh_degree >= 3:
            xx, yy, zz = dx * dx, dy * dy, dz * dz
            c = (
                c
                + SH_C3[0] * dy * (3.0 * xx - yy) * shs[:, 9, ch]
                + SH_C3[1] * dx * dy * dz * shs[:, 10, ch]
                + SH_C3[2] * dy * (4.0 * zz - xx - yy) * shs[:, 11, ch]
                + SH_C3[3] * dz * (2.0 * zz - 3.0 * xx - 3.0 * yy) * shs[:, 12, ch]
                + SH_C3[4] * dx * (4.0 * zz - xx - yy) * shs[:, 13, ch]
                + SH_C3[5] * dz * (xx - yy) * shs[:, 14, ch]
                + SH_C3[6] * dx * (xx - yy) * shs[:, 15, ch]
            )
        out.append(jnp.maximum(c + 0.5, 0.0))
    return tuple(out)


def project_splat_components(
    means: jax.Array,
    shs: jax.Array,
    scales: jax.Array,
    opacities: jax.Array,
    rotations: jax.Array,
    active: jax.Array,
    view: jax.Array,
    proj_view: jax.Array,
    cam_pos: jax.Array,
    tan_fovx,
    tan_fovy,
    width: int,
    height: int,
    sh_degree: int,
    scale_mod=1.0,
    aa: bool = False,
) -> SplatComponents:
    """The per-splat 'preprocess' stage: 3D gaussians -> 2D screen splats.

    All math is written on flat (N,) component vectors (see SplatComponents)
    so XLA fuses the whole stage into a few elementwise kernels.

    ``aa=True`` enables mip-splatting-style anti-aliasing (Yu et al. 2023,
    public method; BEYOND reference parity — the reference renders the raw
    INRIA dilation): opacity is scaled by sqrt(det(cov2d) /
    det(cov2d + dilation)), so sub-pixel splats fade instead of aliasing
    into 0.3-px-floored discs when zoomed out.  Off by default — parity
    paths and tests stay bit-identical.
    """
    f32 = jnp.float32
    x = means[:, 0].astype(f32)
    y = means[:, 1].astype(f32)
    z = means[:, 2].astype(f32)
    v = view.astype(f32)
    pvm = proj_view.astype(f32)

    # view transform (rows of the 4x4 applied to [x, y, z, 1])
    pv_x = v[0, 0] * x + v[0, 1] * y + v[0, 2] * z + v[0, 3]
    pv_y = v[1, 0] * x + v[1, 1] * y + v[1, 2] * z + v[1, 3]
    depth = v[2, 0] * x + v[2, 1] * y + v[2, 2] * z + v[2, 3]
    in_front = depth > NEAR_CULL_Z

    ph_x = pvm[0, 0] * x + pvm[0, 1] * y + pvm[0, 2] * z + pvm[0, 3]
    ph_y = pvm[1, 0] * x + pvm[1, 1] * y + pvm[1, 2] * z + pvm[1, 3]
    ph_w = pvm[3, 0] * x + pvm[3, 1] * y + pvm[3, 2] * z + pvm[3, 3]
    p_w = 1.0 / (ph_w + 1e-7)

    # quaternion -> rotation matrix components (normalized, see quat_to_rotmat)
    q = rotations.astype(f32)
    qn = jnp.sqrt(q[:, 0] ** 2 + q[:, 1] ** 2 + q[:, 2] ** 2 + q[:, 3] ** 2)
    qi = 1.0 / jnp.maximum(qn, 1e-12)
    qr, qx, qy, qz = q[:, 0] * qi, q[:, 1] * qi, q[:, 2] * qi, q[:, 3] * qi
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qr * qz)
    r02 = 2 * (qx * qz + qr * qy)
    r10 = 2 * (qx * qy + qr * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qr * qx)
    r20 = 2 * (qx * qz - qr * qy)
    r21 = 2 * (qy * qz + qr * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)

    s2x = jnp.square(scales[:, 0].astype(f32) * scale_mod)
    s2y = jnp.square(scales[:, 1].astype(f32) * scale_mod)
    s2z = jnp.square(scales[:, 2].astype(f32) * scale_mod)

    # Sigma = R S^2 R^T (6 unique entries)
    c00 = r00 * r00 * s2x + r01 * r01 * s2y + r02 * r02 * s2z
    c01 = r00 * r10 * s2x + r01 * r11 * s2y + r02 * r12 * s2z
    c02 = r00 * r20 * s2x + r01 * r21 * s2y + r02 * r22 * s2z
    c11 = r10 * r10 * s2x + r11 * r11 * s2y + r12 * r12 * s2z
    c12 = r10 * r20 * s2x + r11 * r21 * s2y + r12 * r22 * s2z
    c22 = r20 * r20 * s2x + r21 * r21 * s2y + r22 * r22 * s2z

    # EWA Jacobian (rows [fx/tz, 0, -fx tx/tz^2], [0, fy/tz, -fy ty/tz^2])
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)
    lim_x, lim_y = 1.3 * tan_fovx, 1.3 * tan_fovy
    tzs = jnp.where(jnp.abs(depth) < 1e-12, 1e-12, depth)
    tx = jnp.clip(pv_x / tzs, -lim_x, lim_x) * depth
    ty = jnp.clip(pv_y / tzs, -lim_y, lim_y) * depth
    j00 = focal_x / tzs
    j02 = -focal_x * tx / (tzs * tzs)
    j11 = focal_y / tzs
    j12 = -focal_y * ty / (tzs * tzs)

    # A = J @ W with W = view[:3, :3] (the -lookAt sign squares away)
    a00 = j00 * v[0, 0] + j02 * v[2, 0]
    a01 = j00 * v[0, 1] + j02 * v[2, 1]
    a02 = j00 * v[0, 2] + j02 * v[2, 2]
    a10 = j11 * v[1, 0] + j12 * v[2, 0]
    a11 = j11 * v[1, 1] + j12 * v[2, 1]
    a12 = j11 * v[1, 2] + j12 * v[2, 2]

    # cov2d = A Sigma A^T
    t0 = c00 * a00 + c01 * a01 + c02 * a02
    t1 = c01 * a00 + c11 * a01 + c12 * a02
    t2 = c02 * a00 + c12 * a01 + c22 * a02
    u0 = c00 * a10 + c01 * a11 + c02 * a12
    u1 = c01 * a10 + c11 * a11 + c12 * a12
    u2 = c02 * a10 + c12 * a11 + c22 * a12
    cxx = a00 * t0 + a01 * t1 + a02 * t2 + DILATION
    cxy = a10 * t0 + a11 * t1 + a12 * t2
    cyy = a10 * u0 + a11 * u1 + a12 * u2 + DILATION

    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    det_safe = jnp.where(det_ok, det, 1.0)
    ca = cyy / det_safe
    cb = -cxy / det_safe
    cc = cxx / det_safe

    opacities = opacities.astype(f32)
    if aa:
        # mip-splat compensation: ratio of the raw to the dilated 2D
        # covariance determinant (1 for large splats, -> 0 sub-pixel).
        # sqrt has an INFINITE derivative at 0 and clip zeros its cotangent
        # there, so sqrt(clip(x)) backpropagates inf * 0 = NaN for any
        # fully-collapsed splat (an SGD scale clamp at 0 makes det_raw
        # exactly 0, which NaN'd whole training runs).  A degenerate splat
        # must fade out with ZERO gradient instead.
        det_raw = (cxx - DILATION) * (cyy - DILATION) - cxy * cxy
        ratio = jnp.clip(det_raw / det_safe, 0.0, 1.0)
        nondegen = ratio > 1e-12
        opacities = opacities * jnp.where(
            nondegen, jnp.sqrt(jnp.where(nondegen, ratio, 1.0)), 0.0
        )

    mid = 0.5 * (cxx + cyy)
    disc = jnp.sqrt(jnp.maximum(0.1, mid * mid - det))
    radius = jnp.ceil(3.0 * jnp.sqrt(jnp.maximum(mid + disc, 1e-12)))

    # Tight per-axis, opacity-aware extents (gsplat-style tight bounds;
    # the INRIA/reference convention is a CIRCULAR ceil(3*sigma_max) box,
    # /root/reference submodule semantics): the compositing mask skips any
    # pixel with alpha = op*exp(power) < ALPHA_MIN, so a splat's visible
    # support is the ellipse q <= k^2 with k^2 = 2*ln(op*255), whose exact
    # axis-aligned bounding box is k*sigma_x by k*sigma_y (sigma from the
    # 2D covariance diagonal).  Capping k at 3 keeps the reference's
    # 3-sigma truncation for opaque splats; for faint or anisotropic
    # splats the box (and the duplicate count every downstream stage pays
    # for) shrinks by the opacity and sigma_min/sigma_max factors.
    k2 = jnp.clip(
        2.0 * jnp.log(jnp.maximum(opacities.astype(f32), 1e-12) * 255.0),
        0.0, 9.0,
    )
    k = jnp.sqrt(k2)
    rx = jnp.ceil(k * jnp.sqrt(jnp.maximum(cxx, 1e-12)))
    ry = jnp.ceil(k * jnp.sqrt(jnp.maximum(cyy, 1e-12)))

    # NDC -> pixel centers: ((v + 1) * S - 1) / 2
    px = ((ph_x * p_w + 1.0) * width - 1.0) * 0.5
    py = ((ph_y * p_w + 1.0) * height - 1.0) * 0.5

    on_screen = (
        (px + rx >= 0)
        & (px - rx < width)
        & (py + ry >= 0)
        & (py - ry < height)
    )
    valid = active & in_front & det_ok & on_screen & (rx > 0) & (ry > 0)

    dx = x - cam_pos[0]
    dy = y - cam_pos[1]
    dz = z - cam_pos[2]
    dn = 1.0 / jnp.maximum(jnp.sqrt(dx * dx + dy * dy + dz * dz), 1e-12)
    cr, cg, cb2 = _sh_to_rgb_channels(
        shs.astype(f32), dx * dn, dy * dn, dz * dn, sh_degree
    )

    return SplatComponents(
        mx=px,
        my=py,
        ca=ca,
        cb=cb,
        cc=cc,
        cr=cr,
        cg=cg,
        cb2=cb2,
        opacity=opacities.astype(f32),
        depth=depth,
        radius=jnp.where(valid, radius, 0.0),
        rx=jnp.where(valid, rx, 0.0),
        ry=jnp.where(valid, ry, 0.0),
        valid=valid,
    )


def project_splats(
    means: jax.Array,
    shs: jax.Array,
    scales: jax.Array,
    opacities: jax.Array,
    rotations: jax.Array,
    active: jax.Array,
    view: jax.Array,
    proj_view: jax.Array,
    cam_pos: jax.Array,
    tan_fovx,
    tan_fovy,
    width: int,
    height: int,
    sh_degree: int,
    scale_mod=1.0,
    aa: bool = False,
) -> ProjectedSplats:
    """(N, k)-layout projection (oracle-facing wrapper over the component
    form; the fast path consumes SplatComponents directly)."""
    c = project_splat_components(
        means, shs, scales, opacities, rotations, active,
        view, proj_view, cam_pos, tan_fovx, tan_fovy,
        width, height, sh_degree, scale_mod, aa=aa,
    )
    return ProjectedSplats(
        mean2d=jnp.stack([c.mx, c.my], -1),
        conic=jnp.stack([c.ca, c.cb, c.cc], -1),
        color=jnp.stack([c.cr, c.cg, c.cb2], -1),
        opacity=c.opacity,
        depth=c.depth,
        radius=c.radius,
        rx=c.rx,
        ry=c.ry,
        valid=c.valid,
    )
