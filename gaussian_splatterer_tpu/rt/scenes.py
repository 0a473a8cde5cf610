"""Built-in scenes made from a seed, so no file has to be downloaded.

* ``mushroom_mesh`` / ``mushroom_texture``: the procedural textured mushroom
  (surface of revolution, stem + spotted cap) the training path is driven
  with end to end.
* ``random_splat_scene``: a seeded random splat cloud and a camera batch,
  the rasterizer benchmark's scene.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from gaussian_splatterer_tpu.io.obj import TriangleMesh
from gaussian_splatterer_tpu.models.camera import Camera


def mushroom_mesh(n_theta=48, n_prof=24):
    """Procedural mushroom (surface of revolution: stem + cap), the
    BASELINE 'mushroom-class OBJ' workload. UV: (theta, profile arclength)."""
    # profile (radius, y) from stem base to cap apex
    prof = []
    for t in np.linspace(0.0, 1.0, n_prof):
        if t < 0.45:  # stem
            r = 0.35 + 0.05 * np.cos(t * 9)
            y = -1.2 + t / 0.45 * 1.2
        else:  # cap: hemisphere-ish with a lip
            u = (t - 0.45) / 0.55 * np.pi / 2
            r = 1.25 * np.cos(u) + 0.02
            y = 0.85 * np.sin(u)
        prof.append((r, y))
    prof = np.array(prof, np.float32)

    verts, uvs = [], []
    for i, (r, y) in enumerate(prof):
        for j in range(n_theta):
            th = 2 * np.pi * j / n_theta
            verts.append((r * np.cos(th), y, r * np.sin(th)))
            uvs.append((j / n_theta, i / (n_prof - 1)))
    verts = np.array(verts, np.float32)
    uvs = np.array(uvs, np.float32)

    tris, tri_uv = [], []
    for i in range(n_prof - 1):
        for j in range(n_theta):
            j2 = (j + 1) % n_theta
            a = i * n_theta + j
            b = i * n_theta + j2
            c = (i + 1) * n_theta + j
            d = (i + 1) * n_theta + j2
            for t3 in ((a, b, d), (a, d, c)):
                tris.append(t3)
                tri_uv.append([uvs[k] for k in t3])
    return TriangleMesh(
        verts, np.array(tris, np.int32), np.array(tri_uv, np.float32)
    )


def mushroom_texture(n=128, spot_alpha=1.0):
    """Red-capped, spotted mushroom texture over the (theta, profile) UV.

    ``spot_alpha < 1`` makes the cap spots semi-transparent, exercising the
    tracer's stochastic alpha (reference RtxDevice.cu:128-143) end-to-end:
    the splat model must learn partially-see-through regions from the
    dual-background supervision."""
    t = np.zeros((n, n, 4), np.float32)
    v = np.linspace(0, 1, n)[:, None]  # profile coordinate (rows)
    t[..., 0] = np.where(v > 0.45, 0.85, 0.93)
    t[..., 1] = np.where(v > 0.45, 0.12, 0.87)
    t[..., 2] = np.where(v > 0.45, 0.10, 0.72)
    rng = np.random.default_rng(5)
    spots = np.zeros((n, n), bool)
    for _ in range(25):  # white spots on the cap
        cy = rng.uniform(0.55, 0.95) * n
        cx = rng.uniform(0, 1) * n
        yy, xx = np.mgrid[0:n, 0:n]
        d2 = (yy - cy) ** 2 + (np.minimum(np.abs(xx - cx), n - np.abs(xx - cx))) ** 2
        spot = d2 < (n * 0.035) ** 2
        t[spot, 0:3] = 0.95
        spots |= spot
    t[..., 3] = np.where(spots, spot_alpha, 1.0)
    return t


def random_splat_scene(n_splats, capacity, width, height, n_frames, seed=0,
                       fov_deg=60.0):
    """Seeded random splat cloud in [-3, 3]^3 seen by ``n_frames`` cameras
    near (0, 0, -10).  Returns (params (means, shs, scales, opacities,
    rotations), active, views, proj_views, cam_posns, tan_fovxs, tan_fovys,
    cameras)."""
    rng = np.random.default_rng(seed)
    means = np.zeros((capacity, 3), np.float32)
    means[:n_splats] = rng.uniform(-3, 3, (n_splats, 3))
    shs = np.zeros((capacity, 4, 3), np.float32)
    shs[:n_splats] = rng.normal(0, 0.5, (n_splats, 4, 3))
    scales = np.zeros((capacity, 3), np.float32)
    scales[:n_splats] = rng.uniform(0.01, 0.08, (n_splats, 3))
    opac = np.zeros((capacity,), np.float32)
    opac[:n_splats] = rng.uniform(0.2, 1.0, n_splats)
    rot = np.zeros((capacity, 4), np.float32)
    rot[:, 0] = 1.0
    rot[:n_splats] = rng.normal(0, 1, (n_splats, 4))
    active = np.arange(capacity) < n_splats
    cams = [
        Camera(
            np.array([0.3 + 0.2 * i, -0.2, -10.0 - 0.5 * i], np.float32),
            np.zeros(3, np.float32), fov_deg,
        )
        for i in range(n_frames)
    ]
    views = jnp.stack([jnp.asarray(c.get_view()) for c in cams])
    pvs = jnp.stack([jnp.asarray(c.get_proj_view(width / height)) for c in cams])
    poss = jnp.stack([jnp.asarray(c.location) for c in cams])
    tans = np.array(
        [c.tan_fov(width, height, train=True) for c in cams], np.float32
    )
    return (
        tuple(map(jnp.asarray, (means, shs, scales, opac, rot))),
        jnp.asarray(active),
        views, pvs, poss,
        jnp.asarray(tans[:, 0]), jnp.asarray(tans[:, 1]),
        cams,
    )
