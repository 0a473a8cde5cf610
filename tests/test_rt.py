"""JAX path tracer semantics (reference src/rtx/RtxDevice.cu).

Small meshes, low resolution, few samples — Monte-Carlo noise bounded by
construction (opaque emit-free scenes converge fast against white sky)."""

import numpy as np
import pytest

from gaussian_splatterer_tpu.io.obj import TriangleMesh
from gaussian_splatterer_tpu.models.camera import Camera
from gaussian_splatterer_tpu.rt import RtxHost

RES = 32


def quad_mesh(z=0.0, half=2.0):
    """Two triangles forming a quad facing -z, uv spanning [0,1]^2."""
    v = np.array(
        [[-half, -half, z], [half, -half, z], [half, half, z], [-half, half, z]],
        np.float32,
    )
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.array(
        [[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]], np.float32
    )
    return TriangleMesh(v, tris, uv)


def solid_texture(r, g, b, a=1.0):
    t = np.zeros((4, 4, 4), np.float32)
    t[...] = (r, g, b, a)
    return t


def front_camera(dist=6.0, fov=50.0):
    return Camera(np.array([0.0, 0.0, -dist], np.float32), np.zeros(3, np.float32), fov)


def render(host, bg, samples=12, cams=None, seed=7):
    return np.asarray(
        host.render(front_camera(), bg, samples, RES, RES,
                    splat_cameras=cams, seed=seed)
    )


def test_no_model_renders_black():
    host = RtxHost()
    img = render(host, (1.0, 1.0, 1.0))
    assert np.all(img == 0.0)


def test_miss_gives_background():
    host = RtxHost(tri_chunk=8, ray_chunk=RES * RES)
    host.load_model(quad_mesh(half=0.4))
    host.load_texture_diffuse(solid_texture(1, 0, 0))
    for bg in [(0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (0.2, 0.5, 0.9)]:
        img = render(host, bg)
        corner = img[0, 0]  # quad is small and centered; corner rays miss
        np.testing.assert_allclose(corner, bg, atol=1e-5)


def test_opaque_surface_color_attenuation():
    """Red quad under the white sky: center pixel is red-dominant, gamma by
    multi-bounce attenuation keeps r in (0, 1], g=b=0 exactly (texture rgb
    multiplies attenuation and g=b=0 after first hit)."""
    host = RtxHost(tri_chunk=8, ray_chunk=RES * RES)
    host.load_model(quad_mesh())
    host.load_texture_diffuse(solid_texture(0.8, 0.0, 0.0))
    img = render(host, (0.0, 0.0, 0.0), samples=24)
    c = img[RES // 2, RES // 2]
    assert c[0] > 0.05, f"expected red bounce light, got {c}"
    assert c[1] == 0.0 and c[2] == 0.0


def test_fully_transparent_passes_through():
    host = RtxHost(tri_chunk=8, ray_chunk=RES * RES)
    host.load_model(quad_mesh())
    host.load_texture_diffuse(solid_texture(1, 1, 1, a=0.0))
    bg = (0.3, 0.6, 0.9)
    img = render(host, bg)
    # every ray passes through the alpha-0 quad -> never reflected -> bg
    np.testing.assert_allclose(img, np.broadcast_to(bg, img.shape), atol=1e-5)


def test_dual_background_supervision_signal():
    """The object region must be identical across backgrounds; the miss
    region must follow the background (what teaches opacity downstream)."""
    host = RtxHost(tri_chunk=8, ray_chunk=RES * RES)
    host.load_model(quad_mesh())
    host.load_texture_diffuse(solid_texture(0.5, 0.5, 0.5))
    w = render(host, (1.0, 1.0, 1.0), seed=3)
    b = render(host, (0.0, 0.0, 0.0), seed=3)
    center = (RES // 2, RES // 2)
    np.testing.assert_allclose(w[center], b[center], atol=1e-6)


def test_camera_orb_inverts_pixels():
    host = RtxHost(tri_chunk=8, ray_chunk=RES * RES)
    host.load_model(quad_mesh(half=0.2))
    host.load_texture_diffuse(solid_texture(1, 0, 0))
    bg = (0.0, 0.0, 0.0)
    orb = [np.array([1.0, 1.0, -3.0], np.float32)]  # off-center, in front
    plain = render(host, bg, cams=None)
    with_orb = render(host, bg, cams=orb)
    assert np.any(np.abs(with_orb - plain) > 0.5), "orb should invert pixels"


def test_capture_truths_integration():
    """Trainer.capture_truths drives the tracer at runtime resolution."""
    import jax.numpy as jnp

    from gaussian_splatterer_tpu.config import Project, RuntimeConfig
    from gaussian_splatterer_tpu.models.splats import init_field_mono
    from gaussian_splatterer_tpu.train.trainer import Trainer

    host = RtxHost(tri_chunk=8, ray_chunk=RES * RES)
    host.load_model(quad_mesh())
    host.load_texture_diffuse(solid_texture(0.5, 0.7, 0.2))
    proj = Project()
    proj.sphere1.count = 2
    proj.sphere2.count = 0
    proj.rtSamples = 4
    rt = RuntimeConfig(render_resolution_x=RES, render_resolution_y=RES,
                       splats_capacity=64)
    trainer = Trainer(proj, rt, init_field_mono(64).to_device())
    trainer.capture_truths(host)
    assert trainer.truths.shape == (4, RES, RES, 3)
    assert bool(jnp.all(jnp.isfinite(trainer.truths)))


def icosphere_like(n=12):
    """UV-sphere triangle mesh (enough tris to exercise chunked culling)."""
    verts, tris, uvs = [], [], []
    for i in range(n + 1):
        for j in range(n):
            th = np.pi * i / n
            ph = 2 * np.pi * j / n
            verts.append((1.5 * np.sin(th) * np.cos(ph),
                          1.5 * np.cos(th),
                          1.5 * np.sin(th) * np.sin(ph)))
    verts = np.array(verts, np.float32)
    tri_uv = []
    for i in range(n):
        for j in range(n):
            j2 = (j + 1) % n
            a, b = i * n + j, i * n + j2
            c, d = (i + 1) * n + j, (i + 1) * n + j2
            for t3 in ((a, b, d), (a, d, c)):
                tris.append(t3)
                tri_uv.append([(0.1, 0.1)] * 3)
    return TriangleMesh(verts, np.array(tris, np.int32),
                        np.array(tri_uv, np.float32))


def test_shared_origin_intersector_matches_component_mt():
    """The primary pass's matmul Möller-Trumbore (_intersect_shared)
    agrees with the component-form brute force on hits, indices, and
    distances (algebraically equal formulas; only f32 rounding differs)."""
    import jax
    import jax.numpy as jnp

    from gaussian_splatterer_tpu.rt import tracer as tr

    mesh = icosphere_like(10)  # 200 triangles
    host = RtxHost(tri_chunk=32, ray_chunk=256)
    host.load_model(mesh, accel_min=10**9)  # brute path keeps no bb data
    tris = host._tris

    rng = np.random.default_rng(11)
    o = np.array([0.3, -0.2, -6.0], np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    # aim most rays toward the sphere so hits dominate
    d[:384] = (rng.normal(scale=0.3, size=(384, 3)).astype(np.float32)
               + (np.array([0, 0, 0]) - o))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ox = np.broadcast_to(o[0], (512,))
    oy = np.broadcast_to(o[1], (512,))
    oz = np.broadcast_to(o[2], (512,))

    t0, i0, u0, v0 = jax.jit(tr._intersect_chunked, static_argnums=7)(
        ox, oy, oz, d[:, 0], d[:, 1], d[:, 2], tris, 32
    )
    t1, i1, u1, v1 = jax.jit(tr._intersect_shared, static_argnums=5)(
        jnp.asarray(o), d[:, 0], d[:, 1], d[:, 2], tris, 32
    )
    t0, t1 = np.asarray(t0), np.asarray(t1)
    hit0, hit1 = np.isfinite(t0), np.isfinite(t1)
    # borderline (u/v/t within rounding of an inequality) rays may differ;
    # this scene has none
    np.testing.assert_array_equal(hit0, hit1)
    assert hit0.sum() > 200, "scene should produce plenty of hits"
    np.testing.assert_array_equal(np.asarray(i0)[hit0], np.asarray(i1)[hit0])
    np.testing.assert_allclose(t1[hit0], t0[hit0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(u1)[hit0], np.asarray(u0)[hit0], rtol=1e-3, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(v1)[hit0], np.asarray(v0)[hit0], rtol=1e-3, atol=1e-4
    )


def test_culled_matches_bruteforce():
    """Morton-chunk AABB culling returns the same image as brute force
    (same component-form math, different traversal — must be exact;
    mxu_bounce=False keeps the brute side on the component intersector)."""
    mesh = icosphere_like(12)  # 288 triangles
    tex = solid_texture(0.7, 0.4, 0.2)
    imgs = []
    for accel_min in (1, 10**9):  # force accel on / off
        host = RtxHost(tri_chunk=32, ray_chunk=RES * RES)
        host.load_model(mesh, accel_min=accel_min, mxu_bounce=False)
        host.load_texture_diffuse(tex)
        imgs.append(render(host, (0.1, 0.2, 0.3), samples=6, seed=5))
    np.testing.assert_allclose(imgs[0], imgs[1], atol=1e-5)


def test_mxu_general_intersector_matches_component_mt():
    """The bounce pass's general-origin matmul Möller-Trumbore
    (_intersect_mxu_general) agrees with the component-form brute force on
    hits, indices, and distances for SCATTERED ray origins (algebraically
    equal triple-product formulas; only f32 rounding differs)."""
    import jax

    from gaussian_splatterer_tpu.rt import tracer as tr

    mesh = icosphere_like(10)  # 200 triangles
    host = RtxHost(tri_chunk=32, ray_chunk=256)
    host.load_model(mesh, accel_min=10**9)  # brute path, feat10 present
    tris = host._tris
    assert "feat10" in tris

    rng = np.random.default_rng(13)
    # origins scattered around and ON the sphere surface (bounce origins
    # sit on the mesh — the t_num cancellation case)
    o = rng.normal(scale=2.5, size=(512, 3)).astype(np.float32)
    o[:200] = o[:200] / np.linalg.norm(o[:200], axis=1, keepdims=True) * 1.5
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d[:256] = rng.normal(scale=0.4, size=(256, 3)).astype(np.float32) - o[:256] * 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    t0, i0, u0, v0 = jax.jit(tr._intersect_chunked, static_argnums=7)(
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], tris, 32
    )
    t1, i1, u1, v1 = jax.jit(tr._intersect_mxu_general, static_argnums=7)(
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], tris, 32
    )
    t0, t1 = np.asarray(t0), np.asarray(t1)
    hit0, hit1 = np.isfinite(t0), np.isfinite(t1)
    # borderline (u/v/t within rounding of an inequality) rays may differ;
    # tolerate a tiny disagreement fraction from the on-surface origins
    agree = hit0 == hit1
    assert agree.mean() > 0.99, f"hit disagreement {1 - agree.mean():.3f}"
    both = hit0 & hit1 & (np.asarray(i0) == np.asarray(i1))
    assert hit0.sum() > 150, "scene should produce plenty of hits"
    assert both.sum() > 0.95 * (hit0 & hit1).sum()
    np.testing.assert_allclose(t1[both], t0[both], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(u1)[both], np.asarray(u0)[both], rtol=1e-2, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(v1)[both], np.asarray(v0)[both], rtol=1e-2, atol=1e-3
    )


def test_mxu_bounce_render_statistically_matches_component():
    """Full renders with the matmul bounce intersector on vs off converge to
    the same image (same RNG stream; only f32 rounding and borderline hit
    flips differ, which MC noise dominates)."""
    mesh = icosphere_like(12)
    tex = solid_texture(0.7, 0.4, 0.2)
    imgs = []
    for mxu in (True, False):
        host = RtxHost(tri_chunk=32, ray_chunk=RES * RES)
        host.load_model(mesh, accel_min=10**9, mxu_bounce=mxu)
        host.load_texture_diffuse(tex)
        imgs.append(render(host, (0.1, 0.2, 0.3), samples=8, seed=5))
    # identical to rounding on almost every pixel; a handful of borderline
    # bounce-path flips are allowed
    diff = np.abs(imgs[0] - imgs[1]).max(axis=-1)
    assert (diff < 1e-3).mean() > 0.98, f"{(diff >= 1e-3).mean():.3f} pixels differ"
    assert abs(float(imgs[0].mean()) - float(imgs[1].mean())) < 5e-3


def test_environment_map_sky():
    """Bounced miss rays sample the equirect env map (beyond-parity knob,
    the RtxDevice.cu:155 sky TODO); primary misses keep the background,
    and env=None keeps the reference white-gradient sky bit-identical."""
    import numpy as _np

    bg = (0.1, 0.2, 0.3)
    host = RtxHost(tri_chunk=8, ray_chunk=RES * RES)
    host.load_model(quad_mesh())
    host.load_texture_diffuse(solid_texture(0.5, 0.0, 0.0, 1.0))

    base = np.asarray(render(host, bg, samples=24))
    host.load_environment(_np.zeros((8, 16, 3), _np.float32))  # black sky
    dark = np.asarray(render(host, bg, samples=24))
    red_sky = _np.zeros((8, 16, 3), _np.float32)
    red_sky[..., 0] = 1.0
    host.load_environment(red_sky)
    red = np.asarray(render(host, bg, samples=24))
    host.load_environment(None)
    back = np.asarray(render(host, bg, samples=24))

    # env=None round-trips to the reference gradient sky exactly
    np.testing.assert_allclose(back, base)
    # primary misses keep the background under any sky
    corner = np.broadcast_to(np.asarray(bg, np.float32), (3,))
    np.testing.assert_allclose(dark[0, 0], corner, atol=1e-6)
    np.testing.assert_allclose(red[0, 0], corner, atol=1e-6)
    # the lit surface: a black sky darkens it, and a red sky adds NO
    # green/blue bounce light (albedo is pure red anyway)
    c = RES // 2
    assert dark[c, c].sum() <= base[c, c].sum() + 1e-6
    assert red[c, c, 1] <= base[c, c, 1] + 1e-6


def test_partial_alpha_stochastic_mix():
    """texture.w = 0.5 (reference stochastic transparency,
    RtxDevice.cu:128-143): each sample's primary ray hits the black quad
    with p=0.5 and passes to the background otherwise, so the rendered
    pixel converges to 0.5*bg + 0.5*surface_contribution.  With a black
    surface (zero attenuation) the expectation is exactly bg/2."""
    host = RtxHost(tri_chunk=8, ray_chunk=RES * RES)
    host.load_model(quad_mesh())
    host.load_texture_diffuse(solid_texture(0.0, 0.0, 0.0, a=0.5))
    bg = (0.8, 0.4, 0.2)
    img = render(host, bg, samples=400, seed=5)
    c = img[RES // 2, RES // 2]
    # 400 Bernoulli samples: sigma = 0.5/sqrt(400) = 0.025 per channel
    np.testing.assert_allclose(c, np.asarray(bg) * 0.5, atol=0.1)
    assert 0.05 < c[0] < 0.75  # genuinely mixed, neither pure bg nor black


def test_roulette_unbiased_and_off_by_default():
    """Russian roulette (RuntimeConfig.rt_roulette_from; opt-in deviation —
    the reference always marches to the 50-bounce cap): with the knob off
    the sample stream is untouched, and with it on the estimator stays
    unbiased — the mean image converges to the exact render within MC
    tolerance at a modest sample count."""
    host_exact = RtxHost(tri_chunk=8, ray_chunk=RES * RES)
    host_exact.load_model(quad_mesh())
    host_exact.load_texture_diffuse(solid_texture(0.8, 0.5, 0.3))
    host_off = RtxHost(tri_chunk=8, ray_chunk=RES * RES, roulette_from=0)
    host_off.load_model(quad_mesh())
    host_off.load_texture_diffuse(solid_texture(0.8, 0.5, 0.3))
    host_on = RtxHost(tri_chunk=8, ray_chunk=RES * RES, roulette_from=2)
    host_on.load_model(quad_mesh())
    host_on.load_texture_diffuse(solid_texture(0.8, 0.5, 0.3))

    bg = (0.1, 0.2, 0.3)
    exact = render(host_exact, bg, samples=96, seed=11)
    off = render(host_off, bg, samples=96, seed=11)
    np.testing.assert_array_equal(np.asarray(exact), np.asarray(off))

    on = render(host_on, bg, samples=96, seed=11)
    # unbiasedness: mean brightness agrees within MC noise (the quad
    # scene's paths mostly terminate at bounce 1-2, so roulette from 2
    # touches only the multi-bounce tail)
    diff = float(np.mean(np.abs(np.asarray(on) - np.asarray(exact))))
    assert diff < 0.02, diff
    assert np.isfinite(np.asarray(on)).all()
    # boosted per-sample estimates may exceed 1 by design (the reference
    # per-sample clamp is skipped under roulette so the boost stays
    # unbiased); the sample AVERAGE stays near the exact <= 1 image
    assert float(np.max(np.asarray(on))) <= 1.1
