import numpy as np
import pytest

from gaussian_splatterer_tpu.io.gobj import load_gobj, save_gobj
from gaussian_splatterer_tpu.io.obj import load_obj
from gaussian_splatterer_tpu.models.splats import (
    SplatModel,
    SplatModelHost,
    init_field_grid,
    init_field_model,
    init_field_mono,
    quat_from_axis_angle,
)


def test_splat_model_empty():
    m = SplatModel.empty(64, sh_degree=1, sh_coeffs=4)
    assert m.capacity == 64
    assert m.sh_coeffs == 4
    assert int(m.count) == 0
    assert not bool(m.active_mask().any())
    np.testing.assert_allclose(np.asarray(m.rotations[:, 0]), 1.0)


def test_host_push_copy_roundtrip():
    h = SplatModelHost(8, 1, 4)
    h.push_back([1, 2, 3], np.zeros((4, 3)), [0.1, 0.2, 0.3], 0.5, [1, 0, 0, 0])
    h.push_back([4, 5, 6], np.ones((4, 3)), [0.4, 0.5, 0.6], 0.9, [0.5, 0.5, 0.5, 0.5])
    h.copy(0, 1)
    np.testing.assert_allclose(h.means[0], [4, 5, 6])
    np.testing.assert_allclose(h.opacities[0], 0.9)
    d = h.to_device()
    assert int(d.count) == 2
    h2 = SplatModelHost.from_device(d)
    np.testing.assert_allclose(h2.means[:2], h.means[:2])


def test_init_field_grid():
    m = init_field_grid(capacity=10000)
    assert m.count == 17**3  # 4913 splats (src/ui/UiFrame.cpp:137-160)
    assert m.means[:, 0].min() == -4.0 and m.means[:, 0].max() == 4.0
    np.testing.assert_allclose(m.scales[: m.count], 0.05)
    np.testing.assert_allclose(m.opacities[: m.count], 1.0)


def test_init_field_mono():
    m = init_field_mono(capacity=10)
    assert m.count == 1
    np.testing.assert_allclose(m.scales[0], 0.3)


def test_init_field_model_orients_to_normal():
    # one triangle in the XY plane -> normal +Z -> identity rotation
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tris = np.array([[0, 1, 2]], np.int32)
    m = init_field_model(verts, tris, capacity=10)
    assert m.count == 1
    np.testing.assert_allclose(m.means[0], [1 / 3, 1 / 3, 0], atol=1e-6)
    np.testing.assert_allclose(m.scales[0], [0.2, 0.2, 0.001], atol=1e-6)
    np.testing.assert_allclose(m.rotations[0], [1, 0, 0, 0], atol=1e-6)


def test_quat_from_axis_angle():
    q = quat_from_axis_angle(np.array([0, 0, 2.0]), np.pi / 2)  # unnormalized axis ok
    np.testing.assert_allclose(q, [np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)], atol=1e-6)


def test_gobj_roundtrip(tmp_path):
    h = SplatModelHost(4, 1, 4)
    h.push_back([1, 2, 3], np.arange(12).reshape(4, 3) * 0.1, [0.1, 0.2, 0.3], 0.5,
                [0.9, 0.1, 0.2, 0.3])
    h.push_back([-1, -2, -3], np.zeros((4, 3)), [0.4, 0.5, 0.6], 1.0, [1, 0, 0, 0])
    path = str(tmp_path / "splats.gobj")
    save_gobj(h, path)
    m = load_gobj(path)
    assert m.count == 2
    assert m.sh_coeffs == 4
    np.testing.assert_allclose(m.means[:2], h.means[:2], rtol=1e-5)
    np.testing.assert_allclose(m.shs[:2], h.shs[:2], rtol=1e-5)
    np.testing.assert_allclose(m.rotations[:2], h.rotations[:2], rtol=1e-5)
    np.testing.assert_allclose(m.opacities[:2], h.opacities[:2], rtol=1e-5)
    # capacity autogrow rule (src/ModelSplatsHost.cpp:31-32)
    assert m.capacity == 1_000_000


def test_gobj_text_format(tmp_path):
    h = SplatModelHost(1, 1, 4)
    h.push_back([1, 2, 3], np.zeros((4, 3)), [4, 5, 6], 0.5, [1, 0, 0, 0])
    path = str(tmp_path / "s.gobj")
    save_gobj(h, path)
    lines = open(path).read().strip().split("\n")
    assert lines[0] == "v 1 2 3"
    assert lines[1].startswith("sh 0 0 0")
    assert lines[2] == "s 4 5 6"
    assert lines[3] == "a 0.5"
    assert lines[4] == "r 1 0 0 0"


def test_obj_loader_tris_quads_uvs(tmp_path):
    obj = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
f 1/1 2/2 3/3 4/4
f 1 2 3
"""
    path = tmp_path / "m.obj"
    path.write_text(obj)
    mesh = load_obj(str(path))
    assert mesh.vertices.shape == (4, 3)
    # quad splits into 2 triangles (0,1,2) and (0,2,3); plus a bare tri
    assert mesh.num_triangles == 3
    np.testing.assert_array_equal(mesh.triangles[0], [0, 1, 2])
    np.testing.assert_array_equal(mesh.triangles[1], [0, 2, 3])
    np.testing.assert_allclose(mesh.tri_uv[0], [[0, 0], [1, 0], [1, 1]])
    np.testing.assert_allclose(mesh.tri_uv[1], [[0, 0], [1, 1], [0, 1]])
    # face without vt indices falls back to zeros (src/rtx/RtxHost.cpp:178-182)
    np.testing.assert_allclose(mesh.tri_uv[2], 0.0)


def test_viewer_html_export_roundtrip(tmp_path):
    """The self-contained viewer embeds the exact splat data (base64 f32,
    23 floats/splat) and valid standalone HTML (no external resources)."""
    import base64
    import re

    from gaussian_splatterer_tpu.io.viewer import (
        export_viewer_html,
        pack_viewer_arrays,
    )
    from gaussian_splatterer_tpu.ops.transforms import SH_C0

    h = SplatModelHost(16, 1, 4)
    rng = np.random.default_rng(3)
    for _ in range(5):
        sh = np.zeros((4, 3), np.float32)
        sh[0] = (rng.uniform(0.2, 1, 3) - 0.5) / SH_C0
        sh[1:] = rng.normal(0, 0.1, (3, 3))
        h.push_back(rng.uniform(-1, 1, 3), sh, rng.uniform(0.05, 0.2, 3),
                    rng.uniform(0.5, 1), [1, 0, 0, 0])
    path = str(tmp_path / "v.html")
    export_viewer_html(h, path)
    html = open(path).read()
    assert html.startswith("<!DOCTYPE html>")
    assert "http://" not in html and "https://" not in html  # offline
    m = re.search(r'const B64 = "([^"]*)"', html)
    data = np.frombuffer(
        base64.b64decode(m.group(1)), np.float32
    ).reshape(5, 23)
    np.testing.assert_array_equal(data, pack_viewer_arrays(h))
    # positions / quats / opacity land in the right lanes
    np.testing.assert_allclose(data[:, 0:3], h.means[:5])
    np.testing.assert_allclose(data[:, 6:10], h.rotations[:5])
    np.testing.assert_allclose(data[:, 22], h.opacities[:5])
    assert '"count": 5' in html


@pytest.mark.parametrize("sh_degree", [2, 3])
def test_gobj_roundtrip_high_sh_degree(tmp_path, sh_degree):
    """.gobj round-trip at SH degree 2-3: the reference infers the SH width
    from the first `sh` line (src/ui/UiFrame.cpp:419-420) — 9/16-coeff
    lines must survive write->read with degree re-inferred."""
    from gaussian_splatterer_tpu.io.gobj import load_gobj, save_gobj

    k = (sh_degree + 1) ** 2
    rng = np.random.default_rng(sh_degree)
    h = SplatModelHost(8, sh_degree, k)
    for _ in range(4):
        h.push_back(rng.uniform(-1, 1, 3), rng.normal(0, 0.3, (k, 3)),
                    rng.uniform(0.05, 0.3, 3), rng.uniform(0.2, 1),
                    rng.normal(0, 1, 4))
    path = str(tmp_path / "hi_sh.gobj")
    save_gobj(h, path)
    # the sh lines carry 3*k floats
    sh_lines = [l for l in open(path) if l.startswith("sh ")]
    assert len(sh_lines) == 4
    assert all(len(l.split()) == 1 + 3 * k for l in sh_lines)

    back = load_gobj(path, capacity=8)
    assert back.sh_coeffs == k
    assert back.sh_degree == sh_degree
    np.testing.assert_allclose(back.shs[:4], h.shs[:4], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(back.means[:4], h.means[:4], rtol=1e-4, atol=1e-5)


def test_ply_roundtrip_inria_layout(tmp_path):
    """Standard 3DGS binary PLY export/import (io/ply.py): INRIA field
    layout with logit-opacity / log-scale / channel-major f_rest baked in,
    so the file drops straight into ecosystem viewers.  Round-trip must
    recover the model up to the activation transforms' float error."""
    from gaussian_splatterer_tpu.io.ply import load_ply, save_ply

    rng = np.random.default_rng(7)
    for degree in (1, 2):
        k = (degree + 1) ** 2
        n = 23
        h = SplatModelHost(64, degree, k)
        h.means[:n] = rng.uniform(-2, 2, (n, 3))
        h.shs[:n] = rng.normal(0, 0.5, (n, k, 3))
        h.scales[:n] = rng.uniform(0.01, 0.4, (n, 3))
        h.opacities[:n] = rng.uniform(0.05, 0.95, n)
        h.rotations[:n] = rng.normal(0, 1, (n, 4))
        h.count = n

        path = str(tmp_path / f"model_d{degree}.ply")
        save_ply(h, path)
        back = load_ply(path)
        assert back.count == n
        assert back.sh_degree == degree and back.sh_coeffs == k
        np.testing.assert_allclose(back.means[:n], h.means[:n], atol=1e-6)
        np.testing.assert_allclose(back.shs[:n], h.shs[:n], atol=1e-6)
        np.testing.assert_allclose(back.scales[:n], h.scales[:n], rtol=1e-5)
        np.testing.assert_allclose(
            back.opacities[:n], h.opacities[:n], atol=1e-5
        )
        np.testing.assert_allclose(
            back.rotations[:n], h.rotations[:n], atol=1e-6
        )

        # header is the INRIA property list (ecosystem loaders key on it)
        head = open(path, "rb").read(4000).decode("ascii", "ignore")
        assert "property float f_dc_0" in head
        assert f"f_rest_{3 * (k - 1) - 1}" in head
        assert "property float opacity" in head

    # capacity growth mirrors the .gobj loader
    big = load_ply(path, capacity=256)
    assert big.capacity == 256 and big.count == n


def test_ply_loader_tolerates_ecosystem_headers(tmp_path):
    """Ecosystem writers add comment/obj_info lines and trailing empty
    elements; the loader must accept them (and still reject non-float
    VERTEX properties and pre-vertex elements)."""
    import pytest

    from gaussian_splatterer_tpu.io.ply import load_ply, save_ply

    h = SplatModelHost(8, 1, 4)
    h.means[:2] = [[0, 0, 1], [1, 0, 2]]
    h.opacities[:2] = 0.5
    h.scales[:2] = 0.1
    h.rotations[:2] = [1, 0, 0, 0]
    h.count = 2
    path = str(tmp_path / "m.ply")
    save_ply(h, path)
    raw = open(path, "rb").read()
    head, _, body = raw.partition(b"end_header\n")
    lines = head.decode().splitlines()
    # inject a comment before 'format' and an empty face element at the end
    decorated = (
        [lines[0], "comment Generated by some-ecosystem-tool"]
        + lines[1:]
        + ["element face 0", "property list uchar int vertex_indices"]
    )
    path2 = str(tmp_path / "m2.ply")
    with open(path2, "wb") as fh:
        fh.write(("\n".join(decorated) + "\nend_header\n").encode())
        fh.write(body)
    back = load_ply(path2)
    assert back.count == 2
    np.testing.assert_allclose(back.means[:2], h.means[:2], atol=1e-6)

    # a non-float VERTEX property must still be rejected
    bad = [lines[0]] + lines[1:]
    bad.insert(4, "property uchar red")
    path3 = str(tmp_path / "m3.ply")
    with open(path3, "wb") as fh:
        fh.write(("\n".join(bad) + "\nend_header\n").encode())
        fh.write(body)
    with pytest.raises(ValueError):
        load_ply(path3)


def _viewer_shader_sim(pos, scale, view, proj, focal, viewport):
    """Numpy transcription of the viewer's vertex shader (io/viewer.py VS):
    returns (culled, ndc_center, cov2d) for one splat with identity
    rotation.  Must mirror the GLSL exactly — this test exists because a
    z-sign error there once culled EVERY visible splat (black canvas)."""
    vc = view @ np.append(pos, 1.0)
    if vc[2] > -0.2:  # RH view space: visible points have z < 0
        return True, None, None
    tz = -vc[2]
    V = np.diag(np.asarray(scale, np.float64) ** 2)
    W3 = view[:3, :3]
    iz = 1.0 / tz
    fx, fy = focal
    # column-major GLSL mat3 constructor -> this row-major layout
    J = np.array([
        [fx * iz, 0.0, fx * vc[0] * iz * iz],
        [0.0, fy * iz, fy * vc[1] * iz * iz],
        [0.0, 0.0, 0.0],
    ])
    T = J @ W3
    C = T @ V @ T.T
    cov2d = C[:2, :2] + 0.3 * np.eye(2)
    clip = proj @ vc
    return False, clip[:2] / clip[3], cov2d


def test_viewer_shader_math_matches_projection():
    import jax.numpy as jnp

    """The HTML viewer's vertex-shader math (numpy-simulated) must agree
    with the trusted JAX projection: same near-cull decisions, same
    dilated 2D covariance (up to the y-axis orientation), centered splat
    lands at NDC ~ 0."""
    from gaussian_splatterer_tpu.models.camera import Camera
    from gaussian_splatterer_tpu.ops.transforms import project_splat_components

    # the viewer's standard lookAt/perspective for an orbit camera
    eye = np.array([0.0, 0.5, 4.0])
    tgt = np.zeros(3)
    up = np.array([0.0, 1.0, 0.0])
    z = (eye - tgt) / np.linalg.norm(eye - tgt)
    x = np.cross(up, z); x /= np.linalg.norm(x)
    y = np.cross(z, x)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = x, y, z
    view[:3, 3] = [-x @ eye, -y @ eye, -z @ eye]
    fovy = np.pi / 4
    wpx = hpx = 256
    t = 1.0 / np.tan(fovy / 2)
    proj = np.array([
        [t, 0, 0, 0], [0, t, 0, 0],
        [0, 0, (100.0 + 0.1) / (0.1 - 100.0), 2 * 100.0 * 0.1 / (0.1 - 100.0)],
        [0, 0, -1, 0],
    ])
    fl = 0.5 * hpx / np.tan(fovy / 2)

    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.0, 1.0, (32, 3))
    pts[0] = tgt  # dead-center splat
    scales = rng.uniform(0.05, 0.3, (32, 3))

    # trusted projection at the SAME pose (reference camera convention)
    cam = Camera(eye.astype(np.float32), tgt.astype(np.float32), 45.0)
    n = 32
    shs = np.zeros((n, 4, 3), np.float32)
    rot = np.zeros((n, 4), np.float32); rot[:, 0] = 1.0
    pr = project_splat_components(
        jnp.asarray(pts, jnp.float32), jnp.asarray(shs),
        jnp.asarray(scales, jnp.float32),
        jnp.ones((n,), jnp.float32), jnp.asarray(rot),
        jnp.ones((n,), bool),
        jnp.asarray(cam.get_view()), jnp.asarray(cam.get_proj_view(1.0)),
        jnp.asarray(cam.location), *cam.tan_fov(wpx, hpx, train=True),
        wpx, hpx, 0, 1.0,
    )

    n_visible = 0
    for i in range(32):
        culled, ndc, cov = _viewer_shader_sim(
            pts[i], scales[i], view, proj, (fl, fl), (wpx, hpx)
        )
        assert culled == (not bool(pr.valid[i])), f"cull mismatch splat {i}"
        if culled:
            continue
        n_visible += 1
        assert np.all(np.isfinite(ndc)) and np.all(np.isfinite(cov))
        # reconstruct the trusted dilated cov2d from the conic rows
        ca, cb, cc = (float(pr.ca[i]), float(pr.cb[i]), float(pr.cc[i]))
        conic = np.array([[ca, cb], [cb, cc]])
        cov_ref = np.linalg.inv(conic)
        # y axis is flipped between NDC and image coords: |cxy| matches
        np.testing.assert_allclose(cov[0, 0], cov_ref[0, 0], rtol=2e-3)
        np.testing.assert_allclose(cov[1, 1], cov_ref[1, 1], rtol=2e-3)
        np.testing.assert_allclose(
            abs(cov[0, 1]), abs(cov_ref[0, 1]), rtol=2e-3, atol=1e-3
        )
    assert n_visible >= 30, "orbit camera must see nearly all splats"
    _, ndc0, _ = _viewer_shader_sim(
        pts[0], scales[0], view, proj, (fl, fl), (wpx, hpx)
    )
    np.testing.assert_allclose(ndc0, 0.0, atol=1e-6)
