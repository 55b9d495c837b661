"""Texture system: mip pyramid construction, trilinear filtering, and the
primary-hit LOD path (ops/texture.py; reference mipmap.h + bitmap.cpp)."""
import os
import textwrap

import numpy as np
import pytest

from gradientdomain_mitsuba_tpu.ops import texture as tx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_pyramid_box_filter_preserves_mean():
    rng = np.random.default_rng(0)
    img = rng.random((64, 32, 3)).astype(np.float32)
    levels = tx._build_pyramid(img)
    assert levels[0].shape == (64, 32, 3)
    assert levels[-1].shape == (1, 1, 3)
    assert len(levels) == 7  # 64 -> ... -> 1
    # box filtering preserves the mean at every level (pow2 dims: exact)
    for l in levels:
        np.testing.assert_allclose(l.mean(axis=(0, 1)),
                                   img.mean(axis=(0, 1)), rtol=1e-5)


def test_pyramid_odd_sizes():
    img = np.ones((5, 7, 3), np.float32)
    levels = tx._build_pyramid(img)
    assert levels[-1].shape == (1, 1, 3)
    for l in levels:
        np.testing.assert_allclose(l, 1.0)


def _table_from_image(img):
    """Build a 1-texture table through the packing path."""
    slab, offs, szs = tx._pack_pyramid(tx._build_pyramid(img))
    T, L = 1, len(offs)
    return tx.TextureTable(
        kind=np.zeros(T, np.int32),
        color0=np.ones((T, 3), np.float32),
        color1=np.zeros((T, 3), np.float32),
        uv_scale=np.ones((T, 2), np.float32),
        uv_offset=np.zeros((T, 2), np.float32),
        image=slab[None], img_size=np.array([img.shape[:2]], np.int32),
        lvl_off=np.array([offs], np.int32),
        lvl_size=np.array([szs], np.int32),
        n_levels=np.array([L], np.int32),
        grid_width=np.full(T, 0.01, np.float32),
        filter_ewa=np.zeros(T, np.int32))


def test_trilinear_levels():
    """A 1-texel checker: level 0 reads near 0/1, the coarsest level is
    the 0.5 mean, and LODs in between interpolate monotonically."""
    img = np.zeros((16, 16, 3), np.float32)
    img[::2, ::2] = 1.0
    img[1::2, 1::2] = 1.0
    tab = _table_from_image(img)
    tid = np.zeros(1, np.int32)
    uv = np.array([[0.53125, 0.53125]], np.float32)  # texel center-ish

    import jax.numpy as jnp
    v_fine = np.asarray(tx.eval_texture(tab, tid, uv))  # no footprint
    # footprint covering the whole texture -> coarsest level = mean 0.5
    fp_huge = jnp.full((1,), 64.0)
    v_coarse = np.asarray(tx.eval_texture(tab, tid, uv, fp_huge))
    np.testing.assert_allclose(v_coarse, 0.5, atol=1e-3)
    # tiny footprint -> identical to the no-footprint (finest) path
    fp_tiny = jnp.full((1,), 1e-12)
    v_tiny = np.asarray(tx.eval_texture(tab, tid, uv, fp_tiny))
    np.testing.assert_allclose(v_tiny, v_fine, atol=1e-6)
    # mid footprint sits between
    fp_mid = jnp.full((1,), 4.0 / (16 * 16))  # ~4 texels -> lod 1
    v_mid = np.asarray(tx.eval_texture(tab, tid, uv, fp_mid))
    assert (np.abs(v_mid - 0.5) <= np.abs(v_fine - 0.5) + 1e-6).all()


def test_bitmap_scene_renders_with_lod(tmp_path):
    """End-to-end: a bitmap-textured floor renders finite with the
    primary-hit LOD path enabled (path integrator, peeled bounce 0)."""
    from PIL import Image
    rng = np.random.default_rng(1)
    teximg = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    Image.fromarray(teximg).save(tmp_path / "tex.png")
    xml = textwrap.dedent("""\
        <scene version="0.5.0">
          <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
          <sensor type="perspective">
            <float name="fov" value="39.3077"/>
            <transform name="toWorld">
              <lookat origin="278, 273, -800" target="278, 273, -799" up="0, 1, 0"/>
            </transform>
            <sampler type="independent"><integer name="sampleCount" value="4"/></sampler>
            <film type="hdrfilm">
              <integer name="width" value="16"/><integer name="height" value="16"/>
              <rfilter type="box"/>
            </film>
          </sensor>
          <shape type="obj"><string name="filename" value="{mesh}/cbox_floor.obj"/>
            <bsdf type="diffuse">
              <texture name="reflectance" type="bitmap">
                <string name="filename" value="tex.png"/>
                <float name="uscale" value="8"/><float name="vscale" value="8"/>
              </texture>
            </bsdf>
          </shape>
          <shape type="obj"><string name="filename" value="{mesh}/cbox_luminaire.obj"/>
            <emitter type="area"><rgb name="radiance" value="17, 12, 4"/></emitter>
          </shape>
        </scene>
    """).format(mesh=os.path.join(ROOT, "data/scenes/cbox/meshes"))
    p = tmp_path / "tex.xml"
    p.write_text(xml)
    from gradientdomain_mitsuba_tpu.models import path as path_mod
    from gradientdomain_mitsuba_tpu.scene import scene as sc
    scene, st = sc.load_scene(str(p))
    assert int(scene.textures.n_levels[0]) == 7
    img = path_mod.PathTracer(scene, st).render(scene, seed=0, spp=4)
    assert np.isfinite(img).all()
    assert img.max() > 0


def test_gridtexture_and_scale():
    import jax.numpy as jnp
    from gradientdomain_mitsuba_tpu.ops import texture as tx
    from gradientdomain_mitsuba_tpu.scene.ir import Plugin
    grid = Plugin(kind="texture", type="gridtexture", props={
        "color0": np.array([0.4, 0.4, 0.4], np.float32),
        "color1": np.array([1.0, 0.0, 0.0], np.float32),
        "lineWidth": 0.1})
    nested = Plugin(kind="texture", type="checkerboard", props={
        "color0": np.array([1.0, 1.0, 1.0], np.float32),
        "color1": np.array([0.5, 0.5, 0.5], np.float32)})
    scale = Plugin(kind="texture", type="scale", props={
        "value": np.array([2.0, 2.0, 2.0], np.float32)},
        children=[nested])
    table = tx.build_table([grid, scale], ".")
    # grid: uv in the cell interior -> background, near boundary -> line
    uv = jnp.asarray(np.array([[0.5, 0.5], [0.02, 0.5]], np.float32))
    out = np.asarray(tx.eval_texture(table, jnp.asarray([0, 0]), uv))
    np.testing.assert_allclose(out[0], [0.4, 0.4, 0.4], atol=1e-6)
    np.testing.assert_allclose(out[1], [1.0, 0.0, 0.0], atol=1e-6)
    # scale wrapper: checkerboard colors doubled
    out2 = np.asarray(tx.eval_texture(
        table, jnp.asarray([1, 1]),
        jnp.asarray(np.array([[0.25, 0.25], [0.75, 0.25]], np.float32))))
    assert set(np.round(out2.flatten(), 3)) <= {2.0, 1.0}


# ---------------------------------------------------------------------------
# Anisotropic (EWA-class) filtering — round 2
# ---------------------------------------------------------------------------

def test_aniso_filter_sharper_along_stripes(tmp_path):
    """A footprint ellipse elongated ALONG vertical stripes must keep the
    local stripe value (anisotropic taps follow the stripe) while the
    equal-area isotropic trilinear lookup blurs toward the global mean."""
    import jax.numpy as jnp
    from gradientdomain_mitsuba_tpu.ops import texture as T
    from gradientdomain_mitsuba_tpu.scene.ir import Plugin
    from gradientdomain_mitsuba_tpu.utils import exr as exr_mod

    H = W = 64
    img = np.zeros((H, W, 3), np.float32)
    img[:, (np.arange(W) // 8) % 2 == 0] = 1.0  # vertical stripes (u axis)
    path = str(tmp_path / "stripes.exr")
    exr_mod.write(path, img)

    node = Plugin(kind="texture", type="bitmap",
                  props={"filename": "stripes.exr"})
    tex = T.build_table([node], str(tmp_path))
    assert int(tex.filter_ewa[0]) == 1  # Mitsuba default filterType=ewa

    uv = jnp.asarray([[0.065, 0.5]])    # center of a white stripe
    tid = jnp.zeros(1, jnp.int32)
    point = np.asarray(T.eval_texture(tex, tid, uv))[0]

    # ellipse: long axis 0.4 uv ALONG v (stripes), short 0.004 across
    jac = jnp.asarray([[[0.004, 0.0], [0.0, 0.4]]])
    area = jnp.asarray([0.004 * 0.4])
    aniso = np.asarray(T.eval_texture(tex, tid, uv, (area, jac)))[0]
    # the alias-free ISOTROPIC filter must cover the major axis: a
    # trilinear lookup at that area blurs everything to the mean —
    # exactly the over-blur anisotropic filtering exists to avoid
    tri = np.asarray(T.eval_texture(tex, tid, uv,
                                    jnp.asarray([0.4 * 0.4])))[0]

    err_aniso = abs(float(aniso[0]) - float(point[0]))
    err_tri = abs(float(tri[0]) - float(point[0]))
    assert err_aniso < err_tri * 0.5, (err_aniso, err_tri)
    assert err_aniso < 0.15, err_aniso


def test_aniso_isotropic_matches_trilinear(tmp_path):
    """With an isotropic footprint, the anisotropic filter must agree
    with plain trilinear closely (same mip, taps collapse)."""
    import jax.numpy as jnp
    from gradientdomain_mitsuba_tpu.ops import texture as T
    from gradientdomain_mitsuba_tpu.scene.ir import Plugin
    from gradientdomain_mitsuba_tpu.utils import exr as exr_mod

    rs = np.random.RandomState(0)
    img = rs.rand(32, 32, 3).astype(np.float32)
    path = str(tmp_path / "noise.exr")
    exr_mod.write(path, img)
    node = Plugin(kind="texture", type="bitmap",
                  props={"filename": "noise.exr"})
    tex = T.build_table([node], str(tmp_path))

    uv = jnp.asarray(rs.rand(64, 2).astype(np.float32))
    tid = jnp.zeros(64, jnp.int32)
    s = 0.1
    area = jnp.full(64, s * s)
    jac = jnp.broadcast_to(jnp.asarray([[s, 0.0], [0.0, s]]), (64, 2, 2))
    aniso = np.asarray(T.eval_texture(tex, tid, uv, (area, jac)))
    tri = np.asarray(T.eval_texture(tex, tid, uv, area))
    np.testing.assert_allclose(aniso, tri, atol=0.12)


def test_aniso_filter_vs_ewa_quadrature(tmp_path):
    """The fixed-8-tap anisotropic filter ('EWA-class', ops/texture.py
    _aniso_sample) against a brute-force elliptical-Gaussian quadrature
    of the level-0 image (true EWA reference): on a strongly anisotropic
    footprint whose major axis runs ALONG vertical stripes, the 8-tap
    filter must preserve the stripe signal that isotropic trilinear
    filtering (LOD from footprint area) washes out."""
    import jax.numpy as jnp
    from gradientdomain_mitsuba_tpu.ops import texture as tex_ops
    from gradientdomain_mitsuba_tpu.scene.ir import Plugin
    from gradientdomain_mitsuba_tpu.utils import exr

    # 64x64 vertical stripes, period 8 texels (constant along v)
    W = H = 64
    x = np.arange(W)
    img = np.broadcast_to(
        (0.25 + 0.5 * ((x // 4) % 2))[None, :, None],
        (H, W, 3)).astype(np.float32)
    path = str(tmp_path / "stripes.exr")
    exr.write(path, img, half=False)

    node = Plugin(kind="texture", type="bitmap",
                  props={"filename": "stripes.exr", "filterType": "ewa"})
    tex = tex_ops.build_table([node], str(tmp_path))

    # footprint: 1 texel wide in u (minor), 16 texels long in v (major)
    n_pts = 16
    uv = np.stack([np.linspace(0.1, 0.9, n_pts),
                   np.full(n_pts, 0.5)], -1).astype(np.float32)
    major = np.array([0.0, 16.0 / H], np.float32)   # uv units
    minor = np.array([1.0 / W, 0.0], np.float32)
    jac = np.broadcast_to(
        np.stack([major, minor], -1), (n_pts, 2, 2)).copy()
    area = float(np.linalg.norm(major) * np.linalg.norm(minor))

    tid = jnp.zeros(n_pts, jnp.int32)
    aniso = np.asarray(tex_ops.eval_texture(
        tex, tid, jnp.asarray(uv),
        uv_footprint=(jnp.full(n_pts, area), jnp.asarray(jac))))[:, 0]
    iso = np.asarray(tex_ops.eval_texture(
        tex, tid, jnp.asarray(uv),
        uv_footprint=jnp.full(n_pts, area)))[:, 0]

    # brute-force EWA quadrature of the same separable Gaussian
    # (exp(-8 t^2) along each ellipse axis, t in (-.5, .5)) over the
    # level-0 image with bilinear point taps
    def bilin(u, v):
        xx = (u % 1.0) * W - 0.5
        yy = ((1.0 - v) % 1.0) * H - 0.5
        x0 = np.floor(xx).astype(int)
        y0 = np.floor(yy).astype(int)
        fx, fy = xx - x0, yy - y0
        p = img[..., 0]
        g = lambda yi, xi: p[np.mod(yi, H), np.mod(xi, W)]
        return (g(y0, x0) * (1 - fx) * (1 - fy) +
                g(y0, x0 + 1) * fx * (1 - fy) +
                g(y0 + 1, x0) * (1 - fx) * fy +
                g(y0 + 1, x0 + 1) * fx * fy)

    ts = np.linspace(-0.5, 0.5, 41)
    ref = np.zeros(n_pts)
    for i in range(n_pts):
        acc = wsum = 0.0
        for t in ts:
            for s in ts:
                w = np.exp(-8.0 * (t * t + s * s))
                p = uv[i] + t * major + s * minor
                acc += w * bilin(p[0], p[1])
                wsum += w
        ref[i] = acc / wsum

    err_aniso = np.abs(aniso - ref).mean()
    err_iso = np.abs(iso - ref).mean()
    # the isotropic path blurs the stripes to their mean; the 8-tap
    # anisotropic filter must track the quadrature reference much closer
    assert err_aniso < 0.5 * err_iso, (err_aniso, err_iso)
    assert err_aniso < 0.06, err_aniso
    # and it must preserve more stripe contrast than the isotropic blur
    assert aniso.std() > 1.25 * iso.std(), (aniso.std(), iso.std())
