"""blendbsdf / mixturebsdf / bumpmap / normalmap wrapper validation
(reference: src/bsdfs/{blendbsdf,mixturebsdf,bumpmap,normalmap}.cpp).

Round-2 additions: chi^2 sample-vs-pdf for the
blend mixture, analytic render identities (blend of two diffuse == the
mean diffuse; constant normal/bump maps are no-ops), and end-to-end
loads through the XML front door."""
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gradientdomain_mitsuba_tpu.core import rng
from gradientdomain_mitsuba_tpu.ops import bsdf
from gradientdomain_mitsuba_tpu.scene import materials as M
from gradientdomain_mitsuba_tpu.scene import scene as sc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(ROOT, "data/scenes/cbox/meshes")
N = 1 << 16


def _blend_params(n, w=0.4):
    mb = M.MaterialBuilder()
    c0 = mb.add_row(kind=M.DIFFUSE, reflectance=(0.6, 0.6, 0.6))
    c1 = mb.add_row(kind=M.ROUGH_CONDUCTOR, alpha=0.3,
                    eta=(0.2, 0.92, 1.1), k=(3.91, 2.45, 2.14))
    b = mb.add_blend(c0, c1, w)
    mats = mb.finalize()
    mid = jnp.full(n, b, jnp.int32)
    p = bsdf.gather_params(mats, mid)
    pa = bsdf.gather_params(mats, p.child0)
    pb = bsdf.gather_params(mats, p.child1)
    return pa._replace(blend=pb, blend_w=p.blend_w)


def test_blend_chi2_sample_vs_pdf():
    """Sampled directions of the blend must follow the mixture pdf."""
    from test_bsdf import chi2_sphere
    par = _blend_params(N)
    wi = jnp.asarray(np.float32([0.3, -0.2, 0.93]))
    wi = wi / jnp.linalg.norm(wi)
    u2 = rng.uniform_2d(11, jnp.arange(N), 0, 0)
    uc = rng.uniform_float(11, jnp.arange(N), 0, 2)
    bs = bsdf.sample(par, jnp.broadcast_to(wi, (N, 3)), u2, uc)
    chi2_sphere(jax.tree.map(lambda a: a[:1], par), wi, bs)


def test_blend_weight_matches_eval_over_pdf():
    par = _blend_params(N)
    wi = jnp.asarray(np.float32([0.1, 0.25, 0.96]))
    wi = wi / jnp.linalg.norm(wi)
    u2 = rng.uniform_2d(5, jnp.arange(N), 0, 0)
    uc = rng.uniform_float(5, jnp.arange(N), 0, 2)
    bs = bsdf.sample(par, jnp.broadcast_to(wi, (N, 3)), u2, uc)
    sel = np.asarray(bs.valid & ~bs.is_delta & (bs.pdf > 1e-5))
    f = np.asarray(bsdf.eval(par, jnp.broadcast_to(wi, (N, 3)), bs.wo))
    expect = f[sel] / np.asarray(bs.pdf)[sel][:, None]
    got = np.asarray(bs.weight)[sel]
    np.testing.assert_allclose(got, expect, rtol=2e-3, atol=2e-5)


SCENE_XML = textwrap.dedent("""\
    <scene version="0.5.0">
      <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
      <sensor type="perspective">
        <float name="fov" value="39.3077"/>
        <transform name="toWorld">
          <lookat origin="278, 273, -800" target="278, 273, -799" up="0, 1, 0"/>
        </transform>
        <sampler type="independent"><integer name="sampleCount" value="8"/></sampler>
        <film type="hdrfilm">
          <integer name="width" value="24"/><integer name="height" value="24"/>
          <rfilter type="box"/>
        </film>
      </sensor>
      {floor_bsdf}
      <shape type="rectangle">  <!-- rectangle: HAS UVs (tangent frames
           for the normal/bump perturbation; cbox_floor.obj has none) -->
        <transform name="toWorld">
          <rotate x="1" angle="-90"/><scale x="278" y="1" z="280"/>
          <translate x="278" y="0" z="280"/>
        </transform>
        <ref id="floor"/></shape>
      <shape type="obj"><string name="filename" value="{mesh}/cbox_back.obj"/>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.5 0.5 0.5"/></bsdf>
      </shape>
      <shape type="rectangle">
        <transform name="toWorld">
          <rotate x="1" angle="90"/><scale x="65" y="1" z="52"/>
          <translate x="278" y="548" z="279"/>
        </transform>
        <emitter type="area"><rgb name="radiance" value="18, 15, 8"/></emitter>
      </shape>
    </scene>
""")


def _render(floor_bsdf, spp=24, seed=3):
    import tempfile
    from gradientdomain_mitsuba_tpu.models.path import PathTracer
    xml = SCENE_XML.format(mesh=MESH, floor_bsdf=floor_bsdf)
    with tempfile.NamedTemporaryFile("w", suffix=".xml", dir=MESH + "/..",
                                     delete=False) as f:
        f.write(xml)
        p = f.name
    try:
        scene, st = sc.load_scene(p)
    finally:
        os.unlink(p)
    img = PathTracer(scene, st).render(scene, seed=seed, spp=spp)
    return np.asarray(img), scene


def test_blend_of_diffuse_equals_mean_diffuse():
    """blend(diffuse a, diffuse b, w) == diffuse((1-w)a + w b) exactly in
    expectation — rendered with the same seeds, near-equal images."""
    blend = """
      <bsdf type="blendbsdf" id="floor">
        <float name="weight" value="0.25"/>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.2 0.4 0.6"/></bsdf>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.8 0.6 0.2"/></bsdf>
      </bsdf>"""
    flat = """
      <bsdf type="diffuse" id="floor">
        <rgb name="reflectance" value="0.35 0.45 0.5"/>
      </bsdf>"""
    a, s1 = _render(blend)
    b, s2 = _render(flat)
    assert int(np.asarray(s1.materials.kind).max()) == M.BLEND
    assert np.isfinite(a).all()
    # same estimator in expectation; same RNG stream, sampling differs ->
    # compare means tightly and pixels loosely
    assert abs(a.mean() - b.mean()) / b.mean() < 0.02, (a.mean(), b.mean())


def test_mixture_three_children_loads_and_renders():
    mix = """
      <bsdf type="mixturebsdf" id="floor">
        <string name="weights" value="0.5 0.3 0.2"/>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.7 0.1 0.1"/></bsdf>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.1 0.7 0.1"/></bsdf>
        <bsdf type="roughconductor"><float name="alpha" value="0.2"/></bsdf>
      </bsdf>"""
    img, scene = _render(mix, spp=8)
    assert np.isfinite(img).all()
    assert img.mean() > 1e-3
    assert (np.asarray(scene.materials.kind) == M.BLEND).sum() == 2


def test_normalmap_flat_is_identity():
    """A constant (0.5, 0.5, 1) normal map must not change the render."""
    plain = """
      <bsdf type="diffuse" id="floor">
        <rgb name="reflectance" value="0.6 0.55 0.5"/>
      </bsdf>"""
    nm = """
      <bsdf type="normalmap" id="floor">
        <texture type="checkerboard">
          <rgb name="color0" value="0.5 0.5 1.0"/>
          <rgb name="color1" value="0.5 0.5 1.0"/>
        </texture>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.6 0.55 0.5"/></bsdf>
      </bsdf>"""
    a, _ = _render(plain, spp=8)
    b, s2 = _render(nm, spp=8)
    assert s2.materials.packed.shape[1] >= 32  # perturbation compiled in
    np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-4)


def test_normalmap_tilted_changes_shading():
    nm = """
      <bsdf type="normalmap" id="floor">
        <texture type="checkerboard">
          <rgb name="color0" value="0.8 0.5 0.8"/>
          <rgb name="color1" value="0.8 0.5 0.8"/>
        </texture>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.6 0.55 0.5"/></bsdf>
      </bsdf>"""
    plain = """
      <bsdf type="diffuse" id="floor">
        <rgb name="reflectance" value="0.6 0.55 0.5"/>
      </bsdf>"""
    a, _ = _render(plain, spp=8)
    b, _ = _render(nm, spp=8)
    assert np.isfinite(b).all()
    # tilting the floor normals visibly changes its shading
    floor = np.abs(a - b).mean()
    assert floor > 1e-3, floor


def test_bumpmap_constant_height_is_identity():
    plain = """
      <bsdf type="diffuse" id="floor">
        <rgb name="reflectance" value="0.6 0.55 0.5"/>
      </bsdf>"""
    bm = """
      <bsdf type="bumpmap" id="floor">
        <texture type="checkerboard">
          <rgb name="color0" value="0.5 0.5 0.5"/>
          <rgb name="color1" value="0.5 0.5 0.5"/>
        </texture>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.6 0.55 0.5"/></bsdf>
      </bsdf>"""
    a, _ = _render(plain, spp=8)
    b, _ = _render(bm, spp=8)
    np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------------------
# coating (src/bsdfs/coating.cpp): smooth dielectric layer over a child
# ---------------------------------------------------------------------------

def _coating_params(n, inner_kind=M.DIFFUSE, layer_alpha=0.0, **inner_kw):
    mb = M.MaterialBuilder()
    rid = mb.add_row(kind=inner_kind, **inner_kw)
    cid = mb.add_row(kind=M.COATING, alpha=mb._row_roughness(rid),
                     alpha_v=layer_alpha, dist=M.DIST_GGX,
                     eta=(1.5046,) * 3, specular=(1, 1, 1),
                     transmittance=(0.0, 0.0, 0.0),
                     reflectance=mb.rows[rid]["reflectance"],
                     child0=rid, child1=rid)
    mats = mb.finalize()
    mid = jnp.full(n, cid, jnp.int32)
    p = bsdf.gather_params(mats, mid)
    pa = bsdf.gather_params(mats, p.child0)
    pb = bsdf.gather_params(mats, p.child1)
    is_c = p.kind == M.COATING
    return pa._replace(blend=pb, blend_w=jnp.zeros(n), coat=is_c,
                       coat_eta=p.eta[..., 0],
                       coat_sigma=p.transmittance,
                       coat_spec=p.specular,
                       coat_alpha=jnp.where(is_c, p.alpha_v, 0.0),
                       coat_dist=p.dist)


def test_coating_chi2_sample_vs_pdf():
    from test_bsdf import chi2_sphere
    par = _coating_params(N, reflectance=(0.7, 0.7, 0.7))
    wi = jnp.asarray(np.float32([0.35, 0.1, 0.93]))
    wi = wi / jnp.linalg.norm(wi)
    u2 = rng.uniform_2d(21, jnp.arange(N), 0, 0)
    uc = rng.uniform_float(21, jnp.arange(N), 0, 2)
    bs = bsdf.sample(par, jnp.broadcast_to(wi, (N, 3)), u2, uc)
    # the delta layer-reflection lobe is excluded (like every delta);
    # chi2_sphere compares valid-count vs pdf integral, so mask the
    # delta lanes out of `valid` (the pdf covers only smooth lobes)
    bs = bs._replace(valid=bs.valid & ~bs.is_delta)
    chi2_sphere(jax.tree.map(lambda a: a[:1], par), wi, bs)


def test_coating_weight_matches_eval_over_pdf():
    par = _coating_params(N, reflectance=(0.6, 0.5, 0.4))
    wi = jnp.asarray(np.float32([0.2, -0.3, 0.93]))
    wi = wi / jnp.linalg.norm(wi)
    u2 = rng.uniform_2d(9, jnp.arange(N), 0, 0)
    uc = rng.uniform_float(9, jnp.arange(N), 0, 2)
    bs = bsdf.sample(par, jnp.broadcast_to(wi, (N, 3)), u2, uc)
    sel = np.asarray(bs.valid & ~bs.is_delta & (bs.pdf > 1e-5))
    # inner cosine samples outside the layer's escape cone are TIR-killed
    # (coating.cpp semantics): survival = sin^2(theta_c) ~ 1/eta^2 ~ 0.44
    assert sel.mean() > 0.35
    f = np.asarray(bsdf.eval(par, jnp.broadcast_to(wi, (N, 3)), bs.wo))
    expect = f[sel] / np.asarray(bs.pdf)[sel][:, None]
    got = np.asarray(bs.weight)[sel]
    np.testing.assert_allclose(got, expect, rtol=2e-3, atol=2e-5)


def test_coating_energy_conservation():
    """Coated white diffuse must not create energy: sum of sampled
    weights (incl. the delta lobe) stays <= 1 in expectation."""
    par = _coating_params(N, reflectance=(1.0, 1.0, 1.0))
    wi = jnp.asarray(np.float32([0.3, 0.0, 0.954]))
    wi = wi / jnp.linalg.norm(wi)
    u2 = rng.uniform_2d(4, jnp.arange(N), 0, 0)
    uc = rng.uniform_float(4, jnp.arange(N), 0, 2)
    bs = bsdf.sample(par, jnp.broadcast_to(wi, (N, 3)), u2, uc)
    w = np.asarray(jnp.where(bs.valid[..., None], bs.weight, 0.0))
    assert w.mean() <= 1.02, w.mean()
    # coating.cpp's model loses the TIR-trapped fraction (no internal
    # multiple scattering): E[w] ~ Fi + (1-Fi) * sin^2(theta_c) * E[1-Fo]
    # ~ 0.43 for eta=1.5 over white diffuse.  >0.35 guards against
    # accidental double-counting of the transmission terms.
    assert w.mean() > 0.35


def test_roughcoating_chi2_sample_vs_pdf():
    """roughcoating (src/bsdfs/roughcoating.cpp): the layer's reflection
    is a microfacet lobe with a real pdf — chi^2 over ALL valid samples
    (no delta exclusion needed)."""
    from test_bsdf import chi2_sphere
    par = _coating_params(N, reflectance=(0.7, 0.7, 0.7),
                          layer_alpha=0.25)
    wi = jnp.asarray(np.float32([0.35, 0.1, 0.93]))
    wi = wi / jnp.linalg.norm(wi)
    u2 = rng.uniform_2d(31, jnp.arange(N), 0, 0)
    uc = rng.uniform_float(31, jnp.arange(N), 0, 2)
    bs = bsdf.sample(par, jnp.broadcast_to(wi, (N, 3)), u2, uc)
    assert not np.asarray(bs.is_delta).any()
    chi2_sphere(jax.tree.map(lambda a: a[:1], par), wi, bs)


def test_roughcoating_weight_matches_eval_over_pdf():
    par = _coating_params(N, reflectance=(0.6, 0.5, 0.4),
                          layer_alpha=0.15)
    wi = jnp.asarray(np.float32([0.2, -0.3, 0.93]))
    wi = wi / jnp.linalg.norm(wi)
    u2 = rng.uniform_2d(19, jnp.arange(N), 0, 0)
    uc = rng.uniform_float(19, jnp.arange(N), 0, 2)
    bs = bsdf.sample(par, jnp.broadcast_to(wi, (N, 3)), u2, uc)
    sel = np.asarray(bs.valid & (bs.pdf > 1e-5))
    assert sel.mean() > 0.35
    f = np.asarray(bsdf.eval(par, jnp.broadcast_to(wi, (N, 3)), bs.wo))
    expect = f[sel] / np.asarray(bs.pdf)[sel][:, None]
    got = np.asarray(bs.weight)[sel]
    np.testing.assert_allclose(got, expect, rtol=2e-3, atol=2e-5)


def test_roughcoating_energy_conservation():
    par = _coating_params(N, reflectance=(1.0, 1.0, 1.0),
                          layer_alpha=0.3)
    wi = jnp.asarray(np.float32([0.3, 0.0, 0.954]))
    wi = wi / jnp.linalg.norm(wi)
    u2 = rng.uniform_2d(14, jnp.arange(N), 0, 0)
    uc = rng.uniform_float(14, jnp.arange(N), 0, 2)
    bs = bsdf.sample(par, jnp.broadcast_to(wi, (N, 3)), u2, uc)
    w = np.asarray(jnp.where(bs.valid[..., None], bs.weight, 0.0))
    # one-sample-MIS weights of a rough lobe can exceed 1 per sample;
    # the MEAN must not (plus slack for MC noise at N=65536)
    assert w.mean() <= 1.02, w.mean()
    assert w.mean() > 0.3


def test_roughcoating_scene_end_to_end():
    coat = """
      <bsdf type="roughcoating" id="floor">
        <float name="intIOR" value="1.5"/>
        <float name="alpha" value="0.2"/>
        <string name="distribution" value="ggx"/>
        <rgb name="sigmaA" value="0.05 0.1 0.05"/>
        <float name="thickness" value="1"/>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.5 0.2 0.1"/></bsdf>
      </bsdf>"""
    img, scene = _render(coat, spp=8)
    kinds = np.asarray(scene.materials.kind)
    packed = np.asarray(scene.materials.packed)
    rows = kinds == M.COATING
    assert rows.any() and (packed[rows, 21] > 0.1).any()  # rough layer
    assert np.isfinite(img).all()
    assert img.mean() > 1e-3


def test_coating_scene_end_to_end():
    coat = """
      <bsdf type="coating" id="floor">
        <float name="intIOR" value="1.5"/>
        <rgb name="sigmaA" value="0.05 0.1 0.05"/>
        <float name="thickness" value="1"/>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.5 0.2 0.1"/></bsdf>
      </bsdf>"""
    img, scene = _render(coat, spp=8)
    assert (np.asarray(scene.materials.kind) == M.COATING).any()
    assert np.isfinite(img).all()
    assert img.mean() > 1e-3
