"""BDPT environment + delta-light family validation.

The embedded env/delta NEE family (models/bdpt.py _random_walk
collect_aux) must agree in expectation with the path tracer, which
samples the same scenes through its own NEE+MIS machinery — a
statistical identity E[bdpt] == E[path] over every light type.
"""
import os
import textwrap

import numpy as np
import pytest

from gradientdomain_mitsuba_tpu.models import bdpt as bdpt_mod
from gradientdomain_mitsuba_tpu.models import path as path_mod
from gradientdomain_mitsuba_tpu.scene import scene as sc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(ROOT, "data/scenes/cbox/meshes")

OPEN_BOX_XML = textwrap.dedent("""\
    <scene version="0.5.0">
      <integrator type="bdpt"><integer name="maxDepth" value="4"/></integrator>
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
      <bsdf type="diffuse" id="white"><rgb name="reflectance" value="0.725, 0.71, 0.68"/></bsdf>
      <shape type="obj"><string name="filename" value="{mesh}/cbox_floor.obj"/><ref id="white"/></shape>
      <shape type="obj"><string name="filename" value="{mesh}/cbox_greenwall.obj"/><ref id="white"/></shape>
      <shape type="obj"><string name="filename" value="{mesh}/cbox_redwall.obj"/><ref id="white"/></shape>
      {extra}
    </scene>
""")


def _load(extra, over=None):
    import tempfile
    xml = OPEN_BOX_XML.format(mesh=MESH, extra=extra)
    with tempfile.NamedTemporaryFile("w", suffix=".xml", dir=MESH + "/..",
                                     delete=False) as f:
        f.write(xml)
        p = f.name
    try:
        return sc.load_scene(p, None, over)
    finally:
        os.unlink(p)


def _compare(scene, st, spp_b, spp_p, tol):
    b = bdpt_mod.BDPTracer(scene, st).render(scene, seed=3, spp=spp_b)
    p = path_mod.PathTracer(scene, st).render(scene, seed=11, spp=spp_p)
    b, p = np.asarray(b), np.asarray(p)
    assert np.isfinite(b).all() and np.isfinite(p).all()
    denom = max(float(p.mean()), 1e-9)
    rel = abs(float(b.mean()) - float(p.mean())) / denom
    assert rel < tol, (b.mean(), p.mean(), rel)
    # per-pixel agreement beyond the mean (loose: MC noise at small spp)
    m = p.sum(-1) > 1e-4
    rr = np.abs(b[m] - p[m]) / (p[m] + 0.05 * denom)
    assert np.median(rr) < 3 * tol, np.median(rr)


def test_bdpt_constant_env_open_box():
    scene, st = _load('<emitter type="constant">'
                      '<rgb name="radiance" value="0.6, 0.7, 0.9"/>'
                      '</emitter>')
    assert st.env_kind != 0
    _compare(scene, st, 96, 96, 0.02)


def test_bdpt_env_plus_area_light():
    extra = ('<emitter type="constant">'
             '<rgb name="radiance" value="0.3, 0.35, 0.45"/></emitter>'
             '<shape type="obj">'
             f'<string name="filename" value="{MESH}/cbox_luminaire.obj"/>'
             '<ref id="white"/>'
             '<emitter type="area">'
             '<rgb name="radiance" value="17, 12, 4"/></emitter></shape>')
    scene, st = _load(extra)
    assert st.env_kind != 0
    tr = bdpt_mod.BDPTracer(scene, st)
    assert tr.n_area == 1 and tr.aux_nee
    _compare(scene, st, 128, 128, 0.03)


def test_bdpt_point_light():
    # direct-only: the per-pixel residual is pure pixel-jitter noise at
    # geometry silhouettes, so expectations match tightly
    scene, st = _load('<emitter type="point">'
                      '<point name="position" x="278" y="400" z="250"/>'
                      '<rgb name="intensity" value="3e5, 3e5, 3e5"/>'
                      '</emitter>', {"max_depth": 2})
    assert st.n_delta == 1 and st.max_depth == 2
    _compare(scene, st, 64, 64, 0.01)


def test_bdpt_envmap_scene_matches_path():
    """Lat-long envmap importance sampling through the BDPT aux family."""
    scene, st = sc.load_scene(
        os.path.join(ROOT, "data/scenes/envmap/envmap.xml"),
        {"width": "24", "height": "24", "spp": "8", "maxDepth": "3"})
    _compare(scene, st, 64, 64, 0.03)


def test_gbdpt_env_buffers_finite_and_reconstruct():
    """G-BDPT on an open scene with env + area light: env family routes to
    very_direct, all buffers finite (regression: degenerate offset views
    made w_pair NaN via 0*inf), reconstruction sane."""
    from gradientdomain_mitsuba_tpu.models import poisson
    from gradientdomain_mitsuba_tpu.models.gbdpt import GBDPTracer
    extra = ('<emitter type="constant">'
             '<rgb name="radiance" value="0.6, 0.7, 0.9"/></emitter>'
             '<shape type="obj">'
             f'<string name="filename" value="{MESH}/cbox_luminaire.obj"/>'
             '<ref id="white"/>'
             '<emitter type="area">'
             '<rgb name="radiance" value="17, 12, 4"/></emitter></shape>')
    scene, st = _load(extra)
    out = GBDPTracer(scene, st).render(scene, seed=0, spp=16)
    for k, v in out.items():
        assert np.isfinite(v).all(), k
    assert float(np.asarray(out["very_direct"]).mean()) > 0.1  # env there
    fin = np.asarray(poisson.reconstruct(out, alpha=0.2, mode="L1"))
    assert np.isfinite(fin).all()
    # reconstruction stays close to the (unbiased) primal+very mean
    primal = out["primal"] + out["very_direct"]
    assert abs(fin.mean() - primal.mean()) / primal.mean() < 0.1


def test_gbdpt_env_family_differentiated():
    """Round-2: the env/delta family no longer
    bypasses gradient estimation.  On an env-lit open box:
      - env-lit content lands in PRIMAL (only depth-1 env stays in
        very_direct),
      - dx is nonzero and consistent with the finite difference of a
        high-spp primal,
      - gbdpt primal+very still matches bdpt in expectation."""
    from gradientdomain_mitsuba_tpu.models.gbdpt import GBDPTracer
    # occluder box: env-shadow boundaries give the gradients real signal
    extra = ('<emitter type="constant">'
             '<rgb name="radiance" value="0.8, 0.8, 0.8"/></emitter>'
             f'<shape type="obj"><string name="filename" '
             f'value="{MESH}/cbox_smallbox.obj"/>'
             '<ref id="white"/></shape>')
    scene, st = _load(extra, over={"max_depth": 2})
    g = GBDPTracer(scene, st)
    out = g.render(scene, seed=0, spp=64, chunk=8)
    for k, v in out.items():
        assert np.isfinite(v).all(), k
    # surface bounce content (floor/walls lit by the env) is in primal
    assert float(np.asarray(out["primal"]).mean()) > 0.05
    # gradients exist for the env family
    assert float(np.abs(np.asarray(out["dx"])).mean()) > 1e-4

    # consistency with finite differences: regression slope + correlation
    # + magnitude.  Bounds are calibrated for the errors-in-variables
    # attenuation of regressing one MC estimate on another (measured
    # slope 0.45@32/128spp -> 0.77@128/768spp -> 1 in the limit);
    # zeroed (slope~0, corr~0), doubled (rms ratio ~2) or sign-flipped
    # (corr<0) gradient families all fail.
    ref = g.render(scene, seed=777, spp=256, chunk=8)
    fd_x = (ref["primal"][:, 1:] - ref["primal"][:, :-1]).sum(-1)
    dx = out["dx"][:, :-1].sum(-1)
    vd = out["very_direct"].sum(-1)
    mx = (vd[:, 1:] + vd[:, :-1]) == 0  # interior pixels only
    assert mx.sum() >= 32
    a = dx[mx].ravel()
    b_ = fd_x[mx].ravel()
    slope = float((a * b_).sum() / max((b_ * b_).sum(), 1e-12))
    corr = float(np.corrcoef(a, b_)[0, 1])
    rms_ratio = float(np.sqrt((a * a).mean() / max((b_ * b_).mean(),
                                                   1e-12)))
    assert 0.3 < slope < 1.7, slope
    assert corr > 0.45, corr
    assert 0.5 < rms_ratio < 1.7, rms_ratio

    b = bdpt_mod.BDPTracer(scene, st).render(scene, seed=5, spp=32)
    comb = np.asarray(out["primal"]) + np.asarray(out["very_direct"])
    rel = abs(comb.mean() - np.asarray(b).mean()) / np.asarray(b).mean()
    assert rel < 0.05, rel


def test_gbdpt_point_light_gradients():
    """Delta (point) lights flow through the same differentiated aux
    family."""
    from gradientdomain_mitsuba_tpu.models.gbdpt import GBDPTracer
    extra = ('<emitter type="point">'
             '<point name="position" x="278" y="400" z="279.5"/>'
             '<rgb name="intensity" value="600000, 600000, 600000"/>'
             '</emitter>')
    scene, st = _load(extra)
    g = GBDPTracer(scene, st)
    out = g.render(scene, seed=0, spp=16, chunk=8)
    for k, v in out.items():
        assert np.isfinite(v).all(), k
    assert float(np.asarray(out["primal"]).mean()) > 0.01
    assert float(np.abs(np.asarray(out["dx"])).mean()) > 1e-5
