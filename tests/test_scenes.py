"""Material/emitter breadth scenes (BASELINE configs #2/#4 class):
textured + glossy + dielectric cbox variant, envmap + thinlens DoF."""
import os

import numpy as np
import pytest

from gradientdomain_mitsuba_tpu.models import gpt as gpt_mod
from gradientdomain_mitsuba_tpu.models import path as path_mod
from gradientdomain_mitsuba_tpu.scene import scene as sc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATS = os.path.join(ROOT, "data/scenes/cbox-mats/cbox-mats.xml")
ENV = os.path.join(ROOT, "data/scenes/envmap/envmap.xml")


def test_mats_scene_renders():
    scene, st = sc.load_scene(
        MATS, {"width": "24", "height": "24", "spp": "2", "maxDepth": "4",
               "integrator": "path"})
    assert st.has_textures
    img = path_mod.PathTracer(scene, st).render(scene, seed=0, spp=2)
    assert np.isfinite(img).all()
    assert img.max() > 1.0  # light visible


def test_envmap_scene_renders():
    scene, st = sc.load_scene(
        ENV, {"width": "24", "height": "18", "spp": "2", "maxDepth": "3",
              "integrator": "path"})
    assert st.env_kind == 2  # envmap
    assert abs(float(scene.camera.aperture_radius) - 0.1) < 1e-6
    img = path_mod.PathTracer(scene, st).render(scene, seed=0, spp=2)
    assert np.isfinite(img).all()
    # sky visible above the horizon
    assert img[:4].mean() > 0.05


def test_gpt_parity_on_glossy_textured_scene():
    """gpt primal+very_direct == path EXACTLY also with textures,
    dielectric and rough-conductor materials (covers the half-vector
    shift machinery's base-path bookkeeping)."""
    scene, st = sc.load_scene(
        MATS, {"width": "24", "height": "24", "spp": "2", "maxDepth": "4"})
    g = gpt_mod.GPTracer(scene, st)
    out = g.render(scene, seed=2, spp=2, chunk=2)
    for k, v in out.items():
        assert np.isfinite(v).all(), k
    img = path_mod.PathTracer(scene, st).render(scene, seed=2, spp=2)
    comb = out["primal"] + out["very_direct"]
    np.testing.assert_allclose(comb, img, rtol=3e-4, atol=3e-5)


def test_gpt_runs_on_envmap_dof():
    scene, st = sc.load_scene(
        ENV, {"width": "20", "height": "16", "spp": "2", "maxDepth": "3"})
    g = gpt_mod.GPTracer(scene, st)
    out = g.render(scene, seed=0, spp=2, chunk=2)
    for k, v in out.items():
        assert np.isfinite(v).all(), k
    assert out["very_direct"].max() > 0.01  # env visible at depth 1


def test_field_integrator_aovs():
    """field integrator (src/integrators/misc/field.cpp analog): depth,
    normal, albedo AOVs are consistent with the camera-visible cbox."""
    import os
    import numpy as np
    from gradientdomain_mitsuba_tpu.models.direct import FieldIntegrator
    from gradientdomain_mitsuba_tpu.scene import scene as sc
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "data/scenes/cbox/cbox.xml")
    for field, check in (
            ("distance", lambda a: ((a > 100).mean() > 0.9) and (a < 2000).all()),
            ("shNormal", lambda a: (np.abs(np.linalg.norm(
                a.reshape(-1, 3), axis=1) - 1.0) < 1e-3).mean() > 0.9),
            ("albedo", lambda a: (a >= 0).all() and (a <= 1).all()),
            ("shapeIndex", lambda a: (a >= 1).mean() > 0.9)):
        scene, st = sc.load_scene(path, {
            "width": "16", "height": "16", "spp": "1", "maxDepth": "2"})
        st.integrator_props = {"field": field}
        f = FieldIntegrator(scene, st)
        img = np.asarray(f.render(scene, seed=0, spp=1, chunk=1))
        assert np.isfinite(img).all(), field
        assert check(img), (field, img.min(), img.max())


def test_orthographic_sensor():
    """Orthographic rays are parallel and the film extent comes from the
    toWorld scale (src/sensors/orthographic.cpp)."""
    import numpy as np
    import tempfile, os
    import jax.numpy as jnp
    from gradientdomain_mitsuba_tpu.scene import scene as sc
    from gradientdomain_mitsuba_tpu.ops import sensor as sensor_ops
    xml = """<scene version="0.5.0">
      <integrator type="path"/>
      <sensor type="orthographic">
        <transform name="toWorld">
          <scale x="2" y="2" z="1"/>
          <lookat origin="0,0,-5" target="0,0,0" up="0,1,0"/>
        </transform>
        <film type="hdrfilm">
          <integer name="width" value="8"/><integer name="height" value="8"/>
        </film>
      </sensor>
      <shape type="rectangle"><bsdf type="diffuse"/></shape>
    </scene>"""
    d = tempfile.mkdtemp()
    path = os.path.join(d, "ortho.xml")
    open(path, "w").write(xml)
    scene, st = sc.load_scene(path)
    pos = jnp.asarray(np.array([[0.0, 0.0], [7.0, 7.0], [4.0, 4.0]],
                               np.float32))
    o, dd = sensor_ops.sample_ray(scene.camera, 8, 8, pos,
                                  jnp.zeros((3, 2)))
    dd = np.asarray(dd)
    # all directions identical (parallel), pointing toward the target
    np.testing.assert_allclose(dd[0], dd[1], atol=1e-6)
    np.testing.assert_allclose(dd[0], [0, 0, 1], atol=1e-5)
    o = np.asarray(o)
    # origins spread across the scaled film plane, distinct per pixel
    assert np.linalg.norm(o[0] - o[1]) > 1.0


# ---------------------------------------------------------------------------
# Round-2 stress scenes: door / caustics / forest
# ---------------------------------------------------------------------------

DOOR = os.path.join(ROOT, "data/scenes/door/door.xml")
CAUSTICS = os.path.join(ROOT, "data/scenes/caustics/caustics.xml")


def test_door_scene_gpt_renders_lit_through_doorway():
    """Veach-door class: the camera room is lit ONLY through the doorway;
    the render must be finite and meaningfully nonzero (light made it
    through), with specular materials present (glossy door + thin glass)."""
    scene, st = sc.load_scene(DOOR, {
        "width": "32", "height": "32", "spp": "4", "maxDepth": "6"})
    g = gpt_mod.GPTracer(scene, st)
    assert g.any_specular  # door metal + glass classify as specular/glossy
    out = g.render(scene, seed=0, spp=4, chunk=4)
    for k, v in out.items():
        assert np.isfinite(v).all(), k
    mean = float(np.asarray(out["primal"]).mean())
    assert mean > 1e-3, mean  # indirect light reached the camera room
    assert float(np.abs(np.asarray(out["dx"])).mean()) > 1e-6


def test_caustics_scene_gbdpt_light_image_dominant():
    """Caustic class: glass sphere + small bright emitter.  The t=1 light
    image must carry real energy (light-tracing finds the caustics) and
    all buffers stay finite."""
    from gradientdomain_mitsuba_tpu.models.gbdpt import GBDPTracer
    scene, st = sc.load_scene(CAUSTICS, {
        "width": "32", "height": "32", "spp": "4", "maxDepth": "6"})
    g = GBDPTracer(scene, st)
    state = g.render_chunk(scene, 0, 0, 4)
    li = np.asarray(state["light_img"])
    assert np.isfinite(li).all()
    assert float(li.sum()) > 0.0  # light tracing deposited energy
    out = g.finalize({k: np.asarray(v) for k, v in state.items()}, 4)
    for k, v in out.items():
        assert np.isfinite(v).all(), k
    assert float(np.asarray(out["primal"]).mean()) > 1e-3
