"""Microflake phase function (reference: src/phase/microflake.cpp),
realized as closed-form SGGX fiber flakes (ops/medium.py _sggx_*).

Checks: sphere normalization of the phase, pdf == eval for samples,
fiber-plane concentration, and the scattering furnace (a microflake
medium inside a constant-radiance environment must preserve the field —
this exercises normalization + exact visible-normal sampling together).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from gradientdomain_mitsuba_tpu.ops import medium as med_ops
from gradientdomain_mitsuba_tpu.scene import media as media_mod

N = 200_000


def _flake(axis, sigma, n=N):
    a = np.asarray(axis, np.float32)
    a /= np.linalg.norm(a)
    return jnp.broadcast_to(
        jnp.asarray([a[0], a[1], a[2], sigma], jnp.float32), (n, 4))


@pytest.mark.parametrize("axis,sigma,wi", [
    ((0, 0, 1), 0.1, (1, 0, 0)),
    ((0, 0, 1), 0.3, (0.5, 0.2, 0.84)),
    ((1, 1, 0), 0.8, (0, 0, 1)),
])
def test_phase_normalization(axis, sigma, wi):
    """MC over uniform sphere directions: integral of the phase over wo
    must be 1 (specular SGGX flakes are exactly normalized)."""
    rng = np.random.default_rng(3)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    wiv = np.asarray(wi, np.float32)
    wiv /= np.linalg.norm(wiv)
    kinds = jnp.full(N, media_mod.PHASE_MICROFLAKE, jnp.int32)
    p = med_ops.phase_eval(kinds, jnp.zeros(N),
                           jnp.broadcast_to(jnp.asarray(wiv), (N, 3)),
                           jnp.asarray(d), _flake(axis, sigma))
    integral = float(np.asarray(p).mean() * 4 * np.pi)
    assert abs(integral - 1.0) < 0.03, integral


def test_sample_pdf_matches_eval():
    from gradientdomain_mitsuba_tpu.core import rng as rng_mod
    wi = jnp.asarray(np.float32([0.3, -0.2, 0.93]))
    wi = wi / jnp.linalg.norm(wi)
    u2 = rng_mod.uniform_2d(11, jnp.arange(N), 0, 0)
    kinds = jnp.full(N, media_mod.PHASE_MICROFLAKE, jnp.int32)
    fl = _flake((0, 0, 1), 0.15)
    wo, pdf = med_ops.phase_sample(kinds, jnp.zeros(N),
                                   jnp.broadcast_to(wi, (N, 3)), u2, fl)
    assert np.allclose(np.asarray(jnp.linalg.norm(wo, axis=-1)), 1.0,
                       atol=1e-4)
    pdf2 = med_ops.phase_eval(kinds, jnp.zeros(N),
                              jnp.broadcast_to(wi, (N, 3)), wo, fl)
    np.testing.assert_allclose(np.asarray(pdf), np.asarray(pdf2),
                               rtol=1e-3, atol=1e-6)
    # sampled-direction distribution matches eval: compare the first two
    # moments of cos(wo, axis) against an eval-weighted uniform-sphere MC
    rng = np.random.default_rng(5)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p_ref = np.asarray(med_ops.phase_eval(
        kinds, jnp.zeros(N), jnp.broadcast_to(wi, (N, 3)),
        jnp.asarray(d), fl))
    w_ref = p_ref * 4 * np.pi
    cz_s = np.asarray(wo)[:, 2]
    cz_r = d[:, 2]
    assert abs(cz_s.mean() - (cz_r * w_ref).mean()) < 0.02
    assert abs((cz_s ** 2).mean() - (cz_r ** 2 * w_ref).mean()) < 0.02


def test_fiber_plane_concentration():
    """Thin fiber (sigma -> 0) along z, incidence perpendicular to the
    fiber: flake normals lie in the xy great circle, so scattered
    directions stay near the plane perpendicular to the fiber."""
    from gradientdomain_mitsuba_tpu.core import rng as rng_mod
    wi = jnp.asarray(np.float32([1.0, 0.0, 0.0]))
    u2 = rng_mod.uniform_2d(13, jnp.arange(N), 0, 0)
    kinds = jnp.full(N, media_mod.PHASE_MICROFLAKE, jnp.int32)
    wo, _ = med_ops.phase_sample(kinds, jnp.zeros(N),
                                 jnp.broadcast_to(wi, (N, 3)), u2,
                                 _flake((0, 0, 1), 0.05))
    mean_abs_z = float(np.abs(np.asarray(wo)[:, 2]).mean())
    assert mean_abs_z < 0.12, mean_abs_z


def test_scattering_furnace_microflake():
    """sigma_a = 0 microflake medium inside a constant-radiance
    environment: the radiance field must stay at the environment value
    (an exactly normalized, exactly sampled phase preserves isotropy)."""
    from tests.test_volpath import _HEADER, _render
    xml = _HEADER.replace("$integrator", "volpath") + """
  <shape type="cube">
    <transform name="toWorld">
      <scale value="1.2"/>
    </transform>
    <bsdf type="null"/>
    <medium name="interior" type="homogeneous">
      <rgb name="sigmaA" value="0 0 0"/>
      <rgb name="sigmaS" value="0.8 0.8 0.8"/>
      <phase type="microflake">
        <float name="stddev" value="0.2"/>
        <vector name="orientation" x="0" y="0" z="1"/>
      </phase>
    </medium>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="1 1 1"/></emitter>
</scene>"""
    img, _, _ = _render(xml, "volpath", size=16, spp=32, max_depth=16)
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean((0, 1)), 1.0, rtol=0.03)


# --- gridvolume-driven orientation fields (round 3) -----------------------

def _write_vol3(path, data, bbox=((0, 0, 0), (1, 1, 1))):
    """data [nz, ny, nx, 3] float32 -> Mitsuba .vol v3 (3 channels)."""
    import struct
    nz, ny, nx, ch = data.shape
    assert ch == 3
    with open(path, "wb") as f:
        f.write(b"VOL")
        f.write(bytes([3]))
        f.write(struct.pack("<5i", 1, nx, ny, nz, 3))
        f.write(struct.pack("<6f", *bbox[0], *bbox[1]))
        data.astype("<f4").tofile(f)


def test_flake_at_interpolates_and_normalizes():
    """flake_at: trilinear vector interpolation + normalization
    (gridvolume.cpp lookupVector), constant-axis fallback outside the
    volume and for rows without an orientation grid."""
    from gradientdomain_mitsuba_tpu.scene import media as media_mod
    base = media_mod.vacuum_table()
    # one het row: orientation grid 2 voxels along x: +x then +z
    od = np.array([[[[1, 0, 0], [0, 0, 1]]]], np.float32)  # [1,1,2,3]
    tab = base._replace(
        het=np.ones(1, np.int32),
        flake=np.array([[0, 1, 0, 0.3]], np.float32),
        orient_data=od.ravel(),
        orient_offset=np.zeros(1, np.int32),
        orient_res=np.array([[2, 1, 1]], np.int32),
        orient_w2g=np.eye(4, dtype=np.float32)[None])
    mid = jnp.zeros(3, jnp.int32)
    p = jnp.array([[0.25, 0.5, 0.5],    # 3/4 +x, 1/4 +z
                   [0.0, 0.5, 0.5],     # exactly +x
                   [2.0, 0.5, 0.5]])    # outside -> constant axis
    fl = med_ops.flake_at(tab, mid, p)
    v = np.array([0.75, 0.0, 0.25])
    np.testing.assert_allclose(fl[0, :3], v / np.linalg.norm(v), atol=1e-6)
    np.testing.assert_allclose(fl[1, :3], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(fl[2, :3], [0, 1, 0], atol=1e-6)  # fallback
    np.testing.assert_allclose(fl[:, 3], 0.3, atol=1e-6)
    # rows without a grid: constant axis everywhere
    fl0 = med_ops.flake_at(base._replace(
        flake=np.array([[0, 0, 1, 0.5]], np.float32)), mid, p)
    np.testing.assert_allclose(fl0[:, :3], [[0, 0, 1]] * 3, atol=1e-6)


def test_orientation_grid_constant_matches_vector(tmp_path):
    """A constant orientation GRID must render identically to the same
    axis given as the phase's constant orientation vector (the grid path
    interpolates the same axis everywhere)."""
    from gradientdomain_mitsuba_tpu.scene import scene as sc
    from gradientdomain_mitsuba_tpu.models.volpath import VolPathTracer
    from tests.test_hetmedia import write_vol

    dens = np.full((2, 2, 2), 0.8, np.float32)
    dvol = str(tmp_path / "d.vol")
    write_vol(dvol, dens, bbox=((-1, -1, -1), (1, 1, 1)))
    ovol = str(tmp_path / "o.vol")
    axis = np.array([0.6, 0.0, 0.8], np.float32)
    _write_vol3(ovol, np.broadcast_to(axis, (2, 2, 2, 3)).copy(),
                bbox=((-1, -1, -1), (1, 1, 1)))

    def xml(orient_elem):
        return f"""<scene version="0.5.0">
  <integrator type="volpath"><integer name="maxDepth" value="4"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="toWorld">
      <lookat origin="0 0 5" target="0 0 0" up="0 1 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="4"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="12"/><integer name="height" value="12"/>
      <rfilter type="box"/>
    </film>
  </sensor>
  <shape type="cube">
    <bsdf type="null"/>
    <medium type="heterogeneous" name="interior">
      <volume name="density" type="gridvolume">
        <string name="filename" value="{dvol}"/>
      </volume>
      {orient_elem}
      <phase type="microflake"><float name="stddev" value="0.3"/></phase>
      <float name="scale" value="1.5"/>
    </medium>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld">
      <scale x="2" y="2" z="1"/><translate x="0" y="0" z="-3"/>
    </transform>
    <emitter type="area"><rgb name="radiance" value="4, 4, 4"/></emitter>
  </shape>
</scene>"""

    grid_elem = (f'<volume name="orientation" type="gridvolume">'
                 f'<string name="filename" value="{ovol}"/></volume>')
    vec_elem = ('<volume name="orientation" type="constvolume">'
                '<vector name="value" x="0.6" y="0.0" z="0.8"/></volume>')
    imgs = {}
    for name, elem in (("grid", grid_elem), ("vec", vec_elem)):
        p = tmp_path / f"{name}.xml"
        p.write_text(xml(elem))
        scene, st = sc.load_scene(str(p), {})
        tr = VolPathTracer(scene, st)
        assert tr.has_orient == (name == "grid")
        imgs[name] = np.asarray(tr.render(scene, seed=0, spp=4))
        assert np.isfinite(imgs[name]).all()
    np.testing.assert_allclose(imgs["grid"], imgs["vec"],
                               rtol=2e-5, atol=2e-6)


def test_flake_orientation_rotated_toworld(tmp_path):
    """A rotated medium toWorld must rotate gridvolume fiber axes into
    world space (gridvolume.cpp lookupVector applies the volumeToWorld
    linear part before normalization) — the identity-transform
    tests could not catch a missing rotation."""
    from gradientdomain_mitsuba_tpu.scene import scene as sc
    from tests.test_hetmedia import write_vol

    dens = np.full((2, 2, 2), 0.8, np.float32)
    dvol = str(tmp_path / "d.vol")
    write_vol(dvol, dens, bbox=((-1, -1, -1), (1, 1, 1)))
    ovol = str(tmp_path / "o.vol")
    # constant +x fiber axis in the volume's LOCAL space
    _write_vol3(ovol, np.broadcast_to(
        np.array([1, 0, 0], np.float32), (2, 2, 2, 3)).copy(),
        bbox=((-1, -1, -1), (1, 1, 1)))

    xml = f"""<scene version="0.5.0">
  <integrator type="volpath"/>
  <sensor type="perspective">
    <sampler type="independent"><integer name="sampleCount" value="1"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="4"/><integer name="height" value="4"/>
    </film>
  </sensor>
  <shape type="cube">
    <bsdf type="null"/>
    <medium type="heterogeneous" name="interior">
      <transform name="toWorld"><rotate z="1" angle="90"/></transform>
      <volume name="density" type="gridvolume">
        <string name="filename" value="{dvol}"/>
      </volume>
      <volume name="orientation" type="gridvolume">
        <string name="filename" value="{ovol}"/>
      </volume>
      <phase type="microflake"><float name="stddev" value="0.3"/></phase>
    </medium>
  </shape>
</scene>"""
    p = tmp_path / "rot.xml"
    p.write_text(xml)
    scene, st = sc.load_scene(str(p), {})
    mid = jnp.zeros(1, jnp.int32)
    # the rotated medium still covers the origin; local +x -> world +y
    fl = med_ops.flake_at(scene.media, mid, jnp.zeros((1, 3)))
    np.testing.assert_allclose(np.asarray(fl[0, :3]), [0, 1, 0], atol=1e-5)
