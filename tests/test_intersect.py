"""BVH traversal vs brute-force ground truth (reference analog:
test_kdtree.cpp — kd-tree vs linear scan)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gradientdomain_mitsuba_tpu.ops import intersect as isec
from gradientdomain_mitsuba_tpu.scene import bvh as bvh_mod
from gradientdomain_mitsuba_tpu.scene import scene as sc
from gradientdomain_mitsuba_tpu.ops.intersect import BVHArrays, TriSoup


def _random_soup(n_tris, seed=0, spread=10.0):
    rs = np.random.RandomState(seed)
    base = rs.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    v0 = base
    v1 = base + rs.normal(0, 1.0, (n_tris, 3)).astype(np.float32)
    v2 = base + rs.normal(0, 1.0, (n_tris, 3)).astype(np.float32)
    return v0, v1, v2


def _build(v0, v1, v2):
    tree = bvh_mod.build(v0, v1, v2)
    o = tree.prim_order
    tris = TriSoup(v0=jnp.asarray(v0[o]), e1=jnp.asarray((v1 - v0)[o]),
                   e2=jnp.asarray((v2 - v0)[o]),
                   orig_id=jnp.asarray(o, jnp.int32))
    arr = BVHArrays(
        child0_min=jnp.asarray(tree.child0_min),
        child0_max=jnp.asarray(tree.child0_max),
        child1_min=jnp.asarray(tree.child1_min),
        child1_max=jnp.asarray(tree.child1_max),
        child0=jnp.asarray(tree.child0), child1=jnp.asarray(tree.child1))
    return tris, arr, tree


def _random_rays(n, seed=1, spread=12.0):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("n_tris", [7, 200, 3000])
def test_bvh_matches_brute(n_tris):
    v0, v1, v2 = _random_soup(n_tris)
    tris, arr, tree = _build(v0, v1, v2)
    o, d = _random_rays(512)
    mint = jnp.zeros(512)
    maxt = jnp.full(512, 1e30)

    brute = isec.intersect_brute(o, d, mint, maxt, tris)
    f = jax.jit(isec.make_bvh_intersector(2 * tree.depth + 4))
    hit = f(o, d, mint, maxt, tris, arr)

    np.testing.assert_array_equal(np.asarray(hit.valid), np.asarray(brute.valid))
    m = np.asarray(brute.valid)
    np.testing.assert_allclose(
        np.asarray(hit.t)[m], np.asarray(brute.t)[m], rtol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(hit.prim)[m], np.asarray(brute.prim)[m])


def test_bvh_occluder_matches():
    v0, v1, v2 = _random_soup(500, seed=3)
    tris, arr, tree = _build(v0, v1, v2)
    o, d = _random_rays(512, seed=4)
    mint = jnp.zeros(512)
    maxt = jnp.full(512, 8.0)  # finite shadow-ray length
    brute = isec.occluded_brute(o, d, mint, maxt, tris)
    f = jax.jit(isec.make_bvh_occluder(2 * tree.depth + 4))
    occ = f(o, d, mint, maxt, tris, arr)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(brute))


def test_maxt_respected():
    v0 = np.array([[0, -1, -1]], np.float32)
    v1 = np.array([[0, 3, -1]], np.float32)
    v2 = np.array([[0, -1, 3]], np.float32)
    tris, arr, tree = _build(v0, v1, v2)
    o = jnp.array([[-2.0, 0, 0], [-2.0, 0, 0]])
    d = jnp.array([[1.0, 0, 0], [1.0, 0, 0]])
    f = isec.make_bvh_intersector(8)
    hit = f(o, d, jnp.zeros(2), jnp.array([1.0, 5.0]), tris, arr)
    assert not bool(hit.valid[0])  # tri at t=2 beyond maxt=1
    assert bool(hit.valid[1]) and abs(float(hit.t[1]) - 2.0) < 1e-5


def test_native_builder_matches_brute():
    """The C++ binned-SAH builder (native/bvh_builder.cpp) must produce a
    BVH whose traversal results equal brute force, like the numpy one."""
    v0, v1, v2 = _random_soup(3000, seed=11)
    tree = bvh_mod.build(v0, v1, v2, use_native=True)
    o = tree.prim_order
    tris = TriSoup(v0=jnp.asarray(v0[o]), e1=jnp.asarray((v1 - v0)[o]),
                   e2=jnp.asarray((v2 - v0)[o]),
                   orig_id=jnp.asarray(o, jnp.int32))
    arr = BVHArrays(
        child0_min=jnp.asarray(tree.child0_min),
        child0_max=jnp.asarray(tree.child0_max),
        child1_min=jnp.asarray(tree.child1_min),
        child1_max=jnp.asarray(tree.child1_max),
        child0=jnp.asarray(tree.child0), child1=jnp.asarray(tree.child1))
    o_r, d_r = _random_rays(512, seed=12)
    mint = jnp.zeros(512)
    maxt = jnp.full(512, 1e30)
    brute = isec.intersect_brute(o_r, d_r, mint, maxt, tris)
    f = jax.jit(isec.make_bvh_intersector(2 * tree.depth + 4))
    hit = f(o_r, d_r, mint, maxt, tris, arr)
    np.testing.assert_array_equal(np.asarray(hit.valid),
                                  np.asarray(brute.valid))
    m = np.asarray(brute.valid)
    np.testing.assert_allclose(np.asarray(hit.t)[m],
                               np.asarray(brute.t)[m], rtol=1e-5)


# ---------------------------------------------------------------------------
# Linear-MT matmul traversal (ops/intersect.py intersect_matmul)
# ---------------------------------------------------------------------------

class TestMatmulTraversal:
    def _setup(self, n_tris=97, n_rays=512):
        v0, v1, v2 = _random_soup(n_tris, seed=3)
        tris = TriSoup(v0=jnp.asarray(v0), e1=jnp.asarray(v1 - v0),
                       e2=jnp.asarray(v2 - v0),
                       orig_id=jnp.arange(n_tris, dtype=jnp.int32))
        linC = jnp.asarray(isec.build_linear_mt(v0, v1 - v0, v2 - v0))
        o, d = _random_rays(n_rays, seed=4)
        mint = jnp.zeros(n_rays)
        maxt = jnp.full(n_rays, 3.0e38)
        return tris, linC, jnp.asarray(o), jnp.asarray(d), mint, maxt

    def test_closest_matches_brute(self):
        tris, linC, o, d, mint, maxt = self._setup()
        hb = isec.intersect_brute(o, d, mint, maxt, tris, chunk=128)
        hm = isec.intersect_matmul(o, d, mint, maxt, linC)
        vb = np.asarray(hb.valid)
        vm = np.asarray(hm.valid)
        # the linear decomposition reassociates the MT arithmetic, so
        # hits exactly on a triangle edge may flip; require near-total
        # agreement rather than bit equality
        assert (vb == vm).mean() > 0.998
        m = vb & vm
        agree = np.asarray(hb.prim)[m] == np.asarray(hm.prim)[m]
        assert agree.mean() > 0.998
        ma = m.copy()
        ma[m] &= agree
        np.testing.assert_allclose(np.asarray(hm.t)[ma],
                                   np.asarray(hb.t)[ma], rtol=2e-5)
        np.testing.assert_allclose(np.asarray(hm.u)[ma],
                                   np.asarray(hb.u)[ma], atol=2e-4)
        np.testing.assert_allclose(np.asarray(hm.v)[ma],
                                   np.asarray(hb.v)[ma], atol=2e-4)

    def test_occluded_matches_brute(self):
        tris, linC, o, d, mint, _ = self._setup()
        maxt = jnp.full(o.shape[0], 8.0)
        ob = np.asarray(isec.occluded_brute(o, d, mint, maxt, tris,
                                            chunk=128))
        om = np.asarray(isec.occluded_matmul(o, d, mint, maxt, linC))
        assert (ob == om).mean() > 0.998

    def test_respects_maxt_mint(self):
        tris, linC, o, d, _, _ = self._setup(n_rays=256)
        hit_all = isec.intersect_matmul(
            o, d, jnp.zeros(256), jnp.full(256, 3.0e38), linC)
        # mint beyond the first hit must not return it again at the same t
        mint = jnp.where(hit_all.valid, hit_all.t * 1.001, 0.0)
        h2 = isec.intersect_matmul(o, d, mint, jnp.full(256, 3.0e38), linC)
        m = np.asarray(hit_all.valid) & np.asarray(h2.valid)
        assert np.all(np.asarray(h2.t)[m] > np.asarray(hit_all.t)[m])

    def test_padding_tris_never_hit(self):
        tris, linC, o, d, mint, maxt = self._setup()
        # zero-padded (degenerate) columns: det == 0 -> no hit
        pad = np.zeros((10, 4 * 32), np.float32)
        T = linC.shape[1] // 4
        blocks = [np.concatenate(
            [np.asarray(linC[:, i * T:(i + 1) * T]), pad[:, i * 32:(i + 1) * 32]],
            axis=1) for i in range(4)]
        linC_pad = jnp.asarray(np.concatenate(blocks, axis=1))
        hm = isec.intersect_matmul(o, d, mint, maxt, linC_pad)
        assert np.all(np.asarray(hm.prim) < T)


_CLUSTERED_XML = """<scene version="0.5.0">
  <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="toWorld">
      <lookat origin="0, 6, -12" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="2"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="8"/><integer name="height" value="8"/>
    </film>
  </sensor>
  <shape type="obj"><string name="filename" value="{obj}"/>
    <bsdf type="diffuse"/></shape>
</scene>
"""


def _clustered_scene(tmp_path, n=40):
    """A bumpy n x n heightfield (2 n^2 triangles, above the brute-scan
    limit) loaded through load_scene, so it carries the cluster-major
    padded layout and the BVH of a large scene."""
    rs = np.random.RandomState(4)
    xs = np.linspace(-5, 5, n + 1)
    X, Z = np.meshgrid(xs, xs)
    Y = rs.uniform(-0.6, 0.6, X.shape)
    lines = [f"v {x:.5f} {y:.5f} {z:.5f}"
             for x, y, z in zip(X.ravel(), Y.ravel(), Z.ravel())]
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j + 1
            b, c, d = a + 1, a + n + 1, a + n + 2
            lines += [f"f {a} {c} {b}", f"f {b} {c} {d}"]
    obj = tmp_path / "field.obj"
    obj.write_text("\n".join(lines) + "\n")
    xml = tmp_path / "field.xml"
    xml.write_text(_CLUSTERED_XML.format(obj=obj))
    return sc.load_scene(str(xml))


@pytest.mark.parametrize("kind", ["closest", "occluded"])
def test_soa_matches_brute_on_loaded_clustered_scene(tmp_path, kind):
    """The GPU's large-scene traversal (SoA stack, depth from the scene's
    settings) == brute force on a scene loaded through load_scene."""
    from gradientdomain_mitsuba_tpu.ops import common
    scene, st = _clustered_scene(tmp_path)
    g = scene.geom
    assert int(g.indices.shape[0]) > common.BRUTE_FORCE_MAX_TRIS
    rs = np.random.RandomState(8)
    N = 512
    o = np.float32(rs.uniform(-5, 5, (N, 3)))
    o[:, 1] = rs.uniform(1.0, 3.0, N)
    d = np.float32(rs.normal(size=(N, 3)))
    d[:, 1] = -np.abs(d[:, 1]) - 0.2
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    mint = jnp.zeros(N)
    if kind == "closest":
        maxt = jnp.full(N, 3e38)
        f = jax.jit(isec.make_bvh_intersector_soa(st.stack_depth))
        hit = f(o, d, mint, maxt, g.tris, g.bvh)
        ref = isec.intersect_brute(o, d, mint, maxt, g.tris, chunk=1024)
        np.testing.assert_array_equal(np.asarray(hit.valid),
                                      np.asarray(ref.valid))
        m = np.asarray(ref.valid)
        assert m.mean() > 0.5
        np.testing.assert_array_equal(np.asarray(hit.prim)[m],
                                      np.asarray(ref.prim)[m])
        np.testing.assert_allclose(np.asarray(hit.t)[m],
                                   np.asarray(ref.t)[m], rtol=1e-5)
    else:
        maxt = jnp.asarray(np.float32(rs.uniform(0.5, 4.0, N)))
        f = jax.jit(isec.make_bvh_occluder_soa(st.stack_depth))
        occ = np.asarray(f(o, d, mint, maxt, g.tris, g.bvh))
        ref = np.asarray(isec.occluded_brute(o, d, mint, maxt, g.tris,
                                             chunk=1024))
        np.testing.assert_array_equal(occ, ref)
        assert 0 < ref.sum() < N


@pytest.mark.slow
def test_bvh_matches_brute_at_1M_tris():
    """Large-scene agreement gate: the SAH build
    + SoA traversal must stay exact at >=1M triangles."""
    n_tris = 1_000_000
    rs = np.random.RandomState(42)
    base = rs.uniform(-60, 60, (n_tris, 3)).astype(np.float32)
    v0 = base
    v1 = base + rs.normal(0, 0.2, (n_tris, 3)).astype(np.float32)
    v2 = base + rs.normal(0, 0.2, (n_tris, 3)).astype(np.float32)
    tris, arr, tree = _build(v0, v1, v2)
    o, d = _random_rays(256, seed=9, spread=70.0)
    mint = jnp.zeros(256)
    maxt = jnp.full(256, 1e30)

    brute = isec.intersect_brute(o, d, mint, maxt, tris, chunk=4096)
    f = jax.jit(isec.make_bvh_intersector_soa(2 * tree.depth + 4))
    hit = f(o, d, mint, maxt, tris, arr)

    np.testing.assert_array_equal(np.asarray(hit.valid),
                                  np.asarray(brute.valid))
    m = np.asarray(brute.valid)
    assert m.sum() > 50  # the soup is dense; most rays must hit
    np.testing.assert_allclose(
        np.asarray(hit.t)[m], np.asarray(brute.t)[m], rtol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(hit.prim)[m], np.asarray(brute.prim)[m])


def test_bvh_matches_brute_at_262k_tris():
    """Default-gate large-model traversal proof:
    the SAH build + SoA traversal stays exact at 262k triangles without
    opting into -m slow (the 1M-tri variant above stays slow-only)."""
    n_tris = 262_144
    rs = np.random.RandomState(11)
    base = rs.uniform(-40, 40, (n_tris, 3)).astype(np.float32)
    v0 = base
    v1 = base + rs.normal(0, 0.2, (n_tris, 3)).astype(np.float32)
    v2 = base + rs.normal(0, 0.2, (n_tris, 3)).astype(np.float32)
    tris, arr, tree = _build(v0, v1, v2)
    o, d = _random_rays(256, seed=5, spread=45.0)
    mint = jnp.zeros(256)
    maxt = jnp.full(256, 1e30)

    brute = isec.intersect_brute(o, d, mint, maxt, tris, chunk=4096)
    f = jax.jit(isec.make_bvh_intersector_soa(2 * tree.depth + 4))
    hit = f(o, d, mint, maxt, tris, arr)

    np.testing.assert_array_equal(np.asarray(hit.valid),
                                  np.asarray(brute.valid))
    m = np.asarray(brute.valid)
    assert m.sum() > 50
    np.testing.assert_allclose(
        np.asarray(hit.t)[m], np.asarray(brute.t)[m], rtol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(hit.prim)[m], np.asarray(brute.prim)[m])
