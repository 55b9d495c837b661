"""Fused small-scene sweep kernel (ops/pallas_sweep.py) in interpret mode.

On the CPU, Pallas runs the kernel through its interpreter, which pins
down the kernel's arithmetic, tie rule, padding and dead-lane handling
against the plain forms in ops/intersect.py.  Its compiled form on the
GPU is checked by chip_smoke.py (phase kernels)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from gradientdomain_mitsuba_tpu.ops import intersect as isec
from gradientdomain_mitsuba_tpu.ops import pallas_sweep as psw
from gradientdomain_mitsuba_tpu.scene import scene as sc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _soup(rs, T):
    v0 = np.float32(rs.normal(size=(T, 3)))
    e1 = np.float32(rs.normal(size=(T, 3)))
    e2 = np.float32(rs.normal(size=(T, 3)))
    tris = isec.TriSoup(v0=jnp.asarray(v0), e1=jnp.asarray(e1),
                        e2=jnp.asarray(e2),
                        orig_id=jnp.arange(T, dtype=jnp.int32))
    return tris, jnp.asarray(isec.build_linear_mt(v0, e1, e2))


def _rays(rs, N, tmax):
    o = jnp.asarray(np.float32(rs.normal(size=(N, 3)) * 3))
    d = jnp.asarray(np.float32(rs.normal(size=(N, 3))))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    mint = jnp.full((N,), 1e-4, jnp.float32)
    # every 7th lane dead (maxt = -1, as finished wavefront paths)
    maxt = jnp.where(jnp.arange(N) % 7 == 0, -1.0, tmax)
    return o, d, mint, maxt


@pytest.mark.parametrize("T", [8, 32, 2048])
@pytest.mark.parametrize("kind", ["closest", "occluded"])
def test_sweep_kernel_matches_matmul(kind, T):
    """The interpret-mode kernel == intersect_brute exactly (same
    Moeller-Trumbore arithmetic and tie rule) and == the linear-MT
    intersect_matmul up to its reassociated rounding, on random soups
    of 8, 32 (the cbox count) and 2048 triangles.  300 rays are not a
    multiple of the 128-ray block, so the padding rays are exercised."""
    rs = np.random.RandomState(7 + T)
    tris, linC = _soup(rs, T)
    N = 300
    o, d, mint, maxt = _rays(rs, N, 3e38 if kind == "closest" else 4.0)
    dead = np.asarray(maxt) < 0
    if kind == "closest":
        got = psw.make_sweep_intersector(T, interpret=True)(
            o, d, mint, maxt, tris)
        ref = isec.intersect_brute(o, d, mint, maxt, tris, chunk=64)
        mm = isec.intersect_matmul(o, d, mint, maxt, linC)
        np.testing.assert_array_equal(np.asarray(got.valid),
                                      np.asarray(ref.valid))
        mk = np.asarray(ref.valid)
        assert mk.sum() > 10
        np.testing.assert_array_equal(np.asarray(got.prim)[mk],
                                      np.asarray(ref.prim)[mk])
        np.testing.assert_allclose(np.asarray(got.t)[mk],
                                   np.asarray(ref.t)[mk], rtol=1e-5)
        np.testing.assert_allclose(np.asarray(got.u)[mk],
                                   np.asarray(ref.u)[mk], atol=1e-5)
        assert not np.asarray(got.valid)[dead].any()
        assert (np.asarray(got.prim)[~mk] == -1).all()
        # linear-MT: near-total agreement (reassociated arithmetic)
        assert (np.asarray(mm.valid) == mk).mean() > 0.99
    else:
        got = np.asarray(psw.make_sweep_occluder(T, interpret=True)(
            o, d, mint, maxt, tris))
        ref = np.asarray(isec.occluded_brute(o, d, mint, maxt, tris,
                                             chunk=64))
        np.testing.assert_array_equal(got, ref)
        assert 0 < ref.sum() < N
        assert not got[dead].any()
        mm = np.asarray(isec.occluded_matmul(o, d, mint, maxt, linC))
        assert (mm == ref).mean() > 0.99


@pytest.mark.parametrize("kind", ["closest", "occluded"])
def test_sweep_kernel_on_padded_scene_layout(kind):
    """cbox-mats has more triangles than one cluster window, so its soup
    interleaves real and padding slots; the kernel's compacted table must
    report hits in the scene's slot order, like the brute scan."""
    scene, st = sc.load_scene(
        os.path.join(ROOT, "data/scenes/cbox-mats/cbox-mats.xml"),
        {"width": "16", "height": "16", "spp": "1", "maxDepth": "2"})
    g = scene.geom
    n_tris = int(g.indices.shape[0])
    assert g.tris.v0.shape[0] > n_tris  # padded layout
    rs = np.random.RandomState(3)
    N = 700
    o = jnp.asarray(np.float32(rs.uniform(50, 500, (N, 3))))
    d = jnp.asarray(np.float32(rs.normal(size=(N, 3))))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    mint = jnp.zeros(N)
    maxt = jnp.full(N, 3e38 if kind == "closest" else 300.0)
    if kind == "closest":
        got = psw.make_sweep_intersector(n_tris, interpret=True)(
            o, d, mint, maxt, g.tris)
        ref = isec.intersect_brute(o, d, mint, maxt, g.tris, chunk=1024)
        np.testing.assert_array_equal(np.asarray(got.valid),
                                      np.asarray(ref.valid))
        mk = np.asarray(ref.valid)
        np.testing.assert_array_equal(np.asarray(got.prim)[mk],
                                      np.asarray(ref.prim)[mk])
        assert (np.asarray(g.tris.orig_id)[np.asarray(got.prim)[mk]]
                >= 0).all()
    else:
        got = psw.make_sweep_occluder(n_tris, interpret=True)(
            o, d, mint, maxt, g.tris)
        ref = isec.occluded_brute(o, d, mint, maxt, g.tris, chunk=1024)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("n_tris,chunk", [(1, 16), (36, 16), (37, 8)])
def test_sweep_table_layout(n_tris, chunk):
    """_tri_table keeps exactly the real slots (orig_id >= 0), in slot
    order, padded to whole chunks with empty (-1, all-zero) entries."""
    rs = np.random.RandomState(n_tris)
    Tp = 64
    real = np.sort(rs.choice(Tp, n_tris, replace=False))
    orig = np.full(Tp, -1, np.int32)
    orig[real] = np.arange(n_tris)
    v = np.float32(rs.normal(size=(Tp, 3)))
    tris = isec.TriSoup(v0=jnp.asarray(v), e1=jnp.asarray(v + 1),
                        e2=jnp.asarray(v + 2), orig_id=jnp.asarray(orig))
    tab, slot = psw._tri_table(tris, n_tris, chunk)
    slot = np.asarray(slot)
    Ts = -(-n_tris // chunk) * chunk
    assert slot.shape == (Ts,)
    np.testing.assert_array_equal(slot[:n_tris], real)
    assert (slot[n_tris:] == -1).all()
    tab = np.asarray(tab).reshape(Ts // chunk, psw.N_COEF, chunk)
    v0 = tab[:, 0:3].transpose(0, 2, 1).reshape(Ts, 3)
    np.testing.assert_array_equal(v0[:n_tris], v[real])
    assert (tab.transpose(0, 2, 1).reshape(Ts, -1)[n_tris:] == 0).all()
