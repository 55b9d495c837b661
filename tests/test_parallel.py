"""Multi-chip equivalence: single-device render == 8-virtual-device
sharded render (same seeds), and distributed Poisson == local Poisson.
This is the SURVEY.md §5 'multi-node without a real cluster' test."""
import os

import numpy as np
import pytest

from gradientdomain_mitsuba_tpu.models import gpt as gpt_mod
from gradientdomain_mitsuba_tpu.models import path as path_mod
from gradientdomain_mitsuba_tpu.models import poisson
from gradientdomain_mitsuba_tpu.parallel import dist_poisson, tiles
from gradientdomain_mitsuba_tpu.scene import scene as sc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")


@pytest.fixture(scope="module")
def cbox():
    return sc.load_scene(
        CBOX, {"width": "24", "height": "24", "spp": "4", "maxDepth": "3"})


def test_eight_devices_available():
    import jax
    assert len(jax.devices()) == 8, jax.devices()


def test_path_sharded_matches_single(cbox):
    scene, st = cbox
    pt = path_mod.PathTracer(scene, st)
    single = pt.render(scene, seed=2, spp=4)
    mesh = tiles.make_mesh()
    multi = tiles.render_tiles_path(pt, scene, mesh, 2, 4)
    np.testing.assert_allclose(multi, single, rtol=1e-4, atol=1e-5)


def test_gpt_sharded_matches_single(cbox):
    scene, st = cbox
    g = gpt_mod.GPTracer(scene, st)
    single = g.render(scene, seed=2, spp=2, chunk=2)
    mesh = tiles.make_mesh()
    multi = tiles.render_tiles_gpt(g, scene, mesh, 2, 2)
    for k in single:
        np.testing.assert_allclose(multi[k], single[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_dist_poisson_matches_local():
    rs = np.random.RandomState(0)
    H, W = 25, 16  # deliberately not divisible by 8
    P = rs.gamma(2.0, 0.5, (H, W, 3)).astype(np.float32)
    gx = rs.normal(0, 0.2, (H, W, 3)).astype(np.float32)
    gy = rs.normal(0, 0.2, (H, W, 3)).astype(np.float32)
    local = np.asarray(poisson.solve_l2(P, gx, gy, alpha=0.25, iters=150))
    mesh = tiles.make_mesh()
    dist = dist_poisson.solve_l2_sharded(mesh, P, gx, gy, alpha=0.25,
                                         iters=150)
    np.testing.assert_allclose(dist, local, atol=2e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# Elastic tile queue (parallel/tile_queue.py): idempotent redispatch.
# Mitsuba aborts the job when a worker drops (sched_remote.cpp); here a
# dropped tile is simply re-rendered — SURVEY.md §6.3.
# ---------------------------------------------------------------------------

def test_tile_queue_fault_injection_bit_identical(cbox):
    from gradientdomain_mitsuba_tpu.parallel import tile_queue
    scene, st = cbox
    g = gpt_mod.GPTracer(scene, st)

    clean = tile_queue.render_tiles_queued(g, scene, seed=3, n_samples=2,
                                           tile_rows=8)
    faults = []

    def hook(idx, attempt):
        if idx == 1 and attempt == 0:
            faults.append(idx)
            raise RuntimeError("injected: chip lost tile 1")

    faulty = tile_queue.render_tiles_queued(g, scene, seed=3, n_samples=2,
                                            tile_rows=8, fail_hook=hook)
    assert faults == [1]
    for k in clean:
        np.testing.assert_array_equal(clean[k], faulty[k], err_msg=k)


def test_tile_queue_matches_monolithic(cbox):
    from gradientdomain_mitsuba_tpu.parallel import tile_queue
    scene, st = cbox
    g = gpt_mod.GPTracer(scene, st)
    single = g.render(scene, seed=3, spp=2, chunk=2)
    queued = tile_queue.render_tiles_queued(g, scene, seed=3, n_samples=2,
                                            tile_rows=8)
    for k in single:
        np.testing.assert_allclose(queued[k], single[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_tile_queue_gives_up_after_max_retries(cbox):
    from gradientdomain_mitsuba_tpu.parallel import tile_queue
    scene, st = cbox
    g = gpt_mod.GPTracer(scene, st)

    def always_fail(idx, attempt):
        if idx == 0:
            raise RuntimeError("injected: permanently dead tile")

    with pytest.raises(tile_queue.TileRenderError):
        tile_queue.render_tiles_queued(g, scene, seed=3, n_samples=1,
                                       tile_rows=8, max_retries=2,
                                       fail_hook=always_fail)


def test_gbdpt_sharded_matches_single(cbox):
    """G-BDPT over 8 virtual devices == single-chip, INCLUDING the
    light image whose t=1 splats land on foreign shards (merged with a
    psum over the mesh)."""
    from gradientdomain_mitsuba_tpu.models import gbdpt as gbdpt_mod
    scene, st = cbox
    import copy
    st2 = copy.deepcopy(st)
    st2.integrator = "gbdpt"
    st2.max_depth = 3
    g = gbdpt_mod.GBDPTracer(scene, st2)
    single = g.render(scene, seed=2, spp=2, chunk=2)
    mesh = tiles.make_mesh()
    multi = tiles.render_tiles_gbdpt(g, scene, mesh, 2, 2)
    for k in single:
        np.testing.assert_allclose(multi[k], single[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
