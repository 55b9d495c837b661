"""Multi-host (multi-process) rendering without a real cluster.

The Analog of `mitsuba -c node1;node2` + mtssrv
(SURVEY.md §6.8): two OS processes join a jax.distributed coordination
service on the CPU backend (2 virtual devices each -> a 4-device global
mesh spanning both), render the same seeds through the row-sharded tile
renderer — whose ppermute halo exchange now crosses the process
boundary over the DCN-analog transport — and must agree with a
single-process render bit-for-tolerance."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_render_matches_single(tmp_path):
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    # workers force their own device count; scrub any inherited setting
    env.pop("XLA_FLAGS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coordinator, "2", str(pid),
             str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"

    # both hosts must hold the SAME gathered film
    a = np.load(tmp_path / "bufs_0.npz")
    b = np.load(tmp_path / "bufs_1.npz")
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    # and it must match a single-process 4-virtual-device render of the
    # same seeds (the in-process mesh the regular tests exercise)
    from gradientdomain_mitsuba_tpu.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu.parallel import tiles
    from gradientdomain_mitsuba_tpu.scene import scene as sc
    scene, st = sc.load_scene(
        os.path.join(ROOT, "data/scenes/cbox/cbox.xml"),
        {"width": "16", "height": "16", "spp": "2", "maxDepth": "3",
         "integrator": "gpt"})
    tracer = GPTracer(scene, st)
    mesh = tiles.make_mesh(4)
    ref = tiles.render_tiles_gpt(tracer, scene, mesh, seed=2, n_samples=2)
    for k in ref:
        np.testing.assert_allclose(a[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_two_process_tiny_default_gate(tmp_path):
    """Default-gate DCN proof: 2 processes
    x 1 virtual device each, 8x8 film, maxDepth 2 — small enough for the
    default suite, still exercising jax.distributed init, the process-
    major global mesh, and the cross-process ppermute halo exchange.
    The full 16x16 x 2-device cross-check stays in `-m slow`."""
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coordinator, "2", str(pid),
             str(tmp_path), "8", "2", "1"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"

    # both hosts must hold the SAME gathered film, and it must match an
    # in-process 2-virtual-device mesh render of the same seeds
    a = np.load(tmp_path / "bufs_0.npz")
    b = np.load(tmp_path / "bufs_1.npz")
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    from gradientdomain_mitsuba_tpu.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu.parallel import tiles
    from gradientdomain_mitsuba_tpu.scene import scene as sc
    scene, st = sc.load_scene(
        os.path.join(ROOT, "data/scenes/cbox/cbox.xml"),
        {"width": "8", "height": "8", "spp": "2", "maxDepth": "2",
         "integrator": "gpt"})
    tracer = GPTracer(scene, st)
    mesh = tiles.make_mesh(2)
    ref = tiles.render_tiles_gpt(tracer, scene, mesh, seed=2, n_samples=2)
    for k in ref:
        np.testing.assert_allclose(a[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
