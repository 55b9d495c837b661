"""Platform plumbing: the traversal chosen per backend and scene size, the
compile-cache placement, the GPU smoke script's refusal to run without a
GPU, and the native builder's failure warning."""
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from gradientdomain_mitsuba_tpu import native
from gradientdomain_mitsuba_tpu.ops import common
from gradientdomain_mitsuba_tpu.ops import intersect as isec
from gradientdomain_mitsuba_tpu.ops import pallas_sweep as psw
from gradientdomain_mitsuba_tpu.utils import jaxconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def traversal_tags(monkeypatch):
    """Replace every traversal factory with one that returns a tag naming
    it (and the table it was handed)."""
    def factory(name):
        def make(arg):
            return lambda o, d, mint, maxt, table, *rest: (name, arg, table)
        return make

    monkeypatch.setattr(psw, "make_sweep_intersector", factory("sweep"))
    monkeypatch.setattr(psw, "make_sweep_occluder", factory("sweep_occ"))
    monkeypatch.setattr(isec, "make_bvh_intersector_soa", factory("soa"))
    monkeypatch.setattr(isec, "make_bvh_occluder_soa", factory("soa_occ"))
    monkeypatch.setattr(isec, "make_cluster_intersector",
                        factory("cluster"))
    monkeypatch.setattr(isec, "make_cluster_occluder",
                        factory("cluster_occ"))
    monkeypatch.setattr(isec, "intersect_brute",
                        lambda o, d, mint, maxt, t, chunk: ("brute", chunk, t))
    monkeypatch.setattr(isec, "occluded_brute",
                        lambda o, d, mint, maxt, t, chunk: ("brute_occ",
                                                            chunk, t))


@pytest.mark.parametrize("backend,n_tris,closest,occluded,arg,table", [
    ("gpu", 32, "sweep", "sweep_occ", 32, "tris"),
    ("gpu", 5000, "soa", "soa_occ", 37, "tris"),
    ("cpu", 32, "brute", "brute_occ", 64, "tris"),
    ("cpu", 5000, "cluster", "cluster_occ", 128, "tris"),
])
def test_choose_intersector_per_platform(monkeypatch, traversal_tags,
                                         backend, n_tris, closest,
                                         occluded, arg, table):
    import jax
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    st = SimpleNamespace(stack_depth=37, cluster_window=128)
    geom = SimpleNamespace(tris="tris", bvh="bvh", clusters="clusters",
                           sph_center=np.zeros((0, 3), np.float32))
    c, o = common.choose_intersector(st, n_tris)
    assert c(0, 0, 0, 0, geom) == (closest, arg, table)
    assert o(0, 0, 0, 0, geom) == (occluded, arg, table)


def test_compile_cache_default_path(monkeypatch):
    import jax
    monkeypatch.delenv(jaxconfig.CACHE_ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        jaxconfig.configure()
        assert jaxconfig.cache_dir() == os.path.join(ROOT, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_is_left_to_jax(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, configure() names no directory
    (JAX reads the variable itself)."""
    import jax
    monkeypatch.setenv(jaxconfig.CACHE_ENV, "/nonexistent/elsewhere")
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", "/sentinel")
        jaxconfig.configure()
        assert jaxconfig.cache_dir() == "/sentinel"
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _run(args, cwd, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    full.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=300)


def test_import_initialises_no_backend(tmp_path):
    r = _run(["-c", "import gradientdomain_mitsuba_tpu, jax._src.xla_bridge "
              "as xb; print(len(xb._backends))"], tmp_path,
             PYTHONPATH=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "0"


def test_chip_smoke_refuses_the_cpu(tmp_path):
    r = _run([os.path.join(ROOT, "chip_smoke.py")], tmp_path)
    assert r.returncode != 0
    assert "platform is gpu" in r.stdout
    assert '"ok": true' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """A directory that holds chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run([str(tmp_path / "chip_smoke.py")], tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_native_build_failure_warns_once(monkeypatch, capsys):
    def broken(name):
        raise subprocess.CalledProcessError(1, ["g++"], stderr=b"no g++")

    monkeypatch.setattr(native, "_build_lib", broken)
    monkeypatch.setattr(native, "_LIBS", {})
    assert native.get_lib("missing") is None
    assert native.get_lib("missing") is None
    err = capsys.readouterr().err
    assert err.count("warning: native missing unavailable") == 1
    assert "no g++" in err
