"""Every f32 contraction on the geometry, medium, subsurface and luminance
paths names its precision.

A GPU may run an f32 dot_general without an explicit precision in TF32,
which keeps about three decimal digits: at scene coordinates of ~2000
units that moves camera rays by whole units.  These sites either use
explicit multiply-adds (no dot_general at all) or pass
Precision.HIGHEST; the jaxpr of each is checked here."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gradientdomain_mitsuba_tpu.core import math as m
from gradientdomain_mitsuba_tpu.core import spectrum
from gradientdomain_mitsuba_tpu.models.adaptive import AdaptiveTracer
from gradientdomain_mitsuba_tpu.ops import medium as med_ops
from gradientdomain_mitsuba_tpu.ops import sss as sss_ops
from gradientdomain_mitsuba_tpu.scene import media as media_mod
from gradientdomain_mitsuba_tpu.scene import scene as sc

HIGHEST = jax.lax.Precision.HIGHEST


def _eqns(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _eqns(sub)


def _dot_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    return [e.params["precision"] for e in _eqns(jaxpr)
            if e.primitive.name == "dot_general"]


def _sss_args():
    rs = np.random.RandomState(0)
    table = sc.SSSTable(
        sigma_s=np.ones((1, 3), np.float32), sigma_a=np.ones((1, 3),
                                                             np.float32),
        g=np.zeros(1, np.float32), eta=np.full(1, 1.3, np.float32),
        shape=np.zeros(1, np.int32), shape_sss=np.zeros(1, np.int32),
        tri_offset=np.zeros(1, np.int32), tri_count=np.ones(1, np.int32),
        tri_cdf=np.ones(1, np.float32), tri_index=np.zeros(1, np.int32),
        total_area=np.ones(1, np.float32))
    cache = dict(p=jnp.asarray(rs.randn(64, 3), jnp.float32),
                 E=jnp.ones((64, 3)), aw=jnp.ones(64),
                 row=jnp.zeros(64, jnp.int32))
    co = sss_ops.dipole_coeffs(table)
    return (lambda q: sss_ops.eval_mo(cache, co, q, jnp.zeros(8, jnp.int32),
                                      chunk=32)), jnp.ones((8, 3))


def _site(name):
    M = jnp.eye(4)
    p = jnp.ones((8, 3))
    media = jax.tree.map(jnp.asarray, media_mod.vacuum_table())
    mid = jnp.zeros(8, jnp.int32)
    sites = {
        "transform_point": (lambda p: m.transform_point(M, p), p),
        "transform_vector": (lambda p: m.transform_vector(M, p), p),
        "transform_normal": (lambda p: m.transform_normal(M, p), p),
        "luminance": (spectrum.luminance, p),
        "sss_eval_mo": _sss_args(),
        "medium_density_at": (lambda p: med_ops.density_at(media, mid, p),
                              p),
        "medium_flake_at": (lambda p: med_ops.flake_at(media, mid, p), p),
        "adaptive_error": (
            lambda a: AdaptiveTracer._error.__wrapped__(
                SimpleNamespace(quantile=1.96), (a, jnp.ones(8),
                                                 jnp.full(8, 2.0))), p),
    }
    return sites[name]


@pytest.mark.parametrize("name", [
    "transform_point", "transform_vector", "transform_normal", "luminance",
    "sss_eval_mo", "medium_density_at", "medium_flake_at",
    "adaptive_error"])
def test_f32_contractions_run_at_highest_precision(name):
    fn, arg = _site(name)
    for prec in _dot_precisions(fn, arg):
        assert prec is not None, f"{name}: dot_general without precision"
        assert all(p == HIGHEST for p in prec), (name, prec)
