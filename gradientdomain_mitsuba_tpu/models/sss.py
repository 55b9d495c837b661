"""Path tracing with dipole subsurface scattering.

Analog of rendering a scene whose shapes carry the `dipole`
subsurface plugin (src/subsurface/dipole.cpp): the reference's
Subsurface::preprocess builds an irradiance octree once per render and
every integrator adds its.LoSub(...) at intersections with an attached
subsurface.  Here the preprocess is one jitted pass over a DENSE point
cache (ops/sss.py):

  1. sample P uniform-area points on each subsurface shape (per-row
     triangle CDF in scene.sss)
  2. irradiance per point = NEE direct estimate (M shadow rays)
       + cosine-hemisphere final gather (M full path-traced walks,
         direct_at_first=False so direct light is not double counted)
  3. the render pass threads the cache through render_chunk as a TRACED
     argument (same pattern as irrcache) and PathTracer.bounce adds the
     dipole exit radiance (1/pi) Ft(eta, cos_o) Mo at every vertex on a
     subsurface shape.

Parity note: as in the reference, only the path-tracer family evaluates
subsurface attachments — Mitsuba's bidirectional integrators (bdpt/mlt/
erpt) ignore Subsurface::Lo, and so do ours.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m
from ..core import warp
from ..core.rng import uniform_2d
from ..ops import common, emitter as em_ops
from ..ops import sss as sss_ops
from .path import PathTracer

# rng dim offsets for the preprocess streams (past every bounce dim)
DIM_DIRECT = 7105
DIM_GATHER = 7207


class DipoleTracer(PathTracer):
    """settings.sss_props honors `samples` (cache points, default 2048)
    and `irrSamples` (rays per point for BOTH the direct estimate and
    the indirect gather, default 16)."""

    def __init__(self, scene, settings):
        super().__init__(scene, settings)
        props = settings.sss_props
        self.n_points = int(props.get("samples", 2048))
        self.irr_samples = max(1, int(props.get("irr_samples", 16)))
        self._sss_coeffs = sss_ops.dipole_coeffs(scene.sss)
        self._cache = None

    # -- preprocess: irradiance cache over the subsurface shapes ------------
    @functools.partial(jax.jit, static_argnums=(0,))
    def _build_cache(self, scene, seed):
        P, M = self.n_points, self.irr_samples
        pts = sss_ops.sample_surface_points(scene, P, seed)
        eps = scene.ray_eps
        ids = jnp.arange(P * M, dtype=jnp.uint32)
        p_rep = jnp.repeat(pts["p"], M, axis=0)
        n_rep = jnp.repeat(pts["n"], M, axis=0)

        # direct irradiance: plain NEE (no MIS needed — irradiance has
        # no BSDF lobe to balance against)
        u_sel = uniform_2d(seed ^ 0x3d, ids, 0, DIM_DIRECT)[:, 0]
        u_pos = uniform_2d(seed ^ 0x3e, ids, 0, DIM_DIRECT + 2)
        ds = em_ops.sample_direct(scene, self.n_area, self.env_kind,
                                  p_rep, u_sel, u_pos,
                                  n_delta=self.n_delta)
        cos_i = m.dot(ds.d, n_rep)
        ok = ds.valid & (ds.pdf > 0) & (cos_i > 0)
        o_sh = common.offset_ray_origin(p_rep, n_rep, ds.d, eps)
        occl = self.occluded(
            o_sh, ds.d, jnp.zeros(P * M),
            ds.dist - 2.0 * eps / jnp.maximum(
                jnp.abs(m.dot(ds.d, ds.n)), 1e-3),
            scene.geom)
        contrib = ds.radiance * (cos_i /
                                 jnp.maximum(ds.pdf, 1e-30))[:, None]
        E_dir = jnp.where((ok & ~occl)[:, None], contrib, 0.0)
        E_dir = jnp.mean(E_dir.reshape(P, M, 3), axis=1)

        # indirect irradiance: cosine final gather, E = pi * mean(L)
        u_g = uniform_2d(seed ^ 0x5f, ids, 0, DIM_GATHER)
        d_loc = warp.square_to_cosine_hemisphere(u_g)
        fs, ft = m.build_frame(n_rep)
        d_g = m.to_world(d_loc, fs, ft, n_rep)
        o_g = common.offset_ray_origin(p_rep, n_rep, d_g, eps)
        L_g = self.trace_rays(scene, seed ^ 0x77, 0, ids, o_g, d_g,
                              direct_at_first=False)
        L_g = jnp.nan_to_num(L_g, nan=0.0, posinf=0.0, neginf=0.0)
        E_ind = jnp.pi * jnp.mean(L_g.reshape(P, M, 3), axis=1)

        return dict(**pts, E=E_dir + E_ind)

    # -- render: cache rides as a traced argument ---------------------------
    @functools.partial(jax.jit, static_argnums=(0, 4))
    def _render_chunk_sss(self, bundle, seed, sample_start, n_samples):
        from ..ops import film as film_ops
        scene, cache = bundle
        st = self.settings
        N = st.width * st.height
        spb = self.samples_per_batch(n_samples)
        fb = jnp.zeros((st.height, st.width, 3))
        wb = jnp.zeros((st.height, st.width))
        ids = jnp.tile(jnp.arange(N, dtype=jnp.uint32), spb)

        def body(i, carry):
            fb, wb = carry
            sidx = (sample_start + i * spb +
                    jnp.repeat(jnp.arange(spb, dtype=jnp.uint32), N))
            pos, L = self.trace_pass(scene, seed, sidx, pixel_id=ids,
                                     sss_cache=cache)
            jit = pos % 1.0
            fb, wb = film_ops.splat_grid(fb, wb, jit.reshape(spb, N, 2),
                                         L.reshape(spb, N, 3),
                                         self.filter_kind)
            return fb, wb

        fb, wb = jax.lax.fori_loop(0, n_samples // spb, body, (fb, wb))
        return fb, wb, jnp.zeros(())

    def render_chunk(self, scene, seed, sample_start, n_samples):
        return self._render_chunk_sss((scene, self._cache), seed,
                                      sample_start, n_samples)

    def render(self, scene, seed=0, spp=None, **kw):
        self._cache = self._build_cache(scene, np.uint32(seed))
        return super().render(scene, seed=seed, spp=spp, **kw)


def render(scene, settings, seed=0, spp=None):
    return DipoleTracer(scene, settings).render(scene, seed=seed, spp=spp)
