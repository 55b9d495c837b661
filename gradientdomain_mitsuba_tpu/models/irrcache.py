"""Irradiance caching (Ward/Tabellion style) on the primary-hit lattice.

Replacement for the `irrcache` integrator
(src/integrators/irrcache/irrcache.{cpp,h} + librender octree cache):
the reference builds an octree of irradiance records lazily during
rendering, with data-dependent insertion and nearest-record queries —
both hostile to XLA.  Here the cache IS a dense lattice:

  overture pass   one record per RxR pixel block (default 4x4): primary
                  hit -> M cosine-hemisphere final-gather rays, each a
                  full path-traced walk with direct_at_first=False (so
                  direct lighting is never double counted); the record
                  stores E = pi * mean(L_gather), the hit position/
                  normal, and Ward's harmonic-mean gather distance R_i.
  render pass     every pixel interpolates the 3x3 neighboring records
                  with the Ward/Tabellion weight
                  w_i = 1 / (|x-x_i|/R_i + sqrt(1 - n.n_i)), records cut
                  off at w < 1/quality; indirect = albedo/pi * E.
                  Direct lighting is a full maxDepth=2 walk (emitted +
                  NEE/BSDF-MIS direct), so L = direct + cached indirect.

Deviations (documented): records live only on primary hits (the
reference also caches on secondary diffuse vertices); non-diffuse lanes
fall back to a full path trace (compiled in only when such materials
exist).  Both keep the estimator consistent — the cache is a biased
smoothing of indirect light exactly as in the reference.
"""
from __future__ import annotations

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m
from ..core import warp
from ..core.rng import uniform_2d
from ..ops import common
from ..ops import sensor as sensor_ops
from ..scene.materials import DIFFUSE, ROUGH_DIFFUSE
from .path import PathTracer

GATHER_DIM_BASE = 24576   # rng dim offset for the gather-direction stream


class IrrCacheTracer(PathTracer):
    """settings.integrator_props honors `resolution` (pixels per record,
    default 4), `gatherSamples` (hemisphere rays per record, default 64),
    `quality` (Ward error bound kappa, default 0.5)."""

    def __init__(self, scene, settings):
        super().__init__(scene, settings)
        props = settings.integrator_props
        self.res = max(1, int(props.get("resolution", 4)))
        self.gather_samples = int(props.get("gatherSamples", 64))
        self.kappa = float(props.get("quality", 0.5))
        st_d = copy.deepcopy(settings)
        st_d.max_depth = 2
        self._direct = PathTracer(scene, st_d)
        kinds = np.asarray(scene.materials.kind)
        self._all_diffuse = bool(
            np.isin(kinds, (DIFFUSE, ROUGH_DIFFUSE)).all())
        self._cache = None

    # -- overture: build the record lattice ---------------------------------
    @functools.partial(jax.jit, static_argnums=(0,))
    def _build_cache(self, scene, seed):
        st = self.settings
        W, H = st.width, st.height
        R = self.res
        Wc, Hc = -(-W // R), -(-H // R)
        C = Wc * Hc
        M = self.gather_samples

        cx = (jnp.arange(C, dtype=jnp.uint32) % Wc).astype(jnp.float32)
        cy = (jnp.arange(C, dtype=jnp.uint32) // Wc).astype(jnp.float32)
        pos_film = jnp.stack([jnp.minimum(cx * R + R / 2, W - 0.5),
                              jnp.minimum(cy * R + R / 2, H - 0.5)], -1)
        o, d = sensor_ops.sample_ray(scene.camera, W, H, pos_film,
                                     jnp.full((C, 2), 0.5))
        hit = self.closest(o, d, jnp.zeros(C), jnp.full(C, 3e38),
                           scene.geom)
        its = common.fill_intersection(scene, o, d, hit)
        n = jnp.where((m.dot(its.ns, -d) < 0)[..., None], -its.ns, its.ns)

        # gather rays: [C*M] cosine-hemisphere walks, final-gather mode
        ids = jnp.arange(C * M, dtype=jnp.uint32)
        u = uniform_2d(seed ^ 0x1cc, ids, 0, GATHER_DIM_BASE)
        d_loc = warp.square_to_cosine_hemisphere(u)
        n_rep = jnp.repeat(n, M, axis=0)
        ss, ts = m.build_frame(n_rep)
        d_g = m.to_world(d_loc, ss, ts, n_rep)
        p_rep = jnp.repeat(its.p, M, axis=0)
        ng_rep = jnp.repeat(its.ng, M, axis=0)
        o_g = common.offset_ray_origin(p_rep, ng_rep, d_g, scene.ray_eps)

        L_g = self.trace_rays(scene, seed ^ 0x9a7, 0, ids, o_g, d_g,
                              direct_at_first=False)
        L_g = jnp.nan_to_num(L_g, nan=0.0, posinf=0.0, neginf=0.0)
        # E = integral(L cos) = pi * E_cosine-sampled[L]
        E = jnp.pi * jnp.mean(L_g.reshape(C, M, 3), axis=1)

        # Ward's validity radius: harmonic mean of gather hit distances
        hit_g = self.closest(o_g, d_g, jnp.zeros(C * M),
                             jnp.full(C * M, 3e38), scene.geom)
        t_g = jnp.where(hit_g.valid, jnp.maximum(hit_g.t, 1e-4), 1e4)
        Ri = M / jnp.sum(1.0 / t_g.reshape(C, M), axis=1)

        return dict(E=E, p=its.p, n=n, Ri=Ri,
                    valid=its.valid & (its.bsdf_id >= 0))

    # -- render pass ---------------------------------------------------------
    def _interp(self, cache, pixel_id, p, n):
        """Ward-weighted 3x3 record interpolation. p,n: [N,3]."""
        st = self.settings
        R, Wc = self.res, -(-st.width // self.res)
        Hc = -(-st.height // self.res)
        px = pixel_id % st.width
        py = pixel_id // st.width
        cx = (px // R).astype(jnp.int32)
        cy = (py // R).astype(jnp.int32)
        N = p.shape[0]

        acc = jnp.zeros((N, 3))
        wsum = jnp.zeros(N)
        facc = jnp.zeros((N, 3))
        fwsum = jnp.zeros(N)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ix = jnp.clip(cx + dx, 0, Wc - 1)
                iy = jnp.clip(cy + dy, 0, Hc - 1)
                idx = iy * Wc + ix
                Ei = cache["E"][idx]
                pi_ = cache["p"][idx]
                ni = cache["n"][idx]
                Ri = cache["Ri"][idx]
                ok = cache["valid"][idx]
                dist = jnp.sqrt(m.squared_length(p - pi_))
                ndot = jnp.clip(m.dot(n, ni), -1.0, 1.0)
                err = (dist / jnp.maximum(Ri, 1e-6) +
                       jnp.sqrt(jnp.maximum(1.0 - ndot, 0.0)))
                w = jnp.where(ok, jnp.maximum(1.0 / jnp.maximum(
                    err, 1e-4) - 1.0 / self.kappa, 0.0), 0.0)
                acc = acc + w[..., None] * Ei
                wsum = wsum + w
                # fallback: plain inverse-distance over valid records
                wf = jnp.where(ok, 1.0 / (dist + 1e-4), 0.0)
                facc = facc + wf[..., None] * Ei
                fwsum = fwsum + wf
        interp = acc / jnp.maximum(wsum, 1e-12)[..., None]
        fallback = facc / jnp.maximum(fwsum, 1e-12)[..., None]
        return jnp.where((wsum > 0)[..., None], interp, fallback)

    def _trace_pass_cached(self, scene, cache, seed, sample_idx,
                           pixel_id):
        from ..core.rng import DimAllocator as DA
        st = self.settings
        W, H = st.width, st.height
        px = (pixel_id % W).astype(jnp.float32)
        py = (pixel_id // W).astype(jnp.float32)
        jitter = self._u2(seed, pixel_id, sample_idx, DA.PIXEL_JITTER)
        pos_film = jnp.stack([px, py], -1) + jitter
        u_ap = self._u2(seed, pixel_id, sample_idx, DA.APERTURE)
        o, d = sensor_ops.sample_ray(scene.camera, W, H, pos_film, u_ap)
        N = o.shape[0]

        # direct lighting: a full maxDepth=2 walk (emitted + MIS direct)
        L = self._direct.trace_rays(scene, seed, sample_idx, pixel_id,
                                    o, d)

        # indirect: cached irradiance at the primary hit, diffuse lanes
        hit = self.closest(o, d, jnp.zeros(N), jnp.full(N, 3e38),
                           scene.geom)
        its = common.fill_intersection(scene, o, d, hit)
        n = jnp.where((m.dot(its.ns, -d) < 0)[..., None], -its.ns, its.ns)
        E = self._interp(cache, pixel_id, its.p, n)
        params = common.material_params(scene, self.has_textures,
                                        its.bsdf_id, its.uv,
                                        bary=its.bary)
        diffuse = ((params.kind == DIFFUSE) |
                   (params.kind == ROUGH_DIFFUSE)) & its.valid
        L_ind = params.reflectance / jnp.pi * E
        L = L + jnp.where(diffuse[..., None], L_ind, 0.0)

        if not self._all_diffuse:
            # non-diffuse primaries: the cache cannot represent their
            # transport — replace with a full path trace on those lanes
            L_full = self.trace_rays(scene, seed, sample_idx, pixel_id,
                                     o, d)
            L = jnp.where(diffuse[..., None] | ~its.valid[..., None],
                          L, L_full)
        return pos_film, L

    # the cache rides render_chunk as a TRACED argument (not a captured
    # constant) so re-renders with a different seed refresh correctly
    @functools.partial(jax.jit, static_argnums=(0, 4))
    def _render_chunk_cached(self, bundle, seed, sample_start, n_samples):
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
            pos, L = self._trace_pass_cached(scene, cache, seed, sidx,
                                             ids)
            jit = pos % 1.0
            fb, wb = film_ops.splat_grid(fb, wb, jit.reshape(spb, N, 2),
                                         L.reshape(spb, N, 3),
                                         self.filter_kind)
            return fb, wb

        fb, wb = jax.lax.fori_loop(0, n_samples // spb, body, (fb, wb))
        return fb, wb, jnp.zeros(())

    def render_chunk(self, scene, seed, sample_start, n_samples):
        return self._render_chunk_cached((scene, self._cache), seed,
                                         sample_start, n_samples)

    def render(self, scene, seed=0, spp=None, **kw):
        self._cache = self._build_cache(scene, seed)
        return super().render(scene, seed=seed, spp=spp, **kw)


def render(scene, settings, seed=0, spp=None):
    return IrrCacheTracer(scene, settings).render(scene, seed=seed,
                                                  spp=spp)
