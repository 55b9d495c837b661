"""Wavefront path tracer with NEE + MIS.

Replacement for the `path` integrator (src/integrators/path/
path.cpp, MIPathTracer::Li) re-architected per SURVEY.md §8.1: instead of a
recursive per-ray megakernel, EVERY pixel's ray advances one bounce per
iteration of a fori_loop over SoA megabatches resident in HBM; dead lanes
are masked.  Semantics match the reference:

  - depth counting: depth 1 = camera ray hits emitter; maxDepth caps path
    segments; maxDepth=-1 means unlimited (capped by RR + MAX_BOUNCES)
  - MIS: power heuristic beta=2 between BSDF sampling and NEE
  - NEE: uniform emitter pick, area-uniform sampling, solid-angle pdf
  - RR from rrDepth with survival min(max(throughput)*eta^2, 0.95)
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m
from ..core.rng import DimAllocator as DA
from ..core.rng import make_sampler, uniform_2d, uniform_float
from ..ops import bsdf as bsdf_ops
from ..ops import common, emitter as em_ops
from ..ops import film as film_ops
from ..ops import sensor as sensor_ops

MAX_BOUNCES_UNLIMITED = 40


def mis_weight(pdf_a, pdf_b):
    """Power heuristic, beta=2 (path.cpp miWeight)."""
    a2 = pdf_a * pdf_a
    return jnp.where(pdf_a > 0, a2 / jnp.maximum(a2 + pdf_b * pdf_b, 1e-30),
                     0.0)


class PathTracer:
    """Holds static per-scene config and compiled render functions."""

    def __init__(self, scene, settings):
        self.kinds = bsdf_ops.scene_kinds(scene)
        self._beval = functools.partial(bsdf_ops.eval, kinds=self.kinds)
        self._bpdf = functools.partial(bsdf_ops.pdf, kinds=self.kinds)
        self._bsample = functools.partial(bsdf_ops.sample, kinds=self.kinds)
        self.settings = settings
        self.n_area = int((np.asarray(scene.emitters.tri_count) > 0).sum())
        self.has_env = settings.has_env
        self.env_kind = settings.env_kind
        n_tris = int(scene.geom.indices.shape[0])
        self.closest, self.occluded = common.instrument_intersectors(
            self, *common.choose_intersector(settings, n_tris))
        self.large_scene = n_tris > common.BRUTE_FORCE_MAX_TRIS
        self.count_rays = False  # set True BEFORE first render
        self.ray_tally = None
        self.last_ray_count = None
        self.n_bounces = (settings.max_depth if settings.max_depth > 0
                          else MAX_BOUNCES_UNLIMITED)
        self.has_textures = settings.has_textures
        self.n_delta = settings.n_delta
        self._u1, self._u2 = make_sampler(settings.sampler, settings.spp)
        self.filter_kind = film_ops.FILTERS.get(settings.rfilter, 0)

    # -- one sample per pixel for the whole frame ---------------------------
    def trace_pass(self, scene, seed, sample_idx, pixel_id=None,
                   sss_cache=None):
        st = self.settings
        W, H = st.width, st.height
        if pixel_id is None:
            pixel_id = jnp.arange(W * H, dtype=jnp.uint32)
        px = (pixel_id % W).astype(jnp.float32)
        py = (pixel_id // W).astype(jnp.float32)

        jitter = self._u2(seed, pixel_id, sample_idx, DA.PIXEL_JITTER)
        pos_film = jnp.stack([px, py], -1) + jitter
        u_ap = self._u2(seed, pixel_id, sample_idx, DA.APERTURE)
        o, d = sensor_ops.sample_ray(scene.camera, W, H, pos_film, u_ap)

        # sss_cache is only forwarded when set: subclasses that override
        # trace_rays (volpath) do not take the dipole kwarg
        kw = {} if sss_cache is None else {"sss_cache": sss_cache}
        L = self.trace_rays(scene, seed, sample_idx, pixel_id, o, d, **kw)
        return pos_film, L

    def trace_rays(self, scene, seed, sample_idx, pixel_id, o, d,
                   direct_at_first=True, sss_cache=None):
        """Path-trace a batch of rays to completion. Returns radiance [N,3].

        direct_at_first=False drops emitter/env radiance seen directly by
        the input rays (depth-1 hits) — final-gather semantics, used by
        the irradiance cache so direct lighting is not double-counted."""
        st = self.settings
        N = o.shape[0]
        eps = scene.ray_eps
        inf = jnp.full(N, 3e38)

        hit = self.closest(o, d, jnp.zeros(N), inf, scene.geom)
        its = common.fill_intersection(scene, o, d, hit)

        state = dict(
            o=o, d=d, its=its,
            L=jnp.zeros((N, 3)),
            throughput=jnp.ones((N, 3)),
            eta=jnp.ones(N),
            alive=jnp.ones(N, bool),
            last_pdf=jnp.zeros(N),
            # depth-1 emitter hits: weight 1 (or 0 in final-gather mode —
            # mis_weight(0, x) == 0)
            last_delta=jnp.full(N, bool(direct_at_first)),
        )

        def bounce(b, s, fp=None):
            depth = b + 1  # Mitsuba depth of the CURRENT vertex
            its = s["its"]
            alive = s["alive"]
            tp = s["throughput"]
            L = s["L"]
            wi_world = -s["d"]

            # ---- emitter / environment hit at current vertex --------------
            cos_front = m.dot(its.ns, wi_world)
            is_emitter = its.valid & (its.emitter_id >= 0) & (cos_front > 0)
            rad = scene.emitters.radiance[jnp.maximum(its.emitter_id, 0)]
            lum_pdf = em_ops.pdf_area_direct(
                scene, self.n_area, self.has_env, its.emitter_id,
                s["o"], its.p, its.ng, n_delta=self.n_delta)
            w_hit = jnp.where(s["last_delta"], 1.0,
                              mis_weight(s["last_pdf"], lum_pdf))
            L = L + jnp.where((alive & is_emitter)[..., None],
                              tp * rad * w_hit[..., None], 0.0)

            if self.has_env:
                env_L = em_ops.eval_env(scene, self.env_kind, s["d"])
                env_pdf = em_ops.pdf_env_direct(
                    scene, self.n_area, self.env_kind, s["d"],
                    n_delta=self.n_delta)
                w_env = jnp.where(s["last_delta"], 1.0,
                                  mis_weight(s["last_pdf"], env_pdf))
                L = L + jnp.where((alive & ~its.valid)[..., None],
                                  tp * env_L * w_env[..., None], 0.0)

            if sss_cache is not None:
                # dipole subsurface term at every surface vertex
                # (path.cpp adds its.LoSub at each intersection with an
                # attached <subsurface>):
                #   Lo = (1/pi) Ft(eta, cos_o) Mo(p)
                from ..ops import sss as sss_ops
                from ..ops.bsdf import fresnel_dielectric
                row_q = scene.sss.shape_sss[
                    jnp.clip(its.shape_id, 0,
                             scene.sss.shape_sss.shape[0] - 1)]
                has_sss = alive & its.valid & (row_q >= 0) & (cos_front > 0)
                row_m = jnp.where(has_sss, row_q, -1)
                mo = sss_ops.eval_mo(sss_cache, self._sss_coeffs,
                                     its.p, row_m)
                eta_r = self._sss_coeffs.eta[jnp.maximum(row_m, 0)]
                ft = 1.0 - fresnel_dielectric(
                    jnp.clip(cos_front, 0.0, 1.0), eta_r)[0]
                L = L + jnp.where(has_sss[..., None],
                                  tp * mo * (ft / jnp.pi)[..., None], 0.0)

            alive = alive & its.valid
            # maxDepth cut: no continuation past maxDepth segments
            if st.max_depth > 0:
                alive = alive & (depth < st.max_depth)

            # ---- shading frame --------------------------------------------
            # two-sided shading normal flip is handled inside bsdf dispatch;
            # the frame itself uses the (possibly backfacing) shading normal
            ss, ts = m.build_frame(its.ns)
            wi = m.to_local(wi_world, ss, ts, its.ns)
            params = common.material_params(
                scene, self.has_textures, its.bsdf_id, its.uv,
                uv_footprint=fp, bary=its.bary)

            # ---- NEE --------------------------------------------------------
            u_sel = self._u1(seed, pixel_id, sample_idx,
                                  DA.bounce_dim(b, DA.D_LIGHT_SELECT))
            u_pos = self._u2(seed, pixel_id, sample_idx,
                               DA.bounce_dim(b, DA.D_LIGHT_UV))
            ds = em_ops.sample_direct(scene, self.n_area, self.env_kind,
                                      its.p, u_sel, u_pos,
                                      n_delta=self.n_delta)
            nee_possible = alive & ds.valid & (ds.pdf > 0)
            shadow_o = common.offset_ray_origin(its.p, its.ng, ds.d, eps)
            occl = self.occluded(
                shadow_o, ds.d, jnp.zeros(N),
                ds.dist - 2.0 * eps / jnp.maximum(
                    jnp.abs(m.dot(ds.d, ds.n)), 1e-3),
                scene.geom)
            wo_l = m.to_local(ds.d, ss, ts, its.ns)
            f_l = self._beval(params, wi, wo_l)
            pdf_b = self._bpdf(params, wi, wo_l)
            w_nee = jnp.where(ds.is_delta, 1.0, mis_weight(ds.pdf, pdf_b))
            contrib = (tp * f_l * ds.radiance *
                       (w_nee / jnp.maximum(ds.pdf, 1e-30))[..., None])
            L = L + jnp.where((nee_possible & ~occl)[..., None], contrib, 0.0)

            # ---- BSDF sampling ----------------------------------------------
            u2 = self._u2(seed, pixel_id, sample_idx,
                            DA.bounce_dim(b, DA.D_BSDF_UV))
            uc = self._u1(seed, pixel_id, sample_idx,
                               DA.bounce_dim(b, DA.D_BSDF_COMPONENT))
            bs = self._bsample(params, wi, u2, uc)
            alive = alive & bs.valid
            tp = jnp.where(alive[..., None], tp * bs.weight, tp)
            eta = jnp.where(alive, s["eta"] * bs.eta, s["eta"])
            wo_world = m.to_world(bs.wo, ss, ts, its.ns)
            o_new = common.offset_ray_origin(its.p, its.ng, wo_world, eps)

            # ---- russian roulette -------------------------------------------
            u_rr = self._u1(seed, pixel_id, sample_idx,
                                 DA.bounce_dim(b, DA.D_RR))
            q = jnp.minimum(jnp.max(tp, -1) * eta * eta, 0.95)
            do_rr = depth >= st.rr_depth
            survive = jnp.where(do_rr, u_rr < q, True)
            tp = jnp.where((do_rr & alive)[..., None],
                           tp / jnp.maximum(q, 1e-9)[..., None], tp)
            alive = alive & survive & (jnp.max(tp, -1) > 0)

            # ---- next intersection ------------------------------------------
            hit = self.closest(o_new, wo_world, jnp.zeros(N),
                               jnp.where(alive, 3e38, -1.0),
                               scene.geom)
            its_new = common.fill_intersection(scene, o_new, wo_world, hit)

            return dict(o=o_new, d=wo_world, its=its_new, L=L,
                        throughput=tp, eta=eta, alive=alive,
                        last_pdf=bs.pdf,
                        last_delta=bs.is_delta)

        # bounce 0 is peeled so the primary hits get their mipmap LOD
        # (pixel footprint) without the trilinear gathers riding along in
        # the compiled loop body for every later bounce
        if self.n_bounces > 0:
            fp0 = None
            if self.has_textures:
                fp0 = common.primary_uv_footprint(
                    scene, st.width, st.height, d, its)
                if getattr(self.settings, "has_ewa", False):
                    fp0 = (fp0, common.primary_uv_jacobian(
                        scene, st.width, st.height, d, its))
            state = bounce(0, state, fp0)
            if self.ray_tally is not None:
                # fold the tally through the loop carry (common.drain_tally)
                state["rays"] = common.drain_tally(self)

                def bounce_counted(b, s):
                    rays = s.pop("rays")
                    s2 = bounce(b, s)
                    s2["rays"] = rays + common.drain_tally(self)
                    return s2

                state = jax.lax.fori_loop(1, self.n_bounces,
                                          bounce_counted, state)
                self.ray_tally.append(state.pop("rays"))
            else:
                state = jax.lax.fori_loop(1, self.n_bounces, bounce, state)

        # final emitter-hit pass for the vertex reached by the last bounce
        its = state["its"]
        wi_world = -state["d"]
        cos_front = m.dot(its.ns, wi_world)
        is_emitter = its.valid & (its.emitter_id >= 0) & (cos_front > 0)
        rad = scene.emitters.radiance[jnp.maximum(its.emitter_id, 0)]
        lum_pdf = em_ops.pdf_area_direct(
            scene, self.n_area, self.has_env, its.emitter_id,
            state["o"], its.p, its.ng, n_delta=self.n_delta)
        w_hit = jnp.where(state["last_delta"], 1.0,
                          mis_weight(state["last_pdf"], lum_pdf))
        L = state["L"] + jnp.where(
            (state["alive"] & is_emitter)[..., None],
            state["throughput"] * rad * w_hit[..., None], 0.0)
        if self.has_env:
            env_L = em_ops.eval_env(scene, self.env_kind, state["d"])
            env_pdf = em_ops.pdf_env_direct(
                scene, self.n_area, self.env_kind, state["d"],
                n_delta=self.n_delta)
            w_env = jnp.where(state["last_delta"], 1.0,
                              mis_weight(state["last_pdf"], env_pdf))
            L = L + jnp.where((state["alive"] & ~its.valid)[..., None],
                              state["throughput"] * env_L *
                              w_env[..., None], 0.0)
        return L

    # -- full frame -----------------------------------------------------------
    def samples_per_batch(self, n_samples):
        """Lanes per dispatch, targeting GDMT_LANES: 64k for small scenes
        and 1M for large ones, whose traversal has a larger fixed cost
        per call.  The defaults have not been re-derived for the GPU
        yet."""
        import os
        N = self.settings.width * self.settings.height
        large = getattr(self, "large_scene", False)  # cluster-path scene
        target = int(os.environ.get(
            "GDMT_LANES", str(1 << 20 if large else 1 << 16)))
        spb = max(1, target // max(N, 1))
        while n_samples % spb:
            spb -= 1
        return spb

    @functools.partial(jax.jit, static_argnums=(0, 4))
    def render_chunk(self, scene, seed, sample_start, n_samples):
        st = self.settings
        N = st.width * st.height
        spb = self.samples_per_batch(n_samples)
        fb = jnp.zeros((st.height, st.width, 3))
        wb = jnp.zeros((st.height, st.width))
        base_ids = jnp.arange(N, dtype=jnp.uint32)
        ids = jnp.tile(base_ids, spb)

        def body(i, carry):
            fb, wb, rays = carry
            if self.count_rays:
                self.ray_tally = []
            sidx = (sample_start + i * spb +
                    jnp.repeat(jnp.arange(spb, dtype=jnp.uint32), N))
            pos, L = self.trace_pass(scene, seed, sidx, pixel_id=ids)
            if self.count_rays:
                rays = rays + sum(self.ray_tally)
                self.ray_tally = None
            # samples are grid-aligned: dense filtered adds, no scatter
            jit = pos % 1.0
            fb, wb = film_ops.splat_grid(fb, wb, jit.reshape(spb, N, 2),
                                         L.reshape(spb, N, 3),
                                         self.filter_kind)
            return fb, wb, rays

        return jax.lax.fori_loop(0, n_samples // spb, body,
                                 (fb, wb, jnp.zeros(())))

    def finalize(self, state, spp):
        fb, wb = state["0"], state["1"]
        return fb / np.maximum(wb, 1e-12)[..., None]

    def render(self, scene, seed=0, spp=None, chunk=64,
               checkpoint_path=None, resume=False, progress=None):
        from ..parallel.checkpoint import render_accumulate
        spp = spp or self.settings.spp
        state, spp = render_accumulate(
            self, scene, seed, spp, chunk,
            checkpoint_path=checkpoint_path, resume=resume,
            progress=progress)
        if self.count_rays and "2" in state:
            self.last_ray_count = float(np.asarray(state["2"]))
        return self.finalize(state, spp)


def render(scene, settings, seed=0, spp=None):
    return PathTracer(scene, settings).render(scene, seed=seed, spp=spp)
