"""Wavefront volumetric path tracer (homogeneous + heterogeneous media).

Replacement for the `volpath` / `volpath_simple` integrators
(src/integrators/volpath/volpath{,_simple}.cpp): the surface path loop of
models/path.py extended with per-lane medium tracking, free-flight
distance sampling, phase-function scattering, and attenuated shadow rays
that walk through index-matched (null-BSDF) boundaries.  Both reference
names map to this one tracer (it always applies full NEE+MIS, i.e. the
`volpath` estimator; `volpath_simple`'s reduced MIS is subsumed).

Heterogeneous (density-grid) media switch the free-flight sample to
spectral delta tracking and transmittances to ratio tracking against
the per-medium majorant (ops/medium.py) — the wavefront analog of
heterogeneous.cpp's Woodcock tracking, with a bounded per-segment step
budget (`trackingSteps`, default 64) so every lane stays lockstep.

Wavefront semantics per loop iteration (all lanes in lockstep):
  1. free-flight sample in the lane's current medium, bounded by the
     surface hit:  medium event  ->  phase NEE + phase sampling;
  2. otherwise the surface event: emitter-hit MIS, then null boundaries
     pass through (medium transition, depth NOT incremented — Mitsuba's
     index-matched semantics), real surfaces shade exactly like path.py.

Depth is a PER-LANE counter (null crossings don't consume depth), so the
loop runs max_depth + NULL_SLACK iterations.  MIS bookkeeping (last_pdf /
last real vertex origin) is preserved across null crossings so
emitter-hit weights match the NEE pdfs of the last real vertex.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m
from ..core.rng import DimAllocator as DA
from ..ops import common, emitter as em_ops
from ..ops import medium as med_ops
from ..scene.materials import NULL_BSDF
from .path import PathTracer, mis_weight

MAX_BOUNCES_UNLIMITED = 40
NULL_SLACK = 4          # extra loop iterations to absorb null crossings
MEDIA_DIM_BASE = 8192   # rng dim offset for the media sample stream
TRACK_DIM_BASE = 32768  # free-flight delta-tracking steps
SHADOW_TRACK_DIM_BASE = 49152   # ratio-tracking shadow segments
FINAL_TRACK_DIM_BASE = 61440    # last-segment transmittance


def _media_dim(bounce, which):
    return MEDIA_DIM_BASE + bounce * 4 + which


D_MED_CHANNEL = 0   # 1 dim: spectral channel for free-flight sampling
D_MED_DIST = 1      # 1 dim: exponential distance
D_PHASE_UV = 2      # 2 dims: phase direction


class VolPathTracer(PathTracer):
    """Volumetric wavefront tracer; reuses PathTracer's film/render/
    checkpoint plumbing and replaces trace_rays."""

    def __init__(self, scene, settings):
        super().__init__(scene, settings)
        self.max_null_crossings = int(
            settings.integrator_props.get("maxNullCrossings", 2))
        self.sensor_medium = int(getattr(settings, "sensor_medium", -1))
        # heterogeneous media: delta/ratio tracking with a bounded step
        # budget per segment (the `trackingSteps` knob; expected steps =
        # majorant optical depth of the segment)
        self.has_het = bool(getattr(settings, "has_het_media", False))
        # gridvolume-driven microflake orientation fields: STATIC flag so
        # scenes without them compile no vector-grid lookups
        self.has_orient = bool(
            (np.asarray(scene.media.orient_offset) >= 0).any())
        self.track_steps = int(
            settings.integrator_props.get("trackingSteps", 64))
        # the loop must out-run per-lane depth + null crossings
        self.n_iters = self.n_bounces + NULL_SLACK

    # -- attenuated shadow rays --------------------------------------------
    def _attenuated_tr(self, scene, o, d, dist, medium, active,
                       rng=None, bounce=0):
        """Transmittance along (o, d, dist): walks through up to
        max_null_crossings null boundaries, accumulating each segment's
        transmittance (analytic for homogeneous lanes, ratio tracking
        for density-grid lanes); any other surface blocks (returns 0).
        Mirrors Scene::evalTransmittance + attenuated emitter sampling
        (src/librender/scene.cpp sampleAttenuatedEmitterDirect)."""
        N = o.shape[0]
        eps = scene.ray_eps
        kind_tab = scene.materials.kind
        tr = jnp.ones((N, 3))
        cur_o = o
        remaining = dist
        cur_med = medium
        walking = active
        for c in range(self.max_null_crossings + 1):
            hit = self.closest(cur_o, d, jnp.zeros(N),
                               jnp.where(walking, remaining, -1.0),
                               scene.geom)
            seg = jnp.where(hit.valid, hit.t, remaining)
            _, sigma_t, _, _, _ = med_ops.gather(scene.media, cur_med)
            if self.has_het and rng is not None:
                seed_r, pid_r, sidx_r = rng
                K = self.track_steps
                base = (SHADOW_TRACK_DIM_BASE +
                        (bounce * (self.max_null_crossings + 1) + c) *
                        2 * K)

                def u_trk(k, _base=base):
                    return self._u2(seed_r, pid_r, sidx_r, _base + 2 * k)
                tr_seg = med_ops.transmittance_tracking(
                    scene.media, cur_med, cur_o, d, seg, u_trk, K)
            else:
                tr_seg = med_ops.transmittance(sigma_t, seg)
            tr = jnp.where(walking[..., None], tr * tr_seg, tr)
            its = common.fill_intersection(scene, cur_o, d, hit)
            k = kind_tab[jnp.maximum(its.bsdf_id, 0)]
            is_null = hit.valid & (its.bsdf_id >= 0) & (k == NULL_BSDF)
            blocked = walking & hit.valid & ~is_null
            tr = jnp.where(blocked[..., None], 0.0, tr)
            # pass through the null boundary: medium transition
            sid = jnp.maximum(its.shape_id, 0)
            trans = ((scene.geom.shape_interior[sid] >= 0) |
                     (scene.geom.shape_exterior[sid] >= 0))
            entering = m.dot(d, its.ng) < 0
            new_med = jnp.where(entering, scene.geom.shape_interior[sid],
                                scene.geom.shape_exterior[sid])
            cur_med = jnp.where(walking & is_null & trans, new_med, cur_med)
            cur_o = common.offset_ray_origin(its.p, its.ng, d, eps)
            remaining = jnp.maximum(remaining - seg - eps, 0.0)
            walking = walking & is_null & (remaining > 0)
        # crossings budget exhausted with boundaries left: conservative 0
        return jnp.where(walking[..., None], 0.0, tr)

    # -- the volumetric loop ------------------------------------------------
    def trace_rays(self, scene, seed, sample_idx, pixel_id, o, d):
        st = self.settings
        N = o.shape[0]
        eps = scene.ray_eps
        inf = jnp.full(N, 3e38)
        kind_tab = scene.materials.kind
        g = scene.geom

        hit = self.closest(o, d, jnp.zeros(N), inf, scene.geom)
        its = common.fill_intersection(scene, o, d, hit)

        state = dict(
            o=o, d=d, its=its,
            L=jnp.zeros((N, 3)),
            throughput=jnp.ones((N, 3)),
            eta=jnp.ones(N),
            alive=jnp.ones(N, bool),
            last_pdf=jnp.zeros(N),
            last_delta=jnp.ones(N, bool),
            last_vtx=o,                       # origin of the MIS segment
            medium=jnp.full(N, self.sensor_medium, jnp.int32),
            depth=jnp.zeros(N, jnp.int32),    # depth of last REAL vertex
        )

        u1 = self._u1
        u2 = self._u2

        def step(b, s):
            its = s["its"]
            alive = s["alive"]
            tp = s["throughput"]
            L = s["L"]
            cur_med = s["medium"]
            depth_prev = s["depth"]
            cur_depth = depth_prev + 1   # depth if this event is real

            # ---- free flight in the current medium ------------------------
            t_surf = jnp.where(its.valid, its.t, inf)
            sigma_s, sigma_t, ph_kind, ph_g, ph_flake = med_ops.gather(
                scene.media, cur_med)
            if self.has_het:
                K = self.track_steps

                def u_trk(k, _b=b):
                    return u2(seed, pixel_id, sample_idx,
                              TRACK_DIM_BASE + _b * 2 * K + 2 * k)
                ds_med = med_ops.sample_distance_tracking(
                    scene.media, cur_med, s["o"], s["d"], t_surf,
                    u_trk, K)
            else:
                uch = u1(seed, pixel_id, sample_idx,
                         _media_dim(b, D_MED_CHANNEL))
                udist = u1(seed, pixel_id, sample_idx,
                           _media_dim(b, D_MED_DIST))
                ds_med = med_ops.sample_distance(sigma_s, sigma_t, uch,
                                                 udist, t_surf)
            med_event = alive & ds_med.scattered
            tp = jnp.where(alive[..., None], tp * ds_med.weight, tp)

            # ================= MEDIUM EVENT branch =========================
            p_med = s["o"] + ds_med.t[..., None] * s["d"]
            wi_world = -s["d"]
            if self.has_orient:
                # spatially-varying microflake fiber axis at the scatter
                # point (gridvolume orientation field)
                ph_flake = med_ops.flake_at(scene.media, cur_med, p_med)

            # phase NEE
            u_sel = u1(seed, pixel_id, sample_idx,
                       DA.bounce_dim(b, DA.D_LIGHT_SELECT))
            u_pos = u2(seed, pixel_id, sample_idx,
                       DA.bounce_dim(b, DA.D_LIGHT_UV))
            # one shared emitter sample serves both branches (medium point
            # vs surface point) — evaluate at the blended position
            vtx = jnp.where(med_event[..., None], p_med, its.p)
            ds = em_ops.sample_direct(scene, self.n_area, self.env_kind,
                                      vtx, u_sel, u_pos,
                                      n_delta=self.n_delta)

            ph_f = med_ops.phase_eval(ph_kind, ph_g, wi_world, ds.d,
                                      ph_flake)
            w_nee_med = jnp.where(ds.is_delta, 1.0,
                                  mis_weight(ds.pdf, ph_f))

            # ================= SURFACE EVENT branch ========================
            cos_front = m.dot(its.ns, wi_world)
            is_emitter = its.valid & (its.emitter_id >= 0) & (cos_front > 0)
            rad = scene.emitters.radiance[jnp.maximum(its.emitter_id, 0)]
            lum_pdf = em_ops.pdf_area_direct(
                scene, self.n_area, self.has_env, its.emitter_id,
                s["last_vtx"], its.p, its.ng, n_delta=self.n_delta)
            w_hit = jnp.where(s["last_delta"], 1.0,
                              mis_weight(s["last_pdf"], lum_pdf))
            surf_event = alive & ~med_event
            L = L + jnp.where((surf_event & is_emitter)[..., None],
                              tp * rad * w_hit[..., None], 0.0)
            if self.has_env:
                env_L = em_ops.eval_env(scene, self.env_kind, s["d"])
                env_pdf = em_ops.pdf_env_direct(
                    scene, self.n_area, self.env_kind, s["d"],
                    n_delta=self.n_delta)
                w_env = jnp.where(s["last_delta"], 1.0,
                                  mis_weight(s["last_pdf"], env_pdf))
                L = L + jnp.where((surf_event & ~its.valid)[..., None],
                                  tp * env_L * w_env[..., None], 0.0)

            k_here = kind_tab[jnp.maximum(its.bsdf_id, 0)]
            is_null = its.valid & (its.bsdf_id >= 0) & (k_here == NULL_BSDF)
            real_surf = surf_event & its.valid & ~is_null
            null_surf = surf_event & is_null

            # depth bookkeeping + maxDepth cut
            is_real_vtx = med_event | real_surf
            if st.max_depth > 0:
                over = cur_depth >= st.max_depth
                # the CURRENT vertex may still receive emitter radiance at
                # depth == max_depth (handled above); continuation stops
                cont_ok = ~(is_real_vtx & over)
            else:
                cont_ok = jnp.ones(N, bool)
            alive = alive & (med_event | null_surf | real_surf) & cont_ok

            # ---- surface shading (as in path.py) --------------------------
            ss_f, ts_f = m.build_frame(its.ns)
            wi = m.to_local(wi_world, ss_f, ts_f, its.ns)
            params = common.material_params(
                scene, self.has_textures, its.bsdf_id, its.uv,
                bary=its.bary)
            wo_l = m.to_local(ds.d, ss_f, ts_f, its.ns)
            f_l = self._beval(params, wi, wo_l)
            pdf_b = self._bpdf(params, wi, wo_l)
            w_nee_surf = jnp.where(ds.is_delta, 1.0,
                                   mis_weight(ds.pdf, pdf_b))

            # ---- shared attenuated shadow ray ----------------------------
            nee_possible = (med_event | real_surf) & ds.valid & (ds.pdf > 0)
            sh_o = jnp.where(med_event[..., None], p_med,
                             common.offset_ray_origin(its.p, its.ng, ds.d,
                                                      eps))
            sh_dist = ds.dist - 2.0 * eps / jnp.maximum(
                jnp.abs(m.dot(ds.d, ds.n)), 1e-3)
            # starting medium of the shadow segment
            sid = jnp.maximum(its.shape_id, 0)
            trans = ((g.shape_interior[sid] >= 0) |
                     (g.shape_exterior[sid] >= 0))
            sh_exit_out = m.dot(ds.d, its.ng) > 0
            sh_med_surf = jnp.where(
                trans,
                jnp.where(sh_exit_out, g.shape_exterior[sid],
                          g.shape_interior[sid]),
                cur_med)
            sh_med = jnp.where(med_event, cur_med, sh_med_surf)
            if self.settings.has_media:
                tr_sh = self._attenuated_tr(
                    scene, sh_o, ds.d, sh_dist, sh_med, nee_possible,
                    rng=(seed, pixel_id, sample_idx), bounce=b)
            else:
                occl = self.occluded(sh_o, ds.d, jnp.zeros(N), sh_dist,
                                     scene.geom)
                tr_sh = jnp.where(occl[..., None], 0.0,
                                  jnp.ones((N, 3)))

            f_nee = jnp.where(med_event[..., None],
                              (ph_f * w_nee_med)[..., None] *
                              jnp.ones((N, 3)),
                              f_l * w_nee_surf[..., None])
            contrib = tp * f_nee * ds.radiance * tr_sh / jnp.maximum(
                ds.pdf, 1e-30)[..., None]
            L = L + jnp.where(nee_possible[..., None], contrib, 0.0)

            # ---- continuation direction -----------------------------------
            u_bs = u2(seed, pixel_id, sample_idx,
                      DA.bounce_dim(b, DA.D_BSDF_UV))
            u_bc = u1(seed, pixel_id, sample_idx,
                      DA.bounce_dim(b, DA.D_BSDF_COMPONENT))
            bs = self._bsample(params, wi, u_bs, u_bc)
            u_ph = u2(seed, pixel_id, sample_idx, _media_dim(b, D_PHASE_UV))
            wo_phase, phase_pdf = med_ops.phase_sample(ph_kind, ph_g,
                                                       wi_world, u_ph,
                                                       ph_flake)

            wo_world_s = m.to_world(bs.wo, ss_f, ts_f, its.ns)
            new_d = jnp.where(med_event[..., None], wo_phase, wo_world_s)
            new_o = jnp.where(
                med_event[..., None], p_med,
                common.offset_ray_origin(its.p, its.ng,
                                         jnp.where(surf_event[..., None],
                                                   wo_world_s, s["d"]),
                                         eps))

            surf_ok = jnp.where(real_surf, bs.valid, True)
            alive = alive & surf_ok
            tp = jnp.where((alive & real_surf)[..., None],
                           tp * bs.weight, tp)
            eta = jnp.where(alive & real_surf, s["eta"] * bs.eta, s["eta"])

            # medium transition on the main ray: null pass-through keeps
            # the old direction; real transmission crosses when the new
            # direction leaves through the back side
            crossed = m.dot(new_d, its.ng) * m.dot(wi_world, its.ng) < 0
            new_med_side = jnp.where(m.dot(new_d, its.ng) < 0,
                                     g.shape_interior[sid],
                                     g.shape_exterior[sid])
            switch = surf_event & its.valid & trans & (is_null | crossed)
            new_med = jnp.where(switch, new_med_side, cur_med)

            # MIS bookkeeping: null crossings PRESERVE the last real
            # vertex's pdf/origin
            last_pdf = jnp.where(med_event, phase_pdf,
                                 jnp.where(real_surf, bs.pdf,
                                           s["last_pdf"]))
            last_delta = jnp.where(med_event, jnp.zeros(N, bool),
                                   jnp.where(real_surf, bs.is_delta,
                                             s["last_delta"]))
            last_vtx = jnp.where((med_event | real_surf)[..., None],
                                 jnp.where(med_event[..., None], p_med,
                                           its.p),
                                 s["last_vtx"])
            depth = jnp.where(is_real_vtx, cur_depth, depth_prev)

            # ---- russian roulette (real vertices only) --------------------
            u_rr = u1(seed, pixel_id, sample_idx,
                      DA.bounce_dim(b, DA.D_RR))
            q = jnp.minimum(jnp.max(tp, -1) * eta * eta, 0.95)
            do_rr = is_real_vtx & (cur_depth >= st.rr_depth)
            survive = jnp.where(do_rr, u_rr < q, True)
            tp = jnp.where((do_rr & alive)[..., None],
                           tp / jnp.maximum(q, 1e-9)[..., None], tp)
            alive = alive & survive & (jnp.max(tp, -1) > 0)

            # ---- next intersection ----------------------------------------
            hit = self.closest(new_o, new_d, jnp.zeros(N),
                               jnp.where(alive, 3e38, -1.0),
                               scene.geom)
            its_new = common.fill_intersection(scene, new_o, new_d, hit)

            return dict(o=new_o, d=new_d, its=its_new, L=L,
                        throughput=tp, eta=eta, alive=alive,
                        last_pdf=last_pdf, last_delta=last_delta,
                        last_vtx=last_vtx, medium=new_med, depth=depth)

        if self.n_iters > 0:
            if self.ray_tally is not None:
                # fold the tally through the loop carry (common.drain_tally)
                state["rays"] = common.drain_tally(self)

                def step_counted(b, s):
                    rays = s.pop("rays")
                    s2 = step(b, s)
                    s2["rays"] = rays + common.drain_tally(self)
                    return s2

                state = jax.lax.fori_loop(0, self.n_iters, step_counted,
                                          state)
                self.ray_tally.append(state.pop("rays"))
            else:
                state = jax.lax.fori_loop(0, self.n_iters, step, state)

        # final emitter-hit pass for the last reached vertex.  The loop
        # body applies the last segment's transmittance via free-flight
        # weights; here the segment is evaluated deterministically:
        if self.settings.has_media:
            _, sigma_t_f, _, _, _ = med_ops.gather(scene.media,
                                                   state["medium"])
            t_last = jnp.where(state["its"].valid, state["its"].t, 3e38)
            if self.has_het:
                K = self.track_steps

                def u_fin(k):
                    return self._u2(seed, pixel_id, sample_idx,
                                    FINAL_TRACK_DIM_BASE + 2 * k)
                tr_f = med_ops.transmittance_tracking(
                    scene.media, state["medium"], state["o"],
                    state["d"], t_last, u_fin, K)
            else:
                tr_f = med_ops.transmittance(sigma_t_f, t_last)
            state["throughput"] = state["throughput"] * tr_f
        its = state["its"]
        wi_world = -state["d"]
        cos_front = m.dot(its.ns, wi_world)
        is_emitter = its.valid & (its.emitter_id >= 0) & (cos_front > 0)
        rad = scene.emitters.radiance[jnp.maximum(its.emitter_id, 0)]
        lum_pdf = em_ops.pdf_area_direct(
            scene, self.n_area, self.has_env, its.emitter_id,
            state["last_vtx"], its.p, its.ng, n_delta=self.n_delta)
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


def render(scene, settings, seed=0, spp=None):
    return VolPathTracer(scene, settings).render(scene, seed=seed, spp=spp)
