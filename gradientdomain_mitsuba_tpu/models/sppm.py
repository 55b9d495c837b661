"""Stochastic progressive photon mapping on a sorted hash grid.

Replacement for the reference's photon-mapping family
(src/integrators/photonmapper/{photonmapper,ppm,sppm}.cpp +
src/librender/photonmap.cpp): instead of a balanced kd-tree of photons
queried by per-thread kNN lookups, every pass

  1. traces one camera "visible point" per pixel through the specular
     chain (delta vertices continue, first storable vertex stops;
     emitter radiance along the chain accumulates directly),
  2. traces a fixed-size wavefront of photon random walks from the area
     emitters (adjoint BSDF sampling with the shading-normal correction),
  3. bins the deposited photons into a uniform hash grid with cell size
     equal to the CURRENT gather radius, sorts them by cell key (one
     device sort), and gathers each pixel's 27 neighbor cells with a
     fixed per-cell scan cap — branch-free fixed-shape work instead of
     pointer-chasing a kd-tree.

Radius schedule: the memoryless Knaus-Zwicker 2011 formulation of SPPM —
a GLOBAL per-pass radius with r2_{i+1} = r2_i (i+alpha)/(i+1) and the
final image the mean of independent per-pass estimates.  This replaces
the reference's per-pixel (N, M, tau) statistics with mathematically
equivalent convergence and no cross-pass state but the pass index
(deviation documented; alpha default 0.7 as in sppm.cpp).

`photonmapper` and `ppm` map to the same machinery (photonmapper = a few
passes at fixed radius, ppm = deterministic camera side re-used each
pass; both subsumed — the sppm estimator is strictly more general).

Photons are emitted from area emitters (uniform pick, area-uniform
position, cosine direction) and from point/spot/collimated delta
emitters; environment and directional photon emission (which need a
scene-bounding-disk source) are not implemented — such scenes should
use path/bdpt/gpt (documented deviation; directional photon power is
zeroed rather than emitted from a bogus origin).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m
from ..core import warp
from ..core.rng import DimAllocator as DA
from ..core.rng import make_sampler, random_bits
from ..ops import bsdf as bsdf_ops
from ..ops import common, emitter as em_ops
from ..ops import film as film_ops
from ..ops import sensor as sensor_ops
from .bdpt import _is_delta_kind
from .path import PathTracer

PHOTON_DIM_BASE = 16384   # rng dims for the photon stream
CAM_DIM_BASE = 0          # camera pass reuses the standard layout


class SPPMTracer(PathTracer):
    """Progressive photon mapper.  integrator_props:
      photonCount   photons per pass               (default 1 << 16)
      initialRadius starting gather radius (0 = auto from scene extent)
      alpha         radius-shrink exponent          (default 0.7)
      gatherCap     per-cell scan bound             (default 32)
      maxDepth / rrDepth as usual."""

    def __init__(self, scene, settings):
        super().__init__(scene, settings)
        props = settings.integrator_props
        self.n_photons = int(props.get("photonCount", 1 << 16))
        self.alpha = float(props.get("alpha", 0.7))
        self.gather_cap = int(props.get("gatherCap", 32))
        r0 = float(props.get("initialRadius", 0.0))
        if r0 <= 0.0:
            extent = float(np.asarray(scene.ray_eps)) / 1e-4
            r0 = extent * 5.0 / max(settings.width, settings.height)
        self.r0 = r0
        self.photon_depth = (settings.max_depth if settings.max_depth > 0
                             else 8)
        self.cam_chain = self.photon_depth

    # ---------------- camera pass -----------------------------------------
    def _visible_points(self, scene, seed, pass_idx, pixel_id):
        st = self.settings
        W, H = st.width, st.height
        N = pixel_id.shape[0]
        eps = scene.ray_eps
        px = (pixel_id % W).astype(jnp.float32)
        py = (pixel_id // W).astype(jnp.float32)
        jitter = self._u2(seed, pixel_id, pass_idx, DA.PIXEL_JITTER)
        pos_film = jnp.stack([px, py], -1) + jitter
        u_ap = self._u2(seed, pixel_id, pass_idx, DA.APERTURE)
        o, d = sensor_ops.sample_ray(scene.camera, W, H, pos_film, u_ap)

        L = jnp.zeros((N, 3))
        tp = jnp.ones((N, 3))
        alive = jnp.ones(N, bool)
        stored = jnp.zeros(N, bool)
        vp_p = jnp.zeros((N, 3))
        vp_ns = jnp.zeros((N, 3))
        vp_ng = jnp.zeros((N, 3))
        vp_wi = jnp.zeros((N, 3))
        vp_bsdf = jnp.full(N, -1, jnp.int32)
        vp_uv = jnp.zeros((N, 2))
        vp_tp = jnp.zeros((N, 3))

        for b in range(self.cam_chain):
            hit = self.closest(o, d, jnp.zeros(N),
                               jnp.where(alive, 3e38, -1.0), scene.geom)
            its = common.fill_intersection(scene, o, d, hit)
            wi_world = -d
            cos_front = m.dot(its.ns, wi_world)
            is_em = its.valid & (its.emitter_id >= 0) & (cos_front > 0)
            rad = scene.emitters.radiance[jnp.maximum(its.emitter_id, 0)]
            L = L + jnp.where((alive & is_em)[..., None], tp * rad, 0.0)
            if self.has_env:
                env_L = em_ops.eval_env(scene, self.env_kind, d)
                L = L + jnp.where((alive & ~its.valid)[..., None],
                                  tp * env_L, 0.0)
            alive = alive & its.valid

            storable = alive & ~_is_delta_kind(scene.materials,
                                               its.bsdf_id)
            newly = storable & ~stored
            vp_p = jnp.where(newly[..., None], its.p, vp_p)
            vp_ns = jnp.where(newly[..., None], its.ns, vp_ns)
            vp_ng = jnp.where(newly[..., None], its.ng, vp_ng)
            vp_wi = jnp.where(newly[..., None], wi_world, vp_wi)
            vp_bsdf = jnp.where(newly, its.bsdf_id, vp_bsdf)
            vp_uv = jnp.where(newly[..., None], its.uv, vp_uv)
            vp_tp = jnp.where(newly[..., None], tp, vp_tp)
            stored = stored | storable
            alive = alive & ~storable   # chain stops at the store

            # delta continuation
            ss, ts = m.build_frame(its.ns)
            wi = m.to_local(wi_world, ss, ts, its.ns)
            par = common.material_params(scene, self.has_textures,
                                         its.bsdf_id, its.uv,
                                         bary=its.bary)
            u2 = self._u2(seed, pixel_id, pass_idx,
                          DA.bounce_dim(b, DA.D_BSDF_UV))
            uc = self._u1(seed, pixel_id, pass_idx,
                          DA.bounce_dim(b, DA.D_BSDF_COMPONENT))
            bs = self._bsample(par, wi, u2, uc)
            alive = alive & bs.valid
            tp = jnp.where(alive[..., None], tp * bs.weight, tp)
            d = m.to_world(bs.wo, ss, ts, its.ns)
            o = common.offset_ray_origin(its.p, its.ng, d, eps)

        return pos_film, L, dict(p=vp_p, ns=vp_ns, ng=vp_ng, wi=vp_wi,
                                 bsdf=vp_bsdf, uv=vp_uv, tp=vp_tp,
                                 valid=stored)

    # ---------------- photon pass -----------------------------------------
    def _emit_photons(self, scene, seed, pass_idx):
        """One photon wavefront: returns flat arrays of deposits
        (pos, power, dir, valid) of length P * photon_depth."""
        P = self.n_photons
        em = scene.emitters
        ids = jnp.arange(P, dtype=jnp.uint32)
        eps = scene.ray_eps
        u1 = functools.partial(self._u1, seed, ids, pass_idx)
        u2 = functools.partial(self._u2, seed, ids, pass_idx)

        n_area = max(self.n_area, 1)
        n_delta = self.n_delta
        n_lights = n_area if self.n_area > 0 else 0
        total_lights = max(n_lights + n_delta, 1)

        u_sel = u1(PHOTON_DIM_BASE)
        pick = jnp.minimum((u_sel * total_lights).astype(jnp.int32),
                           total_lights - 1)
        is_area = pick < n_lights

        # --- area emitter start (uniform area, cosine direction) ----------
        e = jnp.clip(pick, 0, max(n_area - 1, 0))
        u_res = jnp.clip(u_sel * total_lights - pick, 0.0, 1.0)
        off = em.tri_offset[e]
        cnt = em.tri_count[e]
        flat = em_ops._searchsorted_segment(em.tri_cdf, off,
                                            off + cnt - 1, u_res)
        pos0, ng0 = em_ops.sample_emitter_triangle(
            scene, flat, u2(PHOTON_DIM_BASE + 1))
        d_local = warp.square_to_cosine_hemisphere(u2(PHOTON_DIM_BASE + 3))
        ss0, ts0 = m.build_frame(ng0)
        d0_area = m.to_world(d_local, ss0, ts0, ng0)
        rad = em.radiance[e]
        # power = Le cos / (pick * pos * dir pdfs) = pi A Le total_lights
        beta_area = (rad * jnp.pi * em.total_area[e][..., None] *
                     total_lights)

        # --- delta emitter start (point/spot) ------------------------------
        if n_delta > 0:
            de = jnp.clip(pick - n_lights, 0, n_delta - 1)
            dkind = em.delta_kind[de]
            dpos = em.delta_pos[de]
            ddir = em.delta_dir[de]
            dint = em.delta_intensity[de]
            sph = warp.square_to_uniform_sphere(u2(PHOTON_DIM_BASE + 5))
            # spot: cone sampling around the axis
            cos_total = em.delta_cos_total[de]
            cone = warp.square_to_uniform_cone(u2(PHOTON_DIM_BASE + 5),
                                               cos_total)
            ssd, tsd = m.build_frame(ddir)
            cone_w = m.to_world(cone, ssd, tsd, ddir)
            is_spot = dkind == 1
            d0_delta = jnp.where(is_spot[..., None], cone_w, sph)
            pdf_delta = jnp.where(
                is_spot, warp.square_to_uniform_cone_pdf(cos_total),
                warp.square_to_uniform_sphere_pdf())
            # collimated beam (kind 3): fixed direction, unit pdf —
            # photon power is the beam power itself
            is_coll = dkind == 3
            d0_delta = jnp.where(is_coll[..., None], ddir, d0_delta)
            pdf_delta = jnp.where(is_coll, 1.0, pdf_delta)
            # spot falloff factor at the sampled direction
            cos_d = m.dot(d0_delta, ddir)
            cos_fall = em.delta_cos_falloff[de]
            t = jnp.clip((cos_d - cos_total) /
                         jnp.maximum(cos_fall - cos_total, 1e-6), 0.0, 1.0)
            spot_fac = jnp.where(is_spot, t, 1.0)
            beta_delta = (dint * (spot_fac / jnp.maximum(pdf_delta, 1e-12)
                                  )[..., None] * total_lights)
            # directional emitters need scene-bounding-disk emission
            # (not implemented — see module docstring); zero their power
            # rather than emit from a bogus origin
            beta_delta = jnp.where((dkind == 2)[..., None], 0.0,
                                   beta_delta)
            pos0 = jnp.where(is_area[..., None], pos0, dpos)
            d0 = jnp.where(is_area[..., None], d0_area, d0_delta)
            beta = jnp.where(is_area[..., None], beta_area, beta_delta)
            ng0 = jnp.where(is_area[..., None], ng0, d0_delta)
        else:
            d0, beta = d0_area, beta_area

        o = common.offset_ray_origin(pos0, ng0, d0, eps)
        d = d0
        alive = jnp.ones(P, bool) if (self.n_area > 0 or n_delta > 0) \
            else jnp.zeros(P, bool)
        beta = jnp.where(alive[..., None], beta, 0.0)

        Kd = self.photon_depth
        ph_pos = jnp.zeros((Kd, P, 3))
        ph_pow = jnp.zeros((Kd, P, 3))
        ph_dir = jnp.zeros((Kd, P, 3))
        ph_ok = jnp.zeros((Kd, P), bool)

        for k in range(Kd):
            hit = self.closest(o, d, jnp.zeros(P),
                               jnp.where(alive, 3e38, -1.0), scene.geom)
            its = common.fill_intersection(scene, o, d, hit)
            alive = alive & its.valid
            storable = alive & ~_is_delta_kind(scene.materials,
                                               its.bsdf_id)
            ph_pos = ph_pos.at[k].set(its.p)
            ph_pow = ph_pow.at[k].set(beta)
            ph_dir = ph_dir.at[k].set(d)
            ph_ok = ph_ok.at[k].set(storable)

            ss, ts = m.build_frame(its.ns)
            wi = m.to_local(-d, ss, ts, its.ns)
            par = common.material_params(scene, self.has_textures,
                                         its.bsdf_id, its.uv,
                                         bary=its.bary)
            u2k = u2(PHOTON_DIM_BASE + 8 + 8 * k)
            uck = u1(PHOTON_DIM_BASE + 8 + 8 * k + 2)
            urr = u1(PHOTON_DIM_BASE + 8 + 8 * k + 3)
            bs = self._bsample(par, wi, u2k, uck)
            wo_w = m.to_world(bs.wo, ss, ts, its.ns)
            # adjoint (importance-transport) shading-normal correction
            num = (jnp.abs(m.dot(wo_w, its.ns)) * jnp.abs(m.dot(d, its.ng)))
            den = (jnp.abs(m.dot(wo_w, its.ng)) * jnp.abs(m.dot(d, its.ns)))
            corr = jnp.where(den > 1e-9, num / jnp.maximum(den, 1e-9), 0.0)
            alive = alive & bs.valid
            beta = jnp.where(alive[..., None],
                             beta * bs.weight * corr[..., None], beta)
            # photon RR (keep power bounded; start after 3 bounces)
            if k >= 3:
                q = jnp.clip(jnp.max(bs.weight, -1), 0.05, 0.95)
                survive = urr < q
                beta = jnp.where((alive & survive)[..., None],
                                 beta / q[..., None], beta)
                alive = alive & survive
            d = wo_w
            o = common.offset_ray_origin(its.p, its.ng, d, eps)

        flat = lambda a: a.reshape((-1,) + a.shape[2:])
        return (flat(ph_pos), flat(ph_pow), flat(ph_dir), flat(ph_ok))

    # ---------------- hash-grid gather ------------------------------------
    @staticmethod
    def _cell_hash(q):
        """uint32 hash of int32 [..., 3] cell coords."""
        h = (q[..., 0].astype(jnp.uint32) * np.uint32(73856093) ^
             q[..., 1].astype(jnp.uint32) * np.uint32(19349663) ^
             q[..., 2].astype(jnp.uint32) * np.uint32(83492791))
        return h

    def _gather(self, scene, vp, photons, r):
        """Sum photon contributions within radius r of each visible
        point via 27-cell scans of the sorted hash grid."""
        pos, power, pdir, ok = photons
        M = pos.shape[0]
        inv_r = 1.0 / r
        q_ph = jnp.floor(pos * inv_r).astype(jnp.int32)
        key = jnp.where(ok, self._cell_hash(q_ph),
                        jnp.uint32(0xFFFFFFFF))
        order = jnp.argsort(key)
        key_s = key[order]
        pos_s = pos[order]
        pow_s = power[order]
        dir_s = pdir[order]

        N = vp["p"].shape[0]
        K = self.gather_cap
        q_vp = jnp.floor(vp["p"] * inv_r).astype(jnp.int32)
        params = common.material_params(scene, self.has_textures,
                                        vp["bsdf"], vp["uv"])
        ssv, tsv = m.build_frame(vp["ns"])
        wi_loc = m.to_local(vp["wi"], ssv, tsv, vp["ns"])

        params_bc = jax.tree.map(
            lambda a: (jnp.broadcast_to(a[:, None],
                                        (N, K) + a.shape[1:])
                       if a is not None else None), params,
            is_leaf=lambda x: x is None)
        wi_bc = jnp.broadcast_to(wi_loc[:, None], (N, K, 3))

        acc = jnp.zeros((N, 3))
        kk = jnp.arange(K)
        for ox in (-1, 0, 1):
            for oy in (-1, 0, 1):
                for oz in (-1, 0, 1):
                    off = jnp.asarray([ox, oy, oz], jnp.int32)
                    h = self._cell_hash(q_vp + off)
                    start = jnp.searchsorted(key_s, h)
                    idx = jnp.clip(start[:, None] + kk[None, :], 0, M - 1)
                    match = key_s[idx] == h[:, None]
                    pp = pos_s[idx]
                    d2 = m.squared_length(pp - vp["p"][:, None])
                    sel = match & (d2 < r * r)
                    wi_ph = -dir_s[idx]
                    wi_ph_loc = m.to_local(
                        wi_ph, ssv[:, None], tsv[:, None],
                        vp["ns"][:, None])
                    # photon must arrive in the camera-side hemisphere
                    sel = sel & (wi_ph_loc[..., 2] * wi_loc[..., 2][:, None]
                                 > 0)
                    f_cos = bsdf_ops.eval(params_bc, wi_bc, wi_ph_loc,
                                          self.kinds)
                    f = f_cos / jnp.maximum(
                        jnp.abs(wi_ph_loc[..., 2]), 0.05)[..., None]
                    acc = acc + jnp.sum(
                        jnp.where(sel[..., None], f * pow_s[idx], 0.0), 1)

        scale = 1.0 / (jnp.pi * r * r * self.n_photons)
        L_ph = vp["tp"] * acc * scale
        return jnp.where(vp["valid"][..., None], L_ph, 0.0)

    # ---------------- per-pass + progressive loop --------------------------
    @functools.partial(jax.jit, static_argnums=(0,))
    def _one_pass(self, scene, seed, pass_idx, r):
        st = self.settings
        N = st.width * st.height
        pixel_id = jnp.arange(N, dtype=jnp.uint32)
        pos_film, L_direct, vp = self._visible_points(scene, seed,
                                                      pass_idx, pixel_id)
        photons = self._emit_photons(scene, seed, pass_idx)
        L = L_direct + self._gather(scene, vp, photons, r)
        fb = jnp.zeros((st.height, st.width, 3))
        wb = jnp.zeros((st.height, st.width))
        jit = pos_film % 1.0
        fb, wb = film_ops.splat_grid(fb, wb, jit[None], L[None],
                                     self.filter_kind)
        return fb, wb

    def render(self, scene, seed=0, spp=None, progress=None, **_):
        """spp = number of SPPM passes (each: 1 camera sample/pixel +
        one photon wavefront)."""
        st = self.settings
        spp = spp or st.spp
        fb_acc = None
        wb_acc = None
        r2 = self.r0 * self.r0
        for i in range(spp):
            fb, wb = self._one_pass(scene, seed, jnp.uint32(i),
                                    jnp.float32(np.sqrt(r2)))
            fb_acc = fb if fb_acc is None else fb_acc + fb
            wb_acc = wb if wb_acc is None else wb_acc + wb
            r2 = r2 * (i + 1 + self.alpha) / (i + 2)
            if progress:
                progress(i + 1, spp)
        self.last_radius = float(np.sqrt(r2))
        return np.asarray(fb_acc) / np.maximum(
            np.asarray(wb_acc), 1e-12)[..., None]


def render(scene, settings, seed=0, spp=None):
    return SPPMTracer(scene, settings).render(scene, seed=seed, spp=spp)
