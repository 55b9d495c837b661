"""Bidirectional path tracing (BDPT) with full multiple importance sampling.

Replacement for the bdpt integrator + libbidir path machinery
(src/integrators/bdpt/bdpt.cpp, src/libbidir/{path,vertex,edge}.cpp):
instead of per-thread vertex memory pools and recursive random walks, both
subpaths live in fixed-shape SoA tensors

    eye   vertices z_1..z_TE     -> arrays [N, TE, ...]   (z_0 = camera)
    light vertices y_1..y_{SM-1} -> arrays [N, SM-1, ...] (y_0 separate)

filled by a bounded random walk; every connection strategy (s,t) is one
vectorized kernel over all N pixel samples with one shadow-ray batch — the
O((s+t)^2) strategy loop is a static Python loop unrolled into the XLA
program.

Conventions (standard Veach formulation, pbrt-style bookkeeping; Mitsuba's
libbidir is semantically equivalent):
  - pdf_fwd / pdf_rev are AREA-measure densities; delta events store 0 and
    remap to 1 inside MIS ratios (remap0);
  - MIS: power heuristic beta=2 over all strategies of equal path length;
    strategy (s=1,t=1) is skipped (covered by (0,2)), s+t==2 has weight 1;
  - camera: pinhole; full-film direction pdf 1/(A_img cos^3 theta) for MIS;
    t>=2 estimators use per-pixel sampling with beta_1 = 1; the t=1 light
    image is splat-accumulated and normalized by spp;
  - light subpaths start on area emitters (uniform pick, area-uniform
    position, cosine-weighted emission) — matches Mitsuba area.cpp;
  - no Russian roulette inside subpaths: depth bounded by maxDepth (or
    MAX_BDPT_DEPTH when maxDepth=-1);
  - shading-normal transport asymmetry correction IS applied on the
    adjoint (light) walk — see _random_walk(adjoint=True).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m
from ..core import warp
from ..core.rng import DimAllocator as DA
from ..core.rng import make_sampler, uniform_2d, uniform_float
from ..ops import bsdf as bsdf_ops
from ..ops import common, emitter as em_ops, film as film_ops
from ..ops import sensor as sensor_ops
from ..scene.materials import CONDUCTOR, DIELECTRIC, THIN_DIELECTRIC

import os as _os

# Depth cap used when maxDepth=-1 (unbounded in the reference; bounded
# here because the (s,t) strategy loop is unrolled into the XLA program
# — compile time grows ~quadratically with depth).  Override with
# GDMT_MAX_BDPT_DEPTH for deeper unbounded renders; explicit maxDepth
# values above 8 are honored as-is.
MAX_BDPT_DEPTH = int(_os.environ.get("GDMT_MAX_BDPT_DEPTH", "8"))
LIGHT_DIM_BASE = 4096  # rng dim offset separating the light-path stream


class SubPath(NamedTuple):
    """SoA subpath vertex storage [N, D, ...].  Array index j holds the
    (j+1)-th vertex of the walk (z_{j+1} / y_{j+1})."""
    p: jnp.ndarray         # [N, D, 3]
    ng: jnp.ndarray        # [N, D, 3]
    ns: jnp.ndarray        # [N, D, 3]
    wi: jnp.ndarray        # [N, D, 3] unit, toward the PREVIOUS vertex
    uv: jnp.ndarray        # [N, D, 2] texture coordinates
    bsdf_id: jnp.ndarray   # [N, D] i32
    emitter_id: jnp.ndarray  # [N, D] i32
    beta: jnp.ndarray      # [N, D, 3] throughput up to (incl) vertex
    pdf_fwd: jnp.ndarray   # [N, D] area pdf of sampling this vertex
    pdf_rev: jnp.ndarray   # [N, D] area pdf of re-sampling THIS vertex
    #                        from its successor (walk's own reverse pdf)
    delta: jnp.ndarray     # [N, D] vertex BSDF is pure delta
    valid: jnp.ndarray     # [N, D]
    # OPTIONAL [N, D, 2] per-vertex shading-frame azimuth of dp/du
    # (fill_intersection bary cols 4:6), stored ONLY when the scene has
    # woven-cloth (irawan) BSDFs so strategy re-evals can reconstruct
    # the bent-cylinder specular lobe (round-2 deviation: re-evals fell
    # back to the diffuse term).  None compiles the payload away.
    aux: jnp.ndarray = None


class LightStart(NamedTuple):
    """y_0: the sampled emitter vertex."""
    p: jnp.ndarray         # [N, 3]
    ng: jnp.ndarray        # [N, 3]
    rad: jnp.ndarray       # [N, 3] emitted radiance (front side)
    pdf_pos: jnp.ndarray   # [N] area pdf incl emitter pick
    beta: jnp.ndarray      # [N, 3] = rad / pdf_pos
    ok: jnp.ndarray        # [N] bool
    pdf_rev: jnp.ndarray   # [N] area pdf of re-sampling y_0 from y_1


class SlotOverlay:
    """Read-only stand-in for a SubPath with individual (field, slot)
    columns replaced, resolved by STATIC slot comparison at trace time.

    G-BDPT's t=1 image-space shift replaces one light-subpath vertex
    (plus one pdf_rev column) per strategy; materializing that view with
    `.at[:, kl].set()` copies every [N, D, ...] field and re-reads them
    all through _strategy_t1/_eval_at/_mis_sum — measured at 41% of the
    light-image gradient pass's memory traffic (0.86 GB of 2.06 GB at
    64^2/depth 6, XLA cost analysis).  The overlay keeps the base arrays
    and serves overridden columns only where a static slot index
    matches, so nothing is copied.

    Only column access (`_col(sp, name, k)`) sees overrides; whole-array
    attribute access passes through to the base SubPath (used only for
    shapes / fields that are never overridden)."""

    def __init__(self, base: "SubPath", overrides):
        object.__setattr__(self, "_base", base)
        object.__setattr__(self, "_ov", dict(overrides))

    def col(self, name, k):
        v = self._ov.get((name, int(k)))
        if v is not None:
            return v
        base_f = getattr(self._base, name)
        return None if base_f is None else base_f[:, k]

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_base"), name)


def _col(sp, name, k):
    """Column k of SubPath field `name`, honoring SlotOverlay overrides
    (static k: the branch resolves at trace time)."""
    if isinstance(sp, SlotOverlay):
        return sp.col(name, k)
    f = getattr(sp, name)
    return None if f is None else f[:, k]


def _remap0(x):
    return jnp.where(x > 0, x, 1.0)


def _dir_to_area(pdf_sa, d, dist2, ng_at_target):
    return pdf_sa * jnp.abs(m.dot(d, ng_at_target)) / jnp.maximum(
        dist2, 1e-12)


def _is_delta_kind(materials, bsdf_id):
    kind = materials.kind[jnp.maximum(bsdf_id, 0)]
    return ((kind == CONDUCTOR) | (kind == DIELECTRIC) |
            (kind == THIN_DIELECTRIC))


def _b3(x):
    return x[..., None]


def synth_bary_from_az(az):
    """Neutral bary payload carrying only the yarn azimuth cols 4:6
    (fill_intersection layout) — lets woven-cloth evals at stored/replayed
    vertices reconstruct the specular lobe."""
    one = jnp.ones_like(az[..., 0])
    return jnp.stack([one, one, one, jnp.full_like(one, 3.4e38),
                      az[..., 0], az[..., 1]], -1)


class BDPTracer:
    """Bidirectional path tracer over SoA wavefronts (reference parity:
    bdpt.cpp with lightImage=true, sampleDirect via s=1 strategies)."""

    def __init__(self, scene, settings):
        self.kinds = bsdf_ops.scene_kinds(scene)
        self._beval = functools.partial(bsdf_ops.eval, kinds=self.kinds)
        self._bpdf = functools.partial(bsdf_ops.pdf, kinds=self.kinds)
        self._bsample = functools.partial(bsdf_ops.sample, kinds=self.kinds)
        self.settings = settings
        self.n_area = int((np.asarray(scene.emitters.tri_count) > 0).sum())
        # Environment + delta lights are integrated as an embedded NEE
        # family on the EYE walk (see _random_walk collect_aux): an env
        # path of any length is sampled by exactly two techniques — the
        # eye walk escaping (s=0) and env-NEE at the last eye vertex
        # (s=1) — MIS-combined with the power heuristic; delta lights
        # (point/spot/directional) only by NEE (weight 1).  Both families
        # are disjoint from the area-light subpath strategies, so no
        # cross-family MIS terms arise (reference: bdpt.cpp handles
        # infinite/degenerate emitters with the same two-technique set).
        self.env_kind = settings.env_kind
        self.n_delta = settings.n_delta
        self.aux_nee = (settings.env_kind != 0) or (settings.n_delta > 0)
        # G-BDPT replaces the embedded aux family with a dedicated
        # aux-only G-PT pass whose gradients are estimated (gbdpt.py);
        # when set, the eye walk skips aux collection entirely
        self.aux_via_gpt = False
        n_tris = int(scene.geom.indices.shape[0])
        self.closest, self.occluded = common.instrument_intersectors(
            self, *common.choose_intersector(settings, n_tris))
        self.count_rays = False  # set True BEFORE first render
        self.ray_tally = None
        self.last_ray_count = None
        md = settings.max_depth
        self.depth = md if md > 0 else MAX_BDPT_DEPTH  # max path edges
        self.TE = self.depth                 # eye surface vertices stored
        self.SM = self.depth                 # max s (y_0..y_{SM-1})
        self.filter_kind = film_ops.FILTERS.get(settings.rfilter, 0)
        self.has_textures = settings.has_textures
        # woven-cloth (irawan) present: subpaths store the yarn azimuth
        # so strategy re-evals keep the specular term (SubPath.aux)
        self.has_cloth = bool(int(settings.has_textures) & 16)
        self._u1, self._u2 = make_sampler(settings.sampler, settings.spp)
        self.light_image = bool(
            settings.integrator_props.get("lightImage", True))
        # whether the camera counts as a connectable endpoint in MIS: when
        # light tracing (t=1) is disabled, its technique must leave the
        # denominators too or every weight underestimates its strategy
        self.camera_connectable = self.light_image

    # -- camera helpers -------------------------------------------------
    def _camera_info(self, scene):
        cam_pos = scene.camera.to_world[:3, 3]
        fwd = scene.camera.to_world[:3, 2]
        x0 = m.transform_point(scene.camera.sample_to_camera,
                               jnp.array([0.0, 0.0, 0.0]))
        x1 = m.transform_point(scene.camera.sample_to_camera,
                               jnp.array([1.0, 1.0, 0.0]))
        a_img = jnp.abs((x1[0] / x1[2] - x0[0] / x0[2]) *
                        (x1[1] / x1[2] - x0[1] / x0[2]))
        return cam_pos, fwd, a_img

    def _camera_pdf_area(self, scene, p, ng):
        """Full-film area pdf at p of the camera sampling a ray through it."""
        cam_pos, fwd, a_img = self._camera_info(scene)
        to_p = p - cam_pos
        dist2 = jnp.maximum(m.squared_length(to_p), 1e-12)
        d = to_p / jnp.sqrt(dist2)[..., None]
        cos_cam = jnp.maximum(m.dot(d, jnp.broadcast_to(fwd, d.shape)),
                              1e-6)
        pdf_dir = 1.0 / (a_img * cos_cam ** 3)
        return _dir_to_area(pdf_dir, d, dist2, ng)

    # -- random walk ------------------------------------------------------
    def _random_walk(self, scene, seed, sample_idx, pixel_id, o0, d0,
                     beta0, pdf_sa0, dim_base, n_steps, adjoint=False,
                     collect_aux=False):
        """Fill a SubPath with up to n_steps vertices.

        adjoint=True applies the shading-normal importance-transport
        correction |cos_ns(wo) cos_ng(wi)| / |cos_ng(wo) cos_ns(wi)| to
        beta at every bounce (Veach 5.3; pbrt CorrectShadingNormal) — the
        light subpath otherwise carries a biased throughput wherever
        shading normals differ from geometric ones.

        collect_aux=True (eye walk only) additionally integrates the
        environment / delta-light family in lockstep: escaped segments
        pick up env radiance MIS-weighted against env-NEE, and every
        non-delta vertex runs one NEE draw over {delta lights, env}
        (dims D_LIGHT_SELECT / D_LIGHT_UV, unused by the walk itself).

        Returns (SubPath, rev0_sa, aux_L) where rev0_sa is the reverse
        solid-angle pdf at the FIRST vertex toward the walk origin (needed
        for the origin's pdf_rev) and aux_L the env/delta radiance."""
        N = o0.shape[0]
        eps = scene.ray_eps
        do_aux = collect_aux and self.aux_nee
        aux_L = jnp.zeros((N, 3))
        # can the PREVIOUS vertex's env-NEE have sampled the current
        # segment's direction? (camera and delta-lobe bounces: no)
        prev_can_nee = jnp.zeros(N, bool)

        def empty(shape, val=0.0, dtype=jnp.float32):
            return jnp.full((N, n_steps) + shape, val, dtype)

        sp = SubPath(
            p=empty((3,)), ng=empty((3,)), ns=empty((3,)), wi=empty((3,)),
            uv=empty((2,)),
            bsdf_id=empty((), -1, jnp.int32),
            emitter_id=empty((), -1, jnp.int32),
            beta=empty((3,)), pdf_fwd=empty(()), pdf_rev=empty(()),
            delta=empty((), False, jnp.bool_),
            valid=empty((), False, jnp.bool_),
            aux=(jnp.stack([empty(()) + 1.0, empty(())], -1)
                 if self.has_cloth else None))

        o, d, beta, pdf_sa = o0, d0, beta0, pdf_sa0
        alive = jnp.ones(N, bool)
        rev0_sa = jnp.zeros(N)

        for k in range(n_steps):
            hit = self.closest(o, d, jnp.zeros(N),
                               jnp.where(alive, 3e38, -1.0),
                               scene.geom)
            its = common.fill_intersection(scene, o, d, hit)
            if do_aux and self.env_kind != 0:
                escaped = alive & ~its.valid
                rad_esc = em_ops.eval_env(scene, self.env_kind, d)
                pdf_nee = em_ops.pdf_env_direct(scene, 0, self.env_kind, d,
                                                n_delta=self.n_delta)
                pdf_nee = jnp.where(prev_can_nee, pdf_nee, 0.0)
                w_esc = jnp.where(
                    pdf_nee > 0,
                    pdf_sa ** 2 / jnp.maximum(pdf_sa ** 2 + pdf_nee ** 2,
                                              1e-24),
                    1.0)
                aux_L = aux_L + jnp.where(_b3(escaped),
                                          beta * rad_esc * _b3(w_esc), 0.0)
            alive = alive & its.valid

            pdf_fwd = _dir_to_area(pdf_sa, d, its.t ** 2, its.ng)
            delta = _is_delta_kind(scene.materials, its.bsdf_id)

            def upd(arr, val):
                mask = jnp.reshape(alive, (-1,) + (1,) * (val.ndim - 1))
                return arr.at[:, k].set(jnp.where(mask, val, arr[:, k]))

            sp = sp._replace(
                p=upd(sp.p, its.p), ng=upd(sp.ng, its.ng),
                ns=upd(sp.ns, its.ns), wi=upd(sp.wi, -d),
                uv=upd(sp.uv, its.uv),
                bsdf_id=sp.bsdf_id.at[:, k].set(
                    jnp.where(alive, its.bsdf_id, -1)),
                emitter_id=sp.emitter_id.at[:, k].set(
                    jnp.where(alive, its.emitter_id, -1)),
                beta=upd(sp.beta, beta),
                pdf_fwd=sp.pdf_fwd.at[:, k].set(
                    jnp.where(alive, pdf_fwd, 0.0)),
                delta=sp.delta.at[:, k].set(jnp.where(alive, delta, False)),
                valid=sp.valid.at[:, k].set(alive),
                aux=(upd(sp.aux, its.bary[..., 4:6])
                     if sp.aux is not None and its.bary is not None
                     else sp.aux))

            # sample continuation at vertex k
            ss, ts = m.build_frame(its.ns)
            wi = m.to_local(-d, ss, ts, its.ns)
            par = common.material_params(scene, self.has_textures,
                                         its.bsdf_id, its.uv,
                                         bary=its.bary)
            u2 = self._u2(seed, pixel_id, sample_idx,
                          dim_base + DA.bounce_dim(k, DA.D_BSDF_UV))
            uc = self._u1(
                seed, pixel_id, sample_idx,
                dim_base + DA.bounce_dim(k, DA.D_BSDF_COMPONENT))
            bs = self._bsample(par, wi, u2, uc)
            # reverse pdf toward the previous vertex, given the sampled wo
            pdf_rev_sa = self._bpdf(par, bs.wo, wi)
            if k == 0:
                rev0_sa = jnp.where(alive, pdf_rev_sa, 0.0)
            else:
                to_prev = sp.p[:, k - 1] - its.p
                d2p = jnp.maximum(m.squared_length(to_prev), 1e-12)
                dirp = to_prev / jnp.sqrt(d2p)[..., None]
                rev_area = _dir_to_area(pdf_rev_sa, dirp, d2p,
                                        sp.ng[:, k - 1])
                sp = sp._replace(pdf_rev=sp.pdf_rev.at[:, k - 1].set(
                    jnp.where(alive, rev_area, 0.0)))

            # --- embedded env/delta NEE at vertex k (eye walk only) ----
            if do_aux and k + 2 <= self.depth:
                u_ds = self._u1(seed, pixel_id, sample_idx,
                                dim_base + DA.bounce_dim(k, DA.D_LIGHT_SELECT))
                u_dp = self._u2(seed, pixel_id, sample_idx,
                                dim_base + DA.bounce_dim(k, DA.D_LIGHT_UV))
                ds = em_ops.sample_direct(scene, 0, self.env_kind, its.p,
                                          u_ds, u_dp,
                                          n_delta=self.n_delta)
                wo_l = m.to_local(ds.d, ss, ts, its.ns)
                f_nee = self._beval(par, wi, wo_l)
                pdf_b = self._bpdf(par, wi, wo_l)
                want = (alive & ds.valid &
                        (jnp.max(f_nee, axis=-1) > 0))
                sh_o = common.offset_ray_origin(its.p, its.ng, ds.d, eps)
                occ = self.occluded(
                    sh_o, ds.d, jnp.zeros(N),
                    jnp.where(want, ds.dist * (1.0 - 1e-4), -1.0),
                    scene.geom)
                want = want & ~occ
                w_nee = jnp.where(
                    ds.is_delta, 1.0,
                    ds.pdf ** 2 / jnp.maximum(ds.pdf ** 2 + pdf_b ** 2,
                                              1e-24))
                aux_L = aux_L + jnp.where(
                    _b3(want),
                    beta * f_nee * ds.radiance *
                    _b3(w_nee / jnp.maximum(ds.pdf, 1e-12)), 0.0)

            wo_w = m.to_world(bs.wo, ss, ts, its.ns)
            weight = bs.weight
            if adjoint:
                num = (jnp.abs(m.dot(wo_w, its.ns)) *
                       jnp.abs(m.dot(d, its.ng)))
                den = (jnp.abs(m.dot(wo_w, its.ng)) *
                       jnp.abs(m.dot(d, its.ns)))
                corr = jnp.where(den > 1e-9, num / jnp.maximum(den, 1e-9),
                                 0.0)
                weight = weight * corr[..., None]
            o = common.offset_ray_origin(its.p, its.ng, wo_w, eps)
            d = wo_w
            alive = alive & bs.valid
            beta = jnp.where(alive[..., None], beta * weight, 0.0)
            pdf_sa = jnp.where(bs.is_delta, 0.0, bs.pdf)
            prev_can_nee = alive & ~bs.is_delta & (k + 2 <= self.depth)

        return sp, rev0_sa, aux_L

    # -- subpath generation -------------------------------------------------
    def _gen_eye_path(self, scene, seed, sample_idx, pixel_id, W, H):
        N = pixel_id.shape[0]
        px = (pixel_id % W).astype(jnp.float32)
        py = (pixel_id // W).astype(jnp.float32)
        jitter = self._u2(seed, pixel_id, sample_idx, DA.PIXEL_JITTER)
        pos_film = jnp.stack([px, py], -1) + jitter
        u_ap = self._u2(seed, pixel_id, sample_idx, DA.APERTURE)
        o, d = sensor_ops.sample_ray(scene.camera, W, H, pos_film, u_ap)
        cam_pos, fwd, a_img = self._camera_info(scene)
        cos_cam = jnp.maximum(m.dot(d, jnp.broadcast_to(fwd, d.shape)),
                              1e-6)
        pdf_dir = 1.0 / (a_img * cos_cam ** 3)
        sp, _, aux_L = self._random_walk(
            scene, seed, sample_idx, pixel_id, o, d,
            jnp.ones((N, 3)), pdf_dir, 0, self.TE,
            collect_aux=not self.aux_via_gpt)
        return pos_film, sp, aux_L

    def _gen_light_path(self, scene, seed, sample_idx, pixel_id):
        N = pixel_id.shape[0]
        em = scene.emitters
        u_sel = self._u1(seed, pixel_id, sample_idx, LIGHT_DIM_BASE)
        u_pos = self._u2(seed, pixel_id, sample_idx, LIGHT_DIM_BASE + 1)
        u_dir = self._u2(seed, pixel_id, sample_idx, LIGHT_DIM_BASE + 3)

        n_area = max(self.n_area, 1)
        e = jnp.minimum((u_sel * n_area).astype(jnp.int32), n_area - 1)
        u_res = jnp.clip(u_sel * n_area - e, 0.0, 1.0)
        from ..ops.emitter import _searchsorted_segment
        off = em.tri_offset[e]
        cnt = em.tri_count[e]
        flat = _searchsorted_segment(em.tri_cdf, off, off + cnt - 1, u_res)
        from ..ops.emitter import sample_emitter_triangle
        y0p, ng0 = sample_emitter_triangle(scene, flat, u_pos)
        pdf_pos = 1.0 / (jnp.maximum(em.total_area[e], 1e-12) * n_area)
        rad = em.radiance[e]
        ok = jnp.full(N, self.n_area > 0)

        ssf, tsf = m.build_frame(ng0)
        d_local = warp.square_to_cosine_hemisphere(u_dir)
        d0 = m.to_world(d_local, ssf, tsf, ng0)
        pdf_dir = jnp.maximum(warp.square_to_cosine_hemisphere_pdf(d_local),
                              1e-12)
        cos0 = jnp.maximum(d_local[..., 2], 0.0)

        beta0 = rad / _b3(pdf_pos)
        beta1 = beta0 * _b3(cos0 / pdf_dir)
        o0 = common.offset_ray_origin(y0p, ng0, d0, scene.ray_eps)
        # at least one slot so downstream indexing stays well-formed even
        # when maxDepth==1 (no s>=2 strategy ever reads it then)
        sp, rev0_sa, _ = self._random_walk(
            scene, seed, sample_idx, pixel_id, o0, d0, beta1, pdf_dir,
            LIGHT_DIM_BASE + 8, max(self.SM - 1, 1), adjoint=True)

        # pdf_rev of y_0: reverse pdf at y_1 toward y_0, area measure
        to0 = y0p - sp.p[:, 0]
        d20 = jnp.maximum(m.squared_length(to0), 1e-12)
        dir0 = to0 / jnp.sqrt(d20)[..., None]
        pdf_rev_y0 = jnp.where(sp.valid[:, 0],
                               _dir_to_area(rev0_sa, dir0, d20, ng0), 0.0)

        y0 = LightStart(p=y0p, ng=ng0, rad=rad, pdf_pos=pdf_pos,
                        beta=beta0, ok=ok, pdf_rev=pdf_rev_y0)
        return y0, sp

    # -- BSDF evaluation at a stored vertex ---------------------------------
    def _vertex_bary(self, sp: SubPath, k):
        """Synthesized bary payload for strategy re-evals at vertex k:
        neutral vertex-color/edge-distance columns + the stored yarn
        azimuth (SubPath.aux).  None when the scene has no cloth."""
        if sp.aux is None:
            return None
        return synth_bary_from_az(_col(sp, "aux", k))

    def _eval_at(self, scene, sp: SubPath, k, wo_world):
        """(f*cos, pdf_sa, None) at vertex k toward world direction wo."""
        ns_k = _col(sp, "ns", k)
        ss, ts = m.build_frame(ns_k)
        wi = m.to_local(_col(sp, "wi", k), ss, ts, ns_k)
        wo = m.to_local(wo_world, ss, ts, ns_k)
        par = common.material_params(scene, self.has_textures,
                                     _col(sp, "bsdf_id", k),
                                     _col(sp, "uv", k),
                                     bary=self._vertex_bary(sp, k))
        f = self._beval(par, wi, wo)
        pdf = self._bpdf(par, wi, wo)
        return f, pdf

    def _pdf_toward_prev(self, scene, sp: SubPath, k, d_new_in, prev_p,
                         prev_ng):
        """Area pdf at sp[k] of sampling the direction toward prev_p given
        the NEW incoming direction d_new_in (strategy-specific pdf_rev
        fixup for the vertex behind a connection endpoint)."""
        to_prev = prev_p - _col(sp, "p", k)
        d2 = jnp.maximum(m.squared_length(to_prev), 1e-12)
        dirp = to_prev / jnp.sqrt(d2)[..., None]
        ns_k = _col(sp, "ns", k)
        ssf, tsf = m.build_frame(ns_k)
        par = common.material_params(scene, self.has_textures,
                                     _col(sp, "bsdf_id", k),
                                     _col(sp, "uv", k),
                                     bary=self._vertex_bary(sp, k))
        pdf_sa = self._bpdf(
            par, m.to_local(d_new_in, ssf, tsf, ns_k),
            m.to_local(dirp, ssf, tsf, ns_k))
        return _dir_to_area(pdf_sa, dirp, d2, prev_ng)

    # -- MIS ------------------------------------------------------------
    def _mis_sum(self, eye: SubPath, light: SubPath, y0: LightStart,
                 s, t, pdf_rev_pt, pdf_rev_pt_minus, pdf_rev_qs,
                 pdf_rev_qs_minus):
        """Power-heuristic (beta=2) technique sum for strategy (s,t):
        sum over competing strategies of (p_other/p_this)^2.  The MIS
        weight is 1/(1+sum); G-BDPT additionally combines base+offset sums
        (gbdpt.py).  pdf_rev_* are the strategy-specific area-pdf fixups
        for the vertices adjacent to the connection."""
        N = eye.p.shape[0]
        if s + t == 2:
            return jnp.zeros(N)
        sum_ri = jnp.zeros(N)

        # eye side: hypothetical connections at z_i, i = t-1 .. 1
        ri = jnp.ones(N)
        for i in range(t - 1, 0, -1):
            idx = i - 1
            if i == t - 1:
                num = pdf_rev_pt
            elif i == t - 2:
                num = pdf_rev_pt_minus
            else:
                num = _col(eye, "pdf_rev", idx)
            den = _col(eye, "pdf_fwd", idx)
            ri = ri * (_remap0(num) / _remap0(den))
            v_delta = _col(eye, "delta", idx)
            if i >= 2:
                prev_delta = _col(eye, "delta", idx - 1)
            else:
                # z_0 = camera: connectable only when light tracing is on
                prev_delta = jnp.full(N, not self.camera_connectable, bool)
            use = ~v_delta & ~prev_delta
            sum_ri = sum_ri + jnp.where(use, ri * ri, 0.0)

        # light side: hypothetical connections at y_i, i = s-1 .. 0
        ri = jnp.ones(N)
        for i in range(s - 1, -1, -1):
            if i == s - 1:
                num = pdf_rev_qs
            elif i == s - 2:
                num = pdf_rev_qs_minus
            elif i == 0:
                num = y0.pdf_rev
            else:
                num = _col(light, "pdf_rev", i - 1)
            if i == 0:
                den = y0.pdf_pos
                v_delta = jnp.zeros(N, bool)
            else:
                den = _col(light, "pdf_fwd", i - 1)
                v_delta = _col(light, "delta", i - 1)
            ri = ri * (_remap0(num) / _remap0(den))
            if i == 0:
                prev_delta = jnp.zeros(N, bool)  # area light origin
            elif i == 1:
                prev_delta = jnp.zeros(N, bool)  # y_0 not delta
            else:
                prev_delta = _col(light, "delta", i - 2)
            use = ~v_delta & ~prev_delta
            sum_ri = sum_ri + jnp.where(use, ri * ri, 0.0)

        return sum_ri

    def _mis_sum_dyn(self, eye: SubPath, light: SubPath, y0: LightStart,
                     s, t, pdf_rev_pt, pdf_rev_pt_minus, pdf_rev_qs,
                     pdf_rev_qs_minus):
        """_mis_sum with TRACED (s, t): the same two telescoping-ratio
        recurrences, masked over the static maximum depth, so ONE compiled
        body serves every (s,t) pair in the scanned strategy loop (the
        unrolled loop compiles O(depth^2) bodies).
        Bit-identical to _mis_sum (tests/test_bdpt.py scan-vs-unrolled)."""
        N = eye.p.shape[0]
        sum_ri = jnp.zeros(N)

        # eye side: i = t-1 .. 1
        ri = jnp.ones(N)
        for j in range(self.TE):
            i = t - 1 - j
            act = i >= 1
            im1 = jnp.maximum(i - 1, 0)
            num = jnp.where(
                i == t - 1, pdf_rev_pt,
                jnp.where(i == t - 2, pdf_rev_pt_minus,
                          eye.pdf_rev[:, im1]))
            den = eye.pdf_fwd[:, im1]
            ri_new = ri * (_remap0(num) / _remap0(den))
            v_delta = eye.delta[:, im1]
            prev_delta = jnp.where(
                i >= 2, eye.delta[:, jnp.maximum(i - 2, 0)],
                jnp.full(N, not self.camera_connectable, bool))
            use = act & ~v_delta & ~prev_delta
            sum_ri = sum_ri + jnp.where(use, ri_new * ri_new, 0.0)
            ri = jnp.where(act, ri_new, ri)

        # light side: i = s-1 .. 0
        ri = jnp.ones(N)
        for j in range(self.SM + 1):
            i = s - 1 - j
            act = i >= 0
            im1 = jnp.maximum(i - 1, 0)
            num = jnp.where(
                i == s - 1, pdf_rev_qs,
                jnp.where(i == s - 2, pdf_rev_qs_minus,
                          jnp.where(i == 0, y0.pdf_rev,
                                    light.pdf_rev[:, im1])))
            den = jnp.where(i == 0, y0.pdf_pos, light.pdf_fwd[:, im1])
            v_delta = jnp.where(i == 0, jnp.zeros(N, bool),
                                light.delta[:, im1])
            ri_new = ri * (_remap0(num) / _remap0(den))
            prev_delta = jnp.where(
                i <= 1, jnp.zeros(N, bool),
                light.delta[:, jnp.maximum(i - 2, 0)])
            use = act & ~v_delta & ~prev_delta
            sum_ri = sum_ri + jnp.where(use, ri_new * ri_new, 0.0)
            ri = jnp.where(act, ri_new, ri)

        return jnp.where(s + t == 2, 0.0, sum_ri)

    # -- strategies -------------------------------------------------------
    def _strategy_s0(self, scene, eye, light, y0, t, N, return_aux=False):
        """Eye path hits an emitter at z_{t-1}.

        return_aux=True additionally returns the strategy's pdf_rev
        fixups (for G-BDPT's suffix-factorized offset MIS sums, which
        re-run _mis_sum on the shifted view with the SAME fixups)."""
        k = t - 2
        em_id = eye.emitter_id[:, k]
        cosf = m.dot(eye.ns[:, k], eye.wi[:, k])
        ok = eye.valid[:, k] & (em_id >= 0) & (cosf > 0)
        rad = scene.emitters.radiance[jnp.maximum(em_id, 0)]
        contrib = eye.beta[:, k] * rad

        n_area = max(self.n_area, 1)
        area = scene.emitters.total_area[jnp.maximum(em_id, 0)]
        pdf_rev_pt = 1.0 / (jnp.maximum(area, 1e-12) * n_area)
        if t >= 3:
            km = k - 1
            to_prev = eye.p[:, km] - eye.p[:, k]
            d2 = jnp.maximum(m.squared_length(to_prev), 1e-12)
            dirp = to_prev / jnp.sqrt(d2)[..., None]
            pdf_dir = jnp.abs(m.dot(dirp, eye.ng[:, k])) / jnp.pi
            pdf_rev_pt_minus = _dir_to_area(pdf_dir, dirp, d2,
                                            eye.ng[:, km])
        else:
            pdf_rev_pt_minus = jnp.zeros(N)
        sum_ri = self._mis_sum(eye, light, y0, 0, t, pdf_rev_pt,
                               pdf_rev_pt_minus, jnp.zeros(N),
                               jnp.zeros(N))
        out = jnp.where(_b3(ok), contrib, 0.0)
        if return_aux:
            return out, sum_ri, dict(
                pdf_rev_pt=pdf_rev_pt, pdf_rev_pt_minus=pdf_rev_pt_minus,
                pdf_rev_qs=jnp.zeros(N), pdf_rev_qs_minus=jnp.zeros(N),
                occ=jnp.zeros(N, bool))
        return out, sum_ri

    def _strategy_s1(self, scene, eye, light, y0, t, N, eps,
                     return_aux=False, occ=None):
        """Connect eye vertex z_{t-1} to the sampled light point y_0.

        occ: precomputed connection-visibility result.  G-BDPT's offset
        views pass the BASE strategy's occlusion when the view's endpoint
        vertex coincides with the base's (reconnected mode in all-diffuse
        scenes: identical endpoints -> identical shadow ray)."""
        k = t - 2
        zp = eye.p[:, k]
        ok = eye.valid[:, k] & ~eye.delta[:, k] & y0.ok
        to_l = y0.p - zp
        d2 = jnp.maximum(m.squared_length(to_l), 1e-12)
        dist = jnp.sqrt(d2)
        d = to_l / _b3(dist)
        cos_l = jnp.maximum(-m.dot(d, y0.ng), 0.0)
        ok = ok & (cos_l > 1e-6)

        f_eye, pdf_eye_sa = self._eval_at(scene, eye, k, d)
        if occ is None:
            sh_o = common.offset_ray_origin(zp, eye.ng[:, k], d, eps)
            occ = self.occluded(sh_o, d, jnp.zeros(N),
                                dist - 2 * eps / jnp.maximum(cos_l, 1e-3),
                                scene.geom)
        ok = ok & ~occ
        contrib = eye.beta[:, k] * f_eye * y0.beta * _b3(cos_l / d2)

        pdf_rev_qs = _dir_to_area(pdf_eye_sa, d, d2, y0.ng)
        pdf_dir_l = cos_l / jnp.pi
        pdf_rev_pt = _dir_to_area(pdf_dir_l, -d, d2, eye.ng[:, k])
        if t >= 3:
            pdf_rev_pt_minus = self._pdf_toward_prev(
                scene, eye, k, d, eye.p[:, k - 1], eye.ng[:, k - 1])
        else:
            pdf_rev_pt_minus = jnp.zeros(N)
        sum_ri = self._mis_sum(eye, light, y0, 1, t, pdf_rev_pt,
                               pdf_rev_pt_minus, pdf_rev_qs, jnp.zeros(N))
        out = jnp.where(_b3(ok), contrib, 0.0)
        if return_aux:
            return out, sum_ri, dict(
                pdf_rev_pt=pdf_rev_pt, pdf_rev_pt_minus=pdf_rev_pt_minus,
                pdf_rev_qs=pdf_rev_qs, pdf_rev_qs_minus=jnp.zeros(N),
                occ=occ)
        return out, sum_ri

    def _strategy_connect(self, scene, eye, light, y0, s, t, N, eps,
                          return_aux=False, occ=None):
        """General connection z_{t-1} <-> y_{s-1} (s>=2, t>=2).
        occ: precomputed visibility (see _strategy_s1)."""
        ke = t - 2
        kl = s - 2
        zp = eye.p[:, ke]
        yp = light.p[:, kl]
        ok = (eye.valid[:, ke] & ~eye.delta[:, ke] &
              light.valid[:, kl] & ~light.delta[:, kl])
        to_l = yp - zp
        d2 = jnp.maximum(m.squared_length(to_l), 1e-12)
        dist = jnp.sqrt(d2)
        d = to_l / _b3(dist)

        f_eye, pdf_eye_sa = self._eval_at(scene, eye, ke, d)
        f_lt, pdf_lt_sa = self._eval_at(scene, light, kl, -d)
        if occ is None:
            sh_o = common.offset_ray_origin(zp, eye.ng[:, ke], d, eps)
            occ = self.occluded(sh_o, d, jnp.zeros(N), dist - 2 * eps,
                                scene.geom)
        ok = ok & ~occ
        contrib = eye.beta[:, ke] * f_eye * f_lt * light.beta[:, kl] / _b3(d2)

        pdf_rev_qs = _dir_to_area(pdf_eye_sa, d, d2, light.ng[:, kl])
        pdf_rev_pt = _dir_to_area(pdf_lt_sa, -d, d2, eye.ng[:, ke])
        if t >= 3:
            pdf_rev_pt_minus = self._pdf_toward_prev(
                scene, eye, ke, d, eye.p[:, ke - 1], eye.ng[:, ke - 1])
        else:
            pdf_rev_pt_minus = jnp.zeros(N)
        if s >= 3:
            pdf_rev_qs_minus = self._pdf_toward_prev(
                scene, light, kl, -d, light.p[:, kl - 1],
                light.ng[:, kl - 1])
        else:  # s == 2: the previous light vertex is y_0
            pdf_rev_qs_minus = self._pdf_toward_prev(
                scene, light, kl, -d, y0.p, y0.ng)
        sum_ri = self._mis_sum(eye, light, y0, s, t, pdf_rev_pt,
                               pdf_rev_pt_minus, pdf_rev_qs,
                               pdf_rev_qs_minus)
        out = jnp.where(_b3(ok), contrib, 0.0)
        if return_aux:
            return out, sum_ri, dict(
                pdf_rev_pt=pdf_rev_pt, pdf_rev_pt_minus=pdf_rev_pt_minus,
                pdf_rev_qs=pdf_rev_qs, pdf_rev_qs_minus=pdf_rev_qs_minus,
                occ=occ)
        return out, sum_ri

    def _strategy_connect_dyn(self, scene, eye, light, y0, s, t, N, eps):
        """_strategy_connect with TRACED (s, t) scalars: vertex fetches
        become dynamic slices along the tiny depth axis and the static
        s/t branches become selects, so lax.scan over the (s,t) pair list
        compiles this body ONCE instead of O(depth^2) unrolled copies.
        Numerically identical to _strategy_connect for every valid pair
        (tests/test_bdpt.py scan-vs-unrolled)."""
        ke = t - 2
        kl = s - 2
        zp = eye.p[:, ke]
        yp = light.p[:, kl]
        ok = (eye.valid[:, ke] & ~eye.delta[:, ke] &
              light.valid[:, kl] & ~light.delta[:, kl])
        to_l = yp - zp
        d2 = jnp.maximum(m.squared_length(to_l), 1e-12)
        dist = jnp.sqrt(d2)
        d = to_l / _b3(dist)

        f_eye, pdf_eye_sa = self._eval_at(scene, eye, ke, d)
        f_lt, pdf_lt_sa = self._eval_at(scene, light, kl, -d)
        sh_o = common.offset_ray_origin(zp, eye.ng[:, ke], d, eps)
        occ = self.occluded(sh_o, d, jnp.zeros(N), dist - 2 * eps,
                            scene.geom)
        ok = ok & ~occ
        contrib = eye.beta[:, ke] * f_eye * f_lt * light.beta[:, kl] / _b3(d2)

        pdf_rev_qs = _dir_to_area(pdf_eye_sa, d, d2, light.ng[:, kl])
        pdf_rev_pt = _dir_to_area(pdf_lt_sa, -d, d2, eye.ng[:, ke])
        kem = jnp.maximum(ke - 1, 0)
        pdf_rev_pt_minus = jnp.where(
            t >= 3,
            self._pdf_toward_prev(scene, eye, ke, d, eye.p[:, kem],
                                  eye.ng[:, kem]),
            0.0)
        # s == 2: the previous light vertex is y_0
        klm = jnp.maximum(kl - 1, 0)
        s3 = s >= 3
        prev_p = jnp.where(s3, light.p[:, klm], y0.p)
        prev_ng = jnp.where(s3, light.ng[:, klm], y0.ng)
        pdf_rev_qs_minus = self._pdf_toward_prev(scene, light, kl, -d,
                                                 prev_p, prev_ng)
        sum_ri = self._mis_sum_dyn(eye, light, y0, s, t, pdf_rev_pt,
                                   pdf_rev_pt_minus, pdf_rev_qs,
                                   pdf_rev_qs_minus)
        auxd = dict(pdf_rev_pt=pdf_rev_pt,
                    pdf_rev_pt_minus=pdf_rev_pt_minus,
                    pdf_rev_qs=pdf_rev_qs,
                    pdf_rev_qs_minus=pdf_rev_qs_minus, occ=occ)
        return jnp.where(_b3(ok), contrib, 0.0), sum_ri, auxd

    def _t1_shadow_ray(self, scene, light, s, eps):
        """The base t=1 strategy's camera-visibility shadow ray for light
        vertex y_{s-1}: (origin, dir, maxt).  Matches _strategy_t1's
        internal construction exactly; callers CONCATENATE these across
        all t=1 strategies into one occlusion dispatch (one trace instead
        of one per s — the per-s dispatches were 38% of G-BDPT's depth-6
        runtime)."""
        cam_pos, _, _ = self._camera_info(scene)
        kl = s - 2
        yp = light.p[:, kl]
        yng = light.ng[:, kl]
        to_cam = jnp.broadcast_to(cam_pos, yp.shape) - yp
        d2 = jnp.maximum(m.squared_length(to_cam), 1e-12)
        dist = jnp.sqrt(d2)
        d = to_cam / _b3(dist)
        sh_o = common.offset_ray_origin(yp, yng, d, eps)
        return sh_o, d, dist - 2 * eps

    def _batched_t1_occlusion(self, scene, light, t1_list, N, eps):
        """One occlusion dispatch covering every t=1 strategy's camera
        shadow ray; returns {s: occ [N]}."""
        if not t1_list:
            return {}
        rays = [self._t1_shadow_ray(scene, light, s, eps) for s in t1_list]
        nb = len(t1_list)
        occ = self.occluded(
            jnp.concatenate([r[0] for r in rays]),
            jnp.concatenate([r[1] for r in rays]),
            jnp.zeros(nb * N),
            jnp.concatenate([r[2] for r in rays]), scene.geom)
        return {s: occ[i * N:(i + 1) * N]
                for i, s in enumerate(t1_list)}

    def _strategy_t1(self, scene, eye, light, y0, s, N, eps, W, H,
                     occ=None):
        """Light tracing (s>=2): connect y_{s-1} to the camera.  Returns
        (film_pos, value UNWEIGHTED, technique sum) — the caller folds the
        MIS weight (G-BDPT needs the raw sum for its pair weights).

        occ: precomputed camera-visibility result; G-BDPT's t=1 offset
        views pass all-False because their endpoint z'_1 IS the closest
        hit along the retraced camera ray (visibility by construction)."""
        cam_pos, cam_fwd, a_img = self._camera_info(scene)
        kl = s - 2
        yp = _col(light, "p", kl)
        yng = _col(light, "ng", kl)
        beta = _col(light, "beta", kl)
        ok = _col(light, "valid", kl) & ~_col(light, "delta", kl)

        film, we, in_frustum = sensor_ops.importance_sample_direct(
            scene.camera, W, H, yp)
        to_cam = jnp.broadcast_to(cam_pos, yp.shape) - yp
        d2 = jnp.maximum(m.squared_length(to_cam), 1e-12)
        dist = jnp.sqrt(d2)
        d = to_cam / _b3(dist)
        cos_cam = jnp.maximum(
            m.dot(-d, jnp.broadcast_to(cam_fwd, d.shape)), 1e-6)

        f_eval, pdf_lt_sa = self._eval_at(scene, light, kl, d)
        if occ is None:
            sh_o = common.offset_ray_origin(yp, yng, d, eps)
            occ = self.occluded(sh_o, d, jnp.zeros(N), dist - 2 * eps,
                                scene.geom)
        ok = ok & ~occ & in_frustum
        value = beta * f_eval * _b3(we * cos_cam / d2)

        pdf_rev_qs = self._camera_pdf_area(scene, yp, yng)
        if s >= 3:
            pdf_rev_qs_minus = self._pdf_toward_prev(
                scene, light, kl, d, _col(light, "p", kl - 1),
                _col(light, "ng", kl - 1))
        else:
            pdf_rev_qs_minus = self._pdf_toward_prev(
                scene, light, kl, d, y0.p, y0.ng)
        sum_ri = self._mis_sum(eye, light, y0, s, 1, jnp.zeros(N),
                               jnp.zeros(N), pdf_rev_qs, pdf_rev_qs_minus)
        value = jnp.where(_b3(ok), value, 0.0)
        return film, value, sum_ri

    # -- per-sample evaluation ---------------------------------------------
    def trace_pass(self, scene, seed, sample_idx, pixel_id=None):
        st = self.settings
        W, H = st.width, st.height
        if pixel_id is None:
            pixel_id = jnp.arange(W * H, dtype=jnp.uint32)
        N = pixel_id.shape[0]
        eps = scene.ray_eps

        pos_film, eye, aux_L = self._gen_eye_path(scene, seed, sample_idx,
                                                   pixel_id, W, H)
        y0, light = self._gen_light_path(scene, seed, sample_idx, pixel_id)

        L = aux_L
        splat_pos, splat_val = [], []
        # s>=2, t>=2 connection pairs: scanned through ONE compiled body
        # when the pair list is large (compile time of the unrolled loop
        # grows ~quadratically with depth), unrolled otherwise.
        # GDMT_SCAN_STRATEGIES=1 forces the scan, =0 forces unrolling.
        conn_pairs = [(s, t) for t in range(2, self.TE + 2)
                      for s in range(2, self.SM + 1)
                      if s + t - 1 <= self.depth]
        scan_env = _os.environ.get("GDMT_SCAN_STRATEGIES", "")
        use_scan = (scan_env == "1" or
                    (scan_env != "0" and len(conn_pairs) > 21))
        t1_list = ([s for s in range(2, self.SM + 1) if s <= self.depth]
                   if self.light_image else [])
        occ_t1 = self._batched_t1_occlusion(scene, light, t1_list, N, eps)
        for t in range(1, self.TE + 2):
            for s in range(0, self.SM + 1):
                k_edges = s + t - 1
                if s + t < 2 or k_edges > self.depth:
                    continue
                if t == 1:
                    if s < 2 or not self.light_image:
                        continue  # (1,1) covered by (0,2)
                    pos, val, sri = self._strategy_t1(scene, eye, light, y0,
                                                      s, N, eps, W, H,
                                                      occ=occ_t1[s])
                    splat_pos.append(pos)
                    splat_val.append(val * _b3(1.0 / (1.0 + sri)))
                elif s == 0:
                    c, sri = self._strategy_s0(scene, eye, light, y0, t, N)
                    L = L + c * _b3(1.0 / (1.0 + sri))
                elif s == 1:
                    c, sri = self._strategy_s1(scene, eye, light, y0, t, N,
                                               eps)
                    L = L + c * _b3(1.0 / (1.0 + sri))
                elif not use_scan:
                    c, sri = self._strategy_connect(scene, eye, light, y0,
                                                    s, t, N, eps)
                    L = L + c * _b3(1.0 / (1.0 + sri))
        if use_scan and conn_pairs:
            tally = self.ray_tally is not None

            def body(carry, st_pair):
                Lc, rays = carry
                c, sri, _ = self._strategy_connect_dyn(
                    scene, eye, light, y0, st_pair[0], st_pair[1], N, eps)
                Lc = Lc + c * _b3(1.0 / (1.0 + sri))
                if tally:
                    rays = rays + common.drain_tally(self)
                return (Lc, rays), None

            rays0 = common.drain_tally(self) if tally else jnp.zeros(())
            (L, rays), _ = jax.lax.scan(
                body, (L, rays0),
                jnp.asarray(conn_pairs, jnp.int32))
            if tally:
                self.ray_tally.append(rays)

        if splat_pos:
            splat_pos = jnp.concatenate(splat_pos, axis=0)
            splat_val = jnp.concatenate(splat_val, axis=0)
        else:
            splat_pos = jnp.zeros((0, 2))
            splat_val = jnp.zeros((0, 3))
        return pos_film, L, splat_pos, splat_val

    # -- frame rendering -----------------------------------------------------
    @functools.partial(jax.jit, static_argnums=(0, 4))
    def render_chunk(self, scene, seed, sample_start, n_samples):
        st = self.settings
        H, W = st.height, st.width
        fb = jnp.zeros((H, W, 3))
        wb = jnp.zeros((H, W))
        li = jnp.zeros((H, W, 3))

        def body(i, carry):
            fb, wb, li, rays = carry
            if self.count_rays:
                self.ray_tally = []
            pos, L, spos, sval = self.trace_pass(scene, seed,
                                                 sample_start + i)
            if self.count_rays:
                rays = rays + sum(self.ray_tally)
                self.ray_tally = None
            fb, wb = film_ops.splat(fb, wb, pos, L, self.filter_kind)
            li = film_ops.splat_unfiltered(li, spos, sval)
            return fb, wb, li, rays

        return jax.lax.fori_loop(0, n_samples, body,
                                 (fb, wb, li, jnp.zeros(())))

    def finalize(self, state, spp):
        img = state["0"] / np.maximum(state["1"], 1e-12)[..., None]
        return img + state["2"] / spp

    def render(self, scene, seed=0, spp=None, chunk=32,
               checkpoint_path=None, resume=False, progress=None):
        from ..parallel.checkpoint import render_accumulate
        spp = spp or self.settings.spp
        state, spp = render_accumulate(
            self, scene, seed, spp, chunk,
            checkpoint_path=checkpoint_path, resume=resume,
            progress=progress)
        if self.count_rays and "3" in state:
            self.last_ray_count = float(np.asarray(state["3"]))
        return self.finalize(state, spp)
