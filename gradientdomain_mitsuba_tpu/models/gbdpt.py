"""Gradient-Domain Bidirectional Path Tracing (G-BDPT).

Replacement for the fork's gbdpt integrator
(src/integrators/gbdpt/gbdpt.cpp + gbdpt_proc.cpp, Manzi et al., EGSR
2015): per pixel sample, the base BDPT evaluation (models/bdpt.py) is
augmented with FOUR shifted evaluations whose EYE subpath is offset to the
neighboring pixel; the light subpath is shared (SURVEY.md §9.5).

Shift map (piecewise, per neighbor):
  - eye shifts (t>=2): offset camera ray -> z'_1; at each vertex i the
    reconnection condition c(z_i) & c(z'_i) & c(z_{i+1}) is checked
    (classification by roughness > shiftThreshold); on success the offset
    reconnects z'_i -> z_{i+1} and shares the suffix, otherwise the base
    bounce is replayed by HALF-VECTOR COPY (specular prefix replay,
    gpt.half_vector_copy) and the walk continues.  When the strategy's
    connection vertex is reached un-reconnected, the light connection
    itself acts as the reconnection (endpoint mode, gated by the same
    classifications).  See _build_offset_view;
  - light-tracing paths (t=1) are shifted in IMAGE space: the splat
    position moves one pixel, the camera ray through the shifted position
    is retraced to find z'_1, and z'_1 reconnects to y_{s-2}.  The image-
    plane Jacobian p_camArea(y_{s-1}) / p_camArea(z'_1) carries the
    vertex-area change (SURVEY.md §9.5 [G/?]).  Non-reconnectable t=1
    configurations FAIL (no replay into the light subpath): r = 0,
    contribution 0 — unbiased under the decomposed MIS below.

Estimator (decomposed gradient MIS): the primal integral is split into
per-technique components I_{s,t} = E[w_st * f] with the standard BDPT
power-heuristic weights w_st = 1/(1+A) (A = bdpt._mis_sum technique sum,
a pure function of the path).  Each component's gradient is estimated
independently with a TWO-way MIS between "sampled at this pixel, shifted
forward" and "sampled at the neighbor, shifted back":

    g_st = 1/(1 + r^2) * ( w_st(ybar) * c_off - w_st(xbar) * c_base ),
    r    = p_st(ybar) |J| / p_st(xbar)
         = |J| * prod_i pdf_fwd_offset(z_i) / pdf_fwd_base(z_i),

where c_* are the raw strategy contributions f/p and w_st(ybar) uses the
technique sum evaluated on the SHIFTED view.

The environment/delta-light family (not expressible as (s,t) strategies
over area-emitter subpaths) is estimated WITH gradients by an embedded
aux-only G-PT pass (gpt.GPTracer(aux_only=True)): its estimator is
exactly the family's two-technique NEE/escape integral, and its shift
machinery (reconnection/half-vector/environment) supplies the family's
dx/dy.  Round-1 routed this family to very_direct undifferentiated.  Unlike the fully-coupled
heuristic (one denominator over all techniques x {base, offset}), this
form stays unbiased even when different techniques use DIFFERENT shift
maps for the same physical path — which they do here: t=1 paths shift in
image space with immediate reconnection while t>=2 eye shifts may replay
specular prefixes.  The offset views store TRUE per-slot densities (so
A_o is correct even for the t'=1 technique, whose density does not
contain the camera edge); the camera-edge image-plane shift is
measure-preserving, so |J_cam| * pdf ratio of slot 0 == 1 and the slot-0
factor is simply skipped.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m
from ..core.rng import DimAllocator as DA
from ..core.rng import uniform_2d
from ..ops import bsdf as bsdf_ops
from ..ops import common, film as film_ops
from ..ops import sensor as sensor_ops
from .bdpt import (BDPTracer, SlotOverlay, SubPath, _b3, _dir_to_area,
                   _is_delta_kind, _remap0, synth_bary_from_az)
from .gpt import OFFSETS, half_vector_copy


class GBDPTracer(BDPTracer):
    """G-BDPT: BDPT base + 4 shifted eye-subpath evaluations."""

    def __init__(self, scene, settings):
        self.kinds = bsdf_ops.scene_kinds(scene)
        self._beval = functools.partial(bsdf_ops.eval, kinds=self.kinds)
        self._bpdf = functools.partial(bsdf_ops.pdf, kinds=self.kinds)
        self._bsample = functools.partial(bsdf_ops.sample, kinds=self.kinds)
        super().__init__(scene, settings)
        p = settings.integrator_props
        self.shift_threshold = float(p.get("shiftThreshold", 0.001))
        # STATIC: all-diffuse scenes compile the prefix replay away (the
        # junction always fires at the first vertex when it fires at all)
        self.any_specular = bsdf_ops.any_specular(scene.materials,
                                                  self.shift_threshold)
        # light tracing (t=1) participates fully: sampled into the light
        # image, shifted in image space for the gradients, and present in
        # every MIS denominator (camera connectable).  lightImage=false
        # removes the whole family consistently (reference knob).
        self.light_image = bool(p.get("lightImage", True))
        self.camera_connectable = self.light_image
        # lightImageGradients=false keeps the light image primal-only
        # (no image-space t=1 shifts).  The t=1 retrace + reconnection
        # visibility are the single most expensive piece of G-BDPT
        # (measured 38% of runtime on cbox at depth 6 — 2 extra 4N-lane
        # traces per t=1 strategy); scenes whose light image carries
        # little energy can trade its gradients away and land at the
        # papers' ~2.4x-of-BDPT cost.  Default ON: the reconstruction
        # then denoises the light image too (exceeds the reference,
        # whose light image is primal-only).
        self.light_image_grads = (self.light_image and
                                  bool(p.get("lightImageGradients", True)))
        # env/delta-light family: estimated (WITH gradients) by an
        # embedded aux-only G-PT tracer — its shift machinery covers
        # exactly the NEE/escape estimator this family uses, so the
        # whole family stops bypassing reconstruction (round-1 gap:
        # it was routed to very_direct undifferentiated)
        self.aux_via_gpt = self.aux_nee
        if self.aux_via_gpt:
            from .gpt import GPTracer
            self._aux_tracer = GPTracer(scene, settings, aux_only=True)

    def _classify_diffuse(self, scene, bsdf_id, valid):
        rough = bsdf_ops.roughness(scene.materials, jnp.maximum(bsdf_id, 0))
        return valid & (rough > self.shift_threshold)

    # ------------------------------------------------------------------
    def _offset_primaries(self, scene, seed, sample_idx, pixel_id, W, H):
        """Trace ALL FOUR offset-pixel camera rays as one 4N batch
        (round-2 perf pass: the four offset views previously rebuilt
        frames/material gathers sequentially; one
        4N-lane batch shares every eye-side computation and dispatch)."""
        N = pixel_id.shape[0]
        px = (pixel_id % W).astype(jnp.float32)
        py = (pixel_id // W).astype(jnp.float32)
        jitter = self._u2(seed, pixel_id, sample_idx, DA.PIXEL_JITTER)
        base = jnp.stack([px, py], -1) + jitter
        pos = (base[None] + jnp.asarray(OFFSETS)[:, None, :]).reshape(
            4 * N, 2)
        u_ap = jnp.tile(self._u2(seed, pixel_id, sample_idx, DA.APERTURE),
                        (4, 1))
        o, d = sensor_ops.sample_ray(scene.camera, W, H, pos, u_ap)
        hit = self.closest(o, d, jnp.zeros(4 * N), jnp.full(4 * N, 3e38),
                           scene.geom)
        its = common.fill_intersection(scene, o, d, hit)
        return its, d

    def _build_offset_view(self, scene, eye: SubPath, its1, d_cam, N, eps):
        """Shifted eye-subpath view with specular-prefix replay.

        The piecewise shift map (one per neighbor): starting from the
        offset camera vertex z'_1, at each vertex index i the reconnection
        condition c(z_i) & c(z'_i) & c(z_{i+1}) is checked; when it holds
        the offset reconnects z'_i -> z_{i+1} (suffix shared with the
        base), otherwise the base bounce is replayed by HALF-VECTOR COPY
        (gpt.half_vector_copy) and the walk continues.  The junction slot
        varies per lane; the view stores, per slot, either the offset
        prefix vertex (with its TRUE sampling density) or the base vertex
        with junction fixups, so every strategy (s,t) reads a consistent
        path out of the same arrays:

          endpoint slot e < junction: the strategy's light connection IS
            the reconnection (offset endpoint vertex; the per-strategy
            endpoint classifications are applied in trace_pass);
          endpoint slot e >= junction: reconnected prefix + shared suffix.

        Returns dict(view, rcum, ok_recon, ok_end, ok_end_s0), indexed by
        the strategy's endpoint slot e = t-2:
          rcum[:, e]     r(s,t) = |J| prod pdf_off/pdf_base, slots 1..e
                         (slot 0's factor is exactly 1: the image-plane
                         shift through the camera is measure-preserving)
          ok_recon[:, e] junction fired validly at some slot <= e-1
          ok_end[:, e]   endpoint mode incl. c(z_e) & c(z'_e)
          ok_end_s0[:, e] endpoint mode without classifications (s=0:
                         the HV chain itself hits the emitter)
        """
        TE = self.TE
        cls = self._classify_diffuse
        c_walk = [cls(scene, eye.bsdf_id[:, k], eye.valid[:, k])
                  for k in range(TE)]
        n_steps = max(TE - 1, 1) if self.any_specular else 1

        def set3(arr, k, val, mask):
            mk = jnp.reshape(mask, mask.shape + (1,) * (val.ndim - 1))
            return arr.at[:, k].set(jnp.where(mk, val, arr[:, k]))

        # view arrays start as the base walk; prefix slots are overwritten
        v = dict(p=eye.p, ng=eye.ng, ns=eye.ns, uv=eye.uv, wi=eye.wi,
                 bsdf_id=eye.bsdf_id, emitter_id=eye.emitter_id,
                 beta=eye.beta, pdf_fwd=eye.pdf_fwd, pdf_rev=eye.pdf_rev,
                 delta=eye.delta, aux=eye.aux)
        rfac = jnp.ones((N, TE))
        prefix_ok = [jnp.zeros(N, bool) for _ in range(TE)]
        jun_struct = [jnp.zeros(N, bool) for _ in range(TE)]
        jun_valid = [jnp.zeros(N, bool) for _ in range(TE)]
        slot_iota = jnp.arange(TE)

        # ---- slot 0: offset camera vertex z'_1, TRUE camera density ----
        ok0 = its1.valid & eye.valid[:, 0]
        prefix_ok[0] = ok0
        pf0_off = self._camera_pdf_area(scene, its1.p, its1.ng)
        v["p"] = v["p"].at[:, 0].set(its1.p)
        v["ng"] = v["ng"].at[:, 0].set(its1.ng)
        v["ns"] = v["ns"].at[:, 0].set(its1.ns)
        v["uv"] = v["uv"].at[:, 0].set(its1.uv)
        v["wi"] = v["wi"].at[:, 0].set(-d_cam)
        v["bsdf_id"] = v["bsdf_id"].at[:, 0].set(its1.bsdf_id)
        v["emitter_id"] = v["emitter_id"].at[:, 0].set(its1.emitter_id)
        v["beta"] = v["beta"].at[:, 0].set(jnp.ones((N, 3)))
        v["pdf_fwd"] = set3(v["pdf_fwd"], 0, pf0_off, ok0)
        v["delta"] = v["delta"].at[:, 0].set(
            _is_delta_kind(scene.materials, its1.bsdf_id))
        if v["aux"] is not None and its1.bary is not None:
            v["aux"] = v["aux"].at[:, 0].set(its1.bary[..., 4:6])

        cur = dict(p=its1.p, ng=its1.ng, ns=its1.ns, uv=its1.uv,
                   bsdf_id=its1.bsdf_id, wi=-d_cam)
        if self.has_cloth and its1.bary is not None:
            cur["az"] = its1.bary[..., 4:6]
        beta_cur = jnp.ones((N, 3))
        replaying = ok0

        for k in range(n_steps):
            kn = min(k + 1, TE - 1)   # slot of z_{k+2}
            kn2 = min(k + 2, TE - 1)  # slot of z_{k+3} (clamped)
            have_next = eye.valid[:, kn]
            co_k = cls(scene, cur["bsdf_id"], prefix_ok[k])
            jst = replaying & c_walk[k] & co_k & c_walk[kn] & have_next
            jun_struct[k] = jst

            # frames/params at the current offset vertex
            ssc, tsc = m.build_frame(cur["ns"])
            wi_c = m.to_local(cur["wi"], ssc, tsc, cur["ns"])
            par_c = common.material_params(
                scene, self.has_textures, cur["bsdf_id"], cur["uv"],
                bary=(synth_bary_from_az(cur["az"]) if "az" in cur
                      else None))

            # base bounce z_{k+1} -> z_{k+2}: geometry + solid-angle pdf
            dir_b = -eye.wi[:, kn]
            d2b = jnp.maximum(
                m.squared_length(eye.p[:, kn] - eye.p[:, k]), 1e-12)
            cosb = jnp.maximum(jnp.abs(m.dot(dir_b, eye.ng[:, kn])), 1e-9)
            pdf_base_sa = eye.pdf_fwd[:, kn] * d2b / cosb

            # ======== junction: reconnect z'_{k+1} -> z_{k+2} ==========
            to_j = eye.p[:, kn] - cur["p"]
            d2j = jnp.maximum(m.squared_length(to_j), 1e-12)
            distj = jnp.sqrt(d2j)
            dir_rc = to_j / _b3(distj)
            occ = self.occluded(
                common.offset_ray_origin(cur["p"], cur["ng"], dir_rc, eps),
                dir_rc, jnp.zeros(N),
                jnp.where(jst, distj - 2 * eps, -1.0), scene.geom)
            wo_rc = m.to_local(dir_rc, ssc, tsc, cur["ns"])
            f_rc = self._beval(par_c, wi_c, wo_rc)
            pb_rc = self._bpdf(par_c, wi_c, wo_rc)
            jok = (jst & ~occ & (jnp.max(f_rc, -1) > 0) & (pb_rc > 0) &
                   (pdf_base_sa > 0))
            jun_valid[k] = jok

            cosj = jnp.abs(m.dot(dir_rc, eye.ng[:, kn]))
            conv_o = cosj / d2j
            jac_rc = conv_o / jnp.maximum(cosb / d2b, 1e-30)
            beta_j = beta_cur * f_rc * _b3(
                jac_rc / jnp.maximum(pdf_base_sa, 1e-30))
            rfac_j = pb_rc * jac_rc / jnp.maximum(pdf_base_sa, 1e-30)
            pf_j = pb_rc * conv_o

            # "recently connected" fixups at slot k+2 (z_{k+2}'s incoming
            # changed to come from z'_{k+1})
            ss2, ts2 = m.build_frame(eye.ns[:, kn])
            par2 = common.material_params(scene, self.has_textures,
                                          eye.bsdf_id[:, kn],
                                          eye.uv[:, kn])
            wi2_off = m.to_local(-dir_rc, ss2, ts2, eye.ns[:, kn])
            wi2_base = m.to_local(eye.wi[:, kn], ss2, ts2, eye.ns[:, kn])
            to3 = eye.p[:, kn2] - eye.p[:, kn]
            d3sq = jnp.maximum(m.squared_length(to3), 1e-12)
            dir23 = to3 / _b3(jnp.sqrt(d3sq))
            wo2 = m.to_local(dir23, ss2, ts2, eye.ns[:, kn])
            f2_off = self._beval(par2, wi2_off, wo2)
            f2_base = self._beval(par2, wi2_base, wo2)
            pdf2_off_sa = self._bpdf(par2, wi2_off, wo2)
            pf_recent = _dir_to_area(pdf2_off_sa, dir23, d3sq,
                                     eye.ng[:, kn2])
            ratio_f2 = jnp.where(
                _b3(jnp.max(f2_base, -1) > 0),
                f2_off / jnp.maximum(f2_base, 1e-20), 0.0)
            # re-sampling z'_{k+1} from z_{k+2} (view pdf_rev[k])
            pr_j_sa = self._bpdf(par2, wo2, wi2_off)
            pr_j = _dir_to_area(pr_j_sa, -dir_rc, d2j, cur["ng"])
            scale = jnp.where(
                _b3(jnp.max(jnp.abs(eye.beta[:, kn]), -1) > 0),
                beta_j / jnp.maximum(eye.beta[:, kn], 1e-30),
                0.0) * ratio_f2

            has_kn2 = (k + 2 <= TE - 1)
            v["wi"] = set3(v["wi"], kn, -dir_rc, jok)
            v["beta"] = set3(v["beta"], kn, beta_j, jok)
            v["pdf_fwd"] = set3(v["pdf_fwd"], kn, pf_j, jok)
            v["pdf_rev"] = set3(v["pdf_rev"], k, jnp.where(jok, pr_j, 0.0),
                                jok)
            rfac = set3(rfac, kn, rfac_j, jok)
            if has_kn2:
                v["pdf_fwd"] = set3(v["pdf_fwd"], kn2, pf_recent, jok)
                rfac = set3(rfac, kn2,
                            pf_recent / _remap0(eye.pdf_fwd[:, kn2]), jok)
                # suffix throughput: beta'[j>=k+2] = beta_base[j] * scale
                suff = (slot_iota >= k + 2)[None, :, None]
                v["beta"] = jnp.where(jok[:, None, None] & suff,
                                      eye.beta * scale[:, None, :],
                                      v["beta"])
            if k >= 1:
                # re-sampling z'_k from z'_{k+1} whose outgoing changed
                pr_prev_sa = self._bpdf(par_c, wo_rc, wi_c)
                to_prev = v["p"][:, k - 1] - cur["p"]
                d2p = jnp.maximum(m.squared_length(to_prev), 1e-12)
                pr_prev = _dir_to_area(
                    pr_prev_sa, to_prev / _b3(jnp.sqrt(d2p)), d2p,
                    v["ng"][:, k - 1])
                v["pdf_rev"] = set3(v["pdf_rev"], k - 1, pr_prev, jok)

            # ======== half-vector replay step ==========================
            if self.any_specular:
                hv_can = replaying & ~jst & have_next
                ssm, tsm = m.build_frame(eye.ns[:, k])
                wi_m = m.to_local(eye.wi[:, k], ssm, tsm, eye.ns[:, k])
                wo_m = m.to_local(dir_b, ssm, tsm, eye.ns[:, k])
                par_m = common.material_params(scene, self.has_textures,
                                               eye.bsdf_id[:, k],
                                               eye.uv[:, k])
                hv = half_vector_copy(self._beval, self._bpdf, wi_m, wo_m,
                                      par_m, eye.delta[:, k], wi_c, par_c)
                hv_ok = hv_can & hv["valid"]
                wo_w = m.to_world(hv["wo"], ssc, tsc, cur["ns"])
                o_new = common.offset_ray_origin(cur["p"], cur["ng"],
                                                 wo_w, eps)
                hit = self.closest(o_new, wo_w, jnp.zeros(N),
                                   jnp.where(hv_ok, 3e38, -1.0),
                                   scene.geom)
                its_n = common.fill_intersection(scene, o_new, wo_w, hit)
                adv = hv_ok & its_n.valid

                pb_base = jnp.where(eye.delta[:, k], 1.0,
                                    jnp.maximum(pdf_base_sa, 1e-30))
                beta_hv = beta_cur * hv["f"] * _b3(hv["jac"] / pb_base)
                rfac_hv = hv["pdf"] * hv["jac"] / pb_base
                conv_n = jnp.abs(m.dot(its_n.ng, wo_w)) / jnp.maximum(
                    its_n.t ** 2, 1e-12)
                pf_hv = jnp.where(hv["is_delta"], 0.0,
                                  hv["pdf"]) * conv_n

                prefix_ok[kn] = adv
                v["p"] = set3(v["p"], kn, its_n.p, adv)
                v["ng"] = set3(v["ng"], kn, its_n.ng, adv)
                v["ns"] = set3(v["ns"], kn, its_n.ns, adv)
                v["uv"] = set3(v["uv"], kn, its_n.uv, adv)
                v["wi"] = set3(v["wi"], kn, -wo_w, adv)
                v["bsdf_id"] = set3(v["bsdf_id"], kn, its_n.bsdf_id, adv)
                v["emitter_id"] = set3(v["emitter_id"], kn,
                                       its_n.emitter_id, adv)
                v["beta"] = set3(v["beta"], kn, beta_hv, adv)
                v["pdf_fwd"] = set3(v["pdf_fwd"], kn,
                                    jnp.where(adv, pf_hv, 0.0), adv)
                v["delta"] = set3(
                    v["delta"], kn,
                    _is_delta_kind(scene.materials, its_n.bsdf_id), adv)
                rfac = set3(rfac, kn, rfac_hv, adv)
                if k >= 1:
                    # re-sampling z'_k from z'_{k+1} given HV outgoing
                    pr_sa = self._bpdf(par_c, hv["wo"], wi_c)
                    to_prev = v["p"][:, k - 1] - cur["p"]
                    d2p = jnp.maximum(m.squared_length(to_prev), 1e-12)
                    pr_hv = _dir_to_area(
                        pr_sa, to_prev / _b3(jnp.sqrt(d2p)), d2p,
                        v["ng"][:, k - 1])
                    v["pdf_rev"] = set3(v["pdf_rev"], k - 1, pr_hv, adv)

                # advance the replay head
                if v["aux"] is not None and its_n.bary is not None:
                    v["aux"] = set3(v["aux"], kn, its_n.bary[..., 4:6],
                                    adv)
                repl = [("p", its_n.p), ("ng", its_n.ng),
                        ("ns", its_n.ns), ("uv", its_n.uv),
                        ("bsdf_id", its_n.bsdf_id), ("wi", -wo_w)]
                if "az" in cur and its_n.bary is not None:
                    repl.append(("az", its_n.bary[..., 4:6]))
                for key, val in repl:
                    mk = jnp.reshape(adv, adv.shape +
                                     (1,) * (val.ndim - 1))
                    cur[key] = jnp.where(mk, val, cur[key])
                beta_cur = jnp.where(_b3(adv), beta_hv, beta_cur)
                replaying = adv
            else:
                replaying = jnp.zeros(N, bool)

        # ---- per-endpoint masks ----------------------------------------
        recon_before = []   # junction fired validly at slot <= e-1
        struct_before = []  # junction fired structurally at slot <= e-1
        acc_v = jnp.zeros(N, bool)
        acc_s = jnp.zeros(N, bool)
        for e in range(TE):
            recon_before.append(acc_v)
            struct_before.append(acc_s)
            acc_v = acc_v | jun_valid[e]
            acc_s = acc_s | jun_struct[e]
        ok_recon = jnp.stack(recon_before, axis=1)
        ok_end_s0 = (jnp.stack(prefix_ok, axis=1) &
                     ~jnp.stack(struct_before, axis=1))
        c_off_all = jnp.stack(
            [cls(scene, v["bsdf_id"][:, e], prefix_ok[e])
             for e in range(TE)], axis=1)
        ok_end = (ok_end_s0 & jnp.stack(c_walk, axis=1) & c_off_all)

        rcum = jnp.cumprod(rfac.at[:, 0].set(1.0), axis=1)

        # slot validity: the offset prefix where it exists, base slots
        # past a valid junction (slot k is post-junction iff the junction
        # fired at some slot <= k-1, which is exactly ok_recon[:, k])
        valid = jnp.stack(prefix_ok, axis=1) | (ok_recon & eye.valid)

        view = SubPath(p=v["p"], ng=v["ng"], ns=v["ns"], wi=v["wi"],
                       uv=v["uv"], bsdf_id=v["bsdf_id"],
                       emitter_id=v["emitter_id"], beta=v["beta"],
                       pdf_fwd=v["pdf_fwd"], pdf_rev=v["pdf_rev"],
                       delta=v["delta"], valid=valid, aux=v["aux"])
        return dict(view=view, rcum=rcum, ok_recon=ok_recon,
                    ok_end=ok_end, ok_end_s0=ok_end_s0)

    # ------------------------------------------------------------------
    def _t1_prev(self, scene, light4, y04, s):
        """(prev_p, prev_ng, prev_ok, c_prev) behind the t=1 endpoint:
        y_{s-2} for s>=3, the emitter point y_0 for s==2."""
        kl = s - 2
        if s >= 3:
            prev_p = light4.p[:, kl - 1]
            prev_ng = light4.ng[:, kl - 1]
            prev_ok = light4.valid[:, kl - 1]
            c_prev = self._classify_diffuse(
                scene, light4.bsdf_id[:, kl - 1], prev_ok)
        else:
            prev_p, prev_ng = y04.p, y04.ng
            prev_ok = y04.ok
            c_prev = prev_ok  # emitter surface: always connectable
        return prev_p, prev_ng, prev_ok, c_prev

    def _t1_cam_rays(self, scene, film_base, N, W, H):
        """Camera retrace rays through the 4 neighbors of the base t=1
        splat position (batched across strategies by the caller)."""
        M = 4 * N
        film_o = (film_base[None] +
                  jnp.asarray(OFFSETS)[:, None, :]).reshape(M, 2)
        return sensor_ops.sample_ray(scene.camera, W, H, film_o,
                                     jnp.full((M, 2), 0.5))

    def _t1_occ_ray(self, scene, light4, y04, s, its1, eps):
        """Reconnection-visibility ray z'_1 -> prev for one t=1 strategy
        (origin, dir, maxt); concatenated across strategies into one
        occlusion dispatch by the caller."""
        prev_p, prev_ng, _, _ = self._t1_prev(scene, light4, y04, s)
        to1 = its1.p - prev_p
        d2 = jnp.maximum(m.squared_length(to1), 1e-12)
        dist = jnp.sqrt(d2)
        dirp = to1 / _b3(dist)
        return (common.offset_ray_origin(prev_p, prev_ng, dirp, eps),
                dirp, dist - 2 * eps)

    def _t1_offset(self, scene, light4, y04, s, film_base, N, eps, W, H,
                   c_light_end, its1=None, occ=None):
        """Image-space shift of a light-tracing path (t=1, reference
        gbdpt_proc.cpp light-image handling): retrace the camera ray
        through film_base + offset -> z'_1, reconnect z'_1 -> y_{s-2},
        evaluate the shifted t=1 contribution + its technique sum on a
        light-subpath VIEW with slot s-2 replaced.

        light4/y04 are the 4x-TILED subpaths ([4N] lanes); all four
        offset directions evaluate as ONE batch (round-2 perf pass).
        Returns (value*J [4,N,3], sri_off [4,N], r [4,N]).  The shift
        fails (r=0) unless y_{s-1}, z'_1 and y_{s-2} are all classified
        diffuse — the same piecewise map as the eye-subpath shifts."""
        kl = s - 2
        M = 4 * N
        prev_p, prev_ng, prev_ok, c_prev = self._t1_prev(
            scene, light4, y04, s)

        pf_base = _remap0(light4.pdf_fwd[:, kl])
        jbase = self._camera_pdf_area(scene, light4.p[:, kl],
                                      light4.ng[:, kl])

        if its1 is None:
            o_c, d_c = self._t1_cam_rays(scene, film_base, N, W, H)
            hit = self.closest(o_c, d_c, jnp.zeros(M), jnp.full(M, 3e38),
                               scene.geom)
            its1 = common.fill_intersection(scene, o_c, d_c, hit)
        c_off = self._classify_diffuse(scene, its1.bsdf_id, its1.valid)

        to1 = its1.p - prev_p
        d2 = jnp.maximum(m.squared_length(to1), 1e-12)
        dist = jnp.sqrt(d2)
        dirp = to1 / _b3(dist)
        conv_rc = jnp.abs(m.dot(dirp, its1.ng)) / d2

        if occ is None:
            occ = self.occluded(
                common.offset_ray_origin(prev_p, prev_ng, dirp, eps),
                dirp, jnp.zeros(M), dist - 2 * eps, scene.geom)
        ok = (its1.valid & prev_ok & light4.valid[:, kl] & c_light_end &
              c_off & c_prev & ~occ)

        # BSDF / emission factor at y_{s-2} toward z'_1 (adjoint side)
        if s >= 3:
            f_prev, pdf_prev_sa = self._eval_at(scene, light4, kl - 1,
                                                dirp)
            wi_w = light4.wi[:, kl - 1]
            ns_p, ng_p = light4.ns[:, kl - 1], light4.ng[:, kl - 1]
            corr = ((jnp.abs(m.dot(dirp, ns_p)) *
                     jnp.abs(m.dot(wi_w, ng_p))) /
                    jnp.maximum(jnp.abs(m.dot(dirp, ng_p)) *
                                jnp.abs(m.dot(wi_w, ns_p)), 1e-9))
            f_prev = f_prev * _b3(corr)
        else:
            cos0 = jnp.maximum(m.dot(dirp, y04.ng), 0.0)
            f_prev = jnp.broadcast_to(_b3(cos0), (M, 3))
            pdf_prev_sa = cos0 / jnp.pi
        ok = ok & (jnp.max(f_prev, -1) > 0) & (pdf_prev_sa > 0)

        # image-plane Jacobian: dA(z'_1)/dA(y_{s-1}) in image coords
        joff = self._camera_pdf_area(scene, its1.p, its1.ng)
        jimg = jbase / jnp.maximum(joff, 1e-30)

        beta_prev = y04.beta if s == 2 else light4.beta[:, kl - 1]
        beta_off = beta_prev * f_prev * _b3(conv_rc / pf_base)
        pf_off = pdf_prev_sa * conv_rc

        # reverse-pdf fixups behind the junction
        y0_view = y04
        over = {
            ("p", kl): its1.p, ("ng", kl): its1.ng, ("ns", kl): its1.ns,
            ("uv", kl): its1.uv, ("wi", kl): -dirp,
            ("bsdf_id", kl): its1.bsdf_id, ("beta", kl): beta_off,
            ("pdf_fwd", kl): pf_off,
            ("delta", kl): _is_delta_kind(scene.materials, its1.bsdf_id),
            ("valid", kl): ok,
        }
        if s >= 4:
            over[("pdf_rev", kl - 2)] = self._pdf_toward_prev(
                scene, light4, kl - 1, dirp, light4.p[:, kl - 2],
                light4.ng[:, kl - 2])
        elif s == 3:
            y0_view = y04._replace(pdf_rev=self._pdf_toward_prev(
                scene, light4, kl - 1, dirp, y04.p, y04.ng))
        if light4.aux is not None and its1.bary is not None:
            over[("aux", kl)] = its1.bary[..., 4:6]
        # SlotOverlay instead of .at[:, kl].set() materialization: the
        # copies + re-reads of the 12 [4N, D, ...] fields were 41% of
        # this pass's memory traffic (bdpt.SlotOverlay docstring)
        view = SlotOverlay(light4, over)

        # eye is only shape-inspected by _mis_sum for t=1 (its loop
        # over eye-side techniques is empty); pass the light view.
        # occ=False: z'_1 IS the closest hit along the retraced camera
        # ray, so its camera visibility holds by construction — this
        # skips one 4N-lane shadow trace per t=1 strategy.
        _, val, sri = self._strategy_t1(scene, view, view, y0_view, s,
                                        M, eps, W, H,
                                        occ=jnp.zeros(M, bool))
        r = jnp.where(ok, (pf_off / pf_base) * jimg, 0.0)
        val = jnp.where(_b3(ok), val * _b3(jimg), 0.0)
        sri = jnp.where(ok, sri, 0.0)
        return (val.reshape(4, N, 3), sri.reshape(4, N), r.reshape(4, N))

    # ------------------------------------------------------------------
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

        # ---- all 4 offset views as ONE 4N-lane batch (perf pass) --------
        def tile4(tree):
            return jax.tree.map(
                lambda a: jnp.tile(a, (4,) + (1,) * (a.ndim - 1)), tree)

        its4, d4 = self._offset_primaries(scene, seed, sample_idx,
                                          pixel_id, W, H)
        eye4 = tile4(eye)
        V4 = self._build_offset_view(scene, eye4, its4, d4, 4 * N, eps)
        light4 = tile4(light)
        y04 = tile4(y0)
        TE = self.TE
        r4 = V4["rcum"].reshape(4, N, TE)
        ok_recon4 = V4["ok_recon"].reshape(4, N, TE)
        ok_end4 = V4["ok_end"].reshape(4, N, TE)
        ok_end_s04 = V4["ok_end_s0"].reshape(4, N, TE)

        primal = jnp.zeros((N, 3))
        very = aux_L  # zeros when aux_via_gpt (walk skips collection)
        grad = jnp.zeros((4, N, 3))
        if self.aux_via_gpt:
            # env/delta family WITH gradients: aux-only G-PT pass (same
            # counter-RNG pixel stream; its depth-1 env radiance is the
            # family's very-direct part, the rest lands in primal+grad
            # and participates in the Poisson reconstruction)
            self._aux_tracer.ray_tally = self.ray_tally  # shared counter
            _, aux_primal, aux_very, aux_grad = self._aux_tracer.trace_pass(
                scene, seed, sample_idx, pixel_id=pixel_id)
            self._aux_tracer.ray_tally = None
            primal = primal + aux_primal
            very = very + aux_very
            grad = grad + aux_grad
        splat_pos, splat_val = [], []
        t1_pos, t1_grad = [], []

        def pair_grad(c_base, sri_base, c_off, sri_off, r, ok):
            """Decomposed gradient estimate for one (strategy, offset)
            pair — see module docstring.  Guards: invalid offset views can
            carry inf/NaN technique sums and r*r can overflow to inf (a
            2-way weight of 0 on this side — the neighbor's sample covers
            the pair)."""
            sri_off = jnp.where(ok, sri_off, 0.0)
            r = jnp.where(ok, r, 0.0)
            c_off = jnp.where(_b3(ok), c_off, 0.0)
            a = 1.0 / (1.0 + r * r)
            a = jnp.where(jnp.isnan(a), 0.0, a)
            w_off = jnp.where(ok, 1.0 / (1.0 + sri_off), 0.0)
            w_base = 1.0 / (1.0 + sri_base)
            return _b3(a) * (_b3(w_off) * c_off - _b3(w_base) * c_base)

        def run_strategy(view, s, t, return_aux=False):
            if s == 0:
                return self._strategy_s0(scene, view, light, y0, t, N,
                                         return_aux=return_aux)
            if s == 1:
                return self._strategy_s1(scene, view, light, y0, t, N, eps,
                                         return_aux=return_aux)
            return self._strategy_connect(scene, view, light, y0, s, t, N,
                                          eps, return_aux=return_aux)

        def run_strategy4(view, s, t, occ=None):
            """Offset-view strategy evaluation on the 4N batch.

            occ: precomputed visibility.  For e=1 in all-diffuse scenes
            the only contributing mode is reconnected-at-slot-0, whose
            endpoint vertex is the BASE z_2 — the shadow ray to the light
            vertex is bit-identical to the base strategy's, so its result
            is reused (one fewer 4N-lane trace per t=3 strategy)."""
            M = 4 * N
            if s == 0:
                return self._strategy_s0(scene, view, light4, y04, t, M)
            if s == 1:
                return self._strategy_s1(scene, view, light4, y04, t, M,
                                         eps, occ=occ)
            return self._strategy_connect(scene, view, light4, y04, s, t,
                                          M, eps, occ=occ)

        def classify_light_end(s):
            """Shift-map classification of the reconnection target when it
            is a light vertex (t=2 endpoint / t=1 second vertex)."""
            if s <= 1:
                return jnp.ones(N, bool)  # y_0: emitter surface
            return self._classify_diffuse(scene, light.bsdf_id[:, s - 2],
                                          light.valid[:, s - 2])

        # s>=2, t>=4 connection pairs: scanned through ONE compiled body
        # when the strategy table is large (compile time of the unrolled
        # double loop grows ~quadratically with depth; bdpt.py applies the
        # same treatment to its s>=2,t>=2 block).  t in {2,3} stays
        # unrolled: those rows use the e==1 occlusion-reuse / endpoint
        # special cases.  GDMT_SCAN_STRATEGIES=1 forces, =0 disables.
        import os as _os
        scan_pairs = [(s, t) for t in range(4, self.TE + 2)
                      for s in range(2, self.SM + 1)
                      if s + t - 1 <= self.depth]
        all_pairs = sum(1 for t in range(2, self.TE + 2)
                        for s in range(2, self.SM + 1)
                        if s + t - 1 <= self.depth)
        scan_env = _os.environ.get("GDMT_SCAN_STRATEGIES", "")
        use_scan = bool(scan_pairs) and (
            scan_env == "1" or (scan_env != "0" and all_pairs > 21))

        # ---- t=1 strategies: ALL traversal work batched across s --------
        # (was one occlusion + one retrace + one visibility dispatch PER
        # strategy — 38% of depth-6 runtime; now 3 dispatches total)
        t1_list = ([s for s in range(2, self.SM + 1) if s <= self.depth]
                   if self.light_image else [])
        occ_t1 = self._batched_t1_occlusion(scene, light, t1_list, N, eps)
        t1_data = {}
        for s in t1_list:
            pos, val, sri = self._strategy_t1(scene, eye, light, y0, s, N,
                                              eps, W, H, occ=occ_t1[s])
            t1_data[s] = dict(pos=pos, val=val, sri=sri)
        if t1_list and self.light_image_grads:
            M = 4 * N
            nb = len(t1_list)
            cam = [self._t1_cam_rays(scene, t1_data[s]["pos"], N, W, H)
                   for s in t1_list]
            o_c = jnp.concatenate([c[0] for c in cam])
            d_c = jnp.concatenate([c[1] for c in cam])
            hit = self.closest(o_c, d_c, jnp.zeros(nb * M),
                               jnp.full(nb * M, 3e38), scene.geom)
            its1_all = common.fill_intersection(scene, o_c, d_c, hit)
            sl = lambda tree, i: jax.tree.map(
                lambda a: a[i * M:(i + 1) * M], tree)
            orays = [self._t1_occ_ray(scene, light4, y04, s,
                                      sl(its1_all, i), eps)
                     for i, s in enumerate(t1_list)]
            occ_all = self.occluded(
                jnp.concatenate([r[0] for r in orays]),
                jnp.concatenate([r[1] for r in orays]),
                jnp.zeros(nb * M),
                jnp.concatenate([r[2] for r in orays]), scene.geom)
            for i, s in enumerate(t1_list):
                t1_data[s]["its1"] = sl(its1_all, i)
                t1_data[s]["occ"] = occ_all[i * M:(i + 1) * M]

        for t in range(1, self.TE + 2):
            for s in range(0, self.SM + 1):
                k_edges = s + t - 1
                if s + t < 2 or k_edges > self.depth:
                    continue
                if use_scan and s >= 2 and t >= 4:
                    continue  # handled by the scanned block below
                if t == 1:
                    if s < 2 or not self.light_image:
                        continue
                    pos = t1_data[s]["pos"]
                    val = t1_data[s]["val"]
                    sri_base = t1_data[s]["sri"]
                    splat_pos.append(pos)
                    splat_val.append(val * _b3(1.0 / (1.0 + sri_base)))
                    if self.light_image_grads:
                        v_off, sri_off, r = self._t1_offset(
                            scene, light4, y04, s, pos, N, eps, W, H,
                            jnp.tile(classify_light_end(s), (4,)),
                            its1=t1_data[s].get("its1"),
                            occ=t1_data[s].get("occ"))
                        g = pair_grad(val[None], sri_base[None], v_off,
                                      sri_off, r, r > 0)
                        t1_pos.append(pos)
                        t1_grad.append(g)
                    continue

                e = t - 2
                # SUFFIX FACTORIZATION (all-diffuse scenes): with
                # any_specular False the junction can only fire at slot 0,
                # so every contributing offset lane of a strategy whose
                # endpoint slot e >= 2 reads a PURE shared suffix —
                # identical endpoint vertex, incoming direction, light-side
                # eval, and connection visibility.  The offset contribution
                # is then exactly c_base * (beta'/beta) and the only real
                # offset work left is _mis_sum over the view's pdf arrays
                # with the base strategy's own fixups (the endpoint-local
                # pdfs coincide).  This removes every 4N-lane occlusion ray
                # and BSDF eval for t >= 4 — the bulk of the (s,t) table —
                # and is what brings G-BDPT's cost toward the papers' 2-3x
                # of BDPT instead of the naive 5x.  (Endpoint mode cannot
                # contribute at e >= 1 here: prefix_ok[k>=1] is statically
                # False without specular replay.)
                use_suffix = (not self.any_specular) and e >= 2
                c_base, sri_base, auxd = run_strategy(eye, s, t,
                                                      return_aux=True)
                w_base = 1.0 / (1.0 + sri_base)
                if s == 0 and t == 2:
                    very = very + c_base * _b3(w_base)
                    continue  # very direct: excluded from gradients
                primal = primal + c_base * _b3(w_base)

                # reconnected mode: junction fired inside this strategy's
                # eye prefix.  Endpoint mode: the light connection IS the
                # reconnection — gate it with the same classifications the
                # map uses everywhere.  All 4 offsets evaluate as one 4N
                # batch.
                if s == 0:
                    ok = ok_recon4[:, :, e] | ok_end_s04[:, :, e]
                else:
                    ok = ok_recon4[:, :, e] | (
                        ok_end4[:, :, e] & classify_light_end(s)[None])
                if use_suffix:
                    bb = eye.beta[:, e]
                    vb = V4["view"].beta[:, e].reshape(4, N, 3)
                    ratio = jnp.where(
                        (jnp.max(bb, -1) > 0)[None, :, None],
                        vb / jnp.maximum(bb, 1e-30)[None], 0.0)
                    c_off = c_base[None] * ratio
                    tl = lambda a: jnp.tile(a, (4,))
                    sri_off = self._mis_sum(
                        V4["view"], light4, y04, s, t,
                        tl(auxd["pdf_rev_pt"]),
                        tl(auxd["pdf_rev_pt_minus"]),
                        tl(auxd["pdf_rev_qs"]),
                        tl(auxd["pdf_rev_qs_minus"])).reshape(4, N)
                else:
                    occ4 = None
                    if (not self.any_specular) and e == 1 and s >= 1:
                        occ4 = jnp.tile(auxd["occ"], (4,))
                    c_off, sri_off = run_strategy4(V4["view"], s, t,
                                                   occ=occ4)
                    c_off = c_off.reshape(4, N, 3)
                    sri_off = sri_off.reshape(4, N)
                grad = grad + pair_grad(
                    c_base[None], sri_base[None], c_off, sri_off,
                    r4[:, :, e], ok)

        if use_scan and scan_pairs:
            # scanned s>=2, t>=4 block: every pair here has endpoint slot
            # e >= 2, so the structure is uniform (suffix factorization in
            # all-diffuse scenes, full 4N offset re-eval otherwise) and
            # ONE compiled body serves the whole class.
            tally = self.ray_tally is not None
            use_suffix = not self.any_specular

            def body(carry, st_pair):
                primal_c, grad_c, rays = carry
                s, t = st_pair[0], st_pair[1]
                e = t - 2
                c_base, sri_base, auxd = self._strategy_connect_dyn(
                    scene, eye, light, y0, s, t, N, eps)
                w_base = 1.0 / (1.0 + sri_base)
                primal_c = primal_c + c_base * _b3(w_base)
                cle = self._classify_diffuse(
                    scene, light.bsdf_id[:, s - 2], light.valid[:, s - 2])
                ok = ok_recon4[:, :, e] | (ok_end4[:, :, e] & cle[None])
                if use_suffix:
                    bb = eye.beta[:, e]
                    vb = V4["view"].beta[:, e].reshape(4, N, 3)
                    ratio = jnp.where(
                        (jnp.max(bb, -1) > 0)[None, :, None],
                        vb / jnp.maximum(bb, 1e-30)[None], 0.0)
                    c_off = c_base[None] * ratio
                    tl = lambda a: jnp.tile(a, (4,))
                    sri_off = self._mis_sum_dyn(
                        V4["view"], light4, y04, s, t,
                        tl(auxd["pdf_rev_pt"]),
                        tl(auxd["pdf_rev_pt_minus"]),
                        tl(auxd["pdf_rev_qs"]),
                        tl(auxd["pdf_rev_qs_minus"])).reshape(4, N)
                else:
                    c_off, sri_off, _ = self._strategy_connect_dyn(
                        scene, V4["view"], light4, y04, s, t, 4 * N, eps)
                    c_off = c_off.reshape(4, N, 3)
                    sri_off = sri_off.reshape(4, N)
                grad_c = grad_c + pair_grad(
                    c_base[None], sri_base[None], c_off, sri_off,
                    r4[:, :, e], ok)
                if tally:
                    rays = rays + common.drain_tally(self)
                return (primal_c, grad_c, rays), None

            rays0 = (common.drain_tally(self) if tally
                     else jnp.zeros(()))
            (primal, grad, rays_out), _ = jax.lax.scan(
                body, (primal, grad, rays0),
                jnp.asarray(scan_pairs, jnp.int32))
            if tally:
                self.ray_tally.append(rays_out)

        def cat(parts, shape):
            if parts:
                return jnp.concatenate(parts, axis=-2 if len(shape) == 3
                                       else 0)
            return jnp.zeros(shape)

        splat_pos = cat(splat_pos, (0, 2))
        splat_val = cat(splat_val, (0, 3))
        t1_pos = cat(t1_pos, (0, 2))
        t1_grad = cat(t1_grad, (4, 0, 3))
        return (pos_film, primal, very, grad, splat_pos, splat_val,
                t1_pos, t1_grad)

    # ------------------------------------------------------------------
    @functools.partial(jax.jit, static_argnums=(0, 4))
    def render_chunk(self, scene, seed, sample_start, n_samples):
        st = self.settings
        H, W = st.height, st.width
        zero = lambda: jnp.zeros((H, W, 3))
        bufs = dict(primal=zero(), dx=zero(), dy=zero(),
                    very_direct=zero(), light_img=zero(),
                    wsum=jnp.zeros((H, W)))
        if self.count_rays:
            bufs["rays"] = jnp.zeros(())

        def body(i, bufs):
            if self.count_rays:
                self.ray_tally = []
            (pos, primal, very, grad, spos, sval, t1p, t1g) = \
                self.trace_pass(scene, seed, sample_start + i)
            rays_acc = None
            if self.count_rays:
                rays_acc = bufs["rays"] + sum(self.ray_tally)
                self.ray_tally = None
            fb, wb = film_ops.splat(bufs["primal"], bufs["wsum"], pos,
                                    primal, self.filter_kind)
            vd, _ = film_ops.splat(bufs["very_direct"],
                                   jnp.zeros_like(wb), pos, very,
                                   self.filter_kind)
            li = film_ops.splat_unfiltered(bufs["light_img"], spos, sval)
            dx = film_ops.splat_unfiltered(bufs["dx"], pos, grad[0])
            dx = film_ops.splat_unfiltered(
                dx, pos + jnp.asarray(OFFSETS[1]), -grad[1])
            dy = film_ops.splat_unfiltered(bufs["dy"], pos, grad[2])
            dy = film_ops.splat_unfiltered(
                dy, pos + jnp.asarray(OFFSETS[3]), -grad[3])
            # light-image (t=1) gradient pairs splat at the base splat
            # position, same forward/backward lattice convention
            dx = film_ops.splat_unfiltered(dx, t1p, t1g[0])
            dx = film_ops.splat_unfiltered(
                dx, t1p + jnp.asarray(OFFSETS[1]), -t1g[1])
            dy = film_ops.splat_unfiltered(dy, t1p, t1g[2])
            dy = film_ops.splat_unfiltered(
                dy, t1p + jnp.asarray(OFFSETS[3]), -t1g[3])
            out = dict(primal=fb, dx=dx, dy=dy, very_direct=vd,
                       light_img=li, wsum=wb)
            if rays_acc is not None:
                out["rays"] = rays_acc
            return out

        return jax.lax.fori_loop(0, n_samples, body, bufs)

    def finalize(self, state, spp):
        if self.count_rays and "rays" in state:
            self.last_ray_count = float(np.asarray(state["rays"]))
        state = {k: v for k, v in state.items() if k != "rays"}
        w = np.maximum(state["wsum"], 1e-12)[..., None]
        return {
            # the light image is part of the PRIMAL the Poisson solve
            # sees — its gradients are estimated (t=1 image-space shifts),
            # so it must not bypass reconstruction (gbdpt_wr merge [G])
            "primal": state["primal"] / w + state["light_img"] / spp,
            "very_direct": state["very_direct"] / w,
            "dx": state["dx"] / spp,
            "dy": state["dy"] / spp,
        }

    def render(self, scene, seed=0, spp=None, chunk=32,
               checkpoint_path=None, resume=False, progress=None):
        """Returns buffers dict; the light image is merged into primal
        (it participates in reconstruction via the t=1 gradient shifts);
        very_direct is re-added after reconstruction."""
        from ..parallel.checkpoint import render_accumulate
        spp = spp or self.settings.spp
        state, spp = render_accumulate(
            self, scene, seed, spp, chunk,
            checkpoint_path=checkpoint_path, resume=resume,
            progress=progress)
        return self.finalize(state, spp)
