"""Virtual point lights / instant radiosity (src/integrators/vpl/vpl.cpp).

The reference deposits VPLs by random-walking from the emitters, then
shades every pixel against every VPL with clamped point-to-point
transport.  That is an outer-product workload — ideal for a wavefront: the
camera pass produces one shading record per pixel, the VPL table is a
small SoA array, and the [pixels x VPL-chunk] contribution matrix is
evaluated branch-free with one shadow-ray batch per chunk.

Estimator decomposition (deviation in bookkeeping, not in the result):
  - DIRECT light: per-pass NEE at the first storable camera vertex plus
    emitters hit through the specular chain (the reference encodes this
    as 'luminaire VPLs'; an explicit NEE sample is strictly lower
    variance for the same ray budget)
  - INDIRECT light: every photon-walk surface deposit y_k with flux
    Phi_k contributes  f_x(cam,dir) cos_x * f_y(in,-dir) cos_y *
    Phi_k / r^2 * V(x,y)  with r^2 clamped below by
    (clamping * scene_extent)^2 — the reference's relative distance
    clamp that trades a small bias for bounded variance.

Camera chains pass through delta vertices exactly like the reference
(VPL rendering shades at the first non-delta vertex).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m
from ..core.rng import DimAllocator as DA
from ..ops import bsdf as bsdf_ops
from ..ops import common, emitter as em_ops
from ..ops import film as film_ops
from .sppm import SPPMTracer

VPL_NEE_DIM = 24576  # rng dim block for the camera-vertex NEE


class VPLTracer(SPPMTracer):
    """integrator_props: vplCount (walk count, default 1024; deposits =
    count x depth), clamping (relative min distance, default 0.1),
    vplChunk (VPLs per shading batch, default 256), maxDepth/rrDepth."""

    def __init__(self, scene, settings):
        # reuse the SPPM photon walk (emission + adjoint correction) and
        # visible-point camera chain; the gather machinery goes unused
        settings.integrator_props.setdefault(
            "photonCount", int(settings.integrator_props.get(
                "vplCount", 1024)))
        super().__init__(scene, settings)
        props = settings.integrator_props
        # a deposit at photon bounce k shades as a (k+3)-segment path:
        # cap the walk so maxDepth counts total segments like vpl.cpp
        if settings.max_depth > 0:
            self.photon_depth = max(settings.max_depth - 2, 1)
        self.clamping = float(props.get("clamping", 0.1))
        self.vpl_chunk = int(props.get("vplChunk", 256))
        self.extent = float(np.asarray(scene.ray_eps)) / 1e-4

    # -- VPL shading --------------------------------------------------------
    def _shade_chunk(self, scene, vp, vpl, n_walks):
        """Contribution of one VPL chunk to every pixel: [N, 3]."""
        pos, flux, pdir, ok, ns_y, bsdf_y, uv_y = vpl
        N = vp["p"].shape[0]
        K = pos.shape[0]
        eps = scene.ray_eps

        to_k = pos[None, :, :] - vp["p"][:, None, :]      # [N, K, 3]
        r2 = jnp.maximum(m.squared_length(to_k), 1e-12)
        r = jnp.sqrt(r2)
        dirs = to_k / r[..., None]
        r2_clamped = jnp.maximum(r2, (self.clamping * self.extent) ** 2)

        # camera-side eval: f_x * cos_x
        ssx, tsx = m.build_frame(vp["ns"])
        wi_x = m.to_local(vp["wi"], ssx, tsx, vp["ns"])
        wo_x = m.to_local(dirs, ssx[:, None], tsx[:, None],
                          vp["ns"][:, None])
        par_x = common.material_params(scene, self.has_textures,
                                       vp["bsdf"], vp["uv"])
        par_xb = jax.tree.map(
            lambda a: (jnp.broadcast_to(a[:, None], (N, K) + a.shape[1:])
                       if a is not None else None), par_x,
            is_leaf=lambda x: x is None)
        f_x = bsdf_ops.eval(par_xb, jnp.broadcast_to(wi_x[:, None],
                                                     (N, K, 3)),
                            wo_x, self.kinds)

        # VPL-side eval: f_y * cos_y (incoming photon direction wi)
        ssy, tsy = m.build_frame(ns_y)
        wi_y = m.to_local(-pdir, ssy, tsy, ns_y)          # [K, 3]
        wo_y = m.to_local(-dirs, ssy[None], tsy[None], ns_y[None])
        par_y = common.material_params(scene, self.has_textures,
                                       bsdf_y, uv_y)
        par_yb = jax.tree.map(
            lambda a: (jnp.broadcast_to(a[None], (N, K) + a.shape[1:])
                       if a is not None else None), par_y,
            is_leaf=lambda x: x is None)
        f_y = bsdf_ops.eval(par_yb, jnp.broadcast_to(wi_y[None],
                                                     (N, K, 3)),
                            wo_y, self.kinds)

        # one shadow-ray batch for the whole [N, K] block; both endpoints
        # lie ON geometry, so the origin offsets along x's geometric
        # normal and tmax stops short of the VPL's surface by the
        # eps/cos rule path.py uses for its NEE rays
        o_sh = common.offset_ray_origin(
            jnp.broadcast_to(vp["p"][:, None, :], (N, K, 3)),
            jnp.broadcast_to(vp["ng"][:, None, :], (N, K, 3)),
            dirs, eps)
        tmax = r - 2.0 * eps / jnp.maximum(
            jnp.abs(jnp.sum(dirs * ns_y[None], -1)), 1e-3)
        occ = self.occluded(
            o_sh.reshape(-1, 3), dirs.reshape(-1, 3),
            jnp.zeros(N * K), tmax.reshape(-1), scene.geom)
        vis = (~occ).reshape(N, K)

        w = (ok[None, :] & vp["valid"][:, None] & vis)
        contrib = (f_x * f_y *
                   (flux[None] / r2_clamped[..., None]))
        contrib = jnp.where(w[..., None], contrib, 0.0)
        return jnp.sum(contrib, axis=1) / n_walks

    def _direct_nee(self, scene, seed, pass_idx, pixel_id, vp):
        """One NEE sample at the visible point."""
        u_sel = self._u1(seed, pixel_id, pass_idx, VPL_NEE_DIM)
        u_pos = self._u2(seed, pixel_id, pass_idx, VPL_NEE_DIM + 1)
        ds = em_ops.sample_direct(scene, self.n_area, self.env_kind,
                                  vp["p"], u_sel, u_pos,
                                  n_delta=self.n_delta)
        eps = scene.ray_eps
        ss, ts = m.build_frame(vp["ns"])
        wi = m.to_local(vp["wi"], ss, ts, vp["ns"])
        wo = m.to_local(ds.d, ss, ts, vp["ns"])
        par = common.material_params(scene, self.has_textures,
                                     vp["bsdf"], vp["uv"])
        f = bsdf_ops.eval(par, wi, wo, self.kinds)
        shadow_o = common.offset_ray_origin(vp["p"], vp["ng"], ds.d, eps)
        occ = self.occluded(shadow_o, ds.d, jnp.zeros(ds.dist.shape),
                            ds.dist - 2.0 * eps / jnp.maximum(
                                jnp.abs(m.dot(ds.d, ds.n)), 1e-3),
                            scene.geom)
        good = vp["valid"] & ds.valid & ~occ & (ds.pdf > 0)
        L = f * ds.radiance / jnp.maximum(ds.pdf, 1e-12)[..., None]
        return jnp.where(good[..., None], L, 0.0)

    @functools.partial(jax.jit, static_argnums=(0, 4))
    def _one_pass(self, scene, seed, pass_idx, n_chunks, vpl_table):
        st = self.settings
        N = st.width * st.height
        pixel_id = jnp.arange(N, dtype=jnp.uint32)
        pos_film, L_chain, vp = self._visible_points(scene, seed,
                                                     pass_idx, pixel_id)
        L = L_chain + self._direct_nee(scene, seed, pass_idx, pixel_id,
                                       vp) * vp["tp"]
        K = self.vpl_chunk
        for c in range(n_chunks):
            sl = lambda a: jax.lax.dynamic_slice_in_dim(a, c * K, K, 0)
            chunk = tuple(sl(a) for a in vpl_table)
            L = L + vp["tp"] * self._shade_chunk(scene, vp, chunk,
                                                 self.n_photons)
        fb = jnp.zeros((st.height, st.width, 3))
        wb = jnp.zeros((st.height, st.width))
        jit = pos_film % 1.0
        fb, wb = film_ops.splat_grid(fb, wb, jit[None], L[None],
                                     self.filter_kind)
        return fb, wb

    @functools.partial(jax.jit, static_argnums=(0,))
    def _gen_vpls(self, scene, seed):
        """Photon walk deposits + per-deposit surface frame/material."""
        ph_pos, ph_pow, ph_dir, ph_ok = self._emit_photons(scene, seed, 0)
        # re-intersect to recover the deposit's surface attributes
        # (the walk stores only position/power/direction): offset back
        # along the incoming direction and re-cast
        o = ph_pos - ph_dir * scene.ray_eps * 20.0
        Nf = ph_pos.shape[0]
        hit = self.closest(o, ph_dir, jnp.zeros(Nf),
                           jnp.where(ph_ok, 3e38, -1.0), scene.geom)
        its = common.fill_intersection(scene, o, ph_dir, hit)
        ok = ph_ok & its.valid
        return (its.p, ph_pow, ph_dir, ok, its.ns,
                jnp.maximum(its.bsdf_id, 0), its.uv)

    def render(self, scene, seed=0, spp=None, progress=None, **_):
        st = self.settings
        spp = spp or st.spp
        vpl_table = self._gen_vpls(scene, jnp.uint32(seed ^ 0x7f1))
        V = int(vpl_table[0].shape[0])
        K = self.vpl_chunk
        n_chunks = max(1, (V + K - 1) // K)
        pad = n_chunks * K - V
        if pad:
            vpl_table = tuple(
                jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:],
                                              a.dtype)]) for a in vpl_table)
        fb_acc = wb_acc = None
        for i in range(spp):
            fb, wb = self._one_pass(scene, seed, jnp.uint32(i), n_chunks,
                                    vpl_table)
            fb_acc = fb if fb_acc is None else fb_acc + fb
            wb_acc = wb if wb_acc is None else wb_acc + wb
            if progress:
                progress(i + 1, spp)
        return np.asarray(fb_acc) / np.maximum(
            np.asarray(wb_acc), 1e-12)[..., None]


def render(scene, settings, seed=0, spp=None):
    return VPLTracer(scene, settings).render(scene, seed=seed, spp=spp)
