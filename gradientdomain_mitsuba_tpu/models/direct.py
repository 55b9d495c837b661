"""`direct` and `ao` integrators.

device-side replacements for src/integrators/direct/direct.cpp (direct
illumination with light/BSDF MIS — semantically `path` truncated to
maxDepth 2) and src/integrators/misc/ao.cpp (ambient occlusion with
cosine-weighted visibility probes).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m
from ..core import warp
from ..core.rng import DimAllocator as DA
from ..core.rng import make_sampler
from ..ops import common, film as film_ops
from ..ops import sensor as sensor_ops
from .path import PathTracer


class DirectIntegrator(PathTracer):
    """Direct illumination: the path tracer with maxDepth forced to 2
    (emitter visibility + one light/BSDF MIS bounce — direct.cpp)."""

    def __init__(self, scene, settings):
        import copy
        settings = copy.deepcopy(settings)
        settings.max_depth = 2
        super().__init__(scene, settings)


class AOIntegrator:
    """Ambient occlusion (ao.cpp): cosine-weighted hemispheric visibility
    within rayLength (default: 0.5 * scene bsphere radius)."""

    def __init__(self, scene, settings):
        self.settings = settings
        n_tris = int(scene.geom.indices.shape[0])
        self.closest, self.occluded = common.choose_intersector(
            settings, n_tris)
        props = settings.integrator_props
        self.ray_length = float(props.get("rayLength", -1.0))
        self.filter_kind = film_ops.FILTERS.get(settings.rfilter, 0)
        self._u1, self._u2 = make_sampler(settings.sampler, settings.spp)

    def trace_pass(self, scene, seed, sample_idx, pixel_id=None):
        st = self.settings
        W, H = st.width, st.height
        if pixel_id is None:
            pixel_id = jnp.arange(W * H, dtype=jnp.uint32)
        N = pixel_id.shape[0]
        px = (pixel_id % W).astype(jnp.float32)
        py = (pixel_id // W).astype(jnp.float32)
        jitter = self._u2(seed, pixel_id, sample_idx, DA.PIXEL_JITTER)
        pos_film = jnp.stack([px, py], -1) + jitter
        u_ap = self._u2(seed, pixel_id, sample_idx, DA.APERTURE)
        o, d = sensor_ops.sample_ray(scene.camera, W, H, pos_film, u_ap)

        hit = self.closest(o, d, jnp.zeros(N), jnp.full(N, 3e38),
                           scene.geom)
        its = common.fill_intersection(scene, o, d, hit)

        u2 = self._u2(seed, pixel_id, sample_idx,
                      DA.bounce_dim(0, DA.D_BSDF_UV))
        d_local = warp.square_to_cosine_hemisphere(u2)
        ss, ts = m.build_frame(its.ns)
        # probe on the visible side of the surface
        ns = its.ns * jnp.sign(m.dot(its.ns, -d, keepdims=True))
        probe = m.to_world(d_local, ss, ts, ns)
        if self.ray_length > 0:
            length = jnp.float32(self.ray_length)
        else:
            length = 1e4 * scene.ray_eps  # ~ scene-scale probe (traced)
        sh_o = common.offset_ray_origin(its.p, its.ng, probe, scene.ray_eps)
        occ = self.occluded(sh_o, probe, jnp.zeros(N),
                            jnp.full(N, length), scene.geom)
        vis = jnp.where(its.valid & ~occ, 1.0, 0.0)
        L = jnp.repeat(vis[:, None], 3, axis=-1)
        return pos_film, L

    @functools.partial(jax.jit, static_argnums=(0, 4))
    def render_chunk(self, scene, seed, sample_start, n_samples):
        st = self.settings
        fb = jnp.zeros((st.height, st.width, 3))
        wb = jnp.zeros((st.height, st.width))

        def body(i, carry):
            fb, wb = carry
            pos, L = self.trace_pass(scene, seed, sample_start + i)
            return film_ops.splat(fb, wb, pos, L, self.filter_kind)

        return jax.lax.fori_loop(0, n_samples, body, (fb, wb))

    def finalize(self, state, spp):
        return state["0"] / np.maximum(state["1"], 1e-12)[..., None]

    def render(self, scene, seed=0, spp=None, chunk=64,
               checkpoint_path=None, resume=False, progress=None):
        from ..parallel.checkpoint import render_accumulate
        spp = spp or self.settings.spp
        state, spp = render_accumulate(
            self, scene, seed, spp, chunk,
            checkpoint_path=checkpoint_path, resume=resume,
            progress=progress)
        return self.finalize(state, spp)


class FieldIntegrator:
    """AOV renderer (src/integrators/misc/field.cpp): outputs a geometric
    field of the first visible surface point — `field` property in
    {position, relPosition, distance, geoNormal, shNormal, uv, albedo,
    shapeIndex, primIndex} — as an RGB image (scalar fields broadcast,
    index fields 1-based like the reference, -1/0 on miss per field
    semantics)."""

    def __init__(self, scene, settings):
        self.settings = settings
        n_tris = int(scene.geom.indices.shape[0])
        self.closest, self.occluded = common.choose_intersector(
            settings, n_tris)
        props = settings.integrator_props
        self.field = str(props.get("field", "distance"))
        self.has_textures = getattr(settings, "has_textures", 0)
        self.filter_kind = film_ops.FILTERS.get(settings.rfilter, 0)
        self._u1, self._u2 = make_sampler(settings.sampler, settings.spp)

    def trace_pass(self, scene, seed, sample_idx, pixel_id=None):
        st = self.settings
        W, H = st.width, st.height
        if pixel_id is None:
            pixel_id = jnp.arange(W * H, dtype=jnp.uint32)
        N = pixel_id.shape[0]
        px = (pixel_id % W).astype(jnp.float32)
        py = (pixel_id // W).astype(jnp.float32)
        jitter = self._u2(seed, pixel_id, sample_idx, DA.PIXEL_JITTER)
        pos_film = jnp.stack([px, py], -1) + jitter
        u_ap = self._u2(seed, pixel_id, sample_idx, DA.APERTURE)
        o, d = sensor_ops.sample_ray(scene.camera, W, H, pos_film, u_ap)
        hit = self.closest(o, d, jnp.zeros(N), jnp.full(N, 3e38),
                           scene.geom)
        its = common.fill_intersection(scene, o, d, hit)
        f = self.field
        v3 = lambda x: jnp.where(its.valid[:, None], x, 0.0)
        if f == "position":
            L = v3(its.p)
        elif f == "relPosition":
            cam_pos = scene.camera.to_world[:3, 3]
            L = v3(its.p - cam_pos[None])
        elif f == "distance":
            L = v3(jnp.repeat(jnp.where(its.valid, its.t, 0.0)[:, None],
                              3, -1))
        elif f == "geoNormal":
            L = v3(its.ng)
        elif f == "shNormal":
            L = v3(its.ns)
        elif f == "uv":
            L = v3(jnp.concatenate(
                [its.uv, jnp.zeros((N, 1))], axis=-1))
        elif f == "albedo":
            par = common.material_params(scene, self.has_textures,
                                         its.bsdf_id, its.uv,
                                         bary=its.bary)
            L = v3(par.reflectance)
        elif f == "shapeIndex":
            idx = jnp.where(its.valid, its.shape_id + 1, 0)
            L = jnp.repeat(idx.astype(jnp.float32)[:, None], 3, -1)
        elif f == "primIndex":
            oid = scene.geom.tris.orig_id[jnp.maximum(its.prim_id, 0)]
            idx = jnp.where(its.valid, oid + 1, 0)
            L = jnp.repeat(idx.astype(jnp.float32)[:, None], 3, -1)
        else:
            raise ValueError(f"field integrator: unknown field '{f}'")
        return pos_film, L

    render_chunk = AOIntegrator.render_chunk
    finalize = AOIntegrator.finalize
    render = AOIntegrator.render
