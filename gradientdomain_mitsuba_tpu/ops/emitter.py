"""Emitter sampling and evaluation (NEE front door).

Replacement for Scene::sampleEmitterDirect / pdfEmitterDirect /
evalEnvironment (src/librender/scene.cpp) + the area/constant/envmap emitter
plugins (src/emitters/{area,constant,envmap}.cpp).  Mitsuba 0.5 picks among
emitters uniformly; area emitters sample their surface uniformly by area
(per-triangle CDF), then the pdf is converted to solid angle at the
reference point.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m
from ..core import warp

ENV_NONE, ENV_CONSTANT, ENV_MAP = 0, 1, 2


class DirectSample(NamedTuple):
    d: jnp.ndarray          # [N, 3] direction ref -> emitter
    dist: jnp.ndarray       # [N] distance (shadow-ray length)
    pdf: jnp.ndarray        # [N] solid-angle pdf incl. emitter pick prob
    radiance: jnp.ndarray   # [N, 3] emitted radiance toward ref
    n: jnp.ndarray          # [N, 3] emitter normal (0 for env)
    valid: jnp.ndarray      # [N] bool
    # gradient-domain extras (G-PT/G-BDPT shift machinery):
    p: jnp.ndarray          # [N, 3] sampled emitter position (0 for env)
    pdf_area: jnp.ndarray   # [N] area-measure pdf incl. pick prob (0 for env)
    is_env: jnp.ndarray     # [N] bool — sample is on the env emitter
    is_delta: jnp.ndarray   # [N] bool — point/spot/directional sample


def _searchsorted_segment(cdf, lo, hi, u, iters=None):
    """Vectorized lower-bound binary search of u in cdf[lo:hi] (flat CDF with
    per-emitter segments).  Returns index into the flat array.

    `iters` defaults to ceil(log2(len(cdf)))+1 — the CDF length is STATIC
    (total emitter-triangle count baked at scene build), so small scenes
    compile a 1-2 step search instead of a worst-case 24-step sequential
    gather loop (each step is a wavefront-wide dynamic gather)."""
    lo = lo.astype(jnp.int32)
    hi = hi.astype(jnp.int32)
    if iters is None:
        iters = max(1, int(np.ceil(np.log2(max(int(cdf.shape[0]), 2)))) + 1)

    def body(_, state):
        lo_, hi_ = state
        mid = (lo_ + hi_) // 2
        go_right = cdf[mid] < u
        return (jnp.where(go_right, mid + 1, lo_),
                jnp.where(go_right, hi_, mid))

    lo_f, _ = jax.lax.fori_loop(0, iters, body, (lo, hi))
    return lo_f


def sample_emitter_triangle(scene, flat, u_pos):
    """Position + unit normal on the flat-indexed emitter triangle.

    ONE packed row gather (EmitterTable.tri_geo [sumT, 12] = p0 | e1 |
    e2 | ng) replaces the 4-gather dependent chain tri_index -> indices
    -> positions x3."""
    row = scene.emitters.tri_geo[flat]
    bary = warp.square_to_uniform_triangle(u_pos)
    pos = (row[..., 0:3] + bary[..., 0:1] * row[..., 3:6] +
           bary[..., 1:2] * row[..., 6:9])
    return pos, row[..., 9:12]


def num_lights(scene):
    """Static count of selectable emitters (area + env)."""
    E = int(scene.emitters.radiance.shape[0]) if int(
        scene.emitters.tri_count.sum()) > 0 else 0
    # tri_count sums 0 only for the dummy row
    E = int((scene.emitters.tri_count > 0).sum())
    return E + (1 if int(scene.emitters.env_kind) != 0 else 0)


def sample_direct(scene, n_area: int, env_kind: int, p_ref, u_sel, u_pos,
                  n_delta: int = 0):
    """NEE sample toward one uniformly-picked emitter.

    n_area / n_delta / env_kind are STATIC (from RenderSettings) so absent
    branches compile away.  Pick order: areas, deltas, env.
    p_ref [N,3]; u_sel [N]; u_pos [N,2].
    """
    has_env = env_kind != ENV_NONE
    em = scene.emitters
    n_total = n_area + n_delta + (1 if has_env else 0)
    if n_total == 0:
        z = jnp.zeros_like(p_ref)
        zero = jnp.zeros(p_ref.shape[:-1])
        return DirectSample(d=z, dist=zero, pdf=zero, radiance=z, n=z,
                            valid=zero > 1)
    pick_pdf = 1.0 / n_total
    idx = jnp.minimum((u_sel * n_total).astype(jnp.int32), n_total - 1)
    # reuse u_sel within its stratum for the picked emitter's tri selection
    u_resc = jnp.clip(u_sel * n_total - idx.astype(u_sel.dtype), 0.0, 1.0)

    is_env = ((idx == n_area + n_delta) if has_env
              else jnp.zeros(idx.shape, bool))
    is_delta = ((idx >= n_area) & (idx < n_area + n_delta)
                if n_delta > 0 else jnp.zeros(idx.shape, bool))
    e = jnp.minimum(idx, max(n_area - 1, 0))

    # --- area emitter sample ------------------------------------------------
    off = em.tri_offset[e]
    cnt = em.tri_count[e]
    flat = _searchsorted_segment(em.tri_cdf, off, off + cnt - 1, u_resc)
    pos, ng = sample_emitter_triangle(scene, flat, u_pos)

    to_l = pos - p_ref
    dist2 = jnp.maximum(m.squared_length(to_l), 1e-12)
    dist = jnp.sqrt(dist2)
    d = to_l / dist[..., None]
    cos_l = -m.dot(d, ng)
    area = em.total_area[e]
    pdf_area = 1.0 / jnp.maximum(area, 1e-12)
    pdf_sa = pick_pdf * pdf_area * dist2 / jnp.maximum(cos_l, 1e-9)
    rad = em.radiance[e]
    valid_area = cos_l > 1e-6

    pdf_area_full = pick_pdf * pdf_area
    out = DirectSample(d=d, dist=dist, pdf=pdf_sa, radiance=rad, n=ng,
                       valid=valid_area, p=pos, pdf_area=pdf_area_full,
                       is_env=jnp.zeros(valid_area.shape, bool),
                       is_delta=jnp.zeros(valid_area.shape, bool))

    if n_delta > 0:
        de = jnp.clip(idx - n_area, 0, max(n_delta - 1, 0))
        kind = em.delta_kind[de]
        dpos = em.delta_pos[de]
        inten = em.delta_intensity[de]
        to_l = dpos - p_ref
        dist2d = jnp.maximum(m.squared_length(to_l), 1e-12)
        distd = jnp.sqrt(dist2d)
        dd = to_l / distd[..., None]
        # directional: fixed direction, "infinite" distance
        ddir = em.delta_dir[de]
        dd = jnp.where((kind == 2)[..., None], -ddir, dd)
        distd = jnp.where(kind == 2, 1e7, distd)
        val = jnp.where((kind == 2)[..., None], inten,
                        inten / dist2d[..., None])
        # spot falloff (spot.cpp: smooth between beamWidth and cutoff)
        cosd = m.dot(-dd, ddir)
        ct = em.delta_cos_total[de]
        cf = em.delta_cos_falloff[de]
        fall = jnp.clip((cosd - ct) / jnp.maximum(cf - ct, 1e-6), 0.0, 1.0)
        spot_f = jnp.where(kind == 1,
                           jnp.where(cosd > ct, fall, 0.0), 1.0)
        val = val * spot_f[..., None]
        # collimated (kind 3, src/emitters/collimated.cpp): a zero-radius
        # beam is doubly delta — surface NEE hits it with probability 0;
        # it contributes through particle/photon transport only
        val = jnp.where((kind == 3)[..., None], 0.0, val)
        # discrete pick probability; pdf fields are 'unified discrete' = pick
        out = DirectSample(
            d=jnp.where(is_delta[..., None], dd, out.d),
            dist=jnp.where(is_delta, distd, out.dist),
            pdf=jnp.where(is_delta, pick_pdf, out.pdf),
            radiance=jnp.where(is_delta[..., None], val / pick_pdf * 0 +
                               val, out.radiance),
            n=jnp.where(is_delta[..., None], -dd, out.n),
            valid=jnp.where(is_delta,
                            jnp.max(val, -1) > 0, out.valid),
            p=jnp.where(is_delta[..., None], dpos, out.p),
            pdf_area=jnp.where(is_delta, pick_pdf, out.pdf_area),
            is_env=out.is_env,
            is_delta=is_delta)

    if not has_env:
        return out

    # --- environment sample --------------------------------------------------
    d_env, pdf_env, rad_env = _sample_env(scene, env_kind, u_pos)
    pdf_env = pick_pdf * pdf_env
    big = 1e7 * jnp.ones_like(dist)
    return DirectSample(
        d=jnp.where(is_env[..., None], d_env, out.d),
        dist=jnp.where(is_env, big, out.dist),
        pdf=jnp.where(is_env, pdf_env, out.pdf),
        radiance=jnp.where(is_env[..., None], rad_env, out.radiance),
        n=jnp.where(is_env[..., None], -d_env, out.n),
        valid=jnp.where(is_env, pdf_env > 0, out.valid),
        p=jnp.where(is_env[..., None], 0.0, out.p),
        pdf_area=jnp.where(is_env, 0.0, out.pdf_area),
        is_env=is_env,
        is_delta=out.is_delta)


def _sample_env(scene, env_kind, u2):
    em = scene.emitters
    if env_kind == ENV_CONSTANT:
        d = warp.square_to_uniform_sphere(u2)
        pdf = jnp.full(u2.shape[:-1], warp.square_to_uniform_sphere_pdf())
        rad = jnp.broadcast_to(em.env_radiance, u2.shape[:-1] + (3,))
        return d, pdf, rad
    # envmap: CDF over rows then columns
    He, We = em.env_map.shape[:2]
    row = jnp.clip(jnp.searchsorted(em.env_cdf_rows, u2[..., 0],
                                    side="right") - 1, 0, He - 1)
    u_row = ((u2[..., 0] - em.env_cdf_rows[row]) /
             jnp.maximum(em.env_cdf_rows[row + 1] - em.env_cdf_rows[row],
                         1e-12))

    def col_search(r, u):
        return jnp.clip(
            jnp.searchsorted(em.env_cdf_cols[r], u, side="right") - 1,
            0, We - 1)

    col = jax.vmap(col_search)(row, u2[..., 1])
    theta = (row.astype(jnp.float32) + 0.5) / He * jnp.pi
    phi = (col.astype(jnp.float32) + 0.5) / We * 2 * jnp.pi
    d_local = m.spherical_direction(theta, phi)
    d = m.transform_vector(em.env_to_world, d_local)
    pdf = em.env_pdf[row, col]
    rad = em.env_map[row, col] * em.env_radiance
    return d, pdf, rad


def eval_env(scene, env_kind, d):
    """Environment radiance along direction d [N,3] (for escaped rays)."""
    em = scene.emitters
    if env_kind == ENV_NONE:
        return jnp.zeros(d.shape[:-1] + (3,))
    if env_kind == ENV_CONSTANT:
        return jnp.broadcast_to(em.env_radiance, d.shape[:-1] + (3,))
    He, We = em.env_map.shape[:2]
    dl = m.transform_vector(em.env_world_to_local, d)
    dl = m.normalize(dl)
    theta, phi = m.spherical_coordinates(dl)
    # bilinear lookup
    x = phi / (2 * jnp.pi) * We - 0.5
    y = theta / jnp.pi * He - 0.5
    x0 = jnp.floor(x); y0 = jnp.floor(y)
    fx = x - x0; fy = y - y0
    x0i = jnp.mod(x0.astype(jnp.int32), We)
    x1i = jnp.mod(x0i + 1, We)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, He - 1)
    y1i = jnp.clip(y0i + 1, 0, He - 1)
    c00 = em.env_map[y0i, x0i]; c01 = em.env_map[y0i, x1i]
    c10 = em.env_map[y1i, x0i]; c11 = em.env_map[y1i, x1i]
    c = (c00 * ((1 - fx) * (1 - fy))[..., None] +
         c01 * (fx * (1 - fy))[..., None] +
         c10 * ((1 - fx) * fy)[..., None] +
         c11 * (fx * fy)[..., None])
    return c * scene.emitters.env_radiance


def pdf_env_direct(scene, n_area: int, env_kind: int, d, n_delta: int = 0):
    """Solid-angle pdf that sample_direct would have produced direction d
    toward the environment (for MIS on escaped BSDF rays)."""
    if env_kind == ENV_NONE:
        return jnp.zeros(d.shape[:-1])
    n_total = n_area + n_delta + 1
    if env_kind == ENV_CONSTANT:
        return jnp.full(d.shape[:-1], warp.square_to_uniform_sphere_pdf()
                        / n_total)
    em = scene.emitters
    He, We = em.env_map.shape[:2]
    dl = m.normalize(m.transform_vector(em.env_world_to_local, d))
    theta, phi = m.spherical_coordinates(dl)
    row = jnp.clip((theta / jnp.pi * He).astype(jnp.int32), 0, He - 1)
    col = jnp.clip((phi / (2 * jnp.pi) * We).astype(jnp.int32), 0, We - 1)
    return em.env_pdf[row, col] / n_total


def pdf_area_direct(scene, n_area: int, has_env: bool, emitter_id, p_ref,
                    p_hit, ng_hit, n_delta: int = 0):
    """Solid-angle pdf that NEE would have sampled the point p_hit on area
    emitter emitter_id from p_ref (MIS weight for BSDF-sampled emitter hits).
    """
    n_total = n_area + n_delta + (1 if has_env else 0)
    if n_total == 0:
        return jnp.zeros(p_ref.shape[:-1])
    to_l = p_hit - p_ref
    dist2 = jnp.maximum(m.squared_length(to_l), 1e-12)
    d = to_l / jnp.sqrt(dist2)[..., None]
    cos_l = -m.dot(d, ng_hit)
    area = scene.emitters.total_area[jnp.maximum(emitter_id, 0)]
    pdf = dist2 / (jnp.maximum(cos_l, 1e-9) * jnp.maximum(area, 1e-12))
    pdf = pdf / n_total
    return jnp.where((emitter_id >= 0) & (cos_l > 1e-6), pdf, 0.0)
