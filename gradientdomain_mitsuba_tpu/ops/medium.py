"""Device-side participating-media ops: homogeneous free-flight sampling,
transmittance, and phase functions.

Replacement for Medium::sampleDistance/evalTransmittance and
PhaseFunction::{sample,eval,pdf} (src/medium/homogeneous.cpp,
src/phase/{isotropic,hg,rayleigh}.cpp), as branch-free SoA kernels over
medium-id lanes.  Lanes with mid < 0 are vacuum: no scatter, unit
transmittance.

Channel strategy: the free-flight distance importance-samples one RGB
channel's sigma_t, the channel picked uniformly; success/failure pdfs
average over channels (the spectral-MIS estimator homogeneous.cpp also
uses by default).  Unbiased for any per-channel sigma_t.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core import math as m
from ..scene.media import (PHASE_HG, PHASE_ISOTROPIC, PHASE_MICROFLAKE,
                           PHASE_RAYLEIGH)

INV_4PI = 1.0 / (4.0 * jnp.pi)
F32_BIG = 3e38


def gather(media, mid):
    """Per-lane medium coefficients; vacuum (mid<0) lanes get zeros."""
    idx = jnp.clip(mid, 0, media.sigma_s.shape[0] - 1)
    vac = (mid < 0)[..., None]
    sigma_s = jnp.where(vac, 0.0, media.sigma_s[idx])
    sigma_t = jnp.where(vac, 0.0, media.sigma_t[idx])
    g = jnp.where(mid < 0, 0.0, media.g[idx])
    kind = jnp.where(mid < 0, PHASE_ISOTROPIC, media.phase_kind[idx])
    flake = media.flake[idx]
    return sigma_s, sigma_t, kind, g, flake


def transmittance(sigma_t, dist):
    """exp(-sigma_t * dist) per channel; dist may be +inf-ish."""
    return jnp.exp(-sigma_t * jnp.minimum(dist, F32_BIG)[..., None])


class DistanceSample(NamedTuple):
    scattered: jnp.ndarray  # [N] bool: medium event before tmax
    t: jnp.ndarray          # [N] scatter distance (valid when scattered)
    weight: jnp.ndarray     # [N, 3] throughput factor:
    #                         scattered: sigma_s*Tr(t)/pdf_succ
    #                         else:      Tr(tmax)/pdf_fail


def sample_distance(sigma_s, sigma_t, u_chan, u_dist, tmax):
    """Free-flight sampling through a homogeneous slab of length tmax.

    Lanes with sigma_t == 0 (vacuum or pure void) never scatter and get
    unit weight."""
    chan = jnp.clip((u_chan * 3.0).astype(jnp.int32), 0, 2)
    st_c = jnp.take_along_axis(sigma_t, chan[..., None], -1)[..., 0]
    active = st_c > 0
    # t = -ln(1-u)/sigma_t_c in (0, inf)
    t = -jnp.log1p(-jnp.clip(u_dist, 0.0, 1.0 - 1e-7)) / jnp.maximum(
        st_c, 1e-20)
    scattered = active & (t < tmax)

    tr_t = transmittance(sigma_t, t)
    tr_max = transmittance(sigma_t, tmax)
    pdf_succ = jnp.mean(sigma_t * tr_t, -1)
    pdf_fail = jnp.mean(tr_max, -1)
    w_scatter = sigma_s * tr_t / jnp.maximum(pdf_succ, 1e-30)[..., None]
    w_pass = tr_max / jnp.maximum(pdf_fail, 1e-30)[..., None]
    weight = jnp.where(scattered[..., None], w_scatter,
                       jnp.where(active[..., None], w_pass, 1.0))
    return DistanceSample(scattered=scattered, t=t, weight=weight)


# ---------------------------------------------------------------------------
# Phase functions.  All three are exactly importance-sampled, so
# eval == pdf and the sampling weight is 1 (PhaseFunction::sample
# semantics in the reference).
# ---------------------------------------------------------------------------

def _hg_pdf(cos_theta, g):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / jnp.maximum(
        denom * jnp.sqrt(jnp.maximum(denom, 1e-12)), 1e-12)


def _rayleigh_pdf(cos_theta):
    return (3.0 / (16.0 * jnp.pi)) * (1.0 + cos_theta * cos_theta)


# --- SGGX microflakes (fiber) ----------------------------------------------
# S = w w^T sigma^2 + (I - w w^T): eigenvalues (sigma^2, 1, 1) in the
# fiber frame, so S v = v + (sigma^2 - 1)(w.v) w and every quadratic
# form is a closed-form dot product — the Replacement for
# microflake.cpp's Gaussian distribution (fitted series + rejection
# sampling).  Specular (mirror) flakes: phase = D(h) / (4 sigma(wi)).


def _sggx_dot(flake, a, b):
    w = flake[..., 0:3]
    s2 = flake[..., 3] ** 2
    return m.dot(a, b) + (s2 - 1.0) * m.dot(w, a) * m.dot(w, b)


def _sggx_ndf(flake, mv):
    """D(m) = 1 / (pi sqrt(det S) (m^T S^-1 m)^2); sqrt(det S) = sigma."""
    w = flake[..., 0:3]
    sig = jnp.maximum(flake[..., 3], 1e-3)
    c = m.dot(w, mv)
    q = c * c / (sig * sig) + (1.0 - c * c)
    return 1.0 / (jnp.pi * sig * jnp.maximum(q * q, 1e-12))


def _sggx_proj(flake, d):
    """Projected flake area sigma(d) = sqrt(d^T S d)."""
    return jnp.sqrt(jnp.maximum(_sggx_dot(flake, d, d), 1e-12))


def _sggx_eval(flake, wi, wo):
    h = m.normalize(wi + wo)
    return _sggx_ndf(flake, h) / (4.0 * _sggx_proj(flake, wi))


def _sggx_sample(flake, wi, u2):
    """Exact visible-normal sampling (Heitz et al. 2015): sample a flake
    normal from the projected-area-weighted NDF, mirror-reflect.  The
    estimator weight is exactly 1."""
    i = wi                                  # reversed incident direction
    k, j = m.build_frame(i)
    skk = _sggx_dot(flake, k, k)
    skj = _sggx_dot(flake, k, j)
    ski = _sggx_dot(flake, k, i)
    sjj = _sggx_dot(flake, j, j)
    sji = _sggx_dot(flake, j, i)
    sii = _sggx_dot(flake, i, i)
    sqrt_det = jnp.maximum(flake[..., 3], 1e-3)   # sqrt(sigma^2 * 1 * 1)
    tmp = jnp.sqrt(jnp.maximum(sjj * sii - sji * sji, 1e-12))
    isq = 1.0 / jnp.sqrt(jnp.maximum(sii, 1e-12))
    # columns of the M matrix mapping hemisphere points to S^(1/2) space
    mk = jnp.stack([sqrt_det / tmp,
                    jnp.zeros_like(tmp), jnp.zeros_like(tmp)], -1)
    mj = jnp.stack([-isq * (ski * sji - skj * sii) / tmp,
                    isq * tmp, jnp.zeros_like(tmp)], -1)
    mi = jnp.stack([isq * ski, isq * sji, isq * sii], -1)
    r = jnp.sqrt(jnp.clip(u2[..., 0], 0.0, 1.0))
    phi = 2.0 * jnp.pi * u2[..., 1]
    pu = (r * jnp.cos(phi))[..., None]
    pv = (r * jnp.sin(phi))[..., None]
    pw = jnp.sqrt(jnp.maximum(1.0 - u2[..., 0], 0.0))[..., None]
    m_kji = m.normalize(pu * mk + pv * mj + pw * mi)
    mv = (k * m_kji[..., 0:1] + j * m_kji[..., 1:2] + i * m_kji[..., 2:3])
    # mirror flake: reflect the propagation direction -wi about mv
    wo = -wi + 2.0 * m.dot(wi, mv)[..., None] * mv
    return m.normalize(wo)


def phase_eval(kind, g, wi, wo, flake=None):
    """Phase value == pdf of sampling wo given wi.

    Convention (matches the BSDF layer): wi points back toward the
    previous vertex, wo is the new propagation direction, so the
    scattering angle alpha is measured from the incident propagation
    -wi: cos(alpha) = dot(-wi, wo).  HG with g > 0 peaks forward
    (wo ~ -wi), as in hg.cpp."""
    cos_alpha = m.dot(-wi, wo)
    iso = jnp.full_like(cos_alpha, INV_4PI)
    # _hg_pdf's denominator is 1 + g^2 + 2 g x, so pass x = -cos(alpha)
    hg = _hg_pdf(-cos_alpha, g)
    ray = _rayleigh_pdf(cos_alpha)
    out = jnp.where(kind == PHASE_HG, hg,
                    jnp.where(kind == PHASE_RAYLEIGH, ray, iso))
    if flake is not None:
        out = jnp.where(kind == PHASE_MICROFLAKE,
                        _sggx_eval(flake, wi, wo), out)
    return out


def phase_sample(kind, g, wi, u2, flake=None):
    """Sample wo from the phase function around the propagation direction
    -wi.  Returns (wo, pdf); weight is 1."""
    prop = -wi  # propagation direction of the incident ray

    # isotropic
    wo_iso = _sphere_dir(u2)

    # Henyey-Greenstein inversion (hg.cpp): cos_theta wrt propagation
    g_safe = jnp.where(jnp.abs(g) < 1e-3, 1e-3, g)
    sqr = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe *
                                     u2[..., 0])
    cos_hg = (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)
    cos_iso = 1.0 - 2.0 * u2[..., 0]
    cos_theta = jnp.where(jnp.abs(g) < 1e-3, cos_iso,
                          jnp.clip(cos_hg, -1.0, 1.0))

    # Rayleigh: solve the cubic CDF inversion (rayleigh.cpp)
    z = 2.0 * (2.0 * u2[..., 0] - 1.0)
    A = jnp.cbrt(z + jnp.sqrt(z * z + 1.0))
    cos_ray = jnp.clip(A - 1.0 / A, -1.0, 1.0)

    cos_t = jnp.where(kind == PHASE_RAYLEIGH, cos_ray, cos_theta)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * jnp.pi * u2[..., 1]
    s, t = m.build_frame(prop)
    wo_aniso = (s * (sin_t * jnp.cos(phi))[..., None] +
                t * (sin_t * jnp.sin(phi))[..., None] +
                prop * cos_t[..., None])
    wo = jnp.where((kind == PHASE_ISOTROPIC)[..., None], wo_iso, wo_aniso)
    if flake is not None:
        wo = jnp.where((kind == PHASE_MICROFLAKE)[..., None],
                       _sggx_sample(flake, wi, u2), wo)
    return wo, phase_eval(kind, g, wi, wo, flake)


def _sphere_dir(u2):
    z = 1.0 - 2.0 * u2[..., 0]
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = 2.0 * jnp.pi * u2[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], -1)


# ---------------------------------------------------------------------------
# Heterogeneous media: trilinear density lookup + spectral delta tracking
# against the per-row majorant (heterogeneous.cpp Woodcock tracking, made
# wavefront-shaped: a fixed-trip fori_loop whose lanes mask out once they
# scatter or escape).
# ---------------------------------------------------------------------------

import jax


def density_at(media, mid, p):
    """Scalar density at world points p [N, 3] for each lane's medium.
    Homogeneous rows (het == 0) return 1; points outside the [0,1]^3
    volume frame return 0 (gridvolume.cpp zero-extension)."""
    idx = jnp.clip(mid, 0, media.het.shape[0] - 1)
    w2g = media.world_to_grid[idx]                       # [N, 4, 4]
    q = (jnp.einsum("nij,nj->ni", w2g[:, :3, :3], p,
                    precision=jax.lax.Precision.HIGHEST) + w2g[:, :3, 3])
    res = media.grid_res[idx]                            # [N, 3] (nx,ny,nz)
    off = media.grid_offset[idx]
    nx = res[:, 0]
    ny = res[:, 1]
    nz = res[:, 2]
    inside = jnp.all((q >= 0.0) & (q <= 1.0), -1)

    # texel-center coordinates (gridvolume.cpp lookupFloat convention)
    fx = jnp.clip(q[:, 0] * (nx - 1), 0.0, (nx - 1).astype(jnp.float32))
    fy = jnp.clip(q[:, 1] * (ny - 1), 0.0, (ny - 1).astype(jnp.float32))
    fz = jnp.clip(q[:, 2] * (nz - 1), 0.0, (nz - 1).astype(jnp.float32))
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    z0 = jnp.floor(fz).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, nx - 1)
    y1 = jnp.minimum(y0 + 1, ny - 1)
    z1 = jnp.minimum(z0 + 1, nz - 1)
    tx = fx - x0
    ty = fy - y0
    tz = fz - z0

    def at(z, y, x):
        flat = off + (z * ny + y) * nx + x
        return media.grid_data[flat]

    d000 = at(z0, y0, x0); d001 = at(z0, y0, x1)
    d010 = at(z0, y1, x0); d011 = at(z0, y1, x1)
    d100 = at(z1, y0, x0); d101 = at(z1, y0, x1)
    d110 = at(z1, y1, x0); d111 = at(z1, y1, x1)
    c00 = d000 * (1 - tx) + d001 * tx
    c01 = d010 * (1 - tx) + d011 * tx
    c10 = d100 * (1 - tx) + d101 * tx
    c11 = d110 * (1 - tx) + d111 * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    dens = c0 * (1 - tz) + c1 * tz
    het = media.het[idx] > 0
    dens = jnp.where(inside, dens, 0.0)
    return jnp.where(het & (mid >= 0), dens, 1.0)


def flake_at(media, mid, p):
    """Per-lane SGGX flake [N, 4] with a gridvolume-driven fiber axis
    (the reference's heterogeneous <volume name="orientation"> consumed
    by microflake.cpp via gridvolume.cpp lookupVector: trilinear
    interpolation of the vector field, then normalization).  Rows
    without an orientation grid (orient_offset < 0), points outside the
    volume, and degenerate interpolated vectors all fall back to the
    row's constant flake axis."""
    idx = jnp.clip(mid, 0, media.het.shape[0] - 1)
    fl = media.flake[idx]                                # [N, 4]
    off = media.orient_offset[idx]
    has = off >= 0
    w2g = media.orient_w2g[idx]
    q = (jnp.einsum("nij,nj->ni", w2g[:, :3, :3], p,
                    precision=jax.lax.Precision.HIGHEST) + w2g[:, :3, 3])
    res = media.orient_res[idx]
    nx, ny, nz = res[:, 0], res[:, 1], res[:, 2]
    inside = jnp.all((q >= 0.0) & (q <= 1.0), -1)

    fx = jnp.clip(q[:, 0] * (nx - 1), 0.0, (nx - 1).astype(jnp.float32))
    fy = jnp.clip(q[:, 1] * (ny - 1), 0.0, (ny - 1).astype(jnp.float32))
    fz = jnp.clip(q[:, 2] * (nz - 1), 0.0, (nz - 1).astype(jnp.float32))
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    z0 = jnp.floor(fz).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, nx - 1)
    y1 = jnp.minimum(y0 + 1, ny - 1)
    z1 = jnp.minimum(z0 + 1, nz - 1)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    tz = (fz - z0)[..., None]

    base = jnp.maximum(off, 0)
    c3 = jnp.arange(3, dtype=jnp.int32)

    def at(z, y, x):
        flat = base + 3 * ((z * ny + y) * nx + x)
        return media.orient_data[flat[:, None] + c3[None, :]]  # [N, 3]

    v000 = at(z0, y0, x0); v001 = at(z0, y0, x1)
    v010 = at(z0, y1, x0); v011 = at(z0, y1, x1)
    v100 = at(z1, y0, x0); v101 = at(z1, y0, x1)
    v110 = at(z1, y1, x0); v111 = at(z1, y1, x1)
    c00 = v000 * (1 - tx) + v001 * tx
    c01 = v010 * (1 - tx) + v011 * tx
    c10 = v100 * (1 - tx) + v101 * tx
    c11 = v110 * (1 - tx) + v111 * tx
    v = ((c00 * (1 - ty) + c01 * ty) * (1 - tz) +
         (c10 * (1 - ty) + c11 * ty) * tz)
    # grid-space fiber vector -> WORLD space via the linear part of
    # (medium toWorld @ volume toWorld), then normalize — gridvolume
    # lookupVector semantics (src/volume/gridvolume.cpp): without this,
    # any rotated toWorld yields wrong flake orientations
    v = jnp.einsum("nij,nj->ni", media.orient_l2w[idx], v,
                   precision=jax.lax.Precision.HIGHEST)
    norm = jnp.sqrt(jnp.maximum(m.squared_length(v), 0.0))
    ok = has & inside & (norm > 1e-6)
    axis = jnp.where(ok[..., None], v / jnp.maximum(norm, 1e-12)[..., None],
                     fl[..., 0:3])
    return jnp.concatenate([axis, fl[..., 3:4]], -1)


def _majorant(media, mid):
    """Scalar majorant extinction per lane: max_density * max_c sigma_t."""
    idx = jnp.clip(mid, 0, media.het.shape[0] - 1)
    mu = media.max_density[idx] * jnp.max(media.sigma_t[idx], -1)
    return jnp.where(mid >= 0, mu, 0.0)


def sample_distance_tracking(media, mid, o, d, tmax, u_step, n_steps):
    """Spectral delta tracking (the unbiased 'spectral tracking' history
    scheme of Kutz et al. 2017) through a density-modulated medium.

    u_step(k) must return [N, 2] fresh uniforms for tracking step k.
    Returns the same DistanceSample contract as sample_distance: lanes
    that scatter carry weight sigma_s(p)*Tr/pdf folded into `weight`;
    escaping lanes carry the transmittance-over-pdf ratio.  Lanes whose
    loop budget runs out escape with their accumulated weight (bias
    vanishes as n_steps covers the optical depth; n_steps is the
    `trackingSteps` knob)."""
    N = mid.shape[0]
    idx = jnp.clip(mid, 0, media.het.shape[0] - 1)
    sigma_t_u = jnp.where((mid < 0)[..., None], 0.0, media.sigma_t[idx])
    sigma_s_u = jnp.where((mid < 0)[..., None], 0.0, media.sigma_s[idx])
    mu = _majorant(media, mid)
    active0 = mu > 0.0

    def body(k, st):
        t, w, scattered, done = st
        u = u_step(k)
        step = -jnp.log1p(-jnp.clip(u[:, 0], 0.0, 1.0 - 1e-7)) / \
            jnp.maximum(mu, 1e-20)
        t_new = t + step
        escape = t_new >= tmax
        p = o + d * t_new[..., None]
        dens = density_at(media, mid, p)
        s_t = sigma_t_u * dens[..., None]
        s_s = sigma_s_u * dens[..., None]
        p_real = jnp.clip(jnp.mean(s_t, -1) / jnp.maximum(mu, 1e-20),
                          0.0, 1.0)
        real = u[:, 1] < p_real
        w_real = s_s / jnp.maximum(mu * p_real, 1e-20)[..., None]
        s_n = jnp.maximum(mu[..., None] - s_t, 0.0)
        w_null = s_n / jnp.maximum(mu * (1.0 - p_real), 1e-20)[..., None]

        live = ~done
        upd_scatter = live & ~escape & real
        upd_null = live & ~escape & ~real
        w = jnp.where(upd_scatter[..., None], w * w_real, w)
        w = jnp.where(upd_null[..., None], w * w_null, w)
        t = jnp.where(live, jnp.minimum(t_new, tmax), t)
        scattered = scattered | upd_scatter
        done = done | (live & (escape | real))
        return (t, w, scattered, done)

    t0 = jnp.zeros(N)
    w0 = jnp.ones((N, 3))
    st = (t0, w0, jnp.zeros(N, bool), ~active0)
    t, w, scattered, _ = jax.lax.fori_loop(0, n_steps, body, st)
    return DistanceSample(scattered=scattered, t=t,
                          weight=jnp.where(active0[..., None], w, 1.0))


def transmittance_tracking(media, mid, o, d, dist, u_step, n_steps):
    """Ratio-tracking transmittance estimator [N, 3] along (o, d, dist)
    (the unbiased analog of evalTransmittance for density grids)."""
    N = mid.shape[0]
    idx = jnp.clip(mid, 0, media.het.shape[0] - 1)
    sigma_t_u = jnp.where((mid < 0)[..., None], 0.0, media.sigma_t[idx])
    mu = _majorant(media, mid)
    active0 = mu > 0.0

    def body(k, st):
        t, w, done = st
        u = u_step(k)
        step = -jnp.log1p(-jnp.clip(u[:, 0], 0.0, 1.0 - 1e-7)) / \
            jnp.maximum(mu, 1e-20)
        t_new = t + step
        escape = t_new >= dist
        p = o + d * t_new[..., None]
        dens = density_at(media, mid, p)
        s_t = sigma_t_u * dens[..., None]
        ratio = jnp.clip(1.0 - s_t / jnp.maximum(mu, 1e-20)[..., None],
                         0.0, 1.0)
        live = ~done
        w = jnp.where((live & ~escape)[..., None], w * ratio, w)
        t = jnp.where(live, t_new, t)
        done = done | (live & escape)
        return (t, w, done)

    st = (jnp.zeros(N), jnp.ones((N, 3)), ~active0)
    _, w, _ = jax.lax.fori_loop(0, n_steps, body, st)
    return jnp.where(active0[..., None], w, 1.0)
