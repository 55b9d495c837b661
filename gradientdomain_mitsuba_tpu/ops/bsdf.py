"""BSDF sample/eval/pdf: branch-free SoA dispatch over the material enum.

Replacement for Mitsuba's BSDF plugin virtual dispatch
(src/bsdfs/{diffuse,conductor,dielectric,roughconductor,plastic,
roughplastic,roughdiffuse,phong,thindielectric}.cpp + microfacet.h).
Every function is batched over N surface interactions; each material model
is evaluated with vector ops and combined with jnp.where masks — no
data-dependent branching, so lanes never diverge.  Mitsuba conventions:

  - directions in the LOCAL shading frame, +z = shading normal
  - wi points AWAY from the surface toward the previous vertex
  - eval() returns f(wi,wo) * |cos(theta_o)| (solid-angle measure)
  - pdf() is the solid-angle density of sample()'s smooth component
  - sample() returns (wo, weight = f*cos/pdf, pdf, is_delta, eta) where eta
    is the RELATIVE index ratio of the transition (1 for reflection)

Microfacet models use FULL-NDF sampling (D(m)cos(m)), matching Mitsuba
0.5's microfacet.h which predates visible-normal sampling — required for
statistical identity with the reference estimators.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core import warp
from ..core.math import reflect_local
from ..core.spectrum import luminance
from ..scene.materials import (BLEND, COATING, CONDUCTOR, DIELECTRIC,
                               DIFFTRANS, DIFFUSE, DIST_GGX, FLAG_TWOSIDED,
                               HK, IRAWAN, NULL_BSDF, PHONG, PLASTIC,
                               ROUGH_CONDUCTOR, ROUGH_DIELECTRIC,
                               ROUGH_DIFFUSE, ROUGH_PLASTIC,
                               THIN_DIELECTRIC, WARD)

INV_PI = 1.0 / jnp.pi


class MatParams(NamedTuple):
    """Per-interaction material parameters (gathered from the table)."""
    kind: jnp.ndarray          # [N] i32
    twosided: jnp.ndarray      # [N] bool
    reflectance: jnp.ndarray   # [N, 3] (texture-resolved albedo)
    specular: jnp.ndarray      # [N, 3]
    transmittance: jnp.ndarray  # [N, 3]
    alpha: jnp.ndarray         # [N]
    eta: jnp.ndarray           # [N, 3]
    k: jnp.ndarray             # [N, 3]
    dist: jnp.ndarray          # [N] i32
    fdr_int: jnp.ndarray       # [N]
    spec_weight: jnp.ndarray   # [N] specular sampling weight (plastic/phong)
    alpha_v: jnp.ndarray       # [N] second roughness (ward anisotropy)
    opacity: jnp.ndarray       # [N] mask wrapper opacity (1 = no mask)
    child0: jnp.ndarray = None  # [N] i32 blend child row (BLEND rows)
    child1: jnp.ndarray = None  # [N] i32
    blend_w: jnp.ndarray = None  # [N] second-child weight (0 = no blend)
    blend: "MatParams" = None   # resolved second-child params (lanes where
    #                             kind==BLEND; common.material_params fills
    #                             this when the scene contains blends)
    coat: jnp.ndarray = None    # [N] bool lane is a COATING wrapper
    coat_eta: jnp.ndarray = None    # [N] layer relative IOR
    coat_sigma: jnp.ndarray = None  # [N, 3] sigmaA * thickness
    coat_spec: jnp.ndarray = None   # [N, 3] layer specularReflectance
    coat_alpha: jnp.ndarray = None  # [N] layer microfacet roughness
    #                                 (0 = smooth delta lobe; roughcoating)
    coat_dist: jnp.ndarray = None   # [N] i32 layer distribution
    cloth: jnp.ndarray = None   # [N, 6] IRAWAN yarn-segment features
    #                             (ops/irawan.resolve_features; None when
    #                             the caller has no uv-stage payload)


def gather_params(materials, mid, albedo_override=None,
                  opacity_override=None) -> MatParams:
    """Material parameters for a batch of ids [N] — ONE gather of the
    packed [M, 24] row table (Materials.packed) instead of 11 separate
    gathers; fields are static slices of the row."""
    row = materials.packed[mid]
    refl = row[..., 2:5]
    if albedo_override is not None:
        refl = albedo_override
    opacity = row[..., 22]
    if opacity_override is not None:
        opacity = opacity_override
    spec = row[..., 5:8]
    # Mitsuba's specularSamplingWeight: sAvg / (sAvg + dAvg) by luminance
    s_lum = luminance(spec)
    d_lum = luminance(refl)
    return MatParams(
        kind=row[..., 0].astype(jnp.int32),
        twosided=(row[..., 1].astype(jnp.int32) & FLAG_TWOSIDED) != 0,
        reflectance=refl, specular=spec,
        transmittance=row[..., 8:11],
        alpha=row[..., 11], eta=row[..., 12:15], k=row[..., 15:18],
        dist=row[..., 18].astype(jnp.int32), fdr_int=row[..., 19],
        spec_weight=s_lum / jnp.maximum(s_lum + d_lum, 1e-9),
        alpha_v=row[..., 21], opacity=opacity,
        child0=row[..., 24].astype(jnp.int32),
        child1=row[..., 25].astype(jnp.int32),
        blend_w=row[..., 26])


# ---------------------------------------------------------------------------
# Fresnel
# ---------------------------------------------------------------------------

def fresnel_dielectric(cos_i, eta):
    """Exact unpolarized dielectric Fresnel (fresnelDielectricExt semantics).

    cos_i may be signed (negative = from inside); eta = int/ext ratio.
    Returns (F, cos_t) where cos_t carries the sign of the transmitted side.
    """
    outside = cos_i >= 0.0
    rel_eta = jnp.where(outside, eta, 1.0 / jnp.maximum(eta, 1e-9))
    ci = jnp.abs(cos_i)
    sin_t2 = (1.0 - ci * ci) / jnp.maximum(rel_eta * rel_eta, 1e-18)
    tir = sin_t2 >= 1.0
    ct = jnp.sqrt(jnp.maximum(1.0 - sin_t2, 0.0))
    rs = (ci - rel_eta * ct) / jnp.maximum(ci + rel_eta * ct, 1e-12)
    rp = (rel_eta * ci - ct) / jnp.maximum(rel_eta * ci + ct, 1e-12)
    F = jnp.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
    cos_t = jnp.where(tir, 0.0, jnp.where(outside, -ct, ct))
    return F, cos_t


def fresnel_conductor(cos_i, eta, k):
    """Unpolarized conductor Fresnel; eta/k are [..., 3] RGB."""
    ci = jnp.abs(cos_i)[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - si2
    a2b2 = jnp.sqrt(jnp.maximum(t0 * t0 + 4.0 * e2 * k2, 0.0))
    t1 = a2b2 + ci2
    a = jnp.sqrt(jnp.maximum(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / jnp.maximum(t1 + t2, 1e-12)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / jnp.maximum(t3 + t4, 1e-12)
    return 0.5 * (rp + rs)


# ---------------------------------------------------------------------------
# Microfacet helpers (Beckmann / GGX, full NDF — Mitsuba 0.5 microfacet.h)
# ---------------------------------------------------------------------------

def mf_D(m, alpha, dist):
    db = warp.square_to_beckmann_pdf(m, alpha) / jnp.maximum(
        jnp.abs(m[..., 2]), 1e-9)
    dg = warp.square_to_ggx_pdf(m, alpha) / jnp.maximum(
        jnp.abs(m[..., 2]), 1e-9)
    return jnp.where(dist == DIST_GGX, dg, db)


def mf_sample(u, alpha, dist):
    mb = warp.square_to_beckmann(u, alpha)
    mg = warp.square_to_ggx(u, alpha)
    return jnp.where((dist == DIST_GGX)[..., None], mg, mb)


def mf_pdf(m, alpha, dist):
    """pdf of sampled half-vector (D * cos)."""
    pb = warp.square_to_beckmann_pdf(m, alpha)
    pg = warp.square_to_ggx_pdf(m, alpha)
    return jnp.where(dist == DIST_GGX, pg, pb)


def _smith_g1(v, m, alpha, dist):
    cos_v = v[..., 2]
    # side check: v and m on same side
    valid = (jnp.sum(v * m, axis=-1) * cos_v) > 0.0
    ct2 = jnp.clip(cos_v * cos_v, 1e-9, 1.0)
    tan_v = jnp.sqrt(jnp.maximum(1.0 - ct2, 0.0) / ct2)
    # Beckmann rational approximation
    a = 1.0 / jnp.maximum(alpha * tan_v, 1e-9)
    g_b = jnp.where(
        a < 1.6,
        (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a),
        1.0)
    # GGX exact
    g_g = 2.0 / (1.0 + jnp.sqrt(1.0 + (alpha * tan_v) ** 2))
    g = jnp.where(dist == DIST_GGX, g_g, g_b)
    return jnp.where(valid, g, 0.0)


def mf_G(wi, wo, m, alpha, dist):
    return _smith_g1(wi, m, alpha, dist) * _smith_g1(wo, m, alpha, dist)


# ---------------------------------------------------------------------------
# Per-model eval / pdf / sample (each takes flipped-to-front wi when the
# model is intrinsically one-sided; dielectrics handle both sides)
# ---------------------------------------------------------------------------

def _d_zero3(x):
    return jnp.zeros(x.shape[:-1] + (3,), x.dtype)


def _diffuse_eval(p: MatParams, wi, wo):
    f = p.reflectance * INV_PI * jnp.maximum(wo[..., 2], 0.0)[..., None]
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return jnp.where(valid[..., None], f, 0.0)


def _diffuse_pdf(p, wi, wo):
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return jnp.where(valid, warp.square_to_cosine_hemisphere_pdf(wo), 0.0)


def _difftrans_eval(p: MatParams, wi, wo):
    """Diffuse transmitter (difftrans.cpp): Lambertian lobe on the
    OPPOSITE hemisphere; `reflectance` carries the transmittance."""
    opposite = wi[..., 2] * wo[..., 2] < 0
    f = p.reflectance * INV_PI * jnp.abs(wo[..., 2])[..., None]
    return jnp.where(opposite[..., None], f, 0.0)


def _difftrans_pdf(p, wi, wo):
    opposite = wi[..., 2] * wo[..., 2] < 0
    return jnp.where(opposite, jnp.abs(wo[..., 2]) * INV_PI, 0.0)


def _hk_coeffs(p: MatParams):
    """(albedo, tau) of the HK slab: sigmaS in `reflectance`, sigmaA in
    `transmittance`, thickness in `alpha` (hk.cpp parameterization)."""
    sig_s = p.reflectance
    sig_t = sig_s + p.transmittance
    alb = sig_s / jnp.maximum(sig_t, 1e-12)
    tau = sig_t * p.alpha[..., None]
    return alb, tau


def _hk_phase(p, wi, wo):
    """HG phase value for the slab (isotropic when |g| ~ 0); angle
    between the incident propagation -wi and the outgoing wo."""
    from .medium import phase_eval
    from ..scene.media import PHASE_HG, PHASE_ISOTROPIC
    kind = jnp.where(jnp.abs(p.alpha_v) < 1e-4, PHASE_ISOTROPIC, PHASE_HG)
    return phase_eval(kind, p.alpha_v, wi, wo)


def _hk_delta_t(p, wi):
    """Unscattered (delta) transmittance through the slab: exp(-tau/mu)."""
    _, tau = _hk_coeffs(p)
    mu_i = jnp.maximum(jnp.abs(wi[..., 2]), 1e-6)[..., None]
    return jnp.exp(-tau / mu_i)


def _hk_eval(p: MatParams, wi, wo):
    """Hanrahan-Krueger single scattering in a slab of optical depth tau
    (hk.cpp, Hanrahan & Krueger 1993).  Returns f*|cos_o|:
      reflection:   alb p mu_o/(mu_i+mu_o) (1 - e^{-tau(1/mu_i+1/mu_o)})
      transmission: alb p mu_o (e^{-tau/mu_o} - e^{-tau/mu_i})/(mu_o-mu_i)
    with the mu_o -> mu_i limit alb p tau e^{-tau/mu}/mu."""
    alb, tau = _hk_coeffs(p)
    mu_i = jnp.maximum(jnp.abs(wi[..., 2]), 1e-6)[..., None]
    mu_o = jnp.maximum(jnp.abs(wo[..., 2]), 1e-6)[..., None]
    ph = _hk_phase(p, wi, wo)[..., None]

    f_r = (alb * ph * mu_o / (mu_i + mu_o) *
           (1.0 - jnp.exp(-tau * (1.0 / mu_i + 1.0 / mu_o))))

    dmu = mu_o - mu_i
    near = jnp.abs(dmu) < 1e-4
    dmu_s = jnp.where(near, 1.0, dmu)
    f_t_gen = (alb * ph * mu_o *
               (jnp.exp(-tau / mu_o) - jnp.exp(-tau / mu_i)) / dmu_s)
    f_t_lim = alb * ph * tau * jnp.exp(-tau / mu_i) / mu_i
    f_t = jnp.where(near, f_t_lim, f_t_gen)

    same_side = wi[..., 2] * wo[..., 2] > 0
    f = jnp.where(same_side[..., None], f_r, f_t)
    valid = jnp.abs(wi[..., 2]) > 1e-7
    return jnp.where(valid[..., None], jnp.maximum(f, 0.0), 0.0)


def _hk_scatter_prob(p, wi):
    """Probability of sampling the scattering (smooth) component; the
    complement goes to delta transmission, weighted by the unscattered
    slab transmittance (hk.cpp component selection)."""
    pd = luminance(_hk_delta_t(p, wi))
    return jnp.clip(1.0 - pd, 1e-3, 1.0)


def _hk_pdf(p, wi, wo):
    ps = _hk_scatter_prob(p, wi)
    return ps * _hk_phase(p, wi, wo)


def _roughdiffuse_eval(p: MatParams, wi, wo):
    """Oren-Nayar (fast qualitative model, matching roughdiffuse.cpp's
    default non-'useFastApprox=false' path semantics closely enough)."""
    sigma = p.alpha
    sigma2 = sigma * sigma
    A = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
    B = 0.45 * sigma2 / (sigma2 + 0.09)
    ci, co = wi[..., 2], wo[..., 2]
    # azimuth cos difference
    si = jnp.sqrt(jnp.maximum(1 - ci * ci, 0.0))
    so = jnp.sqrt(jnp.maximum(1 - co * co, 0.0))
    cos_dphi = jnp.where(
        (si > 1e-4) & (so > 1e-4),
        (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]) /
        jnp.maximum(si * so, 1e-9), 0.0)
    sin_alpha = jnp.maximum(si, so)
    tan_beta = jnp.minimum(si / jnp.maximum(ci, 1e-4),
                           so / jnp.maximum(co, 1e-4))
    f = (p.reflectance * INV_PI *
         (A + B * jnp.maximum(cos_dphi, 0.0) * sin_alpha * tan_beta)[..., None]
         * jnp.maximum(co, 0.0)[..., None])
    valid = (ci > 0) & (co > 0)
    return jnp.where(valid[..., None], f, 0.0)


def _roughconductor_eval(p: MatParams, wi, wo):
    m = wi + wo
    mlen = jnp.linalg.norm(m, axis=-1, keepdims=True)
    m = m / jnp.maximum(mlen, 1e-12)
    m = m * jnp.sign(m[..., 2:3])  # half-vector on the +z side
    D = mf_D(m, p.alpha, p.dist)
    G = mf_G(wi, wo, m, p.alpha, p.dist)
    F = fresnel_conductor(jnp.sum(wi * m, axis=-1), p.eta, p.k)
    ci = wi[..., 2]
    spec = (D * G / jnp.maximum(4.0 * ci, 1e-9))[..., None] * F * p.specular
    valid = (ci > 0) & (wo[..., 2] > 0) & (mlen[..., 0] > 1e-12)
    return jnp.where(valid[..., None], spec, 0.0)


def _roughconductor_pdf(p, wi, wo):
    m = wi + wo
    mlen = jnp.linalg.norm(m, axis=-1, keepdims=True)
    m = m / jnp.maximum(mlen, 1e-12)
    m = m * jnp.sign(m[..., 2:3])
    pdf_m = mf_pdf(m, p.alpha, p.dist)
    jac = 1.0 / jnp.maximum(4.0 * jnp.abs(jnp.sum(wo * m, axis=-1)), 1e-9)
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return jnp.where(valid, pdf_m * jac, 0.0)


def _roughplastic_eval(p: MatParams, wi, wo):
    spec = _roughconductor_spec_dielectric(p, wi, wo)
    Fi, _ = fresnel_dielectric(wi[..., 2], p.eta[..., 0])
    Fo, _ = fresnel_dielectric(wo[..., 2], p.eta[..., 0])
    inv_eta2 = 1.0 / jnp.maximum(p.eta[..., 0] ** 2, 1e-9)
    diff = p.reflectance / jnp.maximum(
        1.0 - p.fdr_int[..., None] * p.reflectance, 1e-6)
    # nonlinear=false default: 1 - rho*fdr uses albedo; Mitsuba default
    # nonlinear=false divides by (1 - fdr) only:
    diff = p.reflectance / jnp.maximum(1.0 - p.fdr_int, 1e-6)[..., None]
    diffuse = (diff * INV_PI * (inv_eta2 * (1.0 - Fi) * (1.0 - Fo) *
                                jnp.maximum(wo[..., 2], 0.0))[..., None])
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return jnp.where(valid[..., None], spec + diffuse, 0.0)


def _roughconductor_spec_dielectric(p, wi, wo):
    """Microfacet specular lobe with DIELECTRIC Fresnel (for roughplastic)."""
    m = wi + wo
    mlen = jnp.linalg.norm(m, axis=-1, keepdims=True)
    m = m / jnp.maximum(mlen, 1e-12)
    m = m * jnp.sign(m[..., 2:3])
    D = mf_D(m, p.alpha, p.dist)
    G = mf_G(wi, wo, m, p.alpha, p.dist)
    F, _ = fresnel_dielectric(jnp.sum(wi * m, axis=-1), p.eta[..., 0])
    ci = wi[..., 2]
    spec = (D * G * F / jnp.maximum(4.0 * ci, 1e-9))[..., None] * p.specular
    valid = (ci > 0) & (wo[..., 2] > 0) & (mlen[..., 0] > 1e-12)
    return jnp.where(valid[..., None], spec, 0.0)


def _roughplastic_probs(p, wi):
    Fi, _ = fresnel_dielectric(wi[..., 2], p.eta[..., 0])
    sw = p.spec_weight
    prob_spec = (Fi * sw) / jnp.maximum(Fi * sw + (1 - Fi) * (1 - sw), 1e-9)
    return jnp.clip(prob_spec, 0.0, 1.0), Fi


def _roughplastic_pdf(p, wi, wo):
    prob_spec, _ = _roughplastic_probs(p, wi)
    pdf_s = _roughconductor_pdf(p, wi, wo)
    pdf_d = _diffuse_pdf(p, wi, wo)
    return prob_spec * pdf_s + (1 - prob_spec) * pdf_d


def _phong_eval(p: MatParams, wi, wo):
    n = p.alpha  # exponent
    wr = reflect_local(wi)
    cos_r = jnp.maximum(jnp.sum(wr * wo, axis=-1), 0.0)
    spec = p.specular * ((n + 2) * INV_PI * 0.5 *
                         jnp.power(cos_r, n) *
                         jnp.maximum(wo[..., 2], 0.0))[..., None]
    diff = p.reflectance * INV_PI * jnp.maximum(wo[..., 2], 0.0)[..., None]
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return jnp.where(valid[..., None], spec + diff, 0.0)


def _phong_pdf(p, wi, wo):
    n = p.alpha
    wr = reflect_local(wi)
    cos_r = jnp.maximum(jnp.sum(wr * wo, axis=-1), 0.0)
    pdf_s = (n + 1) * INV_PI * 0.5 * jnp.power(cos_r, n)
    pdf_d = _diffuse_pdf(p, wi, wo)
    sw = p.spec_weight
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return jnp.where(valid, sw * pdf_s + (1 - sw) * pdf_d, 0.0)


def _ward_spec_terms(p: MatParams, wi, wo):
    """Classic Ward specular lobe (ward.cpp variant='ward', Walter 2005
    sampling notes).  Returns (f_spec_scalar, pdf_spec, valid)."""
    ax = jnp.maximum(p.alpha, 1e-4)
    ay = jnp.maximum(p.alpha_v, 1e-4)
    h = wi + wo
    hz2 = jnp.maximum(h[..., 2] * h[..., 2], 1e-12)
    expo = jnp.exp(-((h[..., 0] / ax) ** 2 + (h[..., 1] / ay) ** 2) / hz2)
    ci = jnp.maximum(wi[..., 2], 1e-6)
    co = jnp.maximum(wo[..., 2], 1e-6)
    f_spec = expo / (4.0 * jnp.pi * ax * ay * jnp.sqrt(ci * co))
    # p(h) = exp(.) / (pi ax ay cos^3 th); p(wo) = p(h) / (4 |h.wo|)
    hlen = jnp.sqrt(jnp.maximum(jnp.sum(h * h, -1), 1e-12))
    cos_h3 = jnp.maximum(h[..., 2] / hlen, 0.0) ** 3
    hdwo = jnp.abs(jnp.sum(h * wo, -1)) / hlen
    p_h = expo / (jnp.pi * ax * ay * jnp.maximum(cos_h3, 1e-9))
    pdf_spec = p_h / jnp.maximum(4.0 * hdwo, 1e-9)
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return f_spec, pdf_spec, valid


def _ward_eval(p: MatParams, wi, wo):
    f_spec, _, valid = _ward_spec_terms(p, wi, wo)
    co = jnp.maximum(wo[..., 2], 0.0)
    out = (p.specular * f_spec[..., None] +
           p.reflectance * INV_PI) * co[..., None]
    return jnp.where(valid[..., None], out, 0.0)


def _ward_pdf(p: MatParams, wi, wo):
    _, pdf_spec, valid = _ward_spec_terms(p, wi, wo)
    sw = p.spec_weight
    pdf = sw * pdf_spec + (1 - sw) * _diffuse_pdf(p, wi, wo)
    return jnp.where(valid, pdf, 0.0)


def _ward_sample_h(p: MatParams, u2):
    """Sample the Ward half-vector (Walter 2005, eq. 6-7)."""
    ax = jnp.maximum(p.alpha, 1e-4)
    ay = jnp.maximum(p.alpha_v, 1e-4)
    phi_iso = 2.0 * jnp.pi * u2[..., 1]
    phi = jnp.arctan2(ay * jnp.sin(phi_iso), ax * jnp.cos(phi_iso))
    cp, sp = jnp.cos(phi), jnp.sin(phi)
    tan2 = -jnp.log(jnp.maximum(u2[..., 0], 1e-9)) / \
        jnp.maximum((cp / ax) ** 2 + (sp / ay) ** 2, 1e-12)
    cos_t = 1.0 / jnp.sqrt(1.0 + tan2)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t ** 2, 0.0))
    return jnp.stack([sin_t * cp, sin_t * sp, cos_t], -1)


def _roughdielectric_H(p, wi, wo):
    """Half vector for reflection/refraction (Walter et al. 2007), oriented
    to +z.  Returns (H, refract_mask, rel_eta)."""
    refract = (wi[..., 2] * wo[..., 2]) < 0
    rel = jnp.where(wi[..., 2] >= 0, p.eta[..., 0],
                    1.0 / jnp.maximum(p.eta[..., 0], 1e-9))
    h_refl = wi + wo
    h_refr = -(wi + _b3ax(rel) * wo)
    h = jnp.where(_b3ax(refract), h_refr, h_refl)
    hlen = jnp.linalg.norm(h, axis=-1, keepdims=True)
    h = h / jnp.maximum(hlen, 1e-12)
    h = h * jnp.sign(h[..., 2:3])
    return h, refract, rel, hlen[..., 0] > 1e-12


def _b3ax(x):
    return x[..., None]


def _roughdielectric_eval(p: MatParams, wi, wo):
    """f*|cos_o| for rough dielectric (radiance transport: the eta^2
    compression folded in, matching the smooth dielectric convention)."""
    h, refract, rel, h_ok = _roughdielectric_H(p, wi, wo)
    D = mf_D(h, p.alpha, p.dist)
    G = mf_G(wi * jnp.sign(wi[..., 2:3]), wo * jnp.sign(wo[..., 2:3]),
             h, p.alpha, p.dist)
    widh = jnp.sum(wi * h, axis=-1)
    wodh = jnp.sum(wo * h, axis=-1)
    F, _ = fresnel_dielectric(widh, p.eta[..., 0])
    ci = jnp.abs(wi[..., 2])

    f_refl = p.specular * (F * D * G / jnp.maximum(4.0 * ci, 1e-9))[..., None]
    denom = (widh + rel * wodh) ** 2
    f_refr = p.transmittance * (
        jnp.abs(widh) * jnp.abs(wodh) / jnp.maximum(ci, 1e-9) *
        (1.0 - F) * D * G / jnp.maximum(denom, 1e-12))[..., None]
    same = (wi[..., 2] * wo[..., 2]) > 0
    # microfacet sidedness: reflection keeps wi/wo on the same side of H,
    # refraction on opposite sides — without this the reconstructed H
    # assigns density to geometrically impossible transmissions
    side_ok = jnp.where(refract, widh * wodh < 0, widh * wodh > 0)
    out = jnp.where(_b3ax(refract), f_refr, f_refl)
    valid = h_ok & side_ok & jnp.where(refract, ~same, same)
    return jnp.where(_b3ax(valid), out, 0.0)


def _roughdielectric_pdf(p: MatParams, wi, wo):
    h, refract, rel, h_ok = _roughdielectric_H(p, wi, wo)
    widh = jnp.sum(wi * h, axis=-1)
    wodh = jnp.sum(wo * h, axis=-1)
    pm = mf_pdf(h, p.alpha, p.dist)   # D * |cos_h|
    F, _ = fresnel_dielectric(widh, p.eta[..., 0])
    jac_refl = 1.0 / jnp.maximum(4.0 * jnp.abs(wodh), 1e-9)
    denom = (widh + rel * wodh) ** 2
    jac_refr = (rel * rel) * jnp.abs(wodh) / jnp.maximum(denom, 1e-12)
    pdf = jnp.where(refract, pm * jac_refr * (1.0 - F),
                    pm * jac_refl * F)
    same = (wi[..., 2] * wo[..., 2]) > 0
    side_ok = jnp.where(refract, widh * wodh < 0, widh * wodh > 0)
    valid = h_ok & side_ok & jnp.where(refract, ~same, same)
    return jnp.where(valid, pdf, 0.0)


def _roughdielectric_sample(p: MatParams, wi, u2, uc):
    """Returns (wo, weight, pdf, valid, eta_transition)."""
    h = mf_sample(u2, p.alpha, p.dist)
    widh = jnp.sum(wi * h, axis=-1)
    F, cos_t = fresnel_dielectric(widh, p.eta[..., 0])
    choose_refl = uc <= F
    wo_refl = 2.0 * widh[..., None] * h - wi
    rel = jnp.where(widh >= 0, p.eta[..., 0],
                    1.0 / jnp.maximum(p.eta[..., 0], 1e-9))
    c2 = 1.0 - (1.0 - widh * widh) / jnp.maximum(rel * rel, 1e-18)
    cos_tp = jnp.sqrt(jnp.maximum(c2, 0.0))
    sgn = jnp.sign(widh)
    wo_refr = -wi / rel[..., None] + (
        widh / rel - sgn * cos_tp)[..., None] * h
    from ..core.math import normalize as _norm
    wo_refr = _norm(wo_refr)
    wo = jnp.where(choose_refl[..., None], wo_refl, wo_refr)
    valid_mode = jnp.where(choose_refl,
                           (wo[..., 2] * wi[..., 2]) > 0,
                           (wo[..., 2] * wi[..., 2]) < 0)
    f = _roughdielectric_eval(p, wi, wo)
    pdf = _roughdielectric_pdf(p, wi, wo)
    weight = f / jnp.maximum(pdf, 1e-12)[..., None]
    valid = valid_mode & (pdf > 0) & (jnp.max(f, -1) > 0)
    eta_tr = jnp.where(choose_refl, 1.0, rel)
    return wo, weight, pdf, valid, eta_tr


# ---------------------------------------------------------------------------
# Public dispatch API
# ---------------------------------------------------------------------------

def _flip_frame(p: MatParams, wi):
    """Two-sided handling: flip z for intrinsically one-sided models when lit
    from the back AND the material is two-sided (or is a dielectric, which
    handles signed cosines itself)."""
    handles_sign = ((p.kind == DIELECTRIC) | (p.kind == THIN_DIELECTRIC) |
                    (p.kind == ROUGH_DIELECTRIC) | (p.kind == NULL_BSDF) |
                    (p.kind == DIFFTRANS) | (p.kind == HK))
    flip = p.twosided & (wi[..., 2] < 0) & ~handles_sign
    sign = jnp.where(flip, -1.0, 1.0)
    return sign, flip


def _has(kinds, k):
    """Static membership: kinds=None means 'all models compiled in'."""
    return kinds is None or k in kinds


# ---------------------------------------------------------------------------
# Smooth coating layer (src/bsdfs/coating.cpp): a dielectric slab with
# absorption over a nested BSDF.  Directions are refracted into the layer
# before the inner dispatch; the layer adds a delta reflection lobe.
# ---------------------------------------------------------------------------

def _coat_in(w, inv_eta):
    """Refract a local direction INTO the (denser) layer, hemisphere
    preserved.  Always succeeds going in."""
    sin2_t = jnp.clip(1.0 - w[..., 2] ** 2, 0.0, 1.0) * inv_eta ** 2
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    return jnp.stack([w[..., 0] * inv_eta, w[..., 1] * inv_eta,
                      jnp.sign(w[..., 2]) * cos_t], -1)


def _coat_out(w, eta):
    """Refract a local direction OUT of the layer; (wo, valid) — invalid
    on total internal reflection."""
    sin2_t = jnp.clip(1.0 - w[..., 2] ** 2, 0.0, 1.0) * eta ** 2
    valid = sin2_t < 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    wo = jnp.stack([w[..., 0] * eta, w[..., 1] * eta,
                    jnp.sign(w[..., 2]) * cos_t], -1)
    from ..core.math import normalize as _norm
    return _norm(wo), valid


def _coat_absorption(p, wi_c, wo_c):
    tau = (1.0 / jnp.maximum(jnp.abs(wi_c[..., 2:3]), 1e-4) +
           1.0 / jnp.maximum(jnp.abs(wo_c[..., 2:3]), 1e-4))
    return jnp.exp(-p.coat_sigma * tau)


def _coat_spec_prob(p, wi):
    """Probability of sampling the layer's delta reflection
    (specularSamplingWeight semantics, coating.cpp)."""
    Fi, _ = fresnel_dielectric(jnp.abs(wi[..., 2]), p.coat_eta)
    s_lum = luminance(p.coat_spec)
    d_lum = luminance(p.reflectance)
    sw = s_lum / jnp.maximum(s_lum + d_lum, 1e-9)
    return Fi, (Fi * sw) / jnp.maximum(Fi * sw + (1 - Fi) * (1 - sw),
                                       1e-9)


def _coat_flip(wi, wo):
    """Flip both local directions into wi's upper hemisphere (the layer
    boundary is two-sided)."""
    s = jnp.sign(wi[..., 2:3])
    one = jnp.ones_like(s)
    fl = jnp.concatenate([one, one, s], -1)
    return wi * fl, wo * fl


def _coat_layer_eval(p, wi, wo):
    """f*cos of the roughcoating layer's microfacet reflection lobe
    (roughcoating.cpp: dielectric-Fresnel microfacet, full-NDF D/G like
    every microfacet model here).  Zero where the layer is smooth — its
    delta lobe is excluded from eval like every delta lobe."""
    wif, wof = _coat_flip(wi, wo)
    m = wif + wof
    mlen = jnp.linalg.norm(m, axis=-1, keepdims=True)
    m = m / jnp.maximum(mlen, 1e-12)
    m = m * jnp.sign(m[..., 2:3])
    D = mf_D(m, p.coat_alpha, p.coat_dist)
    G = mf_G(wif, wof, m, p.coat_alpha, p.coat_dist)
    F, _ = fresnel_dielectric(jnp.abs(jnp.sum(wif * m, axis=-1)),
                              p.coat_eta)
    ci = wif[..., 2]
    spec = ((D * G * F / jnp.maximum(4.0 * ci, 1e-9))[..., None] *
            p.coat_spec)
    valid = ((ci > 1e-6) & (wof[..., 2] > 1e-6) & (mlen[..., 0] > 1e-12) &
             (p.coat_alpha > _ROUGH_LAYER_MIN))
    return jnp.where(valid[..., None], spec, 0.0)


def _coat_layer_pdf(p, wi, wo):
    """Half-vector-sampling pdf of the rough layer lobe (dwh->dwo)."""
    wif, wof = _coat_flip(wi, wo)
    m = wif + wof
    mlen = jnp.linalg.norm(m, axis=-1, keepdims=True)
    m = m / jnp.maximum(mlen, 1e-12)
    m = m * jnp.sign(m[..., 2:3])
    pdf_m = mf_pdf(m, p.coat_alpha, p.coat_dist)
    jac = 1.0 / jnp.maximum(4.0 * jnp.abs(jnp.sum(wof * m, axis=-1)), 1e-9)
    valid = ((wif[..., 2] > 1e-6) & (wof[..., 2] > 1e-6) &
             (p.coat_alpha > _ROUGH_LAYER_MIN))
    return jnp.where(valid, pdf_m * jac, 0.0)


def _coating_eval(p, wi, wo, kinds):
    """f*cos of the coated inner BSDF plus, for rough layers
    (roughcoating), the layer's microfacet reflection lobe.  A smooth
    layer's delta reflection is excluded, like every delta lobe in
    eval."""
    inv_eta = 1.0 / p.coat_eta
    Fi, _ = fresnel_dielectric(jnp.abs(wi[..., 2]), p.coat_eta)
    Fo, _ = fresnel_dielectric(jnp.abs(wo[..., 2]), p.coat_eta)
    wi_c = _coat_in(wi, inv_eta)
    wo_c = _coat_in(wo, inv_eta)
    f_in = eval(p._replace(blend=None, coat=None), wi_c, wo_c, kinds)
    comp = (inv_eta ** 2 * jnp.abs(wo[..., 2]) /
            jnp.maximum(jnp.abs(wo_c[..., 2]), 1e-6))
    scale = ((1.0 - Fi) * (1.0 - Fo) * comp)[..., None]
    f = f_in * scale * _coat_absorption(p, wi_c, wo_c)
    if _has(kinds, ROUGH_COAT) and p.coat_alpha is not None:
        f = f + _coat_layer_eval(p, wi, wo)
    return f


def _coating_sample(p, wi, u2, u_comp, kinds):
    """Sample the coating: delta layer reflection with probability
    prob_spec, otherwise sample the inner BSDF in the layer and refract
    back out (TIR kills the sample — unbiased failure)."""
    from ..core.math import reflect_local
    inv_eta = 1.0 / p.coat_eta
    Fi, prob_spec = _coat_spec_prob(p, wi)
    pick_spec = u_comp < prob_spec
    u_re = jnp.clip(jnp.where(pick_spec,
                              u_comp / jnp.maximum(prob_spec, 1e-9),
                              (u_comp - prob_spec) /
                              jnp.maximum(1.0 - prob_spec, 1e-9)),
                    0.0, 1.0)

    # nested lobe: sample the inner BSDF with the refracted incoming
    wi_c = _coat_in(wi, inv_eta)
    s_in = sample(p._replace(blend=None, coat=None), wi_c, u2, u_re,
                  kinds)
    wo_out, out_ok = _coat_out(s_in.wo, p.coat_eta)
    Fo, _ = fresnel_dielectric(jnp.abs(wo_out[..., 2]), p.coat_eta)
    absorp = _coat_absorption(p, wi_c, s_in.wo)
    nested_valid = s_in.valid & out_ok
    # smooth inner samples: one-sample-MIS weight from the coating's own
    # eval/pdf (verified math above); delta inner (coated mirror): keep
    # the inner weight scaled by the crossing terms, pdf picks up the
    # component probability
    f_c = _coating_eval(p, wi, wo_out, kinds)
    pdf_c = _coating_pdf(p, wi, wo_out, kinds)
    w_smooth = f_c / jnp.maximum(pdf_c, 1e-12)[..., None]
    w_delta_in = (s_in.weight * absorp *
                  ((1.0 - Fi) * (1.0 - Fo) /
                   jnp.maximum(1.0 - prob_spec, 1e-9))[..., None])
    nested_w = jnp.where(s_in.is_delta[..., None], w_delta_in, w_smooth)
    nested_pdf = jnp.where(s_in.is_delta,
                           (1.0 - prob_spec) * s_in.pdf, pdf_c)

    # layer reflection: delta mirror for a smooth layer, microfacet
    # half-vector sample for a rough one (roughcoating).  u2 is free to
    # reuse here — the nested sample it fed is discarded on this branch.
    wo_spec = reflect_local(wi)
    w_spec = p.coat_spec * (Fi / jnp.maximum(prob_spec, 1e-9))[..., None]
    pdf_spec = prob_spec
    spec_valid = prob_spec > 0
    spec_delta = jnp.ones_like(pick_spec)
    if _has(kinds, ROUGH_COAT) and p.coat_alpha is not None:
        rough = p.coat_alpha > _ROUGH_LAYER_MIN
        sgn = jnp.sign(wi[..., 2:3])
        fl = jnp.concatenate([jnp.ones_like(sgn), jnp.ones_like(sgn),
                              sgn], -1)
        wif = wi * fl
        m_h = mf_sample(u2, p.coat_alpha, p.coat_dist)
        wo_r = (2.0 * jnp.sum(wif * m_h, -1, keepdims=True) * m_h -
                wif) * fl
        # one-sample MIS over {layer lobe, nested}: full eval / full pdf
        f_r = _coating_eval(p, wi, wo_r, kinds)
        pdf_r = _coating_pdf(p, wi, wo_r, kinds)
        w_r = f_r / jnp.maximum(pdf_r, 1e-12)[..., None]
        valid_r = (pdf_r > 0) & (wo_r[..., 2] * wi[..., 2] > 0)
        rk3 = rough[..., None]
        wo_spec = jnp.where(rk3, wo_r, wo_spec)
        w_spec = jnp.where(rk3, w_r, w_spec)
        pdf_spec = jnp.where(rough, pdf_r, pdf_spec)
        spec_valid = jnp.where(rough, valid_r, spec_valid)
        spec_delta = ~rough
        # a rough layer also changes the NESTED pick: its pdf/weight must
        # see the layer lobe's density at wo_out (already true: nested_w
        # and nested_pdf come from the full _coating_eval/_coating_pdf
        # for smooth inner samples; delta inner samples keep their own
        # component weight, and the layer lobe can't produce a delta wo)

    pk3 = pick_spec[..., None]
    wo = jnp.where(pk3, wo_spec, wo_out)
    weight = jnp.where(pk3, w_spec, nested_w)
    valid = jnp.where(pick_spec, spec_valid, nested_valid)
    return BSDFSample(
        wo=wo,
        weight=jnp.where(valid[..., None], weight, 0.0),
        pdf=jnp.where(pick_spec, pdf_spec, nested_pdf),
        is_delta=jnp.where(pick_spec, spec_delta, s_in.is_delta),
        eta=jnp.ones_like(Fi),
        valid=valid)


def _coating_pdf(p, wi, wo, kinds):
    inv_eta = 1.0 / p.coat_eta
    _, prob_spec = _coat_spec_prob(p, wi)
    wi_c = _coat_in(wi, inv_eta)
    wo_c = _coat_in(wo, inv_eta)
    pdf_in = pdf(p._replace(blend=None, coat=None), wi_c, wo_c, kinds)
    comp = (inv_eta ** 2 * jnp.abs(wo[..., 2]) /
            jnp.maximum(jnp.abs(wo_c[..., 2]), 1e-6))
    out = (1.0 - prob_spec) * pdf_in * comp
    if _has(kinds, ROUGH_COAT) and p.coat_alpha is not None:
        # rough layer: the reflection lobe is smooth (has a pdf density)
        out = out + prob_spec * _coat_layer_pdf(p, wi, wo)
    return out


def eval(p: MatParams, wi, wo, kinds=None):
    """f(wi,wo)*|cos_o| for the SMOOTH components; zero for delta lobes.

    `kinds` (an optional static frozenset of material enums present in
    the scene) prunes absent models at trace time — a large compile-time
    and run-time saving for typical scenes."""
    if p.blend is not None:
        # blendbsdf.cpp: f = (1-w) f_child0 + w f_child1.  Lanes whose
        # material is not a blend carry w = 0 and child0 = own row.
        w = p.blend_w[..., None]
        f0 = eval(p._replace(blend=None, coat=None), wi, wo, kinds)
        f1 = eval(p.blend, wi, wo, kinds)
        f = (1.0 - w) * f0 + w * f1
        if p.coat is not None:
            f = jnp.where(p.coat[..., None],
                          _coating_eval(p, wi, wo, kinds), f)
        return f
    sign, _ = _flip_frame(p, wi)
    wi = wi * jnp.stack([jnp.ones_like(sign)] * 2 + [sign], -1)
    wo = wo * jnp.stack([jnp.ones_like(sign)] * 2 + [sign], -1)
    out = _diffuse_eval(p, wi, wo)
    if _has(kinds, ROUGH_DIFFUSE):
        out = jnp.where((p.kind == ROUGH_DIFFUSE)[..., None],
                        _roughdiffuse_eval(p, wi, wo), out)
    if _has(kinds, ROUGH_CONDUCTOR):
        out = jnp.where((p.kind == ROUGH_CONDUCTOR)[..., None],
                        _roughconductor_eval(p, wi, wo), out)
    if _has(kinds, ROUGH_PLASTIC):
        out = jnp.where((p.kind == ROUGH_PLASTIC)[..., None],
                        _roughplastic_eval(p, wi, wo), out)
    if _has(kinds, PHONG):
        out = jnp.where((p.kind == PHONG)[..., None],
                        _phong_eval(p, wi, wo), out)
    if _has(kinds, WARD):
        out = jnp.where((p.kind == WARD)[..., None],
                        _ward_eval(p, wi, wo), out)
    if _has(kinds, PLASTIC):
        out = jnp.where((p.kind == PLASTIC)[..., None],
                        _plastic_eval_diffuse(p, wi, wo), out)
    if _has(kinds, ROUGH_DIELECTRIC):
        out = jnp.where((p.kind == ROUGH_DIELECTRIC)[..., None],
                        _roughdielectric_eval(p, wi, wo), out)
    if _has(kinds, DIFFTRANS):
        out = jnp.where((p.kind == DIFFTRANS)[..., None],
                        _difftrans_eval(p, wi, wo), out)
    if _has(kinds, HK):
        out = jnp.where((p.kind == HK)[..., None],
                        _hk_eval(p, wi, wo), out)
    if _has(kinds, IRAWAN):
        from .irawan import eval_cloth
        out = jnp.where((p.kind == IRAWAN)[..., None],
                        eval_cloth(p, wi, wo), out)
    if _has(kinds, OPACITY):
        out = out * p.opacity[..., None]  # mask: f = opacity * f_nested
    delta_only = ((p.kind == CONDUCTOR) | (p.kind == DIELECTRIC) |
                  (p.kind == THIN_DIELECTRIC) | (p.kind == NULL_BSDF))
    return jnp.where(delta_only[..., None], 0.0, out)


def _plastic_eval_diffuse(p, wi, wo):
    """Smooth plastic: delta specular + diffuse substrate; eval covers the
    diffuse part only (plastic.cpp eval with ESolidAngle)."""
    Fi, _ = fresnel_dielectric(wi[..., 2], p.eta[..., 0])
    Fo, _ = fresnel_dielectric(wo[..., 2], p.eta[..., 0])
    inv_eta2 = 1.0 / jnp.maximum(p.eta[..., 0] ** 2, 1e-9)
    diff = p.reflectance / jnp.maximum(1.0 - p.fdr_int, 1e-6)[..., None]
    f = diff * INV_PI * (inv_eta2 * (1 - Fi) * (1 - Fo) *
                         jnp.maximum(wo[..., 2], 0.0))[..., None]
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return jnp.where(valid[..., None], f, 0.0)


def pdf(p: MatParams, wi, wo, kinds=None):
    """Solid-angle pdf of sample() restricted to smooth components."""
    if p.blend is not None:
        w = p.blend_w
        p0 = pdf(p._replace(blend=None, coat=None), wi, wo, kinds)
        p1 = pdf(p.blend, wi, wo, kinds)
        out = (1.0 - w) * p0 + w * p1
        if p.coat is not None:
            out = jnp.where(p.coat, _coating_pdf(p, wi, wo, kinds), out)
        return out
    sign, _ = _flip_frame(p, wi)
    wi = wi * jnp.stack([jnp.ones_like(sign)] * 2 + [sign], -1)
    wo = wo * jnp.stack([jnp.ones_like(sign)] * 2 + [sign], -1)
    out = _diffuse_pdf(p, wi, wo)
    if _has(kinds, ROUGH_CONDUCTOR):
        out = jnp.where(p.kind == ROUGH_CONDUCTOR,
                        _roughconductor_pdf(p, wi, wo), out)
    if _has(kinds, ROUGH_PLASTIC):
        out = jnp.where(p.kind == ROUGH_PLASTIC,
                        _roughplastic_pdf(p, wi, wo), out)
    if _has(kinds, PHONG):
        out = jnp.where(p.kind == PHONG, _phong_pdf(p, wi, wo), out)
    if _has(kinds, WARD):
        out = jnp.where(p.kind == WARD, _ward_pdf(p, wi, wo), out)
    if _has(kinds, PLASTIC):
        out = jnp.where(p.kind == PLASTIC, _plastic_pdf(p, wi, wo), out)
    if _has(kinds, ROUGH_DIELECTRIC):
        out = jnp.where(p.kind == ROUGH_DIELECTRIC,
                        _roughdielectric_pdf(p, wi, wo), out)
    if _has(kinds, DIFFTRANS):
        out = jnp.where(p.kind == DIFFTRANS,
                        _difftrans_pdf(p, wi, wo), out)
    if _has(kinds, HK):
        out = jnp.where(p.kind == HK, _hk_pdf(p, wi, wo), out)
    if _has(kinds, OPACITY):
        out = out * p.opacity  # mask: continuous pdf share
    delta_only = ((p.kind == CONDUCTOR) | (p.kind == DIELECTRIC) |
                  (p.kind == THIN_DIELECTRIC) | (p.kind == NULL_BSDF))
    return jnp.where(delta_only, 0.0, out)


def _plastic_pdf(p, wi, wo):
    Fi, _ = fresnel_dielectric(wi[..., 2], p.eta[..., 0])
    sw = p.spec_weight
    prob_spec = (Fi * sw) / jnp.maximum(Fi * sw + (1 - Fi) * (1 - sw), 1e-9)
    return (1 - prob_spec) * _diffuse_pdf(p, wi, wo)


class BSDFSample(NamedTuple):
    wo: jnp.ndarray        # [N, 3] local
    weight: jnp.ndarray    # [N, 3] f*cos/pdf (0 on failure)
    pdf: jnp.ndarray       # [N] solid-angle pdf (delta: discrete prob)
    is_delta: jnp.ndarray  # [N] bool
    eta: jnp.ndarray       # [N] relative IOR of the transition
    valid: jnp.ndarray     # [N] bool


# pseudo-kind sentinel: present in scene_kinds when any material carries a
# mask-wrapper opacity (< 1 or textured) — compiles the pass-through
# machinery in only where needed.
#
# Shadow-ray semantics match the reference's PLAIN path tracer exactly:
# masked geometry blocks shadow rays geometrically
# (Scene::sampleEmitterDirect -> boolean rayIntersect), and paths that
# cross a mask contribute through BSDF sampling with MIS weight 1 after
# the delta pass-through (path.cpp sets lumPdf = 0 after an ENull-type
# bounce).  The technique set stays complete and unbiased: NEE simply
# cannot produce through-blocker paths, and the BSDF technique claims
# them fully.  (Attenuated NEE is a volpath feature, not a path one.)
OPACITY = -2
ROUGH_COAT = -3         # pseudo-kind: some COATING row has a rough layer
_ROUGH_LAYER_MIN = 1e-5  # coat_alpha above this = microfacet layer lobe


def scene_kinds(scene) -> frozenset:
    """Static set of material kinds present in a compiled scene — used to
    prune absent BSDF models out of the traced program entirely."""
    import numpy as _np
    kinds = set(int(v) for v in
                _np.unique(_np.asarray(scene.materials.kind)))
    packed = _np.asarray(scene.materials.packed)
    if (packed[:, 22] < 1.0).any() or (packed[:, 23] >= 0).any():
        kinds.add(OPACITY)
    coat_rows = packed[:, 0] == COATING
    if (packed[coat_rows, 21] > _ROUGH_LAYER_MIN).any():
        kinds.add(ROUGH_COAT)
    return frozenset(kinds)


def sample(p: MatParams, wi, u2, u_comp, kinds=None) -> BSDFSample:
    """Sample an outgoing direction. u2: [N,2], u_comp: [N].

    `kinds` statically prunes material models absent from the scene."""
    if p.blend is not None:
        # blendbsdf: pick a child with probability (1-w, w), sample it,
        # then weight by the one-sample-MIS estimator f_mix/pdf_mix
        # (the mixture pdf already accounts for the pick probability).
        # Delta children: the pick probability cancels against the
        # mixture's lobe weight, so the child's own weight is exact.
        w = jnp.clip(p.blend_w, 0.0, 1.0)
        pick1 = u_comp < w
        u_re = jnp.clip(jnp.where(pick1,
                                  u_comp / jnp.maximum(w, 1e-9),
                                  (u_comp - w) /
                                  jnp.maximum(1.0 - w, 1e-9)), 0.0, 1.0)
        s0 = sample(p._replace(blend=None, coat=None), wi, u2, u_re,
                    kinds)
        s1 = sample(p.blend, wi, u2, u_re, kinds)
        pick3 = pick1[..., None]
        wo = jnp.where(pick3, s1.wo, s0.wo)
        is_delta = jnp.where(pick1, s1.is_delta, s0.is_delta)
        eta = jnp.where(pick1, s1.eta, s0.eta)
        valid = jnp.where(pick1, s1.valid, s0.valid)
        w_pick = jnp.where(pick1, w, 1.0 - w)
        f_mix = eval(p, wi, wo, kinds)
        pdf_mix = pdf(p, wi, wo, kinds)
        weight = jnp.where(
            is_delta[..., None],
            jnp.where(pick3, s1.weight, s0.weight),
            f_mix / jnp.maximum(pdf_mix, 1e-12)[..., None])
        pdf_out = jnp.where(is_delta,
                            w_pick * jnp.where(pick1, s1.pdf, s0.pdf),
                            pdf_mix)
        out = BSDFSample(wo=wo, weight=jnp.where(valid[..., None],
                                                 weight, 0.0),
                         pdf=pdf_out, is_delta=is_delta, eta=eta,
                         valid=valid)
        if p.coat is not None:
            sc_ = _coating_sample(p, wi, u2, u_comp, kinds)
            c3 = p.coat[..., None]
            out = BSDFSample(
                wo=jnp.where(c3, sc_.wo, out.wo),
                weight=jnp.where(c3, sc_.weight, out.weight),
                pdf=jnp.where(p.coat, sc_.pdf, out.pdf),
                is_delta=jnp.where(p.coat, sc_.is_delta, out.is_delta),
                eta=jnp.where(p.coat, sc_.eta, out.eta),
                valid=jnp.where(p.coat, sc_.valid, out.valid))
        return out
    sign, _ = _flip_frame(p, wi)
    sign3 = jnp.stack([jnp.ones_like(sign)] * 2 + [sign], -1)
    wif = wi * sign3
    N = wi.shape[:-1]
    one = jnp.ones(N, wi.dtype)
    k = p.kind

    if _has(kinds, OPACITY):
        # mask wrapper (mask.cpp): with probability 1-opacity the ray
        # passes straight through (delta transmission); the component
        # random number is rescaled for the nested lobe selection
        op_m = jnp.clip(p.opacity, 0.0, 1.0)
        pass_m = u_comp >= op_m
        u_comp = jnp.clip(u_comp / jnp.maximum(op_m, 1e-9), 0.0, 1.0)

    # --- diffuse-family (always compiled: the default branch) -------------
    wo_d = warp.square_to_cosine_hemisphere(u2)
    pdf_d = warp.square_to_cosine_hemisphere_pdf(wo_d)
    w_d_diffuse = jnp.where((wif[..., 2] > 0)[..., None], p.reflectance, 0.0)

    wo_sel = [];  w_sel = [];  pdf_sel = [];  eta_sel = [];  valid_sel = []
    delta_mask = jnp.zeros(N, bool)

    if _has(kinds, ROUGH_DIFFUSE):
        on_eval = _roughdiffuse_eval(p, wif, wo_d)
        w_d_on = on_eval / jnp.maximum(pdf_d, 1e-12)[..., None]
        wo_sel.append((ROUGH_DIFFUSE, wo_d))
        w_sel.append((ROUGH_DIFFUSE, w_d_on))
        pdf_sel.append((ROUGH_DIFFUSE, pdf_d))
        valid_sel.append((ROUGH_DIFFUSE,
                          (wif[..., 2] > 0) & (wo_d[..., 2] > 0)))

    if _has(kinds, IRAWAN):
        from .irawan import eval_cloth
        ir_eval = eval_cloth(p, wif, wo_d)
        w_ir = ir_eval / jnp.maximum(pdf_d, 1e-12)[..., None]
        wo_sel.append((IRAWAN, wo_d))
        w_sel.append((IRAWAN, w_ir))
        pdf_sel.append((IRAWAN, pdf_d))
        valid_sel.append((IRAWAN,
                          (wif[..., 2] > 0) & (wo_d[..., 2] > 0)))

    if _has(kinds, CONDUCTOR):
        wo_c = reflect_local(wif)
        F_c = fresnel_conductor(wif[..., 2], p.eta, p.k)
        wo_sel.append((CONDUCTOR, wo_c))
        w_sel.append((CONDUCTOR, p.specular * F_c))
        pdf_sel.append((CONDUCTOR, one))
        valid_sel.append((CONDUCTOR, wif[..., 2] > 0))
        delta_mask = delta_mask | (k == CONDUCTOR)

    eta_s = p.eta[..., 0]
    if _has(kinds, DIELECTRIC):
        F_die, cos_t = fresnel_dielectric(wi[..., 2], eta_s)
        choose_refl = u_comp <= F_die
        wo_refl = reflect_local(wi)
        rel_eta = jnp.where(wi[..., 2] >= 0, eta_s,
                            1.0 / jnp.maximum(eta_s, 1e-9))
        wo_refr = jnp.stack(
            [-wi[..., 0] / rel_eta, -wi[..., 1] / rel_eta, cos_t], axis=-1)
        wo_die = jnp.where(choose_refl[..., None], wo_refl, wo_refr)
        # radiance transport: transmitted weight carries 1/eta^2
        w_die = jnp.where(
            choose_refl[..., None], p.specular,
            p.transmittance / jnp.maximum(rel_eta * rel_eta,
                                          1e-9)[..., None])
        pdf_die = jnp.where(choose_refl, F_die, 1.0 - F_die)
        eta_die = jnp.where(choose_refl, 1.0, rel_eta)
        wo_sel.append((DIELECTRIC, wo_die))
        w_sel.append((DIELECTRIC, w_die))
        pdf_sel.append((DIELECTRIC, pdf_die))
        eta_sel.append((DIELECTRIC, eta_die))
        valid_sel.append((DIELECTRIC, pdf_die > 0))
        delta_mask = delta_mask | (k == DIELECTRIC)

    if _has(kinds, THIN_DIELECTRIC):
        # two-interface reflection: R' = R + TRT + ...
        F_thin_raw, _ = fresnel_dielectric(jnp.abs(wi[..., 2]), eta_s)
        F_thin = jnp.where(
            F_thin_raw < 1.0,
            F_thin_raw + (1 - F_thin_raw) ** 2 * F_thin_raw /
            jnp.maximum(1 - F_thin_raw ** 2, 1e-9),
            1.0)
        choose_refl_t = u_comp <= F_thin
        wo_thin = jnp.where(choose_refl_t[..., None], reflect_local(wi),
                            -wi)
        w_thin = jnp.where(choose_refl_t[..., None], p.specular,
                           p.transmittance)
        pdf_thin = jnp.where(choose_refl_t, F_thin, 1.0 - F_thin)
        wo_sel.append((THIN_DIELECTRIC, wo_thin))
        w_sel.append((THIN_DIELECTRIC, w_thin))
        pdf_sel.append((THIN_DIELECTRIC, pdf_thin))
        valid_sel.append((THIN_DIELECTRIC, pdf_thin > 0))
        delta_mask = delta_mask | (k == THIN_DIELECTRIC)

    need_rc = _has(kinds, ROUGH_CONDUCTOR) or _has(kinds, ROUGH_PLASTIC)
    if need_rc:
        m_h = mf_sample(u2, p.alpha, p.dist)
        wo_rc = 2.0 * jnp.sum(wif * m_h, axis=-1, keepdims=True) * m_h - wif
    if _has(kinds, ROUGH_CONDUCTOR):
        pdf_rc = _roughconductor_pdf(p, wif, wo_rc)
        eval_rc = _roughconductor_eval(p, wif, wo_rc)
        w_rc = eval_rc / jnp.maximum(pdf_rc, 1e-12)[..., None]
        wo_sel.append((ROUGH_CONDUCTOR, wo_rc))
        w_sel.append((ROUGH_CONDUCTOR, w_rc))
        pdf_sel.append((ROUGH_CONDUCTOR, pdf_rc))
        valid_sel.append((ROUGH_CONDUCTOR,
                          (wo_rc[..., 2] > 0) & (wif[..., 2] > 0) &
                          (pdf_rc > 0)))

    if _has(kinds, ROUGH_PLASTIC):
        prob_spec_rp, _ = _roughplastic_probs(p, wif)
        pick_spec_rp = u_comp < prob_spec_rp
        wo_rp = jnp.where(pick_spec_rp[..., None], wo_rc, wo_d)
        pdf_rp = _roughplastic_pdf(p, wif, wo_rp)
        eval_rp = _roughplastic_eval(p, wif, wo_rp)
        w_rp = eval_rp / jnp.maximum(pdf_rp, 1e-12)[..., None]
        wo_sel.append((ROUGH_PLASTIC, wo_rp))
        w_sel.append((ROUGH_PLASTIC, w_rp))
        pdf_sel.append((ROUGH_PLASTIC, pdf_rp))
        valid_sel.append((ROUGH_PLASTIC,
                          (wo_rp[..., 2] > 0) & (wif[..., 2] > 0) &
                          (pdf_rp > 0)))

    sw = p.spec_weight
    pick_spec_p = jnp.zeros(N, bool)
    if _has(kinds, PLASTIC):
        Fi_p, _ = fresnel_dielectric(wif[..., 2], eta_s)
        prob_spec_p = jnp.clip(
            (Fi_p * sw) / jnp.maximum(Fi_p * sw + (1 - Fi_p) * (1 - sw),
                                      1e-9), 0.0, 1.0)
        pick_spec_p = u_comp < prob_spec_p
        wo_pl = jnp.where(pick_spec_p[..., None], reflect_local(wif), wo_d)
        w_pl_spec = p.specular * (Fi_p / jnp.maximum(prob_spec_p,
                                                     1e-9))[..., None]
        ev_pl = _plastic_eval_diffuse(p, wif, wo_pl)
        w_pl_diff = ev_pl / jnp.maximum(
            ((1 - prob_spec_p) * pdf_d), 1e-12)[..., None]
        w_pl = jnp.where(pick_spec_p[..., None], w_pl_spec, w_pl_diff)
        pdf_pl = jnp.where(pick_spec_p, prob_spec_p,
                           (1 - prob_spec_p) * pdf_d)
        wo_sel.append((PLASTIC, wo_pl))
        w_sel.append((PLASTIC, w_pl))
        pdf_sel.append((PLASTIC, pdf_pl))
        valid_sel.append((PLASTIC, wif[..., 2] > 0))
        delta_mask = delta_mask | ((k == PLASTIC) & pick_spec_p)

    if _has(kinds, PHONG):
        pick_spec_ph = u_comp < sw
        n_ph = p.alpha
        cos_a = jnp.power(jnp.maximum(u2[..., 0], 1e-12),
                          1.0 / (n_ph + 1))
        sin_a = jnp.sqrt(jnp.maximum(1 - cos_a ** 2, 0.0))
        phi = 2 * jnp.pi * u2[..., 1]
        lobe = jnp.stack([sin_a * jnp.cos(phi), sin_a * jnp.sin(phi),
                          cos_a], -1)
        wr = reflect_local(wif)
        from ..core.math import build_frame, to_world
        s_ax, t_ax = build_frame(wr)
        wo_ph_spec = to_world(lobe, s_ax, t_ax, wr)
        wo_ph = jnp.where(pick_spec_ph[..., None], wo_ph_spec, wo_d)
        pdf_ph = _phong_pdf(p, wif, wo_ph)
        ev_ph = _phong_eval(p, wif, wo_ph)
        w_ph = ev_ph / jnp.maximum(pdf_ph, 1e-12)[..., None]
        wo_sel.append((PHONG, wo_ph))
        w_sel.append((PHONG, w_ph))
        pdf_sel.append((PHONG, pdf_ph))
        valid_sel.append((PHONG, (wo_ph[..., 2] > 0) & (wif[..., 2] > 0)
                          & (pdf_ph > 0)))

    if _has(kinds, WARD):
        pick_spec_w = u_comp < sw
        h_w = _ward_sample_h(p, u2)
        widh_w = jnp.sum(wif * h_w, axis=-1)
        wo_w_spec = 2.0 * widh_w[..., None] * h_w - wif
        wo_wd = jnp.where(pick_spec_w[..., None], wo_w_spec, wo_d)
        pdf_wd = _ward_pdf(p, wif, wo_wd)
        ev_wd = _ward_eval(p, wif, wo_wd)
        w_wd = ev_wd / jnp.maximum(pdf_wd, 1e-12)[..., None]
        wo_sel.append((WARD, wo_wd))
        w_sel.append((WARD, w_wd))
        pdf_sel.append((WARD, pdf_wd))
        valid_sel.append((WARD, (wo_wd[..., 2] > 0) & (wif[..., 2] > 0)
                          & (pdf_wd > 0)))

    if _has(kinds, ROUGH_DIELECTRIC):
        wo_rd, w_rd, pdf_rd, valid_rd, eta_rd = _roughdielectric_sample(
            p, wi, u2, u_comp)
        wo_sel.append((ROUGH_DIELECTRIC, wo_rd))
        w_sel.append((ROUGH_DIELECTRIC, w_rd))
        pdf_sel.append((ROUGH_DIELECTRIC, pdf_rd))
        eta_sel.append((ROUGH_DIELECTRIC, eta_rd))
        valid_sel.append((ROUGH_DIELECTRIC, valid_rd))

    if _has(kinds, DIFFTRANS):
        # cosine hemisphere on the side OPPOSITE wi (difftrans.cpp)
        flip_dt = jnp.where(wi[..., 2] > 0, -1.0, 1.0)
        wo_dt = wo_d * jnp.stack([jnp.ones_like(flip_dt)] * 2 +
                                 [flip_dt], -1)
        wo_sel.append((DIFFTRANS, wo_dt))
        w_sel.append((DIFFTRANS, p.reflectance))
        pdf_sel.append((DIFFTRANS, pdf_d))
        valid_sel.append((DIFFTRANS, jnp.abs(wi[..., 2]) > 1e-7))

    if _has(kinds, HK):
        # hk.cpp: choose delta (unscattered) transmission with the slab
        # transmittance's luminance, else sample the phase function
        # around the incident propagation -wi (full sphere — the lobe
        # covers reflection AND scattered transmission)
        from .medium import phase_sample
        from ..scene.media import PHASE_HG, PHASE_ISOTROPIC
        ps_hk = _hk_scatter_prob(p, wi)
        pick_delta_hk = u_comp >= ps_hk
        kind_ph = jnp.where(jnp.abs(p.alpha_v) < 1e-4,
                            PHASE_ISOTROPIC, PHASE_HG)
        wo_ph_hk, pdf_ph_hk = phase_sample(kind_ph, p.alpha_v, wi, u2)
        pdf_sc = ps_hk * jnp.maximum(pdf_ph_hk, 1e-12)
        w_sc = _hk_eval(p, wi, wo_ph_hk) / pdf_sc[..., None]
        t_hk = _hk_delta_t(p, wi)
        pd_hk = 1.0 - ps_hk
        wo_hk = jnp.where(pick_delta_hk[..., None], -wi, wo_ph_hk)
        w_hk = jnp.where(pick_delta_hk[..., None],
                         t_hk / jnp.maximum(pd_hk, 1e-9)[..., None], w_sc)
        pdf_hk = jnp.where(pick_delta_hk, pd_hk, pdf_sc)
        wo_sel.append((HK, wo_hk))
        w_sel.append((HK, w_hk))
        pdf_sel.append((HK, pdf_hk))
        valid_sel.append((HK, (jnp.abs(wi[..., 2]) > 1e-7) & (pdf_hk > 0)))
        delta_mask = delta_mask | ((k == HK) & pick_delta_hk)

    if _has(kinds, NULL_BSDF):
        wo_sel.append((NULL_BSDF, -wi))
        w_sel.append((NULL_BSDF, jnp.ones_like(p.reflectance)))
        pdf_sel.append((NULL_BSDF, one))
        valid_sel.append((NULL_BSDF, jnp.ones(N, bool)))
        delta_mask = delta_mask | (k == NULL_BSDF)

    def sel(vals, default):
        out = default
        for kk, v in vals:
            out = jnp.where((k == kk)[..., None] if out.ndim > k.ndim
                            else (k == kk), v, out)
        return out

    wo = sel(wo_sel, wo_d)
    weight = sel(w_sel, w_d_diffuse)
    pdf_out = sel(pdf_sel, pdf_d)
    eta_out = sel(eta_sel, jnp.ones_like(one))
    valid = sel(valid_sel, (wif[..., 2] > 0) & (wo_d[..., 2] > 0))
    is_delta = delta_mask

    # un-flip wo back to the true frame (dielectrics were never flipped)
    handles_sign = ((k == DIELECTRIC) | (k == THIN_DIELECTRIC) |
                    (k == NULL_BSDF) | (k == ROUGH_DIELECTRIC) |
                    (k == HK))
    unflip = jnp.where(handles_sign, 1.0, sign)
    wo = wo * jnp.stack([jnp.ones_like(unflip)] * 2 + [unflip], -1)

    if _has(kinds, OPACITY):
        wo = jnp.where(pass_m[..., None], -wi, wo)
        weight = jnp.where(pass_m[..., None], jnp.ones_like(weight),
                           weight)
        pdf_out = jnp.where(pass_m, 1.0 - op_m, pdf_out * op_m)
        eta_out = jnp.where(pass_m, jnp.ones_like(eta_out), eta_out)
        valid = jnp.where(pass_m, True, valid)
        is_delta = is_delta | pass_m

    weight = jnp.where(valid[..., None], weight, 0.0)
    return BSDFSample(wo=wo, weight=weight,
                      pdf=jnp.where(valid, pdf_out, 0.0),
                      is_delta=is_delta, eta=eta_out, valid=valid)


def any_specular(materials, shift_threshold):
    """Host-side (compile-time) check: does ANY material in the scene
    classify as specular/glossy for shifting (roughness <= threshold)?
    All-diffuse scenes statically skip the half-vector machinery."""
    import numpy as np
    kinds = np.asarray(materials.kind)
    alphas = np.asarray(materials.alpha)
    packed = np.asarray(materials.packed)
    # coating: a smooth layer carries a delta lobe (rough 0); a rough
    # layer (roughcoating) classifies by the row's stored
    # min(inner, layer) roughness
    coat_rough = np.where(packed[:, 21] > _ROUGH_LAYER_MIN, alphas, 0.0)
    rough = np.where(
        np.isin(kinds, (CONDUCTOR, DIELECTRIC, THIN_DIELECTRIC)), 0.0,
        np.where(kinds == COATING, coat_rough,
                 np.where(np.isin(kinds, (ROUGH_CONDUCTOR, ROUGH_PLASTIC,
                                          ROUGH_DIELECTRIC, WARD)), alphas,
                          np.inf)))
    has_mask = (packed[:, 22] < 1.0).any() or (packed[:, 23] >= 0).any()
    return bool((rough <= shift_threshold).any() or has_mask)


def roughness(materials, mid):
    """Scalar roughness used by G-PT vertex classification
    (gpt.cpp getVertexType): 0 for smooth-delta, alpha for microfacet,
    inf for pure diffuse.

    Evaluated per MATERIAL ROW first (the table is tiny), then gathered
    per lane."""
    return _roughness_table(materials)[mid]


def _roughness_table(materials):
    """Per-material classification roughness over the whole table.

    Diffuse rows use a large FINITE sentinel (not inf): the one-hot
    matmul gather sums 0*row terms, and 0*inf would poison every lane
    with NaN.  Callers only ever compare `rough > shiftThreshold`."""
    kind = materials.kind
    alpha = materials.alpha
    r = jnp.full(kind.shape, 1e9, jnp.float32)
    r = jnp.where((kind == CONDUCTOR) | (kind == DIELECTRIC) |
                  (kind == THIN_DIELECTRIC), 0.0, r)
    r = jnp.where((kind == ROUGH_CONDUCTOR) | (kind == ROUGH_DIELECTRIC) |
                  (kind == ROUGH_PLASTIC) | (kind == WARD) |
                  (kind == BLEND) | (kind == COATING), alpha, r)
    # BLEND/COATING rows store their children's classification roughness
    # at build time (MaterialBuilder) so wrappers classify like their
    # dominant lobes
    return r
