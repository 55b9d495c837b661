"""Woven-cloth BSDF (reference: src/bsdfs/irawan.{h,cpp} — the
Irawan-Marschner woven-cloth model, "Specular Reflection from Woven
Cloth", TOG 2012).

A re-design, NOT an equation-level port:

- weave structure is faithful: a tiled pattern grid assigns each uv
  cell to a warp or weft yarn SEGMENT; highlights follow the yarn
  curvature and the weave's float structure (denim twill diagonal,
  charmeuse satin sheen, ...).
- the per-segment specular is re-derived: the reference numerically
  integrates a fiber-scattering integrand over the visible yarn arc
  (a data-dependent loop); here the segment is a bent cylinder whose
  surface normal at the hit's own arc point feeds a normalized
  von Mises lobe in microfacet form, so every lane is one branch-free
  closed-form expression.  Twisted (staple) yarns tilt the lobe center
  across the yarn by the twist angle psi; filament yarns (psi = 0)
  keep it in the bending plane.  Parameter roles (umax, psi, kappa)
  match the reference; numeric values are NOT equation-identical to
  irawan.cpp (documented deviation — see PARITY.md).
- per-segment intensity variation ("fineness" noise) is a counter
  hash of the absolute pattern cell, deterministic and replayable.
- sampling is cosine-weighted with eval/pdf weights, exactly the
  reference's sampling strategy for this plugin.

The pattern tables are tiny module-level constants baked into the
compiled program; the material row stores only (preset id, repeatU/V,
kd, ks, eta).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

INV_PI = 1.0 / np.pi

# ---------------------------------------------------------------------------
# Weave presets.  grid[y][x]: 0 = warp segment (yarn runs along v),
# 1 = weft segment (yarn runs along u).  Weave structures are standard
# textile constructions; yarn parameters are chosen per fiber class
# (staple cotton/wool: twisted, broad lobe; filament silk/polyester:
# untwisted, sharp lobe).
# ---------------------------------------------------------------------------


def _twill(h, w, shift, floats):
    """Warp-faced twill: weft shows where (x - shift*y) mod w < floats."""
    g = np.zeros((h, w), np.int32)
    for y in range(h):
        for x in range(w):
            g[y, x] = 1 if (x - shift * y) % w < floats else 0
    return g


def _satin(n, counter):
    """n-harness satin: isolated weft interlacings at x = counter*y mod n."""
    g = np.zeros((n, n), np.int32)
    for y in range(n):
        g[y, (counter * y) % n] = 1
    return g


_PLAIN = np.array([[0, 1], [1, 0]], np.int32)

# name -> (grid, (umax_w, psi_w, kappa_w), (umax_f, psi_f, kappa_f),
#          kd, ks)  — _w = warp yarn, _f = weft yarn; angles in degrees
_PRESET_LIST = [
    ("plain", _PLAIN,
     (40.0, 35.0, 30.0), (40.0, 35.0, 30.0),
     (0.45, 0.43, 0.40), (0.25, 0.25, 0.25)),
    ("denim", _twill(4, 4, 1, 1),
     (38.0, 30.0, 35.0), (38.0, 30.0, 35.0),
     (0.07, 0.10, 0.25), (0.20, 0.20, 0.22)),
    ("gabardine", _twill(4, 4, 1, 2),
     (32.0, 30.0, 40.0), (32.0, 30.0, 40.0),
     (0.18, 0.16, 0.14), (0.30, 0.30, 0.30)),
    ("charmeuse", _satin(5, 2),
     (25.0, 0.0, 80.0), (30.0, 0.0, 60.0),
     (0.22, 0.20, 0.18), (0.50, 0.48, 0.45)),
    ("silk", _satin(5, 2),          # alias class for silk satins
     (25.0, 0.0, 80.0), (30.0, 0.0, 60.0),
     (0.22, 0.20, 0.18), (0.50, 0.48, 0.45)),
    ("polyester", _PLAIN,
     (35.0, 0.0, 60.0), (35.0, 0.0, 60.0),
     (0.30, 0.30, 0.32), (0.40, 0.40, 0.42)),
]

PRESET_IDS = {name: i for i, (name, *_) in enumerate(_PRESET_LIST)}

_P = len(_PRESET_LIST)
_GMAX = max(g.shape[0] for _, g, *_ in _PRESET_LIST)
GRID = np.zeros((_P, _GMAX, _GMAX), np.int32)
GRID_H = np.zeros(_P, np.int32)
GRID_W = np.zeros(_P, np.int32)
# per preset x {warp, weft}: [umax, psi, kappa] (radians)
YARN = np.zeros((_P, 2, 3), np.float32)
PRESET_KD = np.zeros((_P, 3), np.float32)
PRESET_KS = np.zeros((_P, 3), np.float32)
for _i, (_n, _g, _wy, _fy, _kd, _ks) in enumerate(_PRESET_LIST):
    GRID[_i, :_g.shape[0], :_g.shape[1]] = _g
    GRID_H[_i], GRID_W[_i] = _g.shape
    YARN[_i, 0] = np.deg2rad([_wy[0], _wy[1], 0.0])
    YARN[_i, 0, 2] = _wy[2]
    YARN[_i, 1] = np.deg2rad([_fy[0], _fy[1], 0.0])
    YARN[_i, 1, 2] = _fy[2]
    PRESET_KD[_i] = _kd
    PRESET_KS[_i] = _ks


def preset_from_name(name: str) -> int:
    """Match a pattern filename/name to a preset by substring (the
    reference loads .wif-derived pattern files; we ship the classes the
    plugin documentation lists as built-in tables)."""
    low = name.lower()
    for key, pid in PRESET_IDS.items():
        if key in low:
            return pid
    return PRESET_IDS["plain"]


# per-segment intensity jitter amplitude (the reference's per-pattern
# "fineness" noise; fixed amplitude here — documented deviation)
DELTA_X = 0.3


def _hash_cell(cx, cy, pid):
    """lowbias32-style integer mix -> uniform in [0, 1)."""
    h = (cx.astype(jnp.uint32) * jnp.uint32(0x9E3779B1) ^
         cy.astype(jnp.uint32) * jnp.uint32(0x85EBCA77) ^
         pid.astype(jnp.uint32) * jnp.uint32(0xC2B2AE3D))
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x7FEB352D)
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x846CA68B)
    h = h ^ (h >> 16)
    return h.astype(jnp.float32) * (1.0 / 4294967296.0)


def resolve_features(scene, mid, uv, bary):
    """uv-stage yarn-segment resolution -> MatParams.cloth [N, 6]:
    [u_arc, v_twist, axis_cos, axis_sin, kappa, intensity].

    bary carries the shading-frame azimuth of dp/du in cols 4:6
    (ops/common.fill_intersection).  Bidirectional subpath re-evals
    synthesize this payload from the per-vertex yarn-azimuth aux stored
    on SubPath (models/bdpt.py), so the specular lobe survives there
    too; only a caller that passes cloth=None falls back to the diffuse
    term."""
    row = scene.materials.packed[mid]
    pid = row[..., 18].astype(jnp.int32)          # dist column
    rep_u = jnp.maximum(row[..., 11], 1e-6)       # alpha column
    rep_v = jnp.maximum(row[..., 21], 1e-6)       # alpha_v column

    gw = jnp.asarray(GRID_W)[pid].astype(jnp.float32)
    gh = jnp.asarray(GRID_H)[pid].astype(jnp.float32)
    x = uv[..., 0] * rep_u * gw
    y = uv[..., 1] * rep_v * gh
    cxa = jnp.floor(x)
    cya = jnp.floor(y)
    fx = x - cxa
    fy = y - cya
    cx = jnp.mod(cxa, gw).astype(jnp.int32)
    cy = jnp.mod(cya, gh).astype(jnp.int32)

    yarn = jnp.asarray(GRID)[pid, cy, cx]         # 0 = warp, 1 = weft
    prm = jnp.asarray(YARN)[pid, yarn]            # [N, 3]
    umax = prm[..., 0]
    psi = prm[..., 1]
    kappa = prm[..., 2]

    warp = yarn == 0
    along = jnp.where(warp, fy, fx)
    across = jnp.where(warp, fx, fy)
    u_arc = (2.0 * along - 1.0) * umax
    v_tw = (2.0 * across - 1.0) * psi

    # yarn axis in the shading frame: (c, s) = azimuth of dp/du;
    # warp yarns run along v (rotate +90 deg)
    if bary is not None and bary.shape[-1] >= 6:
        c = bary[..., 4]
        s = bary[..., 5]
    else:
        c = jnp.ones(uv.shape[:-1], jnp.float32)
        s = jnp.zeros(uv.shape[:-1], jnp.float32)
    axis_c = jnp.where(warp, -s, c)
    axis_s = jnp.where(warp, c, s)

    inten = 1.0 + DELTA_X * (
        2.0 * _hash_cell(cxa.astype(jnp.int32), cya.astype(jnp.int32),
                         pid) - 1.0)
    return jnp.stack([u_arc, v_tw, axis_c, axis_s, kappa, inten], -1)


def eval_cloth(p, wi, wo):
    """f(wi, wo) * |cos_o| for IRAWAN lanes (local shading frame).

    Bent-cylinder segment normal:
      n(u, v) = normalize(cos u cos v * z + sin u * t - sin v cos u * b)
    with t the yarn axis, b the width axis, u the arc (bend) angle and
    v the twist angle; the specular lobe is a sphere-normalized
    von Mises NDF at n in microfacet form (no masking term — the
    reference's arc-visibility integral is not carried over)."""
    from .bsdf import fresnel_dielectric
    kd = p.reflectance
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    diff = kd * INV_PI * jnp.maximum(wo[..., 2], 0.0)[..., None]
    if p.cloth is None:
        return jnp.where(valid[..., None], diff, 0.0)

    F = p.cloth
    cu = jnp.cos(F[..., 0])
    su = jnp.sin(F[..., 0])
    cv = jnp.cos(F[..., 1])
    sv = jnp.sin(F[..., 1])
    ac = F[..., 2]
    as_ = F[..., 3]
    kap = jnp.maximum(F[..., 4], 1e-3)
    inten = F[..., 5]
    # n = cu*cv*z + su*t - sv*cu*b, t=(ac,as,0), b=(-as,ac,0)
    nx = su * ac + sv * cu * as_
    ny = su * as_ - sv * cu * ac
    nz = cu * cv
    nlen = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    h = wi + wo
    hlen = jnp.sqrt(jnp.sum(h * h, -1))
    hdn = (h[..., 0] * nx + h[..., 1] * ny + h[..., 2] * nz) / \
        jnp.maximum(hlen * nlen, 1e-12)
    hdwi = jnp.sum(h * wi, -1) / jnp.maximum(hlen, 1e-12)
    # sphere-normalized von Mises NDF at the segment normal
    D = kap * jnp.exp(kap * (jnp.clip(hdn, -1.0, 1.0) - 1.0)) / \
        (2.0 * jnp.pi * (1.0 - jnp.exp(-2.0 * kap)))
    Fr, _ = fresnel_dielectric(jnp.clip(jnp.abs(hdwi), 0.0, 1.0),
                               p.eta[..., 0])
    spec = p.specular * (inten * Fr * D /
                         (4.0 * jnp.maximum(wi[..., 2], 1e-4)))[..., None]
    return jnp.where(valid[..., None], diff + spec, 0.0)
