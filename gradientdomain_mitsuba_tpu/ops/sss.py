"""Classical dipole BSSRDF (Jensen et al. 2001) — device-side pieces.

Replacement for the reference's `dipole` subsurface plugin
(src/subsurface/dipole.cpp + the irradiance octree in
src/subsurface/irrtree.cpp).  The reference preprocesses blue-noise
irradiance samples into a hierarchical octree and answers each Lo query
with a data-dependent tree descent — hostile to XLA.  Here the cache is
a DENSE point set and the query is an all-pairs evaluation chunked
through a `lax.scan`:

  Mo(x) = sum_i Rd(|x - p_i|) * E_i * A_i          (same estimator,
                                                    no tree, no bias knob)
  Lo(x, w) = (1/pi) * Ft(eta, cos_o) * Mo(x)

The pairwise squared distances ride one [N,3]x[3,P] matmul per chunk,
at full f32 precision (q.q - 2 q.p + p.p cancels at scene
coordinates); Rd is a handful of transcendentals fused by XLA into the
reduction.  At the default 2048 cache points this is far below the cost
of one path-tracing bounce, and it is exact — the octree's `quality`
cutoff knob has no analog here because none is needed.

Coefficients (per row, per RGB channel), classical dipole:
  sigma_s' = sigma_s (1-g)      sigma_t' = sigma_s' + sigma_a
  alpha'   = sigma_s'/sigma_t'  sigma_tr = sqrt(3 sigma_a sigma_t')
  Fdr(eta) = -1.440/eta^2 + 0.710/eta + 0.668 + 0.0636 eta   (eta > 1)
  A = (1+Fdr)/(1-Fdr)   z_r = 1/sigma_t'   z_v = z_r (1 + 4A/3)
  Rd(r) = alpha'/(4pi) [ z_r (1+s d_r) e^{-s d_r}/d_r^3
                       + z_v (1+s d_v) e^{-s d_v}/d_v^3 ],  s = sigma_tr
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m

HIGHEST = jax.lax.Precision.HIGHEST


class DipoleCoeffs(NamedTuple):
    sigma_tr: jnp.ndarray   # [R, 3]
    zr: jnp.ndarray         # [R, 3]
    zv: jnp.ndarray         # [R, 3]
    alpha_p: jnp.ndarray    # [R, 3]
    eta: jnp.ndarray        # [R]


def fdr(eta):
    """Average diffuse Fresnel reflectance, Egan & Hilgeman / Groenhuis
    rational fit (the same fit fresnelDiffuseReflectance uses for its
    fast path)."""
    eta = np.asarray(eta, np.float64)
    return np.where(
        eta < 1.0,
        -0.4399 + 0.7099 / eta - 0.3319 / eta**2 + 0.0636 / eta**3,
        -1.4399 / eta**2 + 0.7099 / eta + 0.6681 + 0.0636 * eta)


def dipole_coeffs(table) -> DipoleCoeffs:
    """Host-side: SSSTable -> per-row dipole coefficients."""
    ss = np.asarray(table.sigma_s, np.float64)
    sa = np.asarray(table.sigma_a, np.float64)
    g = np.asarray(table.g, np.float64)[:, None]
    eta = np.asarray(table.eta, np.float64)

    ssp = ss * (1.0 - g)
    stp = np.maximum(ssp + sa, 1e-12)
    alpha_p = ssp / stp
    sigma_tr = np.sqrt(3.0 * sa * stp)
    A = (1.0 + fdr(eta)) / np.maximum(1.0 - fdr(eta), 1e-6)
    zr = 1.0 / stp
    zv = zr * (1.0 + 4.0 / 3.0 * A[:, None])
    return DipoleCoeffs(
        sigma_tr=jnp.asarray(sigma_tr, jnp.float32),
        zr=jnp.asarray(zr, jnp.float32),
        zv=jnp.asarray(zv, jnp.float32),
        alpha_p=jnp.asarray(alpha_p, jnp.float32),
        eta=jnp.asarray(eta, jnp.float32))


def rd(r2, sigma_tr, zr, zv, alpha_p):
    """Diffuse reflectance Rd(r) for squared distance r2.

    All args broadcast; channels ride the last axis.  r2 is clamped to
    the standard z_r^2 floor area-wise via the d_r = sqrt(r^2 + z^2)
    form (no singularity at r=0)."""
    dr = jnp.sqrt(r2 + zr * zr)
    dv = jnp.sqrt(r2 + zv * zv)
    c1 = zr * (sigma_tr * dr + 1.0) * jnp.exp(-sigma_tr * dr) / (dr * dr * dr)
    c2 = zv * (sigma_tr * dv + 1.0) * jnp.exp(-sigma_tr * dv) / (dv * dv * dv)
    return alpha_p / (4.0 * jnp.pi) * (c1 + c2)


def rd_total(table, row):
    """Closed-form total diffuse reflectance integral
    2 pi ∫ r Rd(r) dr = alpha'/2 (1 + e^{-4/3 A sqrt(3(1-alpha'))})
                        e^{-sqrt(3(1-alpha'))}   — test oracle."""
    ss = np.asarray(table.sigma_s, np.float64)[row]
    sa = np.asarray(table.sigma_a, np.float64)[row]
    g = float(np.asarray(table.g)[row])
    eta = float(np.asarray(table.eta)[row])
    ssp = ss * (1.0 - g)
    stp = ssp + sa
    ap = ssp / stp
    A = (1.0 + fdr(eta)) / (1.0 - fdr(eta))
    s3 = np.sqrt(3.0 * (1.0 - ap))
    return ap / 2.0 * (1.0 + np.exp(-4.0 / 3.0 * A * s3)) * np.exp(-s3)


def sample_surface_points(scene, n_points: int, seed):
    """[P] uniform-area sample points over each SSS row's surface.

    Points are split round-robin over rows (i % R); the per-point area
    weight A_i = total_area[row]/count[row] makes the Mo sum an unbiased
    area integral regardless of the split.  Returns a cache dict with
    positions, outward geometric normals, row ids and area weights
    (E is filled in by the tracer's irradiance pass)."""
    from ..core.rng import uniform_2d
    from .emitter import _searchsorted_segment

    table = scene.sss
    R = int(table.shape.shape[0])   # row-count is a static array dim
    ids = jnp.arange(n_points, dtype=jnp.uint32)
    row = (ids % R).astype(jnp.int32)
    # counts of the round-robin split (static)
    counts = np.full(R, n_points // R, np.float32)
    counts[: n_points % R] += 1
    aw = (jnp.asarray(table.total_area) /
          jnp.asarray(np.maximum(counts, 1)))[row]

    u_tri = uniform_2d(seed ^ 0x55b, ids, 0, 7001)
    lo = jnp.asarray(table.tri_offset)[row]
    hi = lo + jnp.asarray(table.tri_count)[row]
    k = _searchsorted_segment(jnp.asarray(table.tri_cdf), lo, hi,
                              u_tri[:, 0])
    k = jnp.clip(k, lo, hi - 1)
    tri = jnp.asarray(table.tri_index)[k]

    idx = jnp.asarray(scene.geom.indices)[tri]            # [P, 3]
    pos = jnp.asarray(scene.geom.positions)
    v0 = pos[idx[:, 0]]
    v1 = pos[idx[:, 1]]
    v2 = pos[idx[:, 2]]
    su = jnp.sqrt(jnp.maximum(u_tri[:, 1:2], 1e-12))
    u_b = uniform_2d(seed ^ 0x9d1, ids, 0, 7003)[:, 0:1]
    b0 = 1.0 - su
    b1 = u_b * su
    p = v0 * b0 + v1 * b1 + v2 * (1.0 - b0 - b1)
    n = m.normalize(jnp.cross(v1 - v0, v2 - v0))
    return dict(p=p, n=n, row=row, aw=aw)


def eval_mo(cache, coeffs: DipoleCoeffs, q_p, q_row, chunk: int = 256):
    """Mo at query points: [N,3] = sum over cache points of
    Rd(|q-p|; coeffs[q_row]) * E * A, restricted to the query's own row.

    Chunked over the P cache points with a lax.scan; each chunk's
    pairwise q.p dot products are one [N,3]x[3,chunk] matmul."""
    P = cache["p"].shape[0]
    pad = (-P) % chunk
    pp = jnp.pad(cache["p"], ((0, pad), (0, 0)))
    pe = jnp.pad(cache["E"] * cache["aw"][:, None], ((0, pad), (0, 0)))
    # pad sentinel -2: must match neither real rows nor masked queries (-1)
    prow = jnp.pad(cache["row"], (0, pad), constant_values=-2)

    qr = jnp.maximum(q_row, 0)
    s_tr = coeffs.sigma_tr[qr]      # [N, 3]
    zr = coeffs.zr[qr]
    zv = coeffs.zv[qr]
    ap = coeffs.alpha_p[qr]
    q2 = jnp.sum(q_p * q_p, -1)     # [N]

    n_chunks = (P + pad) // chunk
    pp_c = pp.reshape(n_chunks, chunk, 3)
    pe_c = pe.reshape(n_chunks, chunk, 3)
    prow_c = prow.reshape(n_chunks, chunk)

    def body(acc, args):
        cp, ce, crow = args
        dot = jnp.matmul(q_p, cp.T, precision=HIGHEST)  # [N, chunk]
        r2 = jnp.maximum(q2[:, None] - 2.0 * dot +
                         jnp.sum(cp * cp, -1)[None, :], 0.0)
        same = (crow[None, :] == q_row[:, None])
        r2 = r2[..., None]                             # [N, chunk, 1]
        val = rd(r2, s_tr[:, None, :], zr[:, None, :], zv[:, None, :],
                 ap[:, None, :])
        val = jnp.where(same[..., None], val, 0.0)
        acc = acc + jnp.einsum("nck,ck->nk", val, ce, precision=HIGHEST)
        return acc, None

    mo0 = jnp.zeros((q_p.shape[0], 3))
    mo, _ = jax.lax.scan(body, mo0, (pp_c, pe_c, prow_c))
    return mo
