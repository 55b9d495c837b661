"""Sampling warps: [0,1)^2 -> distributions on spheres/disks/cones.

Equivalent of Mitsuba's warp namespace
(include/mitsuba/core/warp.h, src/libcore/warp.cpp).  These must match the
reference's mappings for statistical identity of the estimators; Mitsuba 0.5
uses the Shirley-Chiu concentric disk mapping for cosine-hemisphere.
All functions are batched over leading axes and jit/vmap-safe.
"""
from __future__ import annotations

import jax.numpy as jnp

from . import math as m

PI = jnp.pi
INV_PI = 1.0 / jnp.pi
INV_TWOPI = 1.0 / (2.0 * jnp.pi)
INV_FOURPI = 1.0 / (4.0 * jnp.pi)


def square_to_uniform_disk_concentric(u):
    """Shirley-Chiu concentric mapping (matches warp::squareToUniformDiskConcentric)."""
    r1 = 2.0 * u[..., 0] - 1.0
    r2 = 2.0 * u[..., 1] - 1.0
    use_r1 = jnp.abs(r1) > jnp.abs(r2)
    r = jnp.where(use_r1, r1, r2)
    phi = jnp.where(
        use_r1,
        (PI / 4.0) * (r2 / jnp.where(r1 == 0.0, 1.0, r1)),
        (PI / 2.0) - (PI / 4.0) * (r1 / jnp.where(r2 == 0.0, 1.0, r2)),
    )
    phi = jnp.where((r1 == 0.0) & (r2 == 0.0), 0.0, phi)
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def square_to_cosine_hemisphere(u):
    """Cosine-weighted hemisphere about +z via concentric disk lift."""
    p = square_to_uniform_disk_concentric(u)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - p[..., 0] ** 2 - p[..., 1] ** 2))
    return jnp.stack([p[..., 0], p[..., 1], z], axis=-1)


def square_to_cosine_hemisphere_pdf(d):
    return jnp.maximum(d[..., 2], 0.0) * INV_PI


def square_to_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def square_to_uniform_sphere_pdf():
    return INV_FOURPI


def square_to_uniform_hemisphere(u):
    z = u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def square_to_uniform_hemisphere_pdf():
    return INV_TWOPI


def square_to_uniform_cone(u, cos_cutoff):
    """Uniform direction in a cone of angle acos(cos_cutoff) about +z."""
    z = 1.0 - u[..., 0] * (1.0 - cos_cutoff)
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def square_to_uniform_cone_pdf(cos_cutoff):
    return INV_TWOPI / (1.0 - cos_cutoff)


def square_to_uniform_triangle(u):
    """Barycentric coords uniform on the unit triangle (matches
    warp::squareToUniformTriangle: a = sqrt(1-u1))."""
    a = jnp.sqrt(jnp.maximum(0.0, 1.0 - u[..., 0]))
    return jnp.stack([1.0 - a, a * u[..., 1]], axis=-1)


def square_to_beckmann(u, alpha):
    """Beckmann NDF-sampled half vector about +z (full-NDF sampling as in
    Mitsuba 0.5's microfacet.h; it predates VNDF sampling)."""
    phi = 2.0 * PI * u[..., 1]
    log_term = jnp.log(jnp.maximum(1.0 - u[..., 0], 1e-38))
    tan2theta = -(alpha ** 2) * log_term
    cos_theta = 1.0 / jnp.sqrt(1.0 + tan2theta)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta ** 2))
    return jnp.stack(
        [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta], axis=-1)


def square_to_beckmann_pdf(d, alpha):
    ct = d[..., 2]
    ct2 = ct * ct
    tan2 = (1.0 - ct2) / jnp.maximum(ct2, 1e-12)
    p = jnp.exp(-tan2 / (alpha ** 2)) / (PI * alpha ** 2 * jnp.maximum(ct2 * ct, 1e-12))
    return jnp.where(ct > 1e-6, p, 0.0)


def square_to_ggx(u, alpha):
    """GGX (Trowbridge-Reitz) NDF-sampled half vector about +z (full NDF)."""
    phi = 2.0 * PI * u[..., 1]
    tan2theta = (alpha ** 2) * u[..., 0] / jnp.maximum(1.0 - u[..., 0], 1e-12)
    cos_theta = 1.0 / jnp.sqrt(1.0 + tan2theta)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta ** 2))
    return jnp.stack(
        [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta], axis=-1)


def square_to_ggx_pdf(d, alpha):
    ct = jnp.maximum(d[..., 2], 0.0)
    a2 = alpha ** 2
    denom = ct * ct * (a2 - 1.0) + 1.0
    D = a2 / (PI * jnp.maximum(denom * denom, 1e-20))
    return D * ct


def interval_to_tent(u):
    """[0,1) -> [-1,1] tent-distributed (for tent reconstruction filter)."""
    sign = jnp.where(u < 0.5, 1.0, -1.0)
    u2 = jnp.where(u < 0.5, 2.0 * u, 2.0 * (1.0 - u))
    return sign * (1.0 - jnp.sqrt(jnp.maximum(u2, 0.0)))
