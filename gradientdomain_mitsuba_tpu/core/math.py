"""Vector math on [..., 3] jnp arrays (SoA-friendly foundation types).

Replacement for Mitsuba's Point/Vector/Normal/Frame/Transform
headers (reference: include/mitsuba/core/{vector,normal,frame,transform}.h).
Everything is batched: a "vector" is any array whose last axis is 3, so all
functions vmap/jit transparently.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

EPS = 1e-6
INF = jnp.inf


def dot(a, b, keepdims: bool = False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a, b):
    return jnp.cross(a, b)


def length(v, keepdims: bool = False):
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims=keepdims), 0.0))


def squared_length(v, keepdims: bool = False):
    return dot(v, v, keepdims=keepdims)


def normalize(v):
    return v / jnp.maximum(length(v, keepdims=True), 1e-20)


def lerp(a, b, t):
    return a + (b - a) * t


def reflect(wi, n):
    """Reflect direction `wi` (pointing away from surface) about normal n."""
    return 2.0 * dot(wi, n, keepdims=True) * n - wi


def reflect_local(wi):
    """Reflect about +z in a local shading frame."""
    return jnp.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], axis=-1)


def refract_local(wi, cos_theta_t, eta_ti):
    """Refract in the local frame given precomputed cos_theta_t (signed) and
    relative IOR eta_ti = eta_i/eta_t for the transmitted side."""
    return jnp.stack(
        [-wi[..., 0] * eta_ti, -wi[..., 1] * eta_ti,
         cos_theta_t], axis=-1)


def build_frame(n):
    """Branchless orthonormal basis from unit normal n (Duff et al. 2017).

    Returns (s, t) so that (s, t, n) is right-handed orthonormal.
    Reference semantics: mitsuba Frame(n) (include/mitsuba/core/frame.h).
    """
    z = n[..., 2]
    sign = jnp.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    s = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        axis=-1)
    t = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return s, t


def to_local(v, s, t, n):
    """World direction -> local shading frame coordinates."""
    return jnp.stack([dot(v, s), dot(v, t), dot(v, n)], axis=-1)


def to_world(v, s, t, n):
    """Local shading frame coordinates -> world direction."""
    return (v[..., 0:1] * s + v[..., 1:2] * t + v[..., 2:3] * n)


def spherical_direction(theta, phi):
    st, ct = jnp.sin(theta), jnp.cos(theta)
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    return jnp.stack([st * cp, st * sp, ct], axis=-1)


def spherical_coordinates(d):
    """Unit vector -> (theta, phi), phi in [0, 2pi)."""
    theta = jnp.arccos(jnp.clip(d[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(d[..., 1], d[..., 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi)
    return theta, phi


# ---------------------------------------------------------------------------
# 4x4 transforms (host-side / scene-build use mostly; also jit-safe)
# ---------------------------------------------------------------------------

def _mat3_apply(a, v):
    """a [3, 3] applied to row vectors v [..., 3], as explicit f32
    multiply-adds: no matrix unit, so no reduced-precision (TF32) path."""
    return (v[..., 0:1] * a[:, 0] + v[..., 1:2] * a[:, 1] +
            v[..., 2:3] * a[:, 2])


def transform_point(m, p):
    """Apply 4x4 matrix m to points p [..., 3]."""
    r = _mat3_apply(m[:3, :3], p) + m[:3, 3]
    w = _mat3_apply(m[3:4, :3], p)[..., 0] + m[3, 3]
    return r / w[..., None]


def transform_vector(m, v):
    return _mat3_apply(m[:3, :3], v)


def transform_normal(m_inv, n):
    """Normals transform by the inverse-transpose."""
    return _mat3_apply(m_inv[:3, :3].T, n)


def np_look_at(origin, target, up):
    """Mitsuba <lookat> semantics: camera-to-world with +z toward target,
    +x right, +y up (reference: Transform::lookAt, src/libcore/transform.cpp)."""
    origin = np.asarray(origin, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    d = target - origin
    d = d / np.linalg.norm(d)
    left = np.cross(up / np.linalg.norm(up), d)
    left = left / np.linalg.norm(left)
    new_up = np.cross(d, left)
    m = np.eye(4)
    # Mitsuba: x axis = "left" column so that the frame is right-handed with
    # +z forward; matches Transform::lookAt which uses (left, up, dir).
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = origin
    return m


def np_translate(v):
    m = np.eye(4)
    m[:3, 3] = v
    return m


def np_scale(v):
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = v[0], v[1], v[2]
    return m


def np_rotate(axis, angle_deg):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    x, y, z = axis
    r = np.array([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
    ])
    m = np.eye(4)
    m[:3, :3] = r
    return m


def np_perspective(fov_deg, near, far):
    """Mitsuba perspective projection (x fov by default)."""
    recip = 1.0 / (far - near)
    cot = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    m = np.array([
        [cot, 0, 0, 0],
        [0, cot, 0, 0],
        [0, 0, far * recip, -near * far * recip],
        [0, 0, 1, 0],
    ])
    return m
