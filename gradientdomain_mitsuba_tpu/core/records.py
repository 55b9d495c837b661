"""Common sampling-record currency as NamedTuples of arrays (SoA pytrees).

Equivalent of Mitsuba's record structs (Intersection,
DirectSamplingRecord, BSDFSamplingRecord — include/mitsuba/render/records.inl
and shape.h).  Each field is a batched jnp array; the tuple as a whole is a
JAX pytree so it flows through jit/vmap/scan/shard_map.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp


class Ray(NamedTuple):
    o: jnp.ndarray      # [..., 3] origin
    d: jnp.ndarray      # [..., 3] unit direction
    maxt: jnp.ndarray   # [...]    far clip (inf for camera/bounce rays)


class Intersection(NamedTuple):
    """Result of scene intersection for a batch of rays."""
    valid: jnp.ndarray     # [...] bool — hit anything?
    t: jnp.ndarray         # [...] hit distance
    p: jnp.ndarray         # [..., 3] hit position
    ng: jnp.ndarray        # [..., 3] geometric normal (unit)
    ns: jnp.ndarray        # [..., 3] shading normal (unit)
    uv: jnp.ndarray        # [..., 2] texture coords
    prim_id: jnp.ndarray   # [...] int32 triangle index (global)
    shape_id: jnp.ndarray  # [...] int32 shape index
    bsdf_id: jnp.ndarray   # [...] int32 material index (-1 = none)
    emitter_id: jnp.ndarray  # [...] int32 area-emitter index (-1 = none)
    # [..., 4] barycentric-attribute payload for vertexcolors/wireframe
    # textures: interpolated vertex color (3) + world-space distance to
    # the nearest triangle edge (1).  None unless the scene binds such a
    # texture (tri_shade packs the extra columns only then).
    bary: Any = None


class PositionSample(NamedTuple):
    """A sampled position on an emitter/shape surface."""
    p: jnp.ndarray        # [..., 3]
    n: jnp.ndarray        # [..., 3]
    uv: jnp.ndarray       # [..., 2]
    pdf_area: jnp.ndarray  # [...] pdf w.r.t. surface area
    emitter_id: jnp.ndarray  # [...] int32


class DirectSample(NamedTuple):
    """NEE sample: a direction toward an emitter with solid-angle pdf.

    Mirrors DirectSamplingRecord semantics (Scene::sampleEmitterDirect).
    """
    d: jnp.ndarray        # [..., 3] unit direction from the reference point
    dist: jnp.ndarray     # [...] distance to the sampled point
    n: jnp.ndarray        # [..., 3] normal at the emitter point
    pdf: jnp.ndarray      # [...] solid-angle pdf (includes emitter pick prob)
    value: jnp.ndarray    # [..., 3] radiance / pdf  (Mitsuba convention)
    radiance: jnp.ndarray  # [..., 3] raw emitted radiance toward ref point
    emitter_id: jnp.ndarray  # [...] int32
    is_delta: jnp.ndarray    # [...] bool (point/directional lights)


def ray(o, d, maxt=None):
    if maxt is None:
        maxt = jnp.full(o.shape[:-1], jnp.inf, o.dtype)
    return Ray(o=o, d=d, maxt=maxt)
