"""Fused small-scene triangle sweep: a Pallas kernel on the Triton route.

Closest hit and any hit of a ray wavefront against the WHOLE triangle
soup of a small scene (the role TriAccel's leaf tests play in Mitsuba's
small-scene traversal, src/librender/skdtree.cpp, triaccel.h).

The plain forms write [N, T]-sized intermediates to device memory:
ops/intersect.intersect_matmul its [N, 4T] linear-MT term matrix,
intersect_brute its per-chunk Moeller-Trumbore terms.  This kernel keeps
every term in registers:

  - one program owns a block of BLOCK_R rays;
  - a loop walks the soup in chunks of CHUNK_T triangles, loading the 9
    per-triangle rows (v0, e1, e2) of each chunk; the whole table is at
    most 2048 x 9 f32, so it stays in L2;
  - the Moeller-Trumbore test is intersect_brute's arithmetic (ops/
    intersect._mt), as explicit f32 multiply-adds on a [BLOCK_R, CHUNK_T]
    tile: no matrix unit, so no TF32;
  - the running closest hit stays in registers, with intersect_brute's
    tie rule (the lowest triangle index among equal t wins);
  - the any-hit loop ends once every live ray of the block is occluded.

Device-memory traffic is the rays in and (t, u, v, prim) out: about 48 B
per ray.  `interpret=True` runs the same kernel on the CPU for tests.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .intersect import Hit, TriSoup

F32_MAX = np.float32(3.0e38)
BLOCK_R = 128      # rays per program
CHUNK_T = 16       # triangles per inner-loop step
NUM_WARPS = 4
NUM_STAGES = 1
N_COEF = 9         # per-triangle rows: v0, e1, e2
_BIG = 2 ** 30


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _tri_table(tris: TriSoup, n_tris: int, chunk: int):
    """Triangle soup -> (flat chunk-major [n_chunks, 9, chunk] rows,
    slot ids [Ts]).

    The sweep visits only the real triangles: the scene's padded layout
    scatters them over Tp >= n_tris slots, and padding slots carry
    orig_id = -1.  Empty table slots (-1) are all-zero triangles, whose
    det = 0 never hits."""
    Tp = tris.v0.shape[0]
    Ts = _round_up(max(min(n_tris, Tp), 1), chunk)
    (slot,) = jnp.nonzero(tris.orig_id >= 0, size=Ts, fill_value=-1)
    slot = slot.astype(jnp.int32)
    rows = jnp.concatenate([tris.v0, tris.e1, tris.e2], axis=1)  # [Tp, 9]
    tab = jnp.where(slot[:, None] >= 0, rows[jnp.maximum(slot, 0)], 0.0)
    tab = tab.T.reshape(N_COEF, Ts // chunk, chunk).transpose(1, 0, 2)
    return tab.reshape(-1).astype(jnp.float32), slot


def _chunk_mt(tab_ref, c, chunk, ray, mint, maxt):
    """intersect_brute's Moeller-Trumbore (ops/intersect._mt) for the
    ray block x triangle chunk c: [BLOCK_R, chunk] (t, u, v, hit)."""
    ox, oy, oz, dx, dy, dz = ray
    base = c * (N_COEF * chunk)

    def row(k):
        return tab_ref[pl.ds(base + k * chunk, chunk)][None, :]

    v0x, v0y, v0z = row(0), row(1), row(2)
    e1x, e1y, e1z = row(3), row(4), row(5)
    e2x, e2y, e2z = row(6), row(7), row(8)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok_det = jnp.abs(det) > 1e-12
    inv_det = jnp.where(ok_det, 1.0 / det, 0.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) &
           (t > mint[:, None]) & (t < maxt[:, None]))
    return t, u, v, hit


def _load_rays(ray_refs):
    vals = [r[...] for r in ray_refs]
    return tuple(a[:, None] for a in vals[:6]), vals[6], vals[7]


def _closest_kernel(n_chunks, chunk, *refs):
    ray_refs, tab_ref = refs[:8], refs[8]
    t_ref, u_ref, v_ref, j_ref = refs[9:]
    ray, mint, maxt = _load_rays(ray_refs)
    nr = mint.shape[0]

    def body(c, carry):
        best_t, best_u, best_v, best_j = carry
        t, u, v, ok = _chunk_mt(tab_ref, c, chunk, ray, mint, maxt)
        tt = jnp.where(ok, t, F32_MAX)
        tm = jnp.min(tt, axis=1)
        iota = jax.lax.broadcasted_iota(jnp.int32, (nr, chunk), 1) + \
            c * chunk
        j = jnp.min(jnp.where(ok & (tt == tm[:, None]), iota, _BIG), axis=1)
        first = iota == j[:, None]
        us = jnp.sum(jnp.where(first, u, 0.0), axis=1)
        vs = jnp.sum(jnp.where(first, v, 0.0), axis=1)
        better = tm < best_t
        return (jnp.where(better, tm, best_t), jnp.where(better, us, best_u),
                jnp.where(better, vs, best_v), jnp.where(better, j, best_j))

    zero = jnp.zeros_like(mint)
    init = (zero + F32_MAX, zero, zero, jnp.full(mint.shape, -1, jnp.int32))
    best_t, best_u, best_v, best_j = jax.lax.fori_loop(0, n_chunks, body,
                                                       init)
    t_ref[...] = best_t
    u_ref[...] = best_u
    v_ref[...] = best_v
    j_ref[...] = best_j


def _occluded_kernel(n_chunks, chunk, *refs):
    ray_refs, tab_ref, occ_ref = refs[:8], refs[8], refs[9]
    ray, mint, maxt = _load_rays(ray_refs)
    # dead lanes (maxt <= mint, e.g. the maxt = -1 of finished paths)
    # count as done, so they do not hold the block in the loop
    dead = (maxt <= mint).astype(jnp.int32)

    def cond(carry):
        c, occ = carry
        return (c < n_chunks) & (jnp.min(jnp.maximum(occ, dead)) == 0)

    def body(carry):
        c, occ = carry
        _, _, _, ok = _chunk_mt(tab_ref, c, chunk, ray, mint, maxt)
        hit = jnp.max(ok.astype(jnp.int32), axis=1)
        return c + 1, jnp.maximum(occ, hit)

    _, occ = jax.lax.while_loop(cond, body,
                                (jnp.int32(0), jnp.zeros_like(dead)))
    occ_ref[...] = occ


def _call(kernel, out_shape, n_chunks, tab, rays, Np, interpret, name):
    ray_spec = pl.BlockSpec((BLOCK_R,), lambda i: (i,))
    return pl.pallas_call(
        functools.partial(kernel, n_chunks, CHUNK_T),
        out_shape=out_shape,
        grid=(Np // BLOCK_R,),
        in_specs=[ray_spec] * 8 + [pl.no_block_spec],
        out_specs=[ray_spec] * len(out_shape),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=NUM_STAGES),
        interpret=interpret,
        name=name,
    )(*rays, tab)


def _pack_rays(o, d, mint, maxt, Np):
    """Eight [Np] rows; padding rays have maxt = -1 (never hit)."""
    pad = Np - o.shape[0]
    cols = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], mint, maxt]
    fills = [0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0, -1.0]
    return [jnp.pad(c.astype(jnp.float32), (0, pad), constant_values=f)
            for c, f in zip(cols, fills)]


def make_sweep_intersector(n_tris: int, interpret: bool = False):
    """Closest hit over the whole soup.  Signature matches
    intersect_brute: (o, d, mint, maxt, tris) -> Hit, prim in the soup's
    slot order."""

    def closest(o, d, mint, maxt, tris):
        tab, slot = _tri_table(tris, n_tris, CHUNK_T)
        N = o.shape[0]
        Np = _round_up(max(N, 1), BLOCK_R)
        rays = _pack_rays(o, d, mint, maxt, Np)
        f32 = jax.ShapeDtypeStruct((Np,), jnp.float32)
        t, u, v, j = _call(
            _closest_kernel,
            [f32, f32, f32, jax.ShapeDtypeStruct((Np,), jnp.int32)],
            slot.shape[0] // CHUNK_T, tab, rays, Np, interpret,
            "sweep_closest")
        t, u, v, j = t[:N], u[:N], v[:N], j[:N]
        valid = t < F32_MAX
        prim = slot[jnp.clip(j, 0, slot.shape[0] - 1)]
        return Hit(t=t, u=u, v=v, prim=jnp.where(valid, prim, -1),
                   valid=valid)

    return closest


def make_sweep_occluder(n_tris: int, interpret: bool = False):
    """Any hit over the whole soup: (o, d, mint, maxt, tris) -> bool [N]."""

    def occluded(o, d, mint, maxt, tris):
        tab, slot = _tri_table(tris, n_tris, CHUNK_T)
        N = o.shape[0]
        Np = _round_up(max(N, 1), BLOCK_R)
        rays = _pack_rays(o, d, mint, maxt, Np)
        (occ,) = _call(
            _occluded_kernel, [jax.ShapeDtypeStruct((Np,), jnp.int32)],
            slot.shape[0] // CHUNK_T, tab, rays, Np, interpret,
            "sweep_occluded")
        return occ[:N] > 0

    return occluded
