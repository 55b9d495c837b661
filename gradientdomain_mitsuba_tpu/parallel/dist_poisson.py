"""Distributed screened-Poisson reconstruction over a row-sharded mesh.

The cross-tile coupling of the reconstruction (each CG iteration's 5-point
stencil needs one neighbor row; the CG dot products are global) is the
context-parallel-shaped component of the design (SURVEY.md §6.7):
`ppermute` moves 1-row halos between devices, `psum` reduces the dot
products.
Semantically identical to models/poisson.solve_l2 — verified by the
single-vs-multi-chip equivalence test.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from .tiles import AXIS, padded_rows


def _send_up(x, axis=AXIS):
    """Return the next shard's FIRST row (zeros on the last shard)."""
    n = jax.lax.axis_size(axis)
    pairs = [(i, i - 1) for i in range(1, n)]
    return jax.lax.ppermute(x[:, :1], axis, pairs)


def _send_down(x, axis=AXIS):
    """Return the previous shard's LAST row (zeros on the first shard)."""
    n = jax.lax.axis_size(axis)
    pairs = [(i, i + 1) for i in range(n - 1)]
    return jax.lax.ppermute(x[:, -1:], axis, pairs)


def _dx(img):
    d = img[..., :, 1:] - img[..., :, :-1]
    return jnp.pad(d, [(0, 0)] * (img.ndim - 1) + [(0, 1)])


def _dxT(g):
    return (jnp.pad(g[..., :, :-1], [(0, 0)] * (g.ndim - 1) + [(1, 0)])
            - jnp.pad(g[..., :, :-1], [(0, 0)] * (g.ndim - 1) + [(0, 1)]))


def _dy_halo(x, below_first_row):
    """Forward y-difference where the row AFTER our last row comes from the
    next shard. x: [3, R, W]; below_first_row: [3, 1, W]."""
    nxt = jnp.concatenate([x[:, 1:], below_first_row], axis=1)
    return nxt - x


def _dyT_halo(g, above_last_row):
    """Adjoint: (DyT g)[k] = g[k-1] - g[k]; g[-1] comes from prev shard."""
    prev = jnp.concatenate([above_last_row, g[:, :-1]], axis=1)
    return prev - g


def solve_l2_sharded(mesh, primal, gx, gy, alpha=0.2, iters=100,
                     row_mask=None):
    """Distributed CG solve. primal/gx/gy: [H, W, 3] global (host) arrays;
    returns [H, W, 3].  Rows are padded to a multiple of the mesh size and
    masked so padding never couples into the solution."""
    H, W = primal.shape[:2]
    n_dev = mesh.devices.size
    Hp = padded_rows(H, n_dev)

    def pad(a):
        return np.pad(np.asarray(a, np.float32), ((0, Hp - H), (0, 0),
                                                  (0, 0)))

    Pm = pad(primal)
    GX = pad(gx)
    GY = pad(gy)
    GX[:, -1] = 0.0
    GY[H - 1:] = 0.0
    mask = np.zeros((Hp, 1, 1), np.float32)
    mask[:H] = 1.0
    a2 = alpha * alpha

    def shard_fn(Pl, GXl, GYl, Ml):
        # [R, W, 3] -> [3, R, W]
        Pl = jnp.moveaxis(Pl, -1, 0)
        GXl = jnp.moveaxis(GXl, -1, 0)
        GYl = jnp.moveaxis(GYl, -1, 0)
        Ml = jnp.moveaxis(Ml, -1, 0)  # [1, R, 1]
        Ml = Ml[0:1]

        # dy at row k is valid only when rows k AND k+1 are valid — this
        # reproduces the global operator's zero last-row Dy (Neumann)
        below_m = _send_up(Ml)
        dy_mask = jnp.concatenate([Ml[:, 1:], below_m], axis=1) * Ml

        def A(x):
            x = x * Ml
            below = _send_up(x)
            dyx = _dy_halo(x, below) * dy_mask
            above = _send_down(dyx)
            out = (_dxT(_dx(x)) + _dyT_halo(dyx, above) + a2 * x)
            return out * Ml

        def dot(u, v):
            s = jnp.sum(u * v, axis=(-2, -1), keepdims=True)
            return jax.lax.psum(s, AXIS)

        GYm = GYl * dy_mask
        b = (_dxT(GXl) + _dyT_halo(GYm, _send_down(GYm)) + a2 * Pl) * Ml

        x = Pl * Ml
        r = b - A(x)
        p = r
        rs = dot(r, r)

        def body(_, st):
            x, r, p, rs = st
            Ap = A(p)
            denom = dot(p, Ap)
            al = jnp.where(denom > 0, rs / jnp.maximum(denom, 1e-30), 0.0)
            x = x + al * p
            r = r - al * Ap
            rs_new = dot(r, r)
            be = jnp.where(rs > 0, rs_new / jnp.maximum(rs, 1e-30), 0.0)
            p = r + be * p
            return x, r, p, rs_new

        x, _, _, _ = jax.lax.fori_loop(0, iters, body, (x, r, p, rs))
        return jnp.moveaxis(x, 0, -1)

    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
                   out_specs=P(AXIS), check_vma=False)
    mask3 = np.broadcast_to(mask, (Hp, 1, 3)).copy()
    out = fn(Pm, GX, GY, mask3)
    return np.asarray(out)[:H]


def reconstruct_sharded(mesh, buffers, alpha=0.2, iters=100):
    """Distributed L2 reconstruction + very-direct re-add."""
    rec = solve_l2_sharded(mesh, buffers["primal"], buffers["dx"],
                           buffers["dy"], alpha=alpha, iters=iters)
    return rec + np.asarray(buffers["very_direct"])
