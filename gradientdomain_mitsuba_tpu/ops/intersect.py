"""Ray-scene intersection kernels.

Replacement for Mitsuba's kd-tree traversal + Wald TriAccel hot
path (src/librender/skdtree.cpp, include/mitsuba/render/triaccel.h).  Plain
jnp/lax paths, one contract (ops/common.choose_intersector picks one per
platform and scene size; ops/pallas_sweep.py holds the GPU's small-scene
kernel):

  - intersect_brute / occluded_brute: every ray against every triangle,
    scanned over triangle chunks (the exact reference for tests; the
    CPU's small-scene path).
  - make_bvh_intersector_soa / make_bvh_occluder_soa: per-lane
    short-stack BVH traversal of the whole wavefront in lockstep (the
    GPU's large-scene path).
  - make_bvh_intersector / make_bvh_occluder: the same walk per ray
    under vmap + lax.while_loop.
  - intersect_matmul / occluded_matmul: linear Moeller-Trumbore as one
    matrix product.
  - make_cluster_intersector / make_cluster_occluder: two-level
    cluster traversal (the CPU's large-scene path).

Triangles are stored REORDERED by BVH leaf ranges (SoA v0/e1/e2), so leaf
prims are contiguous in device memory.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.bvh import LEAF_BITS, MAX_LEAF

F32_MAX = jnp.float32(3.0e38)


class TriSoup(NamedTuple):
    """Triangle geometry in BVH leaf order."""
    v0: jnp.ndarray       # [T, 3]
    e1: jnp.ndarray       # [T, 3]  (v1 - v0)
    e2: jnp.ndarray       # [T, 3]  (v2 - v0)
    orig_id: jnp.ndarray  # [T] i32 — original (scene) triangle index


class ClusterArrays(NamedTuple):
    """Two-level clustered acceleration (see scene/bvh.py
    extract_clusters): cluster AABBs + offsets into the BVH-ordered,
    window-padded triangle soup."""
    bmin: jnp.ndarray    # [K, 3]
    bmax: jnp.ndarray    # [K, 3]
    offset: jnp.ndarray  # [K] i32 window start (window size static)


class BVHArrays(NamedTuple):
    child0_min: jnp.ndarray  # [N, 3]
    child0_max: jnp.ndarray
    child1_min: jnp.ndarray
    child1_max: jnp.ndarray
    child0: jnp.ndarray      # [N] i32 code (>=0 internal, <0 leaf)
    child1: jnp.ndarray      # [N] i32


class Hit(NamedTuple):
    t: jnp.ndarray        # [R] distance (F32_MAX if miss)
    u: jnp.ndarray        # [R] barycentric
    v: jnp.ndarray        # [R]
    prim: jnp.ndarray     # [R] i32 BVH-ORDER triangle index (-1 if miss);
    #                       shading data is gathered from the packed
    #                       tri_shade rows stored in the same order
    valid: jnp.ndarray    # [R] bool


def _mt(o, d, v0, e1, e2, mint, maxt):
    """Moeller-Trumbore; o,d [..., 3] broadcast against v0/e1/e2 [..., 3]."""
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = ((jnp.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) &
           (u + v <= 1.0) & (t > mint) & (t < maxt))
    return t, u, v, hit


def intersect_brute(o, d, mint, maxt, tris: TriSoup, chunk: int = 2048) -> Hit:
    """Closest hit, all rays x all tris, scanned over tri chunks."""
    T = tris.v0.shape[0]
    pad = (-T) % chunk
    v0 = jnp.pad(tris.v0, ((0, pad), (0, 0)))
    e1 = jnp.pad(tris.e1, ((0, pad), (0, 0)), constant_values=0)
    e2 = jnp.pad(tris.e2, ((0, pad), (0, 0)), constant_values=0)
    oid = jnp.where(jnp.arange(T + pad) < T,
                    jnp.arange(T + pad, dtype=jnp.int32), -1)
    n_chunks = (T + pad) // chunk

    R = o.shape[0]
    # derive the carry from the inputs so its sharding/varying axes match
    # the body outputs under shard_map (and plain vmap/jit alike)
    zf = o[..., 0] * 0.0
    init = (zf + F32_MAX, zf, zf, zf.astype(jnp.int32) - 1)

    def body(carry, ck):
        bt, bu, bv, bp = carry
        cv0, ce1, ce2, cid = ck
        t, u, v, h = _mt(o[:, None, :], d[:, None, :],
                         cv0[None], ce1[None], ce2[None],
                         mint[:, None], jnp.minimum(maxt, bt)[:, None])
        h = h & (cid[None, :] >= 0)
        t = jnp.where(h, t, F32_MAX)
        j = jnp.argmin(t, axis=1)
        tj = jnp.take_along_axis(t, j[:, None], 1)[:, 0]
        better = tj < bt
        ar = jnp.arange(R)
        bu = jnp.where(better, u[ar, j], bu)
        bv = jnp.where(better, v[ar, j], bv)
        bp = jnp.where(better, cid[j], bp)
        bt = jnp.where(better, tj, bt)
        return (bt, bu, bv, bp), None

    chunks = (v0.reshape(n_chunks, chunk, 3), e1.reshape(n_chunks, chunk, 3),
              e2.reshape(n_chunks, chunk, 3), oid.reshape(n_chunks, chunk))
    (bt, bu, bv, bp), _ = jax.lax.scan(body, init, chunks)
    return Hit(t=bt, u=bu, v=bv, prim=bp, valid=bp >= 0)


def occluded_brute(o, d, mint, maxt, tris: TriSoup, chunk: int = 2048):
    hit = intersect_brute(o, d, mint, maxt, tris, chunk)
    return hit.valid


def _decode_leaf(code):
    raw = -code - 1
    return raw >> LEAF_BITS, raw & ((1 << LEAF_BITS) - 1)


def _slab(o, inv_d, mint, maxt, bmin, bmax):
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = jnp.max(jnp.minimum(t0, t1))
    tf = jnp.min(jnp.maximum(t0, t1))
    return (tn <= tf) & (tf >= mint) & (tn <= maxt), tn


def make_bvh_intersector_soa(stack_depth: int):
    """Batched SoA closest-hit traversal: the whole wavefront advances one
    stack-pop per while iteration, all lanes in lockstep with masks.

    Written WITHOUT vmap: per-lane stacks live in a [N, depth] array and
    node fetches are plain [N]-index gathers.  Lanes that finish idle
    until the last lane empties its stack; rays in a wavefront are
    image-coherent so divergence stays low.
    """

    def intersect(o, d, mint, maxt, tris: TriSoup, bvh: BVHArrays):
        N = o.shape[0]
        lanes = jnp.arange(N)
        inv_d = jnp.where(jnp.abs(d) > 1e-12, 1.0 / d, 1e30)

        stack = jnp.zeros((N, stack_depth), jnp.int32)
        sp = jnp.ones(N, jnp.int32)          # root pushed
        t_b = maxt
        u_b = jnp.zeros(N)
        v_b = jnp.zeros(N)
        p_b = jnp.full(N, -1, jnp.int32)

        def slab(bmin, bmax, tmax):
            t0 = (bmin - o) * inv_d
            t1 = (bmax - o) * inv_d
            tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
            tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
            return (tn <= tf) & (tf >= mint) & (tn <= tmax), tn

        def body(state):
            sp, stack, t_b, u_b, v_b, p_b = state
            active = sp > 0
            spm = jnp.maximum(sp - 1, 0)
            code = stack[lanes, spm]
            sp = jnp.where(active, sp - 1, sp)

            is_int = active & (code >= 0)
            node = jnp.maximum(code, 0)
            h0, tn0 = slab(bvh.child0_min[node], bvh.child0_max[node], t_b)
            h1, tn1 = slab(bvh.child1_min[node], bvh.child1_max[node], t_b)
            c0 = bvh.child0[node]
            c1 = bvh.child1[node]
            near_first = tn0 <= tn1
            first = jnp.where(near_first, c0, c1)
            second = jnp.where(near_first, c1, c0)
            hf = is_int & jnp.where(near_first, h0, h1)
            hs = is_int & jnp.where(near_first, h1, h0)
            # push far then near (near pops first)
            stack = stack.at[lanes, sp].set(
                jnp.where(hs, second, stack[lanes, sp]))
            sp = sp + hs.astype(jnp.int32)
            stack = stack.at[lanes, sp].set(
                jnp.where(hf, first, stack[lanes, sp]))
            sp = sp + hf.astype(jnp.int32)

            # leaf: test up to MAX_LEAF prims
            is_leaf = active & (code < 0)
            raw = jnp.maximum(-code - 1, 0)
            offset = raw >> LEAF_BITS
            count = raw & ((1 << LEAF_BITS) - 1)
            for j in range(MAX_LEAF):
                idx = offset + j
                t, u, v, h = _mt(o, d, tris.v0[idx], tris.e1[idx],
                                 tris.e2[idx], mint, t_b)
                h = h & is_leaf & (j < count)
                t_b = jnp.where(h, t, t_b)
                u_b = jnp.where(h, u, u_b)
                v_b = jnp.where(h, v, v_b)
                p_b = jnp.where(h, idx, p_b)
            return sp, stack, t_b, u_b, v_b, p_b

        def cond(state):
            return jnp.any(state[0] > 0)

        sp, stack, t_b, u_b, v_b, p_b = jax.lax.while_loop(
            cond, body, (sp, stack, t_b, u_b, v_b, p_b))
        return Hit(t=jnp.where(p_b >= 0, t_b, F32_MAX), u=u_b, v=v_b,
                   prim=p_b, valid=p_b >= 0)

    return intersect


def make_bvh_occluder_soa(stack_depth: int):
    """Batched SoA any-hit traversal (shadow rays); lanes stop pushing as
    soon as they find any hit."""

    def occluded(o, d, mint, maxt, tris: TriSoup, bvh: BVHArrays):
        N = o.shape[0]
        lanes = jnp.arange(N)
        inv_d = jnp.where(jnp.abs(d) > 1e-12, 1.0 / d, 1e30)
        stack = jnp.zeros((N, stack_depth), jnp.int32)
        sp = jnp.ones(N, jnp.int32)
        occ = jnp.zeros(N, bool)

        def slab(bmin, bmax):
            t0 = (bmin - o) * inv_d
            t1 = (bmax - o) * inv_d
            tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
            tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
            return (tn <= tf) & (tf >= mint) & (tn <= maxt)

        def body(state):
            sp, stack, occ = state
            active = (sp > 0) & ~occ
            spm = jnp.maximum(sp - 1, 0)
            code = stack[lanes, spm]
            sp = jnp.where(active, sp - 1, sp)

            is_int = active & (code >= 0)
            node = jnp.maximum(code, 0)
            h0 = is_int & slab(bvh.child0_min[node], bvh.child0_max[node])
            h1 = is_int & slab(bvh.child1_min[node], bvh.child1_max[node])
            stack = stack.at[lanes, sp].set(
                jnp.where(h1, bvh.child1[node], stack[lanes, sp]))
            sp = sp + h1.astype(jnp.int32)
            stack = stack.at[lanes, sp].set(
                jnp.where(h0, bvh.child0[node], stack[lanes, sp]))
            sp = sp + h0.astype(jnp.int32)

            is_leaf = active & (code < 0)
            raw = jnp.maximum(-code - 1, 0)
            offset = raw >> LEAF_BITS
            count = raw & ((1 << LEAF_BITS) - 1)
            for j in range(MAX_LEAF):
                idx = offset + j
                _, _, _, h = _mt(o, d, tris.v0[idx], tris.e1[idx],
                                 tris.e2[idx], mint, maxt)
                occ = occ | (h & is_leaf & (j < count))
            return sp, stack, occ

        def cond(state):
            return jnp.any((state[0] > 0) & ~state[2])

        _, _, occ = jax.lax.while_loop(cond, body, (sp, stack, occ))
        return occ

    return occluded


def make_bvh_intersector(stack_depth: int):
    """Returns jittable (o, d, mint, maxt, tris, bvh) -> Hit closest-hit fn.

    stack_depth must be >= 2 * bvh.depth + 2 (static per scene).
    """

    def one_ray(o, d, mint, maxt, tris: TriSoup, bvh: BVHArrays):
        inv_d = jnp.where(jnp.abs(d) > 1e-12, 1.0 / d, 1e30)
        zf = o[0] * 0.0
        zi = zf.astype(jnp.int32)
        stack = jnp.zeros(stack_depth, jnp.int32) + zi
        # state: (sp, stack, t, u, v, prim)
        state = (zi + 1, stack, maxt, zf, zf, zi - 1)

        def leaf_prims(code, st):
            t_best, u_best, v_best, p_best = st
            offset, count = _decode_leaf(code)

            def pbody(j, s):
                tb, ub, vb, pb = s
                idx = offset + j
                t, u, v, h = _mt(o, d, tris.v0[idx], tris.e1[idx],
                                 tris.e2[idx], mint, tb)
                h = h & (j < count)
                return (jnp.where(h, t, tb), jnp.where(h, u, ub),
                        jnp.where(h, v, vb), jnp.where(h, idx, pb))

            return jax.lax.fori_loop(0, MAX_LEAF, pbody,
                                     (t_best, u_best, v_best, p_best))

        def body(s):
            sp, stk, t_best, u_b, v_b, p_b = s
            sp = sp - 1
            code = stk[sp]

            def internal(args):
                sp, stk, tb, ub, vb, pb = args
                node = code
                h0, tn0 = _slab(o, inv_d, mint, tb,
                                bvh.child0_min[node], bvh.child0_max[node])
                h1, tn1 = _slab(o, inv_d, mint, tb,
                                bvh.child1_min[node], bvh.child1_max[node])
                c0 = bvh.child0[node]
                c1 = bvh.child1[node]
                # push far child first so near child pops first
                near_first = tn0 <= tn1
                first = jnp.where(near_first, c0, c1)
                second = jnp.where(near_first, c1, c0)
                hf = jnp.where(near_first, h0, h1)
                hs = jnp.where(near_first, h1, h0)
                stk = stk.at[sp].set(second)
                sp = sp + hs.astype(jnp.int32)
                stk = stk.at[sp].set(first)
                sp = sp + hf.astype(jnp.int32)
                return sp, stk, tb, ub, vb, pb

            def leaf(args):
                sp, stk, tb, ub, vb, pb = args
                tb, ub, vb, pb = leaf_prims(code, (tb, ub, vb, pb))
                return sp, stk, tb, ub, vb, pb

            return jax.lax.cond(code >= 0, internal, leaf,
                                (sp, stk, t_best, u_b, v_b, p_b))

        def cond(s):
            return s[0] > 0

        sp, stk, t, u, v, p = jax.lax.while_loop(cond, body, state)
        return Hit(t=jnp.where(p >= 0, t, F32_MAX), u=u, v=v, prim=p,
                   valid=p >= 0)

    def intersect(o, d, mint, maxt, tris, bvh):
        return jax.vmap(one_ray, in_axes=(0, 0, 0, 0, None, None))(
            o, d, mint, maxt, tris, bvh)

    return intersect


def make_bvh_occluder(stack_depth: int):
    """Any-hit variant with early exit (shadow rays)."""

    def one_ray(o, d, mint, maxt, tris: TriSoup, bvh: BVHArrays):
        inv_d = jnp.where(jnp.abs(d) > 1e-12, 1.0 / d, 1e30)
        zf = o[0] * 0.0
        zi = zf.astype(jnp.int32)
        stack = jnp.zeros(stack_depth, jnp.int32) + zi
        state = (zi + 1, stack, zi > 0)

        def body(s):
            sp, stk, _ = s
            sp = sp - 1
            code = stk[sp]

            def internal(args):
                sp, stk, occ = args
                node = code
                h0, _ = _slab(o, inv_d, mint, maxt,
                              bvh.child0_min[node], bvh.child0_max[node])
                h1, _ = _slab(o, inv_d, mint, maxt,
                              bvh.child1_min[node], bvh.child1_max[node])
                stk = stk.at[sp].set(bvh.child1[node])
                sp = sp + h1.astype(jnp.int32)
                stk = stk.at[sp].set(bvh.child0[node])
                sp = sp + h0.astype(jnp.int32)
                return sp, stk, occ

            def leaf(args):
                sp, stk, occ = args
                offset, count = _decode_leaf(code)

                def pbody(j, acc):
                    idx = offset + j
                    _, _, _, h = _mt(o, d, tris.v0[idx], tris.e1[idx],
                                     tris.e2[idx], mint, maxt)
                    return acc | (h & (j < count))

                occ = jax.lax.fori_loop(0, MAX_LEAF, pbody, occ)
                return sp, stk, occ

            return jax.lax.cond(code >= 0, internal, leaf, (sp, stk, s[2]))

        def cond(s):
            return (s[0] > 0) & jnp.logical_not(s[2])

        _, _, occ = jax.lax.while_loop(cond, body, state)
        return occ

    def occluded(o, d, mint, maxt, tris, bvh):
        return jax.vmap(one_ray, in_axes=(0, 0, 0, 0, None, None))(
            o, d, mint, maxt, tris, bvh)

    return occluded


# ---------------------------------------------------------------------------
# Linear-MT ("matmul traversal"): Moeller-Trumbore as ONE matrix product
# ---------------------------------------------------------------------------
#
# The four MT determinants are LINEAR in the 10 ray features
# r = [o x d, d, o, 1]:
#
#   det   = e1.(d x e2)        = -d.n                      n = e1 x e2
#   u_num = (o-v0).(d x e2)    = (o x d).e2 + d.(v0 x e2)
#   v_num = d.((o-v0) x e1)    = -(o x d).e1 - d.(v0 x e1)
#   t_num = e2.((o-v0) x e1)   = (o-v0).n = o.n - v0.n
#
# so intersecting R rays against ALL T triangles is one [R,10] @ [10,4T]
# f32 matmul at HIGHEST precision plus a short epilogue of comparisons.
# Like the reference's Wald projection test (include/mitsuba/render/
# triaccel.h) it trades per-ray-per-triangle arithmetic for a
# per-triangle precomputation.  The differences o.n - v0.n cancel for
# rays near a triangle's plane, so t is less exact than the brute form's.
# It writes the whole [R, 4T] term matrix to device memory; it is kept as
# a plain form to measure the sweep kernel against.


def build_linear_mt(v0, e1, e2) -> np.ndarray:
    """[10, 4T] per-triangle coefficient matrix for the linear-MT matmul
    (built in f64 on host, stored f32).  Column blocks: det | u_num |
    v_num | t_num.  Degenerate (padding) triangles get all-zero columns,
    hence det = 0, hence never hit."""
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    T = v0.shape[0]
    n = np.cross(e1, e2)
    C = np.zeros((10, 4 * T), np.float64)
    C[3:6, 0:T] = -n.T
    C[0:3, T:2 * T] = e2.T
    C[3:6, T:2 * T] = np.cross(v0, e2).T
    C[0:3, 2 * T:3 * T] = -e1.T
    C[3:6, 2 * T:3 * T] = -np.cross(v0, e1).T
    C[6:9, 3 * T:4 * T] = n.T
    C[9, 3 * T:4 * T] = -np.einsum('ti,ti->t', v0, n)
    return C.astype(np.float32)


def _linear_mt_terms(o, d, mint, maxt, linC):
    """Shared matmul + sign-fixed hit test.  Returns (su, sv, st, ad, ok)
    with everything multiplied through by sign(det) so the tests read
    su >= 0 etc. without a per-pair division."""
    T = linC.shape[1] // 4
    feats = jnp.concatenate(
        [jnp.cross(o, d), d, o, jnp.ones_like(o[:, :1])], axis=1)
    F = jax.lax.dot(feats, linC, precision=jax.lax.Precision.HIGHEST)
    det = F[:, :T]
    s = jnp.sign(det)
    ad = det * s
    su = F[:, T:2 * T] * s
    sv = F[:, 2 * T:3 * T] * s
    st = F[:, 3 * T:] * s
    ok = ((su >= 0.0) & (sv >= 0.0) & (su + sv <= ad) & (ad > 0.0) &
          (st > mint[:, None] * ad) & (st < maxt[:, None] * ad))
    return su, sv, st, ad, ok


def intersect_matmul(o, d, mint, maxt, linC) -> Hit:
    """Closest hit against every triangle via the linear-MT matmul.

    The epilogue divides by det FIRST (u = u_num/det etc.) so the hit
    test needs no sign-fixing passes, and selects the winner by exact
    t-equality against the row min instead of argmin + one-hot (the
    iota_reduce argmin fusion was 260 us/call on [65k,128]).  det == 0
    (parallel or degenerate padding) yields inf/nan coordinates whose
    comparisons are all false — the lane drops out like in the brute
    Moeller-Trumbore."""
    T = linC.shape[1] // 4
    feats = jnp.concatenate(
        [jnp.cross(o, d), d, o, jnp.ones_like(o[:, :1])], axis=1)
    F = jax.lax.dot(feats, linC, precision=jax.lax.Precision.HIGHEST)
    d_inv = 1.0 / F[:, :T]
    u = F[:, T:2 * T] * d_inv
    v = F[:, 2 * T:3 * T] * d_inv
    t = F[:, 3 * T:] * d_inv
    ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) &
          (t > mint[:, None]) & (t < maxt[:, None]))
    tt = jnp.where(ok, t, F32_MAX)
    tm = jnp.min(tt, axis=1)
    valid = tm < F32_MAX
    sel = ok & (tt == tm[:, None])
    iota = jax.lax.broadcasted_iota(jnp.int32, tt.shape, 1)
    j = jnp.min(jnp.where(sel, iota, jnp.int32(2 ** 30)), axis=1)
    first = sel & (iota == j[:, None])
    us = jnp.sum(jnp.where(first, u, 0.0), axis=1)
    vs = jnp.sum(jnp.where(first, v, 0.0), axis=1)
    return Hit(t=jnp.where(valid, tm, F32_MAX), u=us, v=vs,
               prim=jnp.where(valid, j, -1).astype(jnp.int32),
               valid=valid)


def occluded_matmul(o, d, mint, maxt, linC):
    """Any-hit variant: no division at all, just the masked reduce."""
    _, _, _, _, ok = _linear_mt_terms(o, d, mint, maxt, linC)
    return jnp.any(ok, axis=1)


def make_cluster_intersector(window: int):
    """Two-level clustered closest-hit: dense [N, K] ray-vs-cluster-AABB
    tests, per-ray nearest-first cluster ordering, then a
    while-loop where every lane fetches its own cluster's CONTIGUOUS
    triangle window (one blocked gather) and tests it densely.  Windows
    may overlap neighboring clusters' prims — testing extra real
    triangles is harmless for correctness and keeps the gather shape
    static.  Its [N, K] slab tests and argsort grow with the cluster
    count, so it suits the CPU's modest wavefronts, not 1M-lane ones.
    """

    def intersect(o, d, mint, maxt, tris: TriSoup, clusters: ClusterArrays):
        N = o.shape[0]
        K = clusters.offset.shape[0]
        lanes = jnp.arange(N)
        inv_d = jnp.where(jnp.abs(d) > 1e-12, 1.0 / d, 1e30)

        t0 = (clusters.bmin[None] - o[:, None]) * inv_d[:, None]
        t1 = (clusters.bmax[None] - o[:, None]) * inv_d[:, None]
        tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
        hit_c = (tn <= tf) & (tf >= mint[:, None]) & (tn <= maxt[:, None])
        tnear = jnp.where(hit_c, jnp.maximum(tn, mint[:, None]), F32_MAX)
        order = jnp.argsort(tnear, axis=1)
        sortd = jnp.take_along_axis(tnear, order, axis=1)

        w_ar = jnp.arange(window)

        def body(state):
            r, t_b, u_b, v_b, p_b = state
            cnear = sortd[lanes, r]
            c = order[lanes, r]
            pending = cnear < t_b
            off = clusters.offset[c]
            idx = off[:, None] + w_ar[None, :]
            tv0 = tris.v0[idx]
            te1 = tris.e1[idx]
            te2 = tris.e2[idx]
            t, u, v, h = _mt(o[:, None], d[:, None], tv0, te1, te2,
                             mint[:, None], t_b[:, None])
            h = h & pending[:, None]
            t = jnp.where(h, t, F32_MAX)
            j = jnp.argmin(t, axis=1)
            tj = t[lanes, j]
            better = tj < t_b
            u_b = jnp.where(better, u[lanes, j], u_b)
            v_b = jnp.where(better, v[lanes, j], v_b)
            p_b = jnp.where(better, idx[lanes, j], p_b)
            t_b = jnp.where(better, tj, t_b)
            return r + 1, t_b, u_b, v_b, p_b

        def cond(state):
            r, t_b = state[0], state[1]
            return (r < K) & jnp.any(sortd[lanes, jnp.minimum(r, K - 1)]
                                     < t_b)

        state = (jnp.int32(0), maxt, jnp.zeros(N), jnp.zeros(N),
                 jnp.full(N, -1, jnp.int32))
        _, t_b, u_b, v_b, p_b = jax.lax.while_loop(cond, body, state)
        return Hit(t=jnp.where(p_b >= 0, t_b, F32_MAX), u=u_b, v=v_b,
                   prim=p_b, valid=p_b >= 0)

    return intersect


def make_cluster_occluder(window: int):
    """Any-hit variant: same nearest-first loop, stops lanes on first hit."""

    def occluded(o, d, mint, maxt, tris: TriSoup, clusters: ClusterArrays):
        N = o.shape[0]
        K = clusters.offset.shape[0]
        lanes = jnp.arange(N)
        inv_d = jnp.where(jnp.abs(d) > 1e-12, 1.0 / d, 1e30)
        t0 = (clusters.bmin[None] - o[:, None]) * inv_d[:, None]
        t1 = (clusters.bmax[None] - o[:, None]) * inv_d[:, None]
        tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
        hit_c = (tn <= tf) & (tf >= mint[:, None]) & (tn <= maxt[:, None])
        tnear = jnp.where(hit_c, jnp.maximum(tn, mint[:, None]), F32_MAX)
        order = jnp.argsort(tnear, axis=1)
        sortd = jnp.take_along_axis(tnear, order, axis=1)
        w_ar = jnp.arange(window)

        def body(state):
            r, occ = state
            cnear = sortd[lanes, r]
            c = order[lanes, r]
            pending = (cnear < F32_MAX) & ~occ
            off = clusters.offset[c]
            idx = off[:, None] + w_ar[None, :]
            _, _, _, h = _mt(o[:, None], d[:, None], tris.v0[idx],
                             tris.e1[idx], tris.e2[idx],
                             mint[:, None], maxt[:, None])
            occ = occ | (h & pending[:, None]).any(axis=1)
            return r + 1, occ

        def cond(state):
            r, occ = state
            return (r < K) & jnp.any(
                (sortd[lanes, jnp.minimum(r, K - 1)] < F32_MAX) & ~occ)

        _, occ = jax.lax.while_loop(cond, body,
                                    (jnp.int32(0), jnp.zeros(N, bool)))
        return occ

    return occluded


# ---------------------------------------------------------------------------
# Analytic spheres (src/shapes/sphere.cpp): second primitive type, tested
# densely beside the triangle traversal and merged by closest-t
# (ops/common.add_sphere_intersections).  Scene sphere counts are tiny, so
# the [N, S] quadric solve is negligible work with exact normals —
# round-2 item: caustic/dielectric validation on true quadrics instead of
# tessellations.
# ---------------------------------------------------------------------------

def intersect_spheres(o, d, mint, maxt, centers, radii):
    """Closest sphere hit per ray: (t [N], sid [N], -1 on miss).
    Directions must be unit length (every caller's convention)."""
    F32M = jnp.float32(3.0e38)
    oc = o[:, None, :] - centers[None]               # [N, S, 3]
    b = jnp.sum(oc * d[:, None, :], -1)              # [N, S]
    c = jnp.sum(oc * oc, -1) - radii[None] ** 2
    disc = b * b - c
    ok = disc >= 0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    in0 = (t0 > mint[:, None]) & (t0 < maxt[:, None])
    in1 = (t1 > mint[:, None]) & (t1 < maxt[:, None])
    t = jnp.where(ok & in0, t0, jnp.where(ok & in1, t1, F32M))
    tmin = jnp.min(t, axis=1)
    sid = jnp.argmin(t, axis=1).astype(jnp.int32)
    hit = tmin < 0.5 * F32M
    return jnp.where(hit, tmin, F32M), jnp.where(hit, sid, -1)


def occluded_spheres(o, d, mint, maxt, centers, radii):
    t, sid = intersect_spheres(o, d, mint, maxt, centers, radii)
    return sid >= 0
