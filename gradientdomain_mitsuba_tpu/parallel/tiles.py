"""Multi-chip tile-parallel rendering: shard_map over a device mesh.

Replacement for Mitsuba's scheduler + cluster rendering
(src/libcore/sched.cpp, sched_remote.cpp, mtssrv): instead of streaming
32x32 work units over TCP to worker nodes, the film is row-block sharded
over a 1-D `jax.sharding.Mesh`; the scene pytree is replicated; every chip
renders its own rows.  The gradient-domain coupling at tile boundaries
(G-PT's dy pairs straddle the row split, and wide reconstruction filters
splat across it) is handled with a B-row halo per shard that is exchanged
between devices with `ppermute` and accumulated — the renderer's analog of
context-parallel halo exchange (SURVEY.md §6.7).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import film as film_ops

AXIS = "tiles"


def make_mesh(n_devices=None):
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def padded_rows(H, n_dev):
    return -(-H // n_dev) * n_dev


def _gather_host(v, H):
    """Materialize a (possibly multi-process) row-sharded film buffer on
    the host and crop the padding rows.  With a single-process mesh this
    is a plain device->host copy; with a multi-host mesh (multihost.py)
    the remote shards are fetched with process_allgather over DCN — the
    film gather that ends Mitsuba's cluster render (Film::put of
    deserialized remote blocks, sched_remote.cpp)."""
    import jax
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        v = multihost_utils.process_allgather(v, tiled=True)
    return np.asarray(v)[:H]


def _halo_exchange_add(fb, B, axis=AXIS):
    """fb: [rows_local + 2B, W, ...] accumulated with halo borders.
    Sends the top halo to the previous shard and the bottom halo to the
    next shard (additive), returning the interior [rows_local, W, ...]."""
    n = jax.lax.axis_size(axis)
    if B == 0 or n == 1:
        return fb[B:fb.shape[0] - B] if B else fb
    top = fb[:B]
    bot = fb[fb.shape[0] - B:]
    # my top rows belong to neighbor idx-1's bottom interior;
    # ppermute: send to idx-1 / idx+1 (no wraparound: edges drop)
    up = [(i, i - 1) for i in range(1, n)]
    down = [(i, i + 1) for i in range(n - 1)]
    from_next = jax.lax.ppermute(top, axis, up)      # received bottom add
    from_prev = jax.lax.ppermute(bot, axis, down)    # received top add
    inner = fb[B:fb.shape[0] - B]
    inner = inner.at[:B].add(from_prev)
    inner = inner.at[inner.shape[0] - B:].add(from_next)
    return inner


def render_tiles_gpt(tracer, scene, mesh, seed, n_samples: int):
    """Row-sharded G-PT render over the mesh.

    Returns the GLOBAL (gathered) buffers dict, sample-normalized like
    GPTracer.render.  The per-shard work is identical to the single-chip
    path — tiles are pure functions of (scene, seed, pixel block), which is
    what makes re-dispatch/elastic recovery trivial (SURVEY.md §6.3).
    """
    st = tracer.settings
    H, W = st.height, st.width
    n_dev = mesh.devices.size
    Hp = padded_rows(H, n_dev)
    rows = Hp // n_dev
    B = max(int(np.ceil(2 * film_ops.RADII[tracer.filter_kind])), 1)

    def shard_fn(scene_rep):
        idx = jax.lax.axis_index(AXIS)
        row0 = idx * rows
        local_ids = (row0 * W +
                     jnp.arange(rows * W, dtype=jnp.uint32))
        Hl = rows + 2 * B
        pv = lambda a: jax.lax.pcast(a, (AXIS,), to='varying')
        zero3 = pv(jnp.zeros((Hl, W, 3)))
        bufs = dict(primal=zero3, dx=zero3, dy=zero3, very_direct=zero3,
                    wsum=pv(jnp.zeros((Hl, W))))

        def body(i, bufs):
            pos, primal, very, grad = tracer.trace_pass(
                scene_rep, seed, i, pixel_id=local_ids)
            # mask rows beyond the true film height (padding shard)
            valid = (local_ids // W) < H
            primal = jnp.where(valid[:, None], primal, 0.0)
            very = jnp.where(valid[:, None], very, 0.0)
            grad = jnp.where(valid[None, :, None], grad, 0.0)
            # grid-aligned: dense adds at local row offset B (no scatter)
            jit = (pos % 1.0)[None]
            fb, wb = film_ops.splat_grid(bufs["primal"], bufs["wsum"],
                                         jit, primal[None],
                                         tracer.filter_kind, row0=B)
            vd, _ = film_ops.splat_grid(bufs["very_direct"],
                                        jnp.zeros_like(wb), jit,
                                        very[None], tracer.filter_kind,
                                        row0=B)
            dx = film_ops.add_grid_shifted(bufs["dx"], grad[0][None],
                                           0, 0, row0=B)
            dx = film_ops.add_grid_shifted(dx, -grad[1][None], -1, 0,
                                           row0=B)
            dy = film_ops.add_grid_shifted(bufs["dy"], grad[2][None],
                                           0, 0, row0=B)
            dy = film_ops.add_grid_shifted(dy, -grad[3][None], 0, -1,
                                           row0=B)
            return dict(primal=fb, dx=dx, dy=dy, very_direct=vd, wsum=wb)

        bufs = jax.lax.fori_loop(0, n_samples, body, bufs)
        # halo exchange: border splats belong to neighboring shards
        return {k: _halo_exchange_add(v, B) for k, v in bufs.items()}

    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=(P(),),      # scene replicated
                   out_specs=P(AXIS),    # row-sharded buffers
                   check_vma=False)
    out = fn(scene)
    out = {k: _gather_host(v, H) for k, v in out.items()}
    w = np.maximum(out.pop("wsum"), 1e-12)[..., None]
    return {
        "primal": out["primal"] / w,
        "very_direct": out["very_direct"] / w,
        "dx": out["dx"] / n_samples,
        "dy": out["dy"] / n_samples,
    }


def render_tiles_gbdpt(tracer, scene, mesh, seed, n_samples: int):
    """Row-sharded G-BDPT render over the mesh.

    Camera-path buffers (primal/very-direct + the camera-pixel gradient
    splats) work like render_tiles_gpt: each shard owns a row block plus
    a filter-radius halo, exchanged with its neighbours.  The BDPT-specific
    part is
    the LIGHT IMAGE: t=1 (light-tracing) strategies splat at ARBITRARY
    film positions — the reference ships these blocks back to the master
    film over TCP (gbdpt_wr.cpp light-image blocks [G]); here every
    shard accumulates its own full-film light/t1-gradient buffers and a
    single `psum` over the mesh merges them (the splats are additive), after
    which each shard keeps its own row slice.  At 3x[H,W,3] f32 the
    all-reduce is a few MB — noise next to the render itself."""
    from ..models.gpt import OFFSETS

    st = tracer.settings
    H, W = st.height, st.width
    n_dev = mesh.devices.size
    Hp = padded_rows(H, n_dev)
    rows = Hp // n_dev
    B = max(int(np.ceil(2 * film_ops.RADII[tracer.filter_kind])), 1)
    fk = tracer.filter_kind
    off1 = jnp.asarray(OFFSETS[1])
    off3 = jnp.asarray(OFFSETS[3])

    def shard_fn(scene_rep):
        idx = jax.lax.axis_index(AXIS)
        row0 = idx * rows
        local_ids = (row0 * W + jnp.arange(rows * W, dtype=jnp.uint32))
        Hl = rows + 2 * B
        pv = lambda a: jax.lax.pcast(a, (AXIS,), to='varying')
        zero3 = pv(jnp.zeros((Hl, W, 3)))
        full3 = pv(jnp.zeros((H, W, 3)))
        bufs = dict(primal=zero3, dx=zero3, dy=zero3, very_direct=zero3,
                    wsum=pv(jnp.zeros((Hl, W))),
                    light=full3, dxt1=full3, dyt1=full3)
        # local splat coordinates: film y row0-B maps to local row 0
        loff = jnp.stack([jnp.float32(0.0),
                          (row0 - B).astype(jnp.float32)])

        def body(i, bufs):
            (pos, primal, very, grad, spos, sval, t1p, t1g) = \
                tracer.trace_pass(scene_rep, seed, i, pixel_id=local_ids)
            # mask rows beyond the true film height (padding shard):
            # their camera AND light subpaths don't exist single-chip
            valid = (local_ids // W) < H
            primal = jnp.where(valid[:, None], primal, 0.0)
            very = jnp.where(valid[:, None], very, 0.0)
            grad = jnp.where(valid[None, :, None], grad, 0.0)
            nrep = spos.shape[0] // valid.shape[0]
            v_s = jnp.tile(valid, nrep)
            sval = jnp.where(v_s[:, None], sval, 0.0)
            nrep = t1p.shape[0] // valid.shape[0]
            v_t = jnp.tile(valid, nrep)
            t1g = jnp.where(v_t[None, :, None], t1g, 0.0)

            lpos = pos - loff[None]
            fb, wb = film_ops.splat(bufs["primal"], bufs["wsum"], lpos,
                                    primal, fk)
            vd, _ = film_ops.splat(bufs["very_direct"],
                                   jnp.zeros_like(wb), lpos, very, fk)
            dx = film_ops.splat_unfiltered(bufs["dx"], lpos, grad[0])
            dx = film_ops.splat_unfiltered(dx, lpos + off1, -grad[1])
            dy = film_ops.splat_unfiltered(bufs["dy"], lpos, grad[2])
            dy = film_ops.splat_unfiltered(dy, lpos + off3, -grad[3])
            # t=1 light-image + its gradients: GLOBAL film coordinates
            li = film_ops.splat_unfiltered(bufs["light"], spos, sval)
            dxt1 = film_ops.splat_unfiltered(bufs["dxt1"], t1p, t1g[0])
            dxt1 = film_ops.splat_unfiltered(dxt1, t1p + off1, -t1g[1])
            dyt1 = film_ops.splat_unfiltered(bufs["dyt1"], t1p, t1g[2])
            dyt1 = film_ops.splat_unfiltered(dyt1, t1p + off3, -t1g[3])
            return dict(primal=fb, dx=dx, dy=dy, very_direct=vd,
                        wsum=wb, light=li, dxt1=dxt1, dyt1=dyt1)

        bufs = jax.lax.fori_loop(0, n_samples, body, bufs)
        # camera-path halos ride ppermute; light-image/t1 buffers
        # merge with ONE psum (splats are additive), then every shard
        # keeps its own row slice
        out = {k: _halo_exchange_add(bufs[k], B)
               for k in ("primal", "dx", "dy", "very_direct", "wsum")}
        for k in ("light", "dxt1", "dyt1"):
            full = jax.lax.psum(bufs[k], AXIS)
            out[k] = jax.lax.dynamic_slice(
                full, (row0, 0, 0), (rows, W, 3))
        out["dx"] = out["dx"] + out["dxt1"]
        out["dy"] = out["dy"] + out["dyt1"]
        del out["dxt1"], out["dyt1"]
        return out

    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=(P(),),
                   out_specs=P(AXIS),
                   check_vma=False)
    out = fn(scene)
    out = {k: _gather_host(v, H) for k, v in out.items()}
    w = np.maximum(out.pop("wsum"), 1e-12)[..., None]
    return {
        # light image merges into PRIMAL (it participates in the Poisson
        # solve via the t=1 image-space gradient shifts — GBDPTracer
        # .finalize semantics)
        "primal": out["primal"] / w + out["light"] / n_samples,
        "very_direct": out["very_direct"] / w,
        "dx": out["dx"] / n_samples,
        "dy": out["dy"] / n_samples,
    }


def render_tiles_path(tracer, scene, mesh, seed, n_samples: int):
    """Row-sharded plain PT (single-buffer) — multi-chip `path`."""
    st = tracer.settings
    H, W = st.height, st.width
    n_dev = mesh.devices.size
    Hp = padded_rows(H, n_dev)
    rows = Hp // n_dev
    B = max(int(np.ceil(2 * film_ops.RADII[tracer.filter_kind])), 1)

    def shard_fn(scene_rep):
        idx = jax.lax.axis_index(AXIS)
        row0 = idx * rows
        local_ids = (row0 * W + jnp.arange(rows * W, dtype=jnp.uint32))
        Hl = rows + 2 * B
        pv = lambda a: jax.lax.pcast(a, (AXIS,), to='varying')
        fb = pv(jnp.zeros((Hl, W, 3)))
        wb = pv(jnp.zeros((Hl, W)))

        def body(i, carry):
            fb, wb = carry
            pos, L = tracer.trace_pass(scene_rep, seed, i,
                                       pixel_id=local_ids)
            valid = (local_ids // W) < H
            L = jnp.where(valid[:, None], L, 0.0)
            jit = (pos % 1.0)[None]
            return film_ops.splat_grid(fb, wb, jit, L[None],
                                       tracer.filter_kind, row0=B)

        fb, wb = jax.lax.fori_loop(0, n_samples, body, (fb, wb))
        return (_halo_exchange_add(fb, B), _halo_exchange_add(wb, B))

    fn = shard_map(shard_fn, mesh=mesh, in_specs=(P(),),
                   out_specs=(P(AXIS), P(AXIS)), check_vma=False)
    fb, wb = fn(scene)
    fb = _gather_host(fb, H)
    wb = _gather_host(wb, H)
    return fb / np.maximum(wb, 1e-12)[..., None]
