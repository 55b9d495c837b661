"""Host-side elastic tile queue: idempotent render-tile redispatch.

Analog of the failure-recovery gap in Mitsuba's scheduler
(src/libcore/sched_remote.cpp aborts the whole job when a remote worker
drops — SURVEY.md §6.3): because every tile here is a PURE function of
(scene, seed, tile rows, sample range), a failed dispatch can simply be
re-enqueued and re-rendered with no side effects to undo.

The film is split into row blocks.  Each block renders through the same
jitted per-tile program (one compile, shapes shared across tiles) into
local buffers with a filter-radius halo; the host combines per-tile
results IN TILE-INDEX ORDER, so the final image is bit-identical no
matter in which order tiles completed or how many times any tile was
retried — the property the fault-injection test asserts.

`fail_hook(tile_idx, attempt)` lets tests inject faults (raise to
simulate a dead chip / dropped result).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import film as film_ops


class TileRenderError(RuntimeError):
    """A tile failed more than max_retries times."""


def _tile_program(tracer, scene, seed, sample_start, row0, *, rows, B,
                  n_samples):
    """Render `n_samples` G-PT samples for film rows [row0, row0+rows) into
    local (rows+2B, W) buffers (B halo rows top+bottom).  Pure; jitted by
    the caller.  row0 is a traced scalar so all tiles share ONE compile."""
    st = tracer.settings
    H, W = st.height, st.width
    ids = (jnp.uint32(row0) * W +
           jnp.arange(rows * W, dtype=jnp.uint32))
    Hl = rows + 2 * B
    zero3 = jnp.zeros((Hl, W, 3))
    bufs = dict(primal=zero3, dx=zero3, dy=zero3, very_direct=zero3,
                wsum=jnp.zeros((Hl, W)))

    def body(i, bufs):
        pos, primal, very, grad = tracer.trace_pass(
            scene, seed, sample_start + i, pixel_id=ids)
        valid = (ids // W) < H
        primal = jnp.where(valid[:, None], primal, 0.0)
        very = jnp.where(valid[:, None], very, 0.0)
        grad = jnp.where(valid[None, :, None], grad, 0.0)
        jit = (pos % 1.0)[None]
        fb, wb = film_ops.splat_grid(bufs["primal"], bufs["wsum"],
                                     jit, primal[None],
                                     tracer.filter_kind, row0=B)
        vd, _ = film_ops.splat_grid(bufs["very_direct"],
                                    jnp.zeros_like(wb), jit, very[None],
                                    tracer.filter_kind, row0=B)
        dx = film_ops.add_grid_shifted(bufs["dx"], grad[0][None], 0, 0,
                                       row0=B)
        dx = film_ops.add_grid_shifted(dx, -grad[1][None], -1, 0, row0=B)
        dy = film_ops.add_grid_shifted(bufs["dy"], grad[2][None], 0, 0,
                                       row0=B)
        dy = film_ops.add_grid_shifted(dy, -grad[3][None], 0, -1, row0=B)
        return dict(primal=fb, dx=dx, dy=dy, very_direct=vd, wsum=wb)

    return jax.lax.fori_loop(0, n_samples, body, bufs)


def render_tiles_queued(tracer, scene, seed, n_samples, tile_rows=32,
                        max_retries=3, fail_hook=None, progress=None):
    """Queued G-PT render with elastic redispatch.

    Returns the same sample-normalized buffers dict as GPTracer.render.
    fail_hook(tile_idx, attempt) may raise to inject a fault; the tile is
    then re-enqueued (attempt+1) until max_retries is exceeded.
    """
    st = tracer.settings
    H, W = st.height, st.width
    B = max(int(np.ceil(2 * film_ops.RADII[tracer.filter_kind])), 1)
    n_tiles = -(-H // tile_rows)

    prog = jax.jit(functools.partial(
        _tile_program, tracer, rows=tile_rows, B=B, n_samples=n_samples))

    queue = [(idx, 0) for idx in range(n_tiles)]
    results = {}
    while queue:
        idx, attempt = queue.pop(0)
        try:
            if fail_hook is not None:
                fail_hook(idx, attempt)
            out = prog(scene, seed, 0, idx * tile_rows)
            results[idx] = {k: np.asarray(v) for k, v in out.items()}
            if progress is not None:
                progress(len(results), n_tiles)
        except Exception as e:  # noqa: BLE001 — any tile fault is retryable
            if attempt + 1 > max_retries:
                raise TileRenderError(
                    f"tile {idx} failed {attempt + 1} times: {e}") from e
            queue.append((idx, attempt + 1))

    # Combine in tile-index order: deterministic regardless of completion
    # order (halo rows of adjacent tiles overlap-add).
    Hp = n_tiles * tile_rows
    acc = {k: np.zeros((Hp + 2 * B, W) + v.shape[2:], v.dtype)
           for k, v in results[0].items()}
    for idx in range(n_tiles):
        r0 = idx * tile_rows
        for k, v in results[idx].items():
            acc[k][r0:r0 + tile_rows + 2 * B] += v

    out = {k: v[B:B + H] for k, v in acc.items()}
    w = np.maximum(out.pop("wsum"), 1e-12)[..., None]
    return {
        "primal": out["primal"] / w,
        "very_direct": out["very_direct"] / w,
        "dx": out["dx"] / n_samples,
        "dy": out["dy"] / n_samples,
    }
