"""Film accumulation: reconstruction-filtered scatter-add splatting.

Replacement for ImageBlock::put + Film::put
(src/librender/imageblock.cpp, film.cpp, src/rfilters/*.cpp).  Instead of
per-tile bordered blocks merged under a mutex, samples scatter-add into
full-resolution framebuffers with a weight channel; XLA lowers .at[].add to
a single fused scatter.  Gradient buffers always use box filtering (the
gradients live on the pixel lattice — gpt_wr.cpp semantics).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

FILTERS = {"box": 0, "tent": 1, "gaussian": 2, "mitchell": 3,
           "catmullrom": 4, "lanczos": 5}
# filter radius in pixels (Mitsuba defaults)
RADII = {0: 0.5, 1: 1.0, 2: 2.0, 3: 2.0, 4: 2.0, 5: 3.0}


def filter_weight(kind: int, x):
    """1D filter weight at offset x (pixels)."""
    ax = jnp.abs(x)
    if kind == 0:      # box
        return jnp.where(ax <= 0.5, 1.0, 0.0)
    if kind == 1:      # tent
        return jnp.maximum(0.0, 1.0 - ax)
    if kind == 2:      # gaussian, stddev 0.5, radius 2 (gaussian.cpp)
        sigma = 0.5
        a = jnp.exp(-0.5 * (x / sigma) ** 2)
        b = float(np.exp(-0.5 * (2.0 / sigma) ** 2))
        return jnp.maximum(0.0, a - b)
    if kind in (3, 4):  # mitchell-netravali (B,C) / catmull-rom
        B, C = (1 / 3, 1 / 3) if kind == 3 else (0.0, 0.5)
        ax2, ax3 = ax * ax, ax * ax * ax
        w1 = ((12 - 9 * B - 6 * C) * ax3 + (-18 + 12 * B + 6 * C) * ax2 +
              (6 - 2 * B)) / 6
        w2 = ((-B - 6 * C) * ax3 + (6 * B + 30 * C) * ax2 +
              (-12 * B - 48 * C) * ax + (8 * B + 24 * C)) / 6
        return jnp.where(ax < 1, w1, jnp.where(ax < 2, w2, 0.0))
    if kind == 5:      # lanczos sinc, 3 lobes
        def sinc(v):
            v = jnp.abs(v) * jnp.pi
            return jnp.where(v < 1e-5, 1.0, jnp.sin(v) / v)
        return jnp.where(ax < 3.0, sinc(ax) * sinc(ax / 3.0), 0.0)
    raise ValueError(kind)


def splat(fb, wb, pos, value, filter_kind: int):
    """Scatter-add filtered samples.

    fb: [H, W, C] framebuffer; wb: [H, W] weight accumulator;
    pos: [N, 2] continuous film position; value: [N, C].
    Returns updated (fb, wb).  Footprint is static per filter kind.
    """
    H, W = fb.shape[0], fb.shape[1]
    radius = RADII[filter_kind]
    n_taps = max(1, int(np.ceil(2 * radius)))
    x, y = pos[..., 0], pos[..., 1]
    # leftmost pixel whose center is inside the filter support
    x0 = jnp.floor(x - radius + 0.5).astype(jnp.int32)
    y0 = jnp.floor(y - radius + 0.5).astype(jnp.int32)
    for dy in range(n_taps):
        py = y0 + dy
        wy = filter_weight(filter_kind, py.astype(jnp.float32) + 0.5 - y)
        for dx in range(n_taps):
            px = x0 + dx
            wx = filter_weight(filter_kind, px.astype(jnp.float32) + 0.5 - x)
            w = wx * wy
            inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
            w = jnp.where(inside, w, 0.0)
            pxc = jnp.clip(px, 0, W - 1)
            pyc = jnp.clip(py, 0, H - 1)
            fb = fb.at[pyc, pxc].add(value * w[..., None])
            wb = wb.at[pyc, pxc].add(w)
    return fb, wb


def splat_unfiltered(fb, pos, value):
    """Raw box splat WITHOUT weight tracking — for gradient/light-image
    buffers where each sample belongs to exactly one lattice cell and
    normalization is by sample count."""
    H, W = fb.shape[0], fb.shape[1]
    px = jnp.clip(pos[..., 0].astype(jnp.int32), 0, W - 1)
    py = jnp.clip(pos[..., 1].astype(jnp.int32), 0, H - 1)
    inside = ((pos[..., 0] >= 0) & (pos[..., 0] < W) &
              (pos[..., 1] >= 0) & (pos[..., 1] < H))
    return fb.at[py, px].add(value * inside[..., None])


def develop(fb, wb):
    """Normalize by accumulated filter weights (Film::develop)."""
    return fb / jnp.maximum(wb, 1e-12)[..., None]


# ---------------------------------------------------------------------------
# Grid-aligned splatting: when every sample belongs to a known pixel (the
# wavefront renders one sample per pixel in row-major order), filtering
# becomes a small set of DENSE shifted adds — no scatter at all (colliding
# scatter indices serialize); these paths replace it for the primary film
# and the gradient
# buffers.  pos-based scatter splatting above remains for the BDPT light
# image, whose splat positions are arbitrary.
# ---------------------------------------------------------------------------

def _tap_radius(filter_kind: int) -> int:
    import math
    return int(math.ceil(RADII[filter_kind] - 0.5 + 1e-6))


def splat_grid(fb, wb, jitter, value, filter_kind: int, row0: int = 0):
    """Filtered accumulation of row-major grid samples.

    fb: [H, W, C]; wb: [H, W]; value: [S, rows*W, C] (S sample-batches);
    jitter: [S, rows*W, 2] in-pixel offsets in [0,1).  The sample grid
    starts at film row `row0` (static).  Returns (fb, wb).
    """
    H, W = fb.shape[0], fb.shape[1]
    S, NW, C = value.shape
    rows = NW // W
    img = value.reshape(S, rows, W, C)
    jx = jitter[..., 0].reshape(S, rows, W)
    jy = jitter[..., 1].reshape(S, rows, W)
    K = _tap_radius(filter_kind)

    if K == 0:  # box: the sample always lands in its own pixel
        fb = jax.lax.dynamic_update_slice(
            fb, jax.lax.dynamic_slice(fb, (row0, 0, 0), (rows, W, C)) +
            img.sum(0), (row0, 0, 0))
        wb = jax.lax.dynamic_update_slice(
            wb, jax.lax.dynamic_slice(wb, (row0, 0), (rows, W)) +
            jnp.full((rows, W), float(S)), (row0, 0))
        return fb, wb

    accv = jnp.zeros((rows + 2 * K, W + 2 * K, C), value.dtype)
    accw = jnp.zeros((rows + 2 * K, W + 2 * K), value.dtype)
    for oy in range(-K, K + 1):
        wy = filter_weight(filter_kind, oy + 0.5 - jy)
        for ox in range(-K, K + 1):
            w = wy * filter_weight(filter_kind, ox + 0.5 - jx)
            accv = jax.lax.dynamic_update_slice(
                accv, jax.lax.dynamic_slice(
                    accv, (oy + K, ox + K, 0), (rows, W, C)) +
                (img * w[..., None]).sum(0), (oy + K, ox + K, 0))
            accw = jax.lax.dynamic_update_slice(
                accw, jax.lax.dynamic_slice(
                    accw, (oy + K, ox + K), (rows, W)) + w.sum(0),
                (oy + K, ox + K))
    # fold the accumulator back into the film; taps falling outside the
    # film (row/column halos) are dropped, matching the scatter splat's
    # inside-film check
    y0 = row0 - K
    pad_top = max(0, -y0)
    pad_bot = max(0, (row0 + rows + K) - H)
    src_v = accv[pad_top:accv.shape[0] - pad_bot, K:accv.shape[1] - K]
    src_w = accw[pad_top:accw.shape[0] - pad_bot, K:accw.shape[1] - K]
    dst0 = max(y0, 0)
    fb = fb.at[dst0:dst0 + src_v.shape[0], :].add(src_v)
    wb = wb.at[dst0:dst0 + src_w.shape[0], :].add(src_w)
    return fb, wb


def add_grid_shifted(fb, value, dx: int, dy: int, row0: int = 0,
                     mask=None):
    """Unfiltered lattice add of row-major grid samples at an integer
    pixel offset (dx, dy) — the gradient-buffer path (dense, no scatter).
    value: [S, rows*W, C]."""
    H, W = fb.shape[0], fb.shape[1]
    S, NW, C = value.shape
    rows = NW // W
    img = value.reshape(S, rows, W, C).sum(0)
    y0 = row0 + dy
    # clip rows
    src_top = max(0, -y0)
    src_bot = max(0, y0 + rows - H)
    if src_top + src_bot >= rows:
        return fb
    img_c = img[src_top:rows - src_bot]
    dst_y = y0 + src_top
    # clip columns via slicing
    if dx > 0:
        fb = fb.at[dst_y:dst_y + img_c.shape[0], dx:].add(
            img_c[:, :W - dx])
    elif dx < 0:
        fb = fb.at[dst_y:dst_y + img_c.shape[0], :W + dx].add(
            img_c[:, -dx:])
    else:
        fb = fb.at[dst_y:dst_y + img_c.shape[0], :].add(img_c)
    return fb
