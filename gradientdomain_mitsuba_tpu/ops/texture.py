"""Texture evaluation: bitmap (trilinear mipmapped, wrap) + checkerboard.

Replacement for Mitsuba's texture plugins + mipmap machinery
(src/textures/{bitmap,checkerboard}.cpp, include/mitsuba/render/mipmap.h):
all bitmaps live in one padded atlas stack [T, Hmax, Wmax, 3] in HBM with
the mip pyramid packed beside level 0 (levels >= 1 stacked vertically at
x >= w0); lookups are gathers + bilinear weights, and trilinear filtering
lerps between the two straddling levels.  The level-of-detail comes from
the PRIMARY-hit pixel footprint (like the reference, whose ray
differentials exist only on camera rays — secondary bounces sample the
finest level in both renderers)."""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

TEX_BITMAP = 0
TEX_CHECKERBOARD = 1
TEX_GRID = 2
TEX_VERTEXCOLOR = 3   # src/textures/vertexcolors.cpp: barycentric blend
TEX_WIREFRAME = 4     # src/textures/wireframe.cpp: world edge distance


class TextureTable(NamedTuple):
    kind: np.ndarray       # [T] i32
    color0: np.ndarray     # [T, 3] checkerboard color0 / bitmap scale
    color1: np.ndarray     # [T, 3]
    uv_scale: np.ndarray   # [T, 2]
    uv_offset: np.ndarray  # [T, 2]
    image: np.ndarray      # [T, Hmax, Wmax, 3] atlas incl. mip levels
    img_size: np.ndarray   # [T, 2] (h, w) of level 0
    lvl_off: np.ndarray    # [T, L, 2] (y, x) atlas offset per level
    lvl_size: np.ndarray   # [T, L, 2] (h, w) per level
    n_levels: np.ndarray   # [T] i32
    grid_width: np.ndarray  # [T] gridtexture line width
    filter_ewa: np.ndarray  # [T] i32: anisotropic (EWA-class) filtering
    #                         (bitmap filterType, Mitsuba default "ewa")


def _lvl_dummy(t=1):
    return (np.zeros((t, 1, 2), np.int32), np.ones((t, 1, 2), np.int32),
            np.ones(t, np.int32))


def empty_table() -> TextureTable:
    lo, ls, nl = _lvl_dummy()
    return TextureTable(
        kind=np.zeros(1, np.int32),
        color0=np.ones((1, 3), np.float32),
        color1=np.ones((1, 3), np.float32),
        uv_scale=np.ones((1, 2), np.float32),
        uv_offset=np.zeros((1, 2), np.float32),
        image=np.ones((1, 1, 1, 3), np.float32),
        img_size=np.ones((1, 2), np.int32),
        lvl_off=lo, lvl_size=ls, n_levels=nl,
        grid_width=np.full(1, 0.01, np.float32),
        filter_ewa=np.zeros(1, np.int32))


def _downsample2(img):
    """2x box downsample with replicate padding for odd sizes."""
    h, w = img.shape[:2]
    if h > 1 and h % 2:
        img = np.concatenate([img, img[-1:]], axis=0)
    if w > 1 and w % 2:
        img = np.concatenate([img, img[:, -1:]], axis=1)
    h, w = img.shape[:2]
    if h > 1:
        img = 0.5 * (img[0::2] + img[1::2])
    if w > 1:
        img = 0.5 * (img[:, 0::2] + img[:, 1::2])
    return img


def _build_pyramid(img):
    """[level 0 image, ...] down to 1x1 (box-filtered, mipmap.h E*Box)."""
    levels = [img]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        levels.append(_downsample2(levels[-1]))
    return levels


def _pack_pyramid(levels):
    """Pack a mip chain into one 2D slab: level 0 at (0, 0), levels >= 1
    stacked vertically at x = w0.  Returns (slab, offsets, sizes)."""
    h0, w0 = levels[0].shape[:2]
    side_h = sum(l.shape[0] for l in levels[1:])
    H = max(h0, side_h)
    W = w0 + (levels[1].shape[1] if len(levels) > 1 else 0)
    slab = np.zeros((H, W, 3), np.float32)
    slab[:h0, :w0] = levels[0]
    offs, sizes = [(0, 0)], [(h0, w0)]
    y = 0
    for l in levels[1:]:
        lh, lw = l.shape[:2]
        slab[y:y + lh, w0:w0 + lw] = l
        offs.append((y, w0))
        sizes.append((lh, lw))
        y += lh
    return slab, offs, sizes


def build_table(nodes, base_dir) -> TextureTable:
    """Texture plugin nodes -> stacked table (host side)."""
    import os
    from ..scene.ir import spectrum_value
    if not nodes:
        return empty_table()
    kinds, c0s, c1s, scales, offsets = [], [], [], [], []
    slabs, lvl_offs, lvl_sizes, sizes0 = [], [], [], []
    grid_widths = {}
    ewas = []
    for node in nodes:
        us = float(node.get("uscale", 1.0))
        vs = float(node.get("vscale", 1.0))
        uo = float(node.get("uoffset", 0.0))
        vo = float(node.get("voffset", 0.0))
        scales.append((us, vs))
        offsets.append((uo, vo))
        mul = np.ones(3, np.float32)
        if node.type == "scale":
            # scale wrapper (src/textures/scale.cpp): multiply the
            # nested texture; fold the factor into the color/scale
            # columns at build time
            mul = spectrum_value(node.get("value"), (1.0,) * 3)
            nested = [ch for ch in node.children if ch.kind == "texture"]
            if nested:
                node = nested[0]
        ewas.append(1 if (node.type == "bitmap" and str(
            node.get("filterType", "ewa")).lower() == "ewa") else 0)
        if node.type == "bitmap":
            kinds.append(TEX_BITMAP)
            c0s.append(mul)  # bitmap scale
            c1s.append(np.zeros(3, np.float32))
            path = os.path.join(base_dir, node.get("filename"))
            if path.lower().endswith(".exr"):
                from ..utils import exr
                img = exr.read_rgb(path)
            else:
                from PIL import Image
                raw = np.asarray(Image.open(path).convert("RGB"),
                                 np.float32) / 255.0
                gamma = float(node.get("gamma", -1.0))
                if gamma == -1.0:
                    img = np.where(raw <= 0.04045, raw / 12.92,
                                   ((raw + 0.055) / 1.055) ** 2.4)
                else:
                    img = raw ** gamma
            img = img.astype(np.float32)
        else:
            if node.type == "checkerboard":
                kinds.append(TEX_CHECKERBOARD)
                c0s.append(mul * spectrum_value(node.get("color0"),
                                                (0.4,) * 3))
                c1s.append(mul * spectrum_value(node.get("color1"),
                                                (0.2,) * 3))
            elif node.type == "gridtexture":
                kinds.append(TEX_GRID)
                # color0 = background, color1 = grid lines; lineWidth
                # rides the unused color1 alpha... stored in offsets? no:
                # keep it in color0's companion scalar table via c1 w
                c0s.append(mul * spectrum_value(node.get("color0"),
                                                (0.4,) * 3))
                c1s.append(mul * spectrum_value(node.get("color1"),
                                                (0.2,) * 3))
                grid_widths[len(kinds) - 1] = float(
                    node.get("lineWidth", 0.01))
            elif node.type in ("vertexcolors", "curvature"):
                # per-hit barycentric color arrives via the Intersection
                # bary payload; color0 folds in a scale-wrapper factor.
                # curvature (curvature.cpp) bakes its per-vertex estimate
                # into the same channel at mesh load (scene.compile_scene)
                # and folds its own `scale` knob here.
                kinds.append(TEX_VERTEXCOLOR)
                c0s.append(mul * (float(node.get("scale", 1.0))
                                  if node.type == "curvature" else 1.0))
                c1s.append(np.zeros(3, np.float32))
            elif node.type == "wireframe":
                kinds.append(TEX_WIREFRAME)
                c0s.append(mul * spectrum_value(node.get("interiorColor"),
                                                (0.5,) * 3))
                c1s.append(mul * spectrum_value(node.get("edgeColor"),
                                                (0.1,) * 3))
                # 0.0 = "auto": compile_scene patches in 0.1x the scene
                # mean edge length (wireframe.cpp default)
                grid_widths[len(kinds) - 1] = float(
                    node.get("lineWidth", 0.0))
            else:
                # unsupported texture type: constant grey stand-in
                kinds.append(TEX_CHECKERBOARD)
                c0s.append(np.full(3, 0.5, np.float32))
                c1s.append(np.full(3, 0.5, np.float32))
            img = np.ones((1, 1, 3), np.float32)
        slab, offs, szs = _pack_pyramid(_build_pyramid(img))
        slabs.append(slab)
        lvl_offs.append(offs)
        lvl_sizes.append(szs)
        sizes0.append((img.shape[0], img.shape[1]))

    hmax = max(s.shape[0] for s in slabs)
    wmax = max(s.shape[1] for s in slabs)
    L = max(len(o) for o in lvl_offs)
    T = len(slabs)
    stack = np.zeros((T, hmax, wmax, 3), np.float32)
    lo = np.zeros((T, L, 2), np.int32)
    ls = np.ones((T, L, 2), np.int32)
    nl = np.zeros(T, np.int32)
    for i, slab in enumerate(slabs):
        stack[i, :slab.shape[0], :slab.shape[1]] = slab
        n = len(lvl_offs[i])
        lo[i, :n] = lvl_offs[i]
        ls[i, :n] = lvl_sizes[i]
        # out-of-range rows repeat the coarsest level (clamped gathers)
        lo[i, n:] = lvl_offs[i][-1]
        ls[i, n:] = lvl_sizes[i][-1]
        nl[i] = n
    return TextureTable(
        kind=np.asarray(kinds, np.int32),
        color0=np.stack(c0s).astype(np.float32),
        color1=np.stack(c1s).astype(np.float32),
        uv_scale=np.asarray(scales, np.float32),
        uv_offset=np.asarray(offsets, np.float32),
        image=stack, img_size=np.asarray(sizes0, np.int32),
        lvl_off=lo, lvl_size=ls, n_levels=nl,
        grid_width=np.asarray(
            [grid_widths.get(i, 0.01) for i in range(T)], np.float32),
        filter_ewa=np.asarray(ewas, np.int32))


def _bilinear(tex: TextureTable, tid, lvl, u, v):
    """Bilinear tap at mip level lvl (wrap addressing, v flipped: uv
    origin bottom-left, image row 0 at top — Mitsuba bitmap convention)."""
    off = tex.lvl_off[tid, lvl]
    size = tex.lvl_size[tid, lvl]
    h = size[..., 0].astype(jnp.float32)
    w = size[..., 1].astype(jnp.float32)
    x = (u % 1.0) * w - 0.5
    y = ((1.0 - v) % 1.0) * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    hi = size[..., 0]
    wi_ = size[..., 1]
    x0i = jnp.mod(x0.astype(jnp.int32), wi_)
    x1i = jnp.mod(x0i + 1, wi_)
    y0i = jnp.mod(y0.astype(jnp.int32), hi)
    y1i = jnp.mod(y0i + 1, hi)
    oy = off[..., 0]
    ox = off[..., 1]
    c00 = tex.image[tid, oy + y0i, ox + x0i]
    c01 = tex.image[tid, oy + y0i, ox + x1i]
    c10 = tex.image[tid, oy + y1i, ox + x0i]
    c11 = tex.image[tid, oy + y1i, ox + x1i]
    return (c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy) +
            c10 * (1 - fx) * fy + c11 * fx * fy)


N_ANISO_TAPS = 8   # fixed tap count: static shapes for XLA
MAX_ANISO = 8.0


def _aniso_sample(tex, tid, u, v, jac):
    """Anisotropic (EWA-class) filtering: mip level from the footprint
    ellipse's MINOR axis, N_ANISO_TAPS Gaussian-weighted trilinear taps
    spread along the MAJOR axis (mipmap.h EWA lookup, realized as the
    bounded fixed-tap form that keeps shapes static for XLA).

    jac: [N, 2, 2] with columns = the footprint ellipse's two axes in
    SCALED uv space ([du1 du2] / [dv1 dv2])."""
    h0 = tex.img_size[tid, 0].astype(jnp.float32)
    w0 = tex.img_size[tid, 1].astype(jnp.float32)
    # axis lengths in texel units
    ax = jac[..., 0] * jnp.stack([w0, h0], -1)   # [N, 2]
    ay = jac[..., 1] * jnp.stack([w0, h0], -1)
    la = jnp.sqrt(jnp.sum(ax * ax, -1) + 1e-20)
    lb = jnp.sqrt(jnp.sum(ay * ay, -1) + 1e-20)
    swap = lb > la
    major_uv = jnp.where(swap[..., None], jac[..., 1], jac[..., 0])
    l_maj = jnp.maximum(la, lb)
    l_min = jnp.minimum(la, lb)
    # clamp anisotropy; widen the minor axis if the ellipse is too thin
    l_min = jnp.maximum(l_min, l_maj / MAX_ANISO)
    lod = jnp.log2(jnp.maximum(l_min, 1e-6))
    lod = jnp.clip(lod, 0.0, (tex.n_levels[tid] - 1).astype(jnp.float32))
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, tex.n_levels[tid] - 1)
    fl = (lod - l0.astype(jnp.float32))[..., None]

    acc = 0.0
    wsum = 0.0
    for i in range(N_ANISO_TAPS):
        t = (i + 0.5) / N_ANISO_TAPS - 0.5          # in (-0.5, 0.5)
        w = float(np.exp(-2.0 * (2.0 * t) ** 2))     # Gaussian falloff
        du = major_uv[..., 0] * t
        dv = major_uv[..., 1] * t
        tap = (_bilinear(tex, tid, l0, u + du, v + dv) * (1 - fl) +
               _bilinear(tex, tid, l1, u + du, v + dv) * fl)
        acc = acc + w * tap
        wsum = wsum + w
    return acc / wsum


def eval_texture(tex: TextureTable, tex_id, uv, uv_footprint=None,
                 bary=None):
    """Evaluate textures for a batch: tex_id [N] (>=0), uv [N, 2].

    uv_footprint (optional): either the scalar UV-space footprint area
    [N] (trilinear level selection), or a tuple (area [N], jac [N,2,2])
    where jac's columns are the footprint ellipse axes in UV space —
    textures flagged filter_ewa then use anisotropic filtering.
    (None == finest level, the behavior for secondary bounces.)"""
    uv_jac = None
    if isinstance(uv_footprint, tuple):
        uv_footprint, uv_jac = uv_footprint
    tid = jnp.maximum(tex_id, 0)
    scale = tex.uv_scale[tid]
    off = tex.uv_offset[tid]
    u = uv[..., 0] * scale[..., 0] + off[..., 0]
    v = uv[..., 1] * scale[..., 1] + off[..., 1]

    # checkerboard (Mitsuba: floor(u)+floor(v) parity over [0,1] cells)
    iu = jnp.floor(u * 2.0).astype(jnp.int32)
    iv = jnp.floor(v * 2.0).astype(jnp.int32)
    even = ((iu + iv) % 2) == 0
    checker = jnp.where(even[..., None], tex.color0[tid], tex.color1[tid])

    if uv_footprint is None:
        bmp = _bilinear(tex, tid, jnp.zeros_like(tid), u, v)
    else:
        # lod = 0.5 log2(texels covered): footprint in scaled-uv space
        # times the level-0 texel density
        h0 = tex.img_size[tid, 0].astype(jnp.float32)
        w0 = tex.img_size[tid, 1].astype(jnp.float32)
        texels = (uv_footprint * scale[..., 0] * scale[..., 1] * h0 * w0)
        lod = 0.5 * jnp.log2(jnp.maximum(texels, 1e-20))
        lod = jnp.clip(lod, 0.0,
                       (tex.n_levels[tid] - 1).astype(jnp.float32))
        l0 = jnp.floor(lod).astype(jnp.int32)
        l1 = jnp.minimum(l0 + 1, tex.n_levels[tid] - 1)
        fl = (lod - l0.astype(jnp.float32))[..., None]
        bmp = (_bilinear(tex, tid, l0, u, v) * (1 - fl) +
               _bilinear(tex, tid, l1, u, v) * fl)
        if uv_jac is not None:
            # ellipse axes into SCALED uv space: row 0 (du) by uscale,
            # row 1 (dv) by vscale
            jac_s = uv_jac * scale[..., :, None]
            aniso = _aniso_sample(tex, tid, u, v, jac_s)
            use = (tex.filter_ewa[tid] > 0)[..., None]
            bmp = jnp.where(use, aniso, bmp)
    bmp = bmp * tex.color0[tid]

    # gridtexture (src/textures/gridtexture.cpp): lines of color1 at
    # integer uv boundaries over a color0 background
    lw = tex.grid_width[tid]
    fu = u % 1.0
    fv = v % 1.0
    on_line = ((fu < lw) | (fu > 1.0 - lw) |
               (fv < lw) | (fv > 1.0 - lw))
    grid = jnp.where(on_line[..., None], tex.color1[tid],
                     tex.color0[tid])

    kind = tex.kind[tid]
    out = jnp.where((kind == TEX_CHECKERBOARD)[..., None], checker,
                    jnp.where((kind == TEX_GRID)[..., None], grid, bmp))

    # barycentric-attribute textures (vertexcolors/wireframe): the per-hit
    # payload (interpolated vertex color + world distance to the nearest
    # triangle edge) is computed once in fill_intersection; callers
    # without one (bidirectional subpath re-evals) get the interior color
    if bary is not None:
        vcol = bary[..., 0:3] * tex.color0[tid]
        wire = jnp.where((bary[..., 3] < tex.grid_width[tid])[..., None],
                         tex.color1[tid], tex.color0[tid])
        out = jnp.where((kind == TEX_VERTEXCOLOR)[..., None], vcol, out)
        out = jnp.where((kind == TEX_WIREFRAME)[..., None], wire, out)
    else:
        flat = (kind == TEX_VERTEXCOLOR) | (kind == TEX_WIREFRAME)
        out = jnp.where(flat[..., None], tex.color0[tid], out)
    return out


def resolve_opacity(scene, mid, uv, bary=None):
    """Mask-wrapper opacity with texture override where bound (luminance
    of the opacity texture, mask.cpp semantics)."""
    from ..core.spectrum import luminance
    row = scene.materials.packed[mid]
    op = row[..., 22]
    tex_id = row[..., 23].astype(jnp.int32)
    tex_val = eval_texture(scene.textures, tex_id, uv, bary=bary)
    return jnp.where(tex_id >= 0, luminance(tex_val), op)


def resolve_albedo(scene, mid, uv, uv_footprint=None, bary=None):
    """Material reflectance with texture override where bound."""
    row = scene.materials.packed[mid]
    refl = row[..., 2:5]
    tex_id = row[..., 20].astype(jnp.int32)
    has_tex = tex_id >= 0
    tex_val = eval_texture(scene.textures, tex_id, uv, uv_footprint,
                           bary=bary)
    return jnp.where(has_tex[..., None], tex_val, refl)


def resolve_blend_weight(scene, mid, uv, bary=None):
    """blendbsdf textured weight (luminance of the weight texture where
    bound, else the scalar weight — blendbsdf.cpp semantics)."""
    from ..core.spectrum import luminance
    row = scene.materials.packed[mid]
    w = row[..., 26]
    tex_id = row[..., 27].astype(jnp.int32)
    tex_val = eval_texture(scene.textures, tex_id, uv, bary=bary)
    return jnp.clip(jnp.where(tex_id >= 0, luminance(tex_val), w),
                    0.0, 1.0)
