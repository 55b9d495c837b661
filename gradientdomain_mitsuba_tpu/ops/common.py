"""Scene-level intersection wrappers: traversal + hit-record fill.

Replacement for Scene::rayIntersect + Shape::fillIntersectionRecord
(src/librender/scene.cpp, shape.cpp, trimesh.cpp): traversal returns
(t, u, v, prim); this module gathers vertex attributes and material/emitter
ids into the flat Intersection record used by every integrator.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import math as m
from ..core.records import Intersection
from . import intersect as isec


BRUTE_FORCE_MAX_TRIS = 2048

# prim-id namespace for analytic spheres (above any padded triangle count)
SPHERE_PRIM_BASE = 1 << 28


def add_sphere_intersections(closest_tri, occl_tri):
    """Merge analytic-sphere hits (ops/intersect.intersect_spheres) into
    the triangle traversal by closest t.  Scenes without analytic spheres
    (geom.sph_center.shape[0] == 0, a STATIC shape) compile this away."""
    from . import intersect as isec_mod

    def closest(o, d, mint, maxt, geom):
        hit = closest_tri(o, d, mint, maxt, geom)
        if geom.sph_center.shape[0] == 0:
            return hit
        tri_t = jnp.where(hit.valid, hit.t, maxt)
        ts, sid = isec_mod.intersect_spheres(
            o, d, mint, tri_t, geom.sph_center, geom.sph_radius)
        sph = sid >= 0
        return isec_mod.Hit(
            t=jnp.where(sph, ts, hit.t),
            u=jnp.where(sph, 0.0, hit.u),
            v=jnp.where(sph, 0.0, hit.v),
            prim=jnp.where(sph, SPHERE_PRIM_BASE + sid, hit.prim),
            valid=hit.valid | sph)

    def occluded(o, d, mint, maxt, geom):
        occ = occl_tri(o, d, mint, maxt, geom)
        if geom.sph_center.shape[0] == 0:
            return occ
        return occ | isec_mod.occluded_spheres(
            o, d, mint, maxt, geom.sph_center, geom.sph_radius)

    return closest, occluded


def choose_intersector(settings, n_tris: int):
    """Returns (closest, occluded) with signature (o, d, mint, maxt, geom),
    with analytic-sphere merging layered on top (add_sphere_intersections;
    compiles away when the scene has no analytic spheres).

    One triangle traversal per platform and regime:

    =========  ===============================  ==========================
    backend    n_tris <= BRUTE_FORCE_MAX_TRIS   larger scenes
    =========  ===============================  ==========================
    "gpu"      fused sweep kernel               SoA per-lane stack BVH
               (ops/pallas_sweep.py)            traversal (stack depth
                                                settings.stack_depth)
    other      brute scan (intersect_brute)     two-level cluster
                                                traversal
    =========  ===============================  ==========================
    """
    import jax
    on_gpu = jax.default_backend() == "gpu"
    if n_tris <= BRUTE_FORCE_MAX_TRIS:
        if on_gpu:
            from . import pallas_sweep as psw
            closest_k = psw.make_sweep_intersector(n_tris)
            occl_k = psw.make_sweep_occluder(n_tris)

            def closest(o, d, mint, maxt, geom):
                return closest_k(o, d, mint, maxt, geom.tris)

            def occl(o, d, mint, maxt, geom):
                return occl_k(o, d, mint, maxt, geom.tris)
            return add_sphere_intersections(closest, occl)
        chunk = min(1024, max(64, n_tris))

        def closest(o, d, mint, maxt, geom):
            return isec.intersect_brute(o, d, mint, maxt, geom.tris,
                                        chunk=chunk)

        def occl(o, d, mint, maxt, geom):
            return isec.occluded_brute(o, d, mint, maxt, geom.tris,
                                       chunk=chunk)
        return add_sphere_intersections(closest, occl)

    if on_gpu:
        closest_s = isec.make_bvh_intersector_soa(settings.stack_depth)
        occl_s = isec.make_bvh_occluder_soa(settings.stack_depth)

        def closest(o, d, mint, maxt, geom):
            return closest_s(o, d, mint, maxt, geom.tris, geom.bvh)

        def occl(o, d, mint, maxt, geom):
            return occl_s(o, d, mint, maxt, geom.tris, geom.bvh)
        return add_sphere_intersections(closest, occl)

    closest_c = isec.make_cluster_intersector(settings.cluster_window)
    occl_c = isec.make_cluster_occluder(settings.cluster_window)

    def closest(o, d, mint, maxt, geom):
        return closest_c(o, d, mint, maxt, geom.tris, geom.clusters)

    def occl(o, d, mint, maxt, geom):
        return occl_c(o, d, mint, maxt, geom.tris, geom.clusters)
    return add_sphere_intersections(closest, occl)


def instrument_intersectors(tracer, closest, occluded):
    """Wrap the intersectors with a DEVICE-SIDE ray counter (SURVEY.md
    §6.1: measured counters, not formulas — replaces StatsCounter's
    'Rays traced').  When `tracer.ray_tally` is a list, every traversal
    call appends the popcount of lanes with positive extent (maxt > 0 —
    dead wavefront lanes are masked with maxt = -1 by every call site);
    render_chunk sums the tally into a 'rays' accumulation buffer.  The
    tally only exists DURING tracing, so the instrumentation costs
    nothing when tracer.count_rays is off."""
    import jax.numpy as jnp

    def closest_w(o, d, mint, maxt, geom):
        tally = getattr(tracer, "ray_tally", None)
        if tally is not None:
            tally.append(jnp.sum((maxt > 0).astype(jnp.float32)))
        return closest(o, d, mint, maxt, geom)

    def occluded_w(o, d, mint, maxt, geom):
        tally = getattr(tracer, "ray_tally", None)
        if tally is not None:
            tally.append(jnp.sum((maxt > 0).astype(jnp.float32)))
        return occluded(o, d, mint, maxt, geom)

    return closest_w, occluded_w


def drain_tally(tracer):
    """Sum and remove every pending ray-tally entry (0.0 if none).

    Tally entries appended inside a traced `lax.fori_loop` body belong
    to that body's trace scope; summing them after the loop leaks
    tracers (jax UnexpectedTracerError).  Loop call sites therefore
    thread a scalar "rays" slot through the loop carry: drain pending
    outer-scope entries into the initial carry, drain per-iteration
    entries inside the body, and append the loop's total back onto the
    tally afterwards (see PathTracer/GPTracer.trace_pass)."""
    import jax.numpy as jnp
    t = tracer.ray_tally
    total = sum(t) if t else jnp.zeros(())
    del t[:]
    return total


def fill_intersection(scene, o, d, hit) -> Intersection:
    """Shading data for Hit records via ONE packed-row gather.

    hit.prim indexes the BVH-ordered tri_shade table (see scene.Geometry);
    prim >= SPHERE_PRIM_BASE designates an analytic sphere whose shading
    data is computed in closed form.  A single packed-row gather replaces
    the 13-gather dependent chain through indices/positions/normals/uvs/
    per-shape tables."""
    g = scene.geom
    prim = jnp.clip(hit.prim, 0, g.tri_shade.shape[0] - 1)
    row = g.tri_shade[prim]                      # [N, 29]

    u = hit.u[..., None]
    v = hit.v[..., None]
    w = 1.0 - u - v
    # missed lanes carry t = F32_MAX; an inf position would turn later
    # masked arithmetic into 0*NaN — keep them finite instead
    t_safe = jnp.where(hit.valid, hit.t, 1.0)
    p = o + t_safe[..., None] * d
    ng = row[..., 0:3]
    ns = row[..., 3:6] * w + row[..., 6:9] * u + row[..., 9:12] * v
    ns = m.normalize(ns)
    ns_ok = m.squared_length(ns) > 0.5
    use_face_n = row[..., 21] > 0.5
    ns = jnp.where((use_face_n | ~ns_ok)[..., None], ng, ns)
    uv = row[..., 12:14] * w + row[..., 14:16] * u + row[..., 16:18] * v

    bsdf_id = row[..., 18].astype(jnp.int32)
    emitter_id = row[..., 19].astype(jnp.int32)
    shape_id = row[..., 20].astype(jnp.int32)

    if g.sph_center.shape[0] > 0:
        # analytic-sphere lanes: exact quadric normals + lat-long uv
        # (z-up, matching meshes.make_sphere / sphere.cpp)
        is_sph = hit.prim >= SPHERE_PRIM_BASE
        sid = jnp.clip(hit.prim - SPHERE_PRIM_BASE, 0,
                       g.sph_center.shape[0] - 1)
        cen = g.sph_center[sid]
        rad = g.sph_radius[sid]
        n_s = (p - cen) / jnp.maximum(rad, 1e-12)[..., None]
        n_s = m.normalize(n_s)
        theta = jnp.arccos(jnp.clip(n_s[..., 2], -1.0, 1.0))
        phi = jnp.arctan2(n_s[..., 1], n_s[..., 0])
        phi = jnp.where(phi < 0, phi + 2 * jnp.pi, phi)
        uv_s = jnp.stack([phi / (2 * jnp.pi), 1.0 - theta / jnp.pi], -1)
        s3 = is_sph[..., None]
        # sphere lanes must not inherit the clamped tri row's tangents
        # (normal perturbation / EWA read row cols 23:29)
        keep = (jnp.arange(row.shape[-1]) < 23).astype(row.dtype)
        row = jnp.where(s3, row * keep, row)
        ng = jnp.where(s3, n_s, ng)
        ns = jnp.where(s3, n_s, ns)
        uv = jnp.where(s3, uv_s, uv)
        bsdf_id = jnp.where(is_sph, g.sph_bsdf[sid], bsdf_id)
        emitter_id = jnp.where(is_sph, -1, emitter_id)
        shape_id = jnp.where(is_sph, g.sph_shape[sid], shape_id)

    if scene.materials.packed.shape[1] >= 32:
        # bumpmap/normalmap shading-normal perturbation (src/bsdfs/
        # {bumpmap,normalmap}.cpp): STATICALLY compiled in only when a
        # perturbing material exists (packed width 32 is the marker).
        ns = _perturb_normal(scene, row, bsdf_id, uv, ns)

    bary = None
    if g.tri_shade.shape[-1] >= 41:
        # per-hit barycentric-attribute payload (STATICALLY compiled in
        # only when a vertexcolors/wireframe texture or a woven-cloth
        # BSDF is bound — scene.py widens tri_shade): cols 29:38 =
        # per-vertex colors, 38:41 = triangle heights (2A/|opposite
        # edge|), so bary_i * h_i is the world distance to edge i and
        # their min is the wireframe edge distance
        wb = 1.0 - hit.u - hit.v
        vc = (row[..., 29:32] * wb[..., None] +
              row[..., 32:35] * hit.u[..., None] +
              row[..., 35:38] * hit.v[..., None])
        edist = jnp.minimum(
            jnp.minimum(wb * row[..., 38], hit.u * row[..., 39]),
            hit.v * row[..., 40])
        # cols 4:6 — azimuth of dp/du inside the canonical shading
        # frame built from ns (cloth yarn orientation, ops/irawan.py)
        ss_f, ts_f = m.build_frame(ns)
        dpdu = row[..., 23:26]
        fc = jnp.sum(dpdu * ss_f, -1)
        fs = jnp.sum(dpdu * ts_f, -1)
        flen = jnp.sqrt(fc * fc + fs * fs)
        ok_f = flen > 1e-12
        fc = jnp.where(ok_f, fc / jnp.where(ok_f, flen, 1.0), 1.0)
        fs = jnp.where(ok_f, fs / jnp.where(ok_f, flen, 1.0), 0.0)
        if g.sph_center.shape[0] > 0:
            on_sph = hit.prim >= SPHERE_PRIM_BASE
            vc = jnp.where(on_sph[..., None], 1.0, vc)
            edist = jnp.where(on_sph, 3.4e38, edist)
            fc = jnp.where(on_sph, 1.0, fc)
            fs = jnp.where(on_sph, 0.0, fs)
        bary = jnp.stack([vc[..., 0], vc[..., 1], vc[..., 2],
                          edist, fc, fs], -1)
    return Intersection(
        valid=hit.valid,
        t=hit.t,
        p=p,
        ng=ng,
        ns=ns,
        uv=uv,
        prim_id=jnp.where(hit.valid, hit.prim, -1),
        shape_id=jnp.where(hit.valid, shape_id, -1),
        bsdf_id=jnp.where(hit.valid, bsdf_id, -1),
        emitter_id=jnp.where(hit.valid, emitter_id, -1),
        bary=bary,
    )


def _perturb_normal(scene, row, bsdf_id, uv, ns):
    """Shading-normal perturbation for bumpmap/normalmap materials.

    row: the tri_shade gather (cols 23:26 = dp/du, 26:29 = dp/dv).
    Normal maps rotate the tangent-space normal into the UV-aligned TBN
    frame; bump maps displace the tangents by the finite-differenced
    height gradient and re-cross (bumpmap.cpp getFrame semantics)."""
    from ..core import math as m
    from ..core.spectrum import luminance
    from .texture import eval_texture

    mrow = scene.materials.packed[jnp.maximum(bsdf_id, 0)]
    mode = mrow[..., 28].astype(jnp.int32)
    ptex = jnp.maximum(mrow[..., 29].astype(jnp.int32), 0)
    scale = mrow[..., 30]

    dpdu = row[..., 23:26]
    dpdv = row[..., 26:29]
    ok_tb = (m.squared_length(dpdu) > 1e-20) & \
            (m.squared_length(dpdv) > 1e-20)

    # normalmap: ns' = TBN * (2*rgb - 1)
    tval = 2.0 * eval_texture(scene.textures, ptex, uv) - 1.0
    su_raw = dpdu - ns * m.dot(ns, dpdu, keepdims=True)
    su = m.normalize(jnp.where(ok_tb[..., None], su_raw, ns))
    sv = jnp.cross(ns, su)
    n_nm = m.normalize(su * tval[..., 0:1] + sv * tval[..., 1:2] +
                       ns * jnp.maximum(tval[..., 2:3], 1e-3))

    # bumpmap: displaced tangents, FD height gradient
    e = jnp.float32(5e-4)
    h0 = luminance(eval_texture(scene.textures, ptex, uv))
    eu = jnp.stack([jnp.full_like(h0, e), jnp.zeros_like(h0)], -1)
    ev = jnp.stack([jnp.zeros_like(h0), jnp.full_like(h0, e)], -1)
    hu = luminance(eval_texture(scene.textures, ptex, uv + eu))
    hv = luminance(eval_texture(scene.textures, ptex, uv + ev))
    dhdu = (hu - h0) / e * scale
    dhdv = (hv - h0) / e * scale
    n_bm = jnp.cross(dpdu + ns * dhdu[..., None],
                     dpdv + ns * dhdv[..., None])
    n_bm = m.normalize(n_bm)
    n_bm = n_bm * jnp.sign(m.dot(n_bm, ns, keepdims=True))

    use_nm = ((mode == 2) & ok_tb)[..., None]
    use_bm = ((mode == 1) & ok_tb)[..., None]
    return jnp.where(use_nm, n_nm, jnp.where(use_bm, n_bm, ns))


def material_params(scene, has_textures: bool, bsdf_id, uv,
                    uv_footprint=None, bary=None):
    """Gather BSDF params, resolving reflectance textures when present.

    has_textures is a STATIC bitmask (scene.compile_scene): bit 0 = any
    textures bound, bit 1 = textured mask opacity, bit 2 = blend BSDFs
    present, bit 3 = textured blend weight, bit 4 = woven-cloth (irawan)
    BSDFs present.  Untextured/blend-free scenes skip all the extra
    gathers."""
    from . import bsdf as bsdf_ops
    bits = int(has_textures)
    mid = jnp.maximum(bsdf_id, 0)

    def gather(ids):
        albedo = op = None
        if bits & 1:
            from .texture import resolve_albedo
            albedo = resolve_albedo(scene, ids, uv, uv_footprint, bary)
        if bits & 2:
            from .texture import resolve_opacity
            op = resolve_opacity(scene, ids, uv, bary)
        pg = bsdf_ops.gather_params(scene.materials, ids,
                                    albedo_override=albedo,
                                    opacity_override=op)
        if bits & 16:
            # woven-cloth (irawan) yarn-segment features: uv-stage
            # resolution, direction-independent — eval uses them for the
            # bent-cylinder specular lobe.  Needs the bary payload's
            # frame azimuth; without it cloth stays None and eval falls
            # back to the diffuse term (documented in PARITY.md).
            if bary is not None:
                from .irawan import resolve_features
                pg = pg._replace(cloth=resolve_features(
                    scene, ids, uv, bary))
        return pg

    p = gather(mid)
    if bits & 4:
        # wrapper BSDFs (BLEND / COATING): resolve child rows so
        # eval/pdf/sample can recurse one level (materials.{BLEND,COATING})
        from ..scene.materials import BLEND, COATING
        is_b = p.kind == BLEND
        is_c = p.kind == COATING
        wrap = is_b | is_c
        c0 = jnp.where(wrap, p.child0, mid)
        c1 = jnp.where(is_b, p.child1, mid)
        pa = gather(c0)
        pb = gather(c1)
        w = jnp.where(is_b, p.blend_w, 0.0)
        if bits & 8:  # textured blend weight
            from .texture import resolve_blend_weight
            w = jnp.where(is_b, resolve_blend_weight(scene, mid, uv, bary),
                          w)
        return pa._replace(blend=pb, blend_w=w, coat=is_c,
                           coat_eta=jnp.maximum(p.eta[..., 0], 1.0 + 1e-4),
                           coat_sigma=p.transmittance,
                           coat_spec=p.specular,
                           coat_alpha=jnp.where(is_c, p.alpha_v, 0.0),
                           coat_dist=p.dist)
    return p


def primary_uv_footprint(scene, W, H, d, its):
    """UV-space area of one pixel's footprint at a camera-ray hit — the
    mipmap LOD source (replaces the reference's camera-ray differentials,
    include/mitsuba/render/mipmap.h + perspective.cpp; secondary bounces
    have no differentials in either renderer and sample the finest
    level).  Pixel solid angle ~ (A_img/(W*H)) * cos^3(theta_cam);
    projected surface area = t^2 * omega / |cos(ng, d)|; converted to UV
    with the hit triangle's uv-per-world-area density (tri_shade col 22).
    """
    cam = scene.camera
    fwd = cam.to_world[:3, 2]
    x0 = m.transform_point(cam.sample_to_camera,
                           jnp.array([0.0, 0.0, 0.0]))
    x1 = m.transform_point(cam.sample_to_camera,
                           jnp.array([1.0, 1.0, 0.0]))
    a_img = jnp.abs((x1[0] / x1[2] - x0[0] / x0[2]) *
                    (x1[1] / x1[2] - x0[1] / x0[2]))
    cos_cam = jnp.maximum(m.dot(d, jnp.broadcast_to(fwd, d.shape)), 1e-6)
    omega = (a_img / (W * H)) * cos_cam ** 3
    cos_hit = jnp.maximum(jnp.abs(m.dot(its.ng, d)), 1e-4)
    area = jnp.where(its.valid, its.t, 0.0) ** 2 * omega / cos_hit
    prim = jnp.clip(its.prim_id, 0, scene.geom.tri_shade.shape[0] - 1)
    uvd = scene.geom.tri_shade[prim, 22]
    # analytic-sphere lanes: no uv-density row; sample the finest level
    uvd = jnp.where(its.prim_id >= SPHERE_PRIM_BASE, 0.0, uvd)
    return area * uvd


def primary_uv_jacobian(scene, W, H, d, its):
    """Footprint ellipse axes in UV space at primary hits — the input to
    the anisotropic (EWA-class) texture filter (ops/texture.py).

    The pixel's solid-angle disk is projected onto the hit tangent
    plane: major axis along the in-plane projection of the view ray
    (1/|cos| grazing elongation), minor axis perpendicular — the two
    dominant anisotropy sources (grazing incidence + UV stretch, via the
    dual basis of the triangle's dp/du, dp/dv).  Deviation from the
    reference's ray-differential EWA (mipmap.h): perspective divergence
    anisotropy within a pixel is ignored (it is O(pixel/film) and the
    fixed-tap filter clamps anisotropy at 8 anyway)."""
    cam = scene.camera
    fwd = cam.to_world[:3, 2]
    x0 = m.transform_point(cam.sample_to_camera,
                           jnp.array([0.0, 0.0, 0.0]))
    x1 = m.transform_point(cam.sample_to_camera,
                           jnp.array([1.0, 1.0, 0.0]))
    a_img = jnp.abs((x1[0] / x1[2] - x0[0] / x0[2]) *
                    (x1[1] / x1[2] - x0[1] / x0[2]))
    cos_cam = jnp.maximum(m.dot(d, jnp.broadcast_to(fwd, d.shape)), 1e-6)
    omega = (a_img / (W * H)) * cos_cam ** 3
    cos_hit = jnp.maximum(jnp.abs(m.dot(its.ng, d)), 1e-2)
    area_w = jnp.where(its.valid, its.t, 0.0) ** 2 * omega / cos_hit
    r = jnp.sqrt(area_w * cos_hit / jnp.pi)

    ng = its.ng
    dir_t = d - ng * m.dot(ng, d, keepdims=True)
    lt = jnp.sqrt(m.squared_length(dir_t))
    # normal incidence: any tangent direction works
    fallback = m.build_frame(ng)[0]
    dir_maj = jnp.where((lt > 1e-6)[..., None],
                        dir_t / jnp.maximum(lt, 1e-6)[..., None], fallback)
    a1 = dir_maj * (r / cos_hit)[..., None]           # [N, 3]
    a2 = jnp.cross(ng, dir_maj) * r[..., None]

    row = scene.geom.tri_shade[
        jnp.clip(its.prim_id, 0, scene.geom.tri_shade.shape[0] - 1)]
    dpdu = row[..., 23:26]
    dpdv = row[..., 26:29]
    E = m.dot(dpdu, dpdu)
    F = m.dot(dpdu, dpdv)
    G2 = m.dot(dpdv, dpdv)
    det = E * G2 - F * F
    inv_det = jnp.where(jnp.abs(det) > 1e-20, 1.0 / det, 0.0)

    def to_uv(a):
        bu = m.dot(dpdu, a)
        bv = m.dot(dpdv, a)
        return ((G2 * bu - F * bv) * inv_det,
                (E * bv - F * bu) * inv_det)

    du1, dv1 = to_uv(a1)
    du2, dv2 = to_uv(a2)
    return jnp.stack([jnp.stack([du1, du2], -1),
                      jnp.stack([dv1, dv2], -1)], -2)  # [N, 2, 2]


def offset_ray_origin(p, ng, d, eps):
    """Spawn-point offset along the geometric normal, signed toward the ray
    direction (replaces Mitsuba's Epsilon-scaled mint handling)."""
    sign = jnp.sign(m.dot(ng, d, keepdims=True))
    return p + ng * sign * eps
