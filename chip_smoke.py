#!/usr/bin/env python3
"""GPU smoke test: the renderer's main path on one card, phase by phase.

    python chip_smoke.py            # phases 1-8 on one GPU
    python chip_smoke.py --multi    # tile-parallel G-PT/G-BDPT on 4 GPUs

Phases (one process, one card; the first failure ends the run with a
non-zero exit code and no result line):

  1 device         a GPU is present (no CPU fallback); card name and power
                   limit, JAX version, compile-cache directory
  2 kernels        the small-scene sweep kernel and the large-scene SoA
                   stack traversal against intersect_brute at real widths,
                   with timings of the plain forms beside them
  3 precision      core.math.transform_point at forest-scale coordinates
                   against float64 (fails if the transform runs in TF32)
  4 gpt            cbox G-PT 256^2, 64 spp, L1 reconstruction
                   (GPTracer.render_final); primal + very_direct == path
  5 gbdpt          cbox G-BDPT 128^2 + poisson.reconstruct; gbdpt == bdpt
  6 forest         the 3.08M-triangle forest through PathTracer, 256^2 x 16
  7 cli            tpurender (utils.cli.main) on cbox, gpt, 64^2
  8 cpu-agreement  a 64^2 G-PT render on the card against the same seed
                   rendered by a JAX_PLATFORMS=cpu subprocess

The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")
FOREST = os.path.join(ROOT, "data/scenes/forest/forest.xml")


class PhaseFailed(Exception):
    pass


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)
    log(f"  ok: {msg}")


def block(x):
    import jax
    return jax.block_until_ready(x)


def timed(fn, *args, reps=3):
    """(median seconds, last result) of fn(*args) after one warm-up call;
    every call ends in block_until_ready."""
    out = block(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = block(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def peak_gb(dev=None):
    import jax
    dev = dev or jax.devices()[0]
    return dev.memory_stats()["peak_bytes_in_use"] / 1e9


def load(path, **variables):
    from gradientdomain_mitsuba_tpu.scene import scene as sc
    return sc.load_scene(path, {k: str(v) for k, v in variables.items()})


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device(ctx):
    import jax
    devs = jax.devices()
    d = devs[0]
    log(f"  jax {jax.__version__}, devices: {len(devs)} x {d.platform} "
        f"({d.device_kind})")
    check(d.platform == "gpu", f"platform is gpu (got {d.platform!r})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, "nvidia-smi answers")
    for line in smi.stdout.strip().splitlines():
        log(f"  card: {line.strip()}")
    ctx["card"] = smi.stdout.strip().splitlines()[0].strip()
    import gradientdomain_mitsuba_tpu as pkg
    from gradientdomain_mitsuba_tpu.utils import jaxconfig
    check(os.path.dirname(os.path.abspath(pkg.__file__)).startswith(ROOT),
          f"package imported from this checkout ({pkg.__file__})")
    log(f"  compile cache: {jaxconfig.cache_dir()}")
    ctx["device"] = {"platform": d.platform, "kind": d.device_kind,
                     "count": len(devs)}


# ---------------------------------------------------------------------------
# 2. kernels
# ---------------------------------------------------------------------------

# Traversal agreement bounds against intersect_brute.  Hits that differ
# are ties at edges shared by two triangles (or grazing hits) where the
# linear-MT / FMA arithmetic rounds differently from the brute
# Moeller-Trumbore; they are rare, not zero.
VALID_AGREE = 0.999   # valid flags agree on >= 99.9% of rays
PRIM_AGREE = 0.999    # prim equal on >= 99.9% of rays where both hit
T_RTOL = 1e-5         # t agrees to rtol 1e-5 where the prims match


def _compare_hits(name, got, ref):
    gv, rv = np.asarray(got.valid), np.asarray(ref.valid)
    va = float((gv == rv).mean())
    both = gv & rv
    gp, rp = np.asarray(got.prim)[both], np.asarray(ref.prim)[both]
    pa = float((gp == rp).mean()) if both.any() else 1.0
    same = both.copy()
    same[both] = gp == rp
    gt, rt = np.asarray(got.t)[same], np.asarray(ref.t)[same]
    terr = float(np.max(np.abs(gt - rt) / np.maximum(np.abs(rt), 1e-30))) \
        if same.any() else 0.0
    log(f"  {name}: valid agree {va:.6f} (>= {VALID_AGREE}), prim agree "
        f"{pa:.6f} (>= {PRIM_AGREE}), max t rel err {terr:.2e} "
        f"(<= {T_RTOL}), hit rate {rv.mean():.3f}")
    check(va >= VALID_AGREE and pa >= PRIM_AGREE and terr <= T_RTOL,
          f"{name} matches intersect_brute")


def _compare_occ(name, got, ref):
    a = float((np.asarray(got) == np.asarray(ref)).mean())
    log(f"  {name}: occluded agree {a:.6f} (>= {VALID_AGREE}), "
        f"occluded rate {np.asarray(ref).mean():.3f}")
    check(a >= VALID_AGREE, f"{name} matches occluded_brute")


def _random_rays(rs, n, lo, hi, tmax):
    import jax.numpy as jnp
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    maxt = np.full(n, tmax, np.float32)
    maxt[::16] = -1.0  # dead wavefront lanes
    return (jnp.asarray(o), jnp.asarray(d), jnp.zeros(n, jnp.float32),
            jnp.asarray(maxt))


def _soup(rs, T, size=0.08):
    from gradientdomain_mitsuba_tpu.ops import intersect as isec
    import jax.numpy as jnp
    v0 = rs.uniform(0, 1, (T, 3)).astype(np.float32)
    e1 = rs.normal(0, size, (T, 3)).astype(np.float32)
    e2 = rs.normal(0, size, (T, 3)).astype(np.float32)
    tris = isec.TriSoup(v0=jnp.asarray(v0), e1=jnp.asarray(e1),
                        e2=jnp.asarray(e2),
                        orig_id=jnp.arange(T, dtype=jnp.int32))
    return tris, jnp.asarray(isec.build_linear_mt(v0, e1, e2))


def phase_kernels(ctx):
    import jax
    import jax.numpy as jnp
    from gradientdomain_mitsuba_tpu.ops import intersect as isec
    from gradientdomain_mitsuba_tpu.ops import pallas_sweep as psw

    rs = np.random.RandomState(0)
    scene, st = load(CBOX, width=256, height=256, spp=64, maxDepth=6,
                     integrator="gpt")
    scene = jax.device_put(scene)
    ctx["cbox"] = (scene, st)
    n_cbox = int(scene.geom.indices.shape[0])
    rand_tris, rand_linC = _soup(rs, 2048)
    g = scene.geom
    cbox_linC = jnp.asarray(isec.build_linear_mt(
        *(np.asarray(a) for a in (g.tris.v0, g.tris.e1, g.tris.e2))))
    soups = [("cbox", n_cbox, g.tris, cbox_linC, 0.0, 560.0, 900.0),
             ("soup2048", 2048, rand_tris, rand_linC, 0.0, 1.0, 1.5)]
    timings = {}
    brute_c = jax.jit(lambda o, d, a, b, tr: isec.intersect_brute(
        o, d, a, b, tr, chunk=256))
    brute_o = jax.jit(lambda o, d, a, b, tr: isec.occluded_brute(
        o, d, a, b, tr, chunk=256))
    mm_c = jax.jit(isec.intersect_matmul)
    mm_o = jax.jit(isec.occluded_matmul)
    for name, T, tris, linC, lo, hi, occ_t in soups:
        sweep_c = jax.jit(psw.make_sweep_intersector(T))
        sweep_o = jax.jit(psw.make_sweep_occluder(T))
        for n in (1 << 18, 1 << 20):
            tag = f"{name} T={T} N={n}"
            f_gb = n * linC.shape[1] * 4 / 1e9
            for kind in ("closest", "occluded"):
                rays = _random_rays(rs, n, lo, hi,
                                    3e38 if kind == "closest" else occ_t)
                k_fn, b_fn, m_fn = ((sweep_c, brute_c, mm_c)
                                    if kind == "closest" else
                                    (sweep_o, brute_o, mm_o))
                t_k, hk = timed(k_fn, *rays, tris)
                t_b, hb = timed(b_fn, *rays, tris, reps=1)
                if kind == "closest":
                    _compare_hits(f"sweep closest [{tag}]", hk, hb)
                else:
                    _compare_occ(f"sweep occluded [{tag}]", hk, hb)
                line = (f"  time {kind} [{tag}]: sweep kernel "
                        f"{t_k * 1e3:.3f} ms, brute {t_b * 1e3:.3f} ms")
                timings[(name, n, kind, "sweep")] = t_k
                timings[(name, n, kind, "brute")] = t_b
                if f_gb <= 8.0:
                    t_m, _ = timed(m_fn, *rays, linC)
                    timings[(name, n, kind, "matmul")] = t_m
                    line += f", matmul {t_m * 1e3:.3f} ms"
                else:
                    line += (f", matmul not run (its [N, 4T] term matrix "
                             f"would take {f_gb:.0f} GB)")
                log(line)
    wins = all(v < min(w for k2, w in timings.items()
                       if k2[:3] == k[:3] and k2[3] != "sweep")
               for k, v in timings.items() if k[3] == "sweep")
    log(f"  traversal-level choice for scenes <= 2048 tris: "
        f"{'the sweep kernel' if wins else 'not the sweep kernel'} is "
        f"fastest at every measured width")

    # large scenes: SoA stack traversal on the forest
    t0 = time.time()
    fscene, fst = load(FOREST, width=256, height=256, spp=16, maxDepth=5)
    prep = time.time() - t0
    fscene = jax.device_put(fscene)
    ctx["forest"] = (fscene, fst, prep)
    g = fscene.geom
    n_f = int(g.indices.shape[0])
    lo = np.asarray(g.positions).min(0)
    hi = np.asarray(g.positions).max(0)
    hi_o = lo + (hi - lo) * np.array([1.0, 0.3, 1.0])  # below the canopy tops
    log(f"  forest: {n_f} tris, prep {prep:.1f} s, BVH stack depth "
        f"{fst.stack_depth}")
    soa_c = jax.jit(lambda o, d, a, b, tr, bvh: isec.make_bvh_intersector_soa(
        fst.stack_depth)(o, d, a, b, tr, bvh))
    soa_o = jax.jit(lambda o, d, a, b, tr, bvh: isec.make_bvh_occluder_soa(
        fst.stack_depth)(o, d, a, b, tr, bvh))
    brute_c = jax.jit(lambda o, d, a, b, tr: isec.intersect_brute(
        o, d, a, b, tr, chunk=2048))
    brute_o = jax.jit(lambda o, d, a, b, tr: isec.occluded_brute(
        o, d, a, b, tr, chunk=2048))
    occ_t = float(np.linalg.norm(hi - lo)) * 0.25
    n = 1 << 14
    rays = _random_rays(rs, n, lo, hi_o, 3e38)
    t_b, hb = timed(brute_c, *rays, g.tris, reps=1)
    t_s, hs = timed(soa_c, *rays, g.tris, g.bvh)
    _compare_hits(f"SoA closest [forest N={n}]", hs, hb)
    log(f"  time closest [forest N={n}]: SoA {t_s * 1e3:.3f} ms, "
        f"brute {t_b * 1e3:.3f} ms")
    rays = _random_rays(rs, n, lo, hi_o, occ_t)
    _, ob_ = timed(brute_o, *rays, g.tris, reps=1)
    _, os_ = timed(soa_o, *rays, g.tris, g.bvh)
    _compare_occ(f"SoA occluded [forest N={n}]", os_, ob_)
    n = 1 << 20
    t_s, _ = timed(soa_c, *_random_rays(rs, n, lo, hi_o, 3e38), g.tris,
                   g.bvh)
    t_so, _ = timed(soa_o, *_random_rays(rs, n, lo, hi_o, occ_t), g.tris,
                    g.bvh)
    live = n - n // 16
    log(f"  time SoA [forest N={n}, {live} live rays]: closest "
        f"{t_s * 1e3:.3f} ms ({live / t_s / 1e6:.3f} Mrays/s), occluded "
        f"{t_so * 1e3:.3f} ms ({live / t_so / 1e6:.3f} Mrays/s)")


# ---------------------------------------------------------------------------
# 3. precision
# ---------------------------------------------------------------------------

def phase_precision(ctx):
    import jax
    import jax.numpy as jnp
    from gradientdomain_mitsuba_tpu.core import math as m
    fscene = ctx["forest"][0] if "forest" in ctx else None
    rs = np.random.RandomState(1)
    if fscene is not None:
        M = np.asarray(fscene.camera.world_to_camera, np.float64)
    else:
        M = m.np_look_at([2100, 700, -900], [2100, 150, 2100], [0, 1, 0])
        M = np.linalg.inv(M)
    p = rs.uniform([0, 0, 0], [4200, 600, 4200], (1 << 16, 3))
    ref = (p @ M[:3, :3].T + M[:3, 3]) / (p @ M[3, :3] + M[3, 3])[:, None]
    got = np.asarray(jax.jit(m.transform_point)(
        jnp.asarray(M, jnp.float32), jnp.asarray(p, jnp.float32)))
    rel = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
    # the same product through a default-precision matmul, for contrast
    dflt = np.asarray(jax.jit(lambda a, b: b @ a[:3, :3].T + a[:3, 3])(
        jnp.asarray(M, jnp.float32), jnp.asarray(p, jnp.float32)))
    rel_d = float(np.max(np.abs(dflt - ref)) / np.max(np.abs(ref)))
    log(f"  transform_point at |p| <= {np.abs(p).max():.0f}: max rel err "
        f"{rel:.2e}; a default-precision matmul gives {rel_d:.2e}")
    check(rel <= 1e-6, "transform_point within 1e-6 relative of float64")


# ---------------------------------------------------------------------------
# 4. gpt
# ---------------------------------------------------------------------------

def phase_gpt(ctx):
    import jax
    from gradientdomain_mitsuba_tpu.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu.models.path import PathTracer
    scene, st = ctx.get("cbox") or load(CBOX, width=256, height=256, spp=64,
                                        maxDepth=6, integrator="gpt")
    scene = jax.device_put(scene)
    spp = 64
    tracer = GPTracer(scene, st)
    tracer.count_rays = True
    t0 = time.time()
    block(tracer.render_final(scene, 0, spp, alpha=0.2, mode="L1"))
    log(f"  compile + first render: {time.time() - t0:.1f} s")
    t0 = time.perf_counter()
    final, bufs = block(tracer.render_final(scene, 1, spp, alpha=0.2,
                                            mode="L1"))
    wall = time.perf_counter() - t0
    rays = float(bufs["rays"])
    log(f"  warm render + L1 reconstruction, {st.width}x{st.height} @ "
        f"{spp} spp, "
        f"maxDepth 6: {wall:.3f} s, {rays:.0f} rays (device counter), "
        f"{rays / wall / 1e6:.3f} Mrays/s, peak device memory "
        f"{peak_gb():.3f} GB [{ctx.get('card', '?')}]")
    final = np.asarray(final)
    H, W = st.height, st.width
    check(final.shape == (H, W, 3) and np.isfinite(final).all(),
          f"final image finite, {H}x{W}x3")
    left = final[H // 4:3 * H // 4, W // 32:W * 5 // 32].mean((0, 1))
    right = final[H // 4:3 * H // 4, W * 27 // 32:W * 31 // 32].mean((0, 1))
    log(f"  left wall rgb {left}, right wall rgb {right}")
    check(left[0] > 1.5 * left[1] and left[0] > 1.5 * left[2],
          "left wall is red")
    check(right[1] > 1.5 * right[0] and right[1] > 1.5 * right[2],
          "right wall is green")
    # primal + very_direct == path for the same seed (same counters).
    # Russian roulette is off for this check: the two tracers draw the RR
    # decision at different sample dimensions, so with it on they agree in
    # expectation only.
    import copy
    st_id = copy.deepcopy(st)
    st_id.rr_depth = st.max_depth + 1
    ispp = 4
    out = GPTracer(scene, st_id).render(scene, seed=1, spp=ispp, chunk=ispp)
    path = PathTracer(scene, st_id).render(scene, seed=1, spp=ispp)
    _identity("primal + very_direct vs path",
              out["primal"] + out["very_direct"], path)


def _identity(name, got, ref):
    """Both sides sum the same per-lane terms; on the H100 the gap has
    read exactly 0 with every pixel within bound, so the slack left is
    for summation order only: 1 in 1e4 pixels, a mean gap of 1e-6."""
    mean_rel = abs(got.mean() / ref.mean() - 1.0)
    close = float(np.mean(np.all(np.abs(got - ref) <=
                                 2e-4 + 2e-3 * np.abs(ref), -1)))
    log(f"  {name}: mean rel diff {mean_rel:.2e} (<= 1e-6), pixels within "
        f"2e-4 + 2e-3*|ref|: {close:.5f} (>= 0.9999)")
    check(mean_rel <= 1e-6 and close >= 0.9999, f"{name}: identity holds")


# ---------------------------------------------------------------------------
# 5. gbdpt
# ---------------------------------------------------------------------------

def phase_gbdpt(ctx):
    import jax
    from gradientdomain_mitsuba_tpu.models import poisson
    from gradientdomain_mitsuba_tpu.models.bdpt import BDPTracer
    from gradientdomain_mitsuba_tpu.models.gbdpt import GBDPTracer
    scene, st = load(CBOX, width=128, height=128, spp=16, maxDepth=6,
                     integrator="gbdpt")
    scene = jax.device_put(scene)
    spp = 16
    g = GBDPTracer(scene, st)
    t0 = time.time()
    out = g.render(scene, seed=0, spp=spp, chunk=spp)
    t_r = time.time() - t0
    t0 = time.perf_counter()
    g.render(scene, seed=1, spp=spp, chunk=spp)
    wall = time.perf_counter() - t0
    final = np.asarray(block(poisson.reconstruct(out, alpha=0.2,
                                                 mode="L1")))
    log(f"  G-BDPT 128x128 @ {spp} spp, maxDepth 6: compile + first "
        f"render {t_r:.1f} s, warm render {wall:.3f} s, peak device "
        f"memory {peak_gb():.3f} GB [{ctx.get('card', '?')}]")
    check(np.isfinite(final).all() and all(
        np.isfinite(v).all() for v in out.values()),
        "gbdpt buffers and reconstruction finite")
    # the identity tests/test_bdpt.py holds on the CPU: gbdpt primal +
    # very_direct == bdpt at one seed (both walk the same subpaths, Russian
    # roulette included), bounded for the card's order of summation
    b = BDPTracer(scene, st).render(scene, seed=0, spp=spp, chunk=spp)
    _identity("gbdpt primal + very_direct vs bdpt",
              out["primal"] + out["very_direct"], b)


# ---------------------------------------------------------------------------
# 6. forest
# ---------------------------------------------------------------------------

def phase_forest(ctx):
    import jax
    from gradientdomain_mitsuba_tpu.models.path import PathTracer
    if "forest" in ctx:
        fscene, fst, prep = ctx["forest"]
    else:
        t0 = time.time()
        fscene, fst = load(FOREST, width=256, height=256, spp=16,
                           maxDepth=5)
        prep = time.time() - t0
        fscene = jax.device_put(fscene)
    table_gb = sum(x.nbytes for x in jax.tree.leaves(fscene)) / 1e9
    spp = 16
    tracer = PathTracer(fscene, fst)
    tracer.count_rays = True
    t0 = time.time()
    tracer.render(fscene, seed=0, spp=spp, chunk=spp)
    log(f"  compile + first render: {time.time() - t0:.1f} s")
    t0 = time.perf_counter()
    img = tracer.render(fscene, seed=1, spp=spp, chunk=spp)
    wall = time.perf_counter() - t0
    rays = float(tracer.last_ray_count)
    log(f"  forest {int(fscene.geom.indices.shape[0])} tris, 256x256 @ "
        f"{spp} spp, maxDepth 5, SoA traversal: {wall:.3f} s, {rays:.0f} "
        f"rays, {rays / wall / 1e6:.3f} Mrays/s, scene tables "
        f"{table_gb:.3f} GB, scene prep {prep:.1f} s, peak device memory "
        f"{peak_gb():.3f} GB [{ctx.get('card', '?')}]")
    check(img.shape == (fst.height, fst.width, 3) and np.isfinite(img).all()
          and img.mean() > 0, "forest image finite and lit")


# ---------------------------------------------------------------------------
# 7. cli
# ---------------------------------------------------------------------------

def phase_cli(ctx):
    from gradientdomain_mitsuba_tpu.utils import cli, exr
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cbox.exr")
        rc = cli.main([CBOX, "-o", out, "-q", "-D", "integrator=gpt",
                       "-D", "width=64", "-D", "height=64", "-D", "spp=16",
                       "-D", "maxDepth=6"])
        check(rc == 0, "tpurender exits 0")
        base = out[:-4]
        for suffix in ("-primal", "-dx", "-dy", "-direct", "-final"):
            path = base + suffix + ".exr"
            check(os.path.exists(path), f"wrote {os.path.basename(path)}")
            img = exr.read_rgb(path)
            check(img.shape == (64, 64, 3) and np.isfinite(img).all(),
                  f"{os.path.basename(path)} reads back finite")


# ---------------------------------------------------------------------------
# 8. cpu-agreement
# ---------------------------------------------------------------------------

_CPU_RENDER = """
import sys, numpy as np
sys.path.insert(0, {root!r})
from gradientdomain_mitsuba_tpu.models.gpt import GPTracer
from gradientdomain_mitsuba_tpu.scene import scene as sc
import jax
assert jax.default_backend() == "cpu"
scene, st = sc.load_scene({cbox!r}, {{"width": "64", "height": "64",
                          "spp": "4", "maxDepth": "6", "integrator": "gpt"}})
out = GPTracer(scene, st).render(scene, seed=0, spp=4, chunk=4)
np.savez({path!r}, **out)
"""


def start_cpu_render(ctx):
    """The CPU half of phase 8, started early so it overlaps the card's
    phases.  JAX_PLATFORMS=cpu and no visible CUDA device: the subprocess
    never opens the card."""
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "cpu.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    code = _CPU_RENDER.format(root=ROOT, cbox=CBOX, path=path)
    ctx["cpu_job"] = (subprocess.Popen(
        [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), path)


def phase_cpu_agreement(ctx):
    import jax
    from gradientdomain_mitsuba_tpu.models.gpt import GPTracer
    scene, st = load(CBOX, width=64, height=64, spp=4, maxDepth=6,
                     integrator="gpt")
    scene = jax.device_put(scene)
    gpu = GPTracer(scene, st).render(scene, seed=0, spp=4, chunk=4)
    if "cpu_job" not in ctx:
        start_cpu_render(ctx)
    proc, path = ctx["cpu_job"]
    try:
        text, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise PhaseFailed("CPU render did not finish in 600 s")
    check(proc.returncode == 0, "CPU render subprocess exits 0"
          + ("" if proc.returncode == 0 else ":\n" + text[-3000:]))
    cpu = dict(np.load(path))
    # counter RNG replays the same paths on both backends; the hit
    # arithmetic differs (sweep kernel vs brute scan), so a few paths may
    # part ways at triangle edges
    for key in ("primal", "very_direct", "dx", "dy"):
        a, b = gpu[key], cpu[key]
        frac = float(np.mean(np.all(np.abs(a - b) <= 1e-4, -1)))
        log(f"  {key}: card mean {a.mean():.6e}, cpu mean {b.mean():.6e}, "
            f"pixels within 1e-4: {frac:.4f}")
    img_g = gpu["primal"] + gpu["very_direct"]
    img_c = cpu["primal"] + cpu["very_direct"]
    mean_rel = abs(img_g.mean() / img_c.mean() - 1.0)
    frac = float(np.mean(np.all(np.abs(img_g - img_c) <= 1e-4, -1)))
    log(f"  image: mean rel diff {mean_rel:.2e} (<= 5e-3), pixels within "
        f"1e-4: {frac:.4f} (>= 0.9)")
    check(mean_rel <= 5e-3 and frac >= 0.9, "card render matches the CPU")


# ---------------------------------------------------------------------------
# --multi: tile-parallel render over four cards
# ---------------------------------------------------------------------------

def phase_multi(ctx):
    import copy
    import jax
    from gradientdomain_mitsuba_tpu.models import poisson
    from gradientdomain_mitsuba_tpu.models.gbdpt import GBDPTracer
    from gradientdomain_mitsuba_tpu.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu.parallel import dist_poisson, tiles
    n_dev = 4
    check(len(jax.devices()) >= n_dev, f"{n_dev} GPUs visible "
          f"(got {len(jax.devices())})")
    mesh = tiles.make_mesh(n_dev)
    check(mesh.devices.size == n_dev, f"1-D mesh over {n_dev} devices")
    scene, st = load(CBOX, width=256, height=256, spp=8, maxDepth=6,
                     integrator="gpt")
    spp = 8
    g = GPTracer(scene, st)
    t0 = time.time()
    multi = tiles.render_tiles_gpt(g, scene, mesh, 3, spp)
    t_multi = time.time() - t0
    final_m = np.asarray(dist_poisson.reconstruct_sharded(
        mesh, multi, alpha=0.2, iters=100))
    peaks = [peak_gb(d) for d in mesh.devices.flat]
    log(f"  G-PT tiles over {n_dev} cards: {t_multi:.1f} s (compile "
        f"included); peak memory per card (GB): "
        f"{', '.join(f'{p:.3f}' for p in peaks)}")
    check(min(peaks) > 0.25 * max(peaks),
          "every card held a share of the film and the work")
    single = g.render(scene, seed=3, spp=spp, chunk=spp)
    final_s = np.asarray(poisson.reconstruct(single, alpha=0.2, mode="L2",
                                             l2_iters=100))
    # same seeds, same per-pixel work: buffers agree as in
    # tests/test_parallel.py; the distributed CG sums its dot products in
    # another order than the local one
    _tile_agreement("gpt", multi, single)
    rec_err = float(np.max(np.abs(final_m - final_s) /
                           (2e-3 + 1e-3 * np.abs(final_s))))
    log(f"  reconstruction: max |dist - local| / (2e-3 + 1e-3|local|) = "
        f"{rec_err:.3f} (<= 1)")
    check(rec_err <= 1.0, "distributed reconstruction matches local")

    st2 = copy.deepcopy(st)
    st2.integrator = "gbdpt"
    gb = GBDPTracer(scene, st2)
    gspp = 4
    gmulti = tiles.render_tiles_gbdpt(gb, scene, mesh, 3, gspp)
    gsingle = gb.render(scene, seed=3, spp=gspp, chunk=gspp)
    gfinal = np.asarray(dist_poisson.reconstruct_sharded(
        mesh, gmulti, alpha=0.2, iters=100))
    check(np.isfinite(gfinal).all(), "gbdpt distributed reconstruction "
          "finite")
    _tile_agreement("gbdpt", gmulti, gsingle)
    ctx["device"]["count"] = len(jax.devices())


def _tile_agreement(name, multi, single):
    """Every pixel of every buffer within 1e-5 + 1e-4|single|, the bound
    of tests/test_parallel.py: the tiles trace the same paths, so only
    rounding may differ.  All buffers are reported before the check."""
    worst = {}
    for k in single:
        ratio = (np.abs(multi[k] - single[k]) /
                 (1e-5 + 1e-4 * np.abs(single[k])))
        worst[k] = float(ratio.max())
        bad = np.argwhere(np.any(ratio > 1.0, -1))
        log(f"  {name} {k}: worst pixel at {worst[k]:.3f}x the bound "
            f"1e-5 + 1e-4|single| (<= 1); {len(bad)} pixels beyond it"
            + (f", first (row, col): {bad[:5].tolist()}" if len(bad)
               else ""))
    check(max(worst.values()) <= 1.0,
          f"{name} tiles match the single-card render in every buffer")


PHASES = [("device", phase_device), ("kernels", phase_kernels),
          ("precision", phase_precision), ("gpt", phase_gpt),
          ("gbdpt", phase_gbdpt), ("forest", phase_forest),
          ("cli", phase_cli), ("cpu-agreement", phase_cpu_agreement)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU tile-parallel path")
    ap.add_argument("--phases", default=None,
                    help="comma-separated subset of phases (device always "
                         "runs)")
    args = ap.parse_args(argv)
    if args.multi:
        phases = [PHASES[0], ("multi", phase_multi)]
    else:
        want = set(args.phases.split(",")) if args.phases else None
        phases = [p for p in PHASES
                  if want is None or p[0] == "device" or p[0] in want]
    ctx = {}
    t_all = time.time()
    for name, fn in phases:
        log(f"== phase {name}")
        t0 = time.time()
        try:
            fn(ctx)
            if name == "device" and any(p[0] == "cpu-agreement"
                                        for p in phases):
                start_cpu_render(ctx)
        except Exception as e:  # noqa: BLE001 - report, then stop
            import traceback
            traceback.print_exc()
            log(f"== phase {name} FAILED after {time.time() - t0:.1f} s: "
                f"{e!r}")
            job = ctx.get("cpu_job")
            if job:
                job[0].kill()
                job[0].communicate()
            return 1
        log(f"== phase {name} passed in {time.time() - t0:.1f} s")
    log(f"all phases passed in {time.time() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": ctx["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
