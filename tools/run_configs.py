"""Run the five BASELINE.json benchmark configs end-to-end and report.

    python tools/run_configs.py [--size 128] [--spp 32] [--ref-spp 2048]

Per config: renders, reconstructs where gradient-domain, computes relMSE
against a long-run plain-PT reference of the same scene (BASELINE.md
protocol: relMSE = mean((I-R)^2 / (R^2 + eps)), eps = 1e-2*mean(R)^2),
and prints one table row.  Config #5 uses the procedural large scene
(tools/bench_large.py) and, on CPU backends with
--xla_force_host_platform_device_count, the multi-chip tile renderer.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np


def relmse(img, ref):
    eps = 1e-2 * float(np.mean(ref)) ** 2
    return float(np.mean((img - ref) ** 2 / (ref ** 2 + eps)))


def render_ref(scene, st, spp):
    import jax
    from gradientdomain_mitsuba_tpu.models.path import PathTracer
    pt = PathTracer(scene, st)
    return np.asarray(pt.render(scene, seed=999, spp=spp))


def run_gd(scene_path, integrator, mode, over, spp, ref_spp, label,
           results=None):
    """One gradient-domain config: relMSE vs a long PT reference at
    EQUAL SPP (vs the same-spp plain-PT render) and at EQUAL TIME (vs a
    plain-PT render given the same wall-clock budget as render +
    reconstruct) — the papers' protocol (SURVEY §7 rows 1 & 5).  Both
    L1 and L2 reconstructions are reported from the same buffers."""
    import jax
    from gradientdomain_mitsuba_tpu.models import poisson
    from gradientdomain_mitsuba_tpu.models.path import PathTracer
    from gradientdomain_mitsuba_tpu.scene import scene as sc

    scene, st = sc.load_scene(scene_path, over)
    scene = jax.device_put(scene)
    ref = render_ref(scene, st, ref_spp)

    if integrator == "gpt":
        from gradientdomain_mitsuba_tpu.models.gpt import GPTracer
        tracer = GPTracer(scene, st)
    else:
        from gradientdomain_mitsuba_tpu.models.gbdpt import GBDPTracer
        tracer = GBDPTracer(scene, st)
    # warm compile BOTH stages (render and the reconstructs) so the
    # timed wall below is steady-state device time, not XLA compiles
    warm = tracer.render(scene, seed=0, spp=spp)
    for m in ("L1", "L2"):
        np.asarray(poisson.reconstruct(warm, alpha=0.2, mode=m))
    t0 = time.time()
    bufs = tracer.render(scene, seed=1, spp=spp)
    final_main = np.asarray(poisson.reconstruct(bufs, alpha=0.2, mode=mode))
    wall = time.time() - t0
    other = "L1" if mode == "L2" else "L2"
    finals = {mode: final_main,
              other: np.asarray(poisson.reconstruct(bufs, alpha=0.2,
                                                    mode=other))}
    primal = np.asarray(bufs["primal"]) + np.asarray(bufs["very_direct"])

    # plain PT at EQUAL SPP (also the probe for the per-spp rate)
    pt = PathTracer(scene, st)
    pt.render(scene, seed=0, spp=spp)                   # warm compile
    t0 = time.time()
    img_pt_spp = np.asarray(pt.render(scene, seed=1, spp=spp))
    wall_pt = time.time() - t0
    # plain PT at EQUAL TIME: same wall budget as GD render+reconstruct
    spp_eq = max(1, int(round(spp * wall / max(wall_pt, 1e-9))))
    t0 = time.time()
    img_pt_time = np.asarray(pt.render(scene, seed=2, spp=spp_eq))
    wall_pt_eq = time.time() - t0

    r_fin = relmse(finals[mode], ref)
    row = {
        "label": label, "integrator": integrator, "mode": mode,
        "spp": spp, "wall_s": round(wall, 3),
        "relmse_final_L1": relmse(finals["L1"], ref),
        "relmse_final_L2": relmse(finals["L2"], ref),
        "relmse_primal": relmse(primal, ref),
        "relmse_pt_equal_spp": relmse(img_pt_spp, ref),
        "pt_equal_time_spp": spp_eq,
        "pt_equal_time_wall_s": round(wall_pt_eq, 3),
        "relmse_pt_equal_time": relmse(img_pt_time, ref),
    }
    row["gain_equal_spp"] = row["relmse_pt_equal_spp"] / max(r_fin, 1e-12)
    row["gain_equal_time"] = (row["relmse_pt_equal_time"] /
                              max(r_fin, 1e-12))
    if results is not None:
        results.append(row)
    print(f"{label:40s} {wall:7.2f}s  relMSE {r_fin:.5f}  "
          f"PT@spp {row['relmse_pt_equal_spp']:.5f} "
          f"(gain {row['gain_equal_spp']:.1f}x)  "
          f"PT@time[{spp_eq}spp] {row['relmse_pt_equal_time']:.5f} "
          f"(gain {row['gain_equal_time']:.1f}x)")
    return r_fin < row["relmse_pt_equal_spp"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--ref-spp", type=int, default=2048)
    ap.add_argument("--json", type=str, default=None,
                    help="write per-config results as JSON")
    args = ap.parse_args()

    sz = {"width": str(args.size), "height": str(args.size)}
    data = os.path.join(ROOT, "data/scenes")
    ok = []
    results = []

    # 1: G-PT Cornell box, L2
    ok.append(run_gd(os.path.join(data, "cbox/cbox.xml"), "gpt", "L2",
                     dict(sz, spp=str(args.spp), maxDepth="6",
                          integrator="gpt"),
                     args.spp, args.ref_spp,
                     "#1 G-PT cbox L2", results))
    # 2: G-PT Veach-door-class interior (glossy metal door + thin-glass
    #    insert, light only in the far room), L1 — data/scenes/door
    ok.append(run_gd(os.path.join(data, "door/door.xml"),
                     "gpt", "L1",
                     dict(sz, spp=str(args.spp), maxDepth="8",
                          integrator="gpt"),
                     args.spp, args.ref_spp,
                     "#2 G-PT Veach door L1", results))
    # 3: G-BDPT caustic scene (glass+mirror spheres, small bright
    #    emitter; t=1 light tracing dominates) — data/scenes/caustics
    ok.append(run_gd(os.path.join(data, "caustics/caustics.xml"),
                     "gbdpt", "L1",
                     dict(sz, spp=str(max(args.spp // 2, 4)),
                          maxDepth="8", integrator="gbdpt"),
                     max(args.spp // 2, 4), args.ref_spp,
                     "#3 G-BDPT caustics L1", results))
    # 4: envmap + textured rough BSDFs + DoF
    ok.append(run_gd(os.path.join(data, "envmap/envmap.xml"), "gpt", "L1",
                     dict(sz, spp=str(args.spp), maxDepth="6",
                          integrator="gpt"),
                     args.spp, args.ref_spp,
                     "#4 G-PT envmap+textures+DoF L1", results))

    # 5: large instanced BVH — data/scenes/forest (~3.2M tris after
    #    instance baking); scalable via --forest-tris using the
    #    procedural bench_large scene instead
    import copy
    import jax
    from gradientdomain_mitsuba_tpu.scene import scene as sc
    from gradientdomain_mitsuba_tpu.models.path import PathTracer
    t0 = time.time()
    scene, st = sc.load_scene(
        os.path.join(data, "forest/forest.xml"),
        dict(sz, spp="4", maxDepth="5"))
    build_s = time.time() - t0
    scene_d = jax.device_put(scene)
    pt = PathTracer(scene_d, st)
    pt.count_rays = True  # measured device-side counters, not a formula
    img = pt.render(scene_d, seed=0, spp=4, chunk=4)
    t0 = time.time()
    img = pt.render(scene_d, seed=1, spp=4, chunk=4)
    wall = time.time() - t0
    rays = getattr(pt, "last_ray_count",
                   args.size * args.size * 4 * (1 + 4 * 2))
    n_dev = jax.device_count()
    multi = ""
    if n_dev > 1:
        from gradientdomain_mitsuba_tpu.parallel import tiles
        mesh = tiles.make_mesh()
        from gradientdomain_mitsuba_tpu.models.gpt import GPTracer
        st2 = copy.deepcopy(st)
        st2.integrator = "gpt"
        gt = GPTracer(scene_d, st2)
        bufs = tiles.render_tiles_gpt(gt, scene_d, mesh, seed=0,
                                      n_samples=4)
        multi = (f"; multi-chip({n_dev}) tiles OK"
                 if all(np.isfinite(v).all() for v in bufs.values())
                 else f"; multi-chip({n_dev}) NONFINITE")
    sane = bool(np.isfinite(np.asarray(img)).all() and
                np.asarray(img).mean() > 1e-3)
    n_tris = int(scene.geom.indices.shape[0])
    # forest quality evidence: relMSE of the 4-spp
    # render against a longer plain-PT reference of the SAME scene, plus
    # the mean ratio (estimator consistency — must be ~1)
    f_ref_spp = int(os.environ.get("GDMT_FOREST_REF_SPP", "64"))
    ref_f = np.asarray(pt.render(scene_d, seed=999, spp=f_ref_spp,
                                 chunk=4))
    r_forest = relmse(np.asarray(img), ref_f)
    mean_ratio = float(np.asarray(img).mean() / max(ref_f.mean(), 1e-12))
    print(f"{'#5 forest (' + str(n_tris) + ' tris) PT':44s} "
          f"{wall:7.2f}s  {rays/wall/1e6:6.1f} Mrays/s  build {build_s:.0f}s"
          f"  finite+lit {sane}  relMSE@4spp(vs {f_ref_spp}spp) "
          f"{r_forest:.4f}  mean-ratio {mean_ratio:.4f}{multi}")
    ok.append(sane and abs(mean_ratio - 1.0) < 0.05)
    results.append({
        "label": "#5 forest 3M-tri PT", "integrator": "path",
        "n_tris": n_tris, "wall_s": round(wall, 3),
        "mrays_per_sec": round(rays / wall / 1e6, 3),
        "scene_prep_s": round(build_s, 1), "finite_and_lit": sane,
        "relmse_4spp_vs_ref": r_forest, "ref_spp": f_ref_spp,
        "mean_ratio_vs_ref": mean_ratio,
        "multichip": multi.strip("; ")})

    if args.json:
        import json as _json
        import platform
        import jax as _jax
        payload = {
            "size": args.size, "spp": args.spp, "ref_spp": args.ref_spp,
            "backend": _jax.default_backend(),
            "device": str(_jax.devices()[0]),
            "configs": results,
        }
        with open(args.json, "w") as f:
            _json.dump(payload, f, indent=1)
        print(f"wrote {args.json}")

    print("PASS" if all(ok) else "SOME CONFIGS REGRESSED", flush=True)


if __name__ == "__main__":
    main()
