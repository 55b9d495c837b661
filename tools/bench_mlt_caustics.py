"""Equal-time MLT vs BDPT on the caustics scene.

The reference's MLT carries Veach mutations + manifold exploration
(src/libbidir/mut_*.cpp, manifold.cpp [unverifiable - mount empty]); this
framework redesigns them as coordinate-subset Kelemen kernels over a
PSSMLT-style primary-sample chain (models/mlt.py).  The caustics scene
(glass + mirror spheres, small bright emitter) is the scene class those
mutations exist for — this tool measures whether the redesign actually
pays there, honestly, at EQUAL WALL-CLOCK against bdpt on the same
hardware.

    python tools/bench_mlt_caustics.py [--size 128] [--spp 16]
                                       [--ref-spp 4096] [--json out.json]

Output: relMSE vs a long BDPT reference for (a) bdpt at --spp, (b) mlt
given the same wall-clock budget (mutations scaled by a timed probe), and
(c) erpt likewise.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np


def relmse(img, ref):
    eps = 1e-2 * float(np.mean(ref)) ** 2
    return float(np.mean((img - ref) ** 2 / (ref ** 2 + eps)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--ref-spp", type=int, default=4096)
    ap.add_argument("--json", type=str, default=None)
    args = ap.parse_args()

    import jax
    from gradientdomain_mitsuba_tpu.scene import scene as sc
    from gradientdomain_mitsuba_tpu.models.bdpt import BDPTracer
    from gradientdomain_mitsuba_tpu.models.mlt import MLTracer
    from gradientdomain_mitsuba_tpu.models.erpt import ERPTracer

    over = {"width": str(args.size), "height": str(args.size),
            "spp": str(args.spp), "maxDepth": "8", "integrator": "bdpt"}
    scene, st = sc.load_scene(
        os.path.join(ROOT, "data/scenes/caustics/caustics.xml"), over)
    scene = jax.device_put(scene)

    bd = BDPTracer(scene, st)
    print("reference: bdpt @", args.ref_spp, "spp ...", flush=True)
    ref = np.asarray(bd.render(scene, seed=99, spp=args.ref_spp))

    bd.render(scene, seed=0, spp=args.spp)            # warm compile
    t0 = time.time()
    img_bd = np.asarray(bd.render(scene, seed=1, spp=args.spp))
    wall_bd = time.time() - t0
    r_bd = relmse(img_bd, ref)
    print(f"bdpt     {args.spp:4d} spp  {wall_bd:7.2f}s  relMSE {r_bd:.5f}")

    rows = [{"method": "bdpt", "spp": args.spp,
             "wall_s": round(wall_bd, 3), "relmse": r_bd}]
    for name, cls in (("mlt", MLTracer), ("erpt", ERPTracer)):
        tr = cls(scene, st)
        probe = max(2, args.spp // 4)
        np.asarray(tr.render(scene, seed=0, spp=probe))  # warm compile
        t0 = time.time()
        # np.asarray: a host sync, so the wall covers the execution
        np.asarray(tr.render(scene, seed=0, spp=probe))
        per_spp = (time.time() - t0) / probe
        spp_eq = max(1, int(round(wall_bd / max(per_spp, 1e-9))))
        # warm-compile at the equal-time mutation count too: spp is a
        # static arg of render_chunk, so the first spp_eq call compiles
        # (the round-5 first run charged a fresh MLT compile to the
        # timed wall)
        np.asarray(tr.render(scene, seed=0, spp=spp_eq))
        t0 = time.time()
        img = np.asarray(tr.render(scene, seed=1, spp=spp_eq))
        wall = time.time() - t0
        r = relmse(img, ref)
        print(f"{name:8s} {spp_eq:4d} mpp  {wall:7.2f}s  relMSE {r:.5f}  "
              f"({r_bd / max(r, 1e-12):.2f}x vs bdpt)")
        rows.append({"method": name, "mutations_per_pixel": spp_eq,
                     "wall_s": round(wall, 3), "relmse": r,
                     "ratio_vs_bdpt": r_bd / max(r, 1e-12)})

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"size": args.size, "maxDepth": 8,
                       "backend": jax.default_backend(),
                       "scene": "caustics", "rows": rows}, f, indent=1)
        print("wrote", args.json)


if __name__ == "__main__":
    main()
