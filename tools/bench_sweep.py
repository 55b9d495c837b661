#!/usr/bin/env python3
"""End-to-end comparison of the small-scene traversals on the GPU.

Renders cbox with G-PT at 256^2, 64 spp, maxDepth 6 and L1 reconstruction
(GPTracer.render_final, the path tpurender takes) three ways:

  sweep   the fused sweep kernel (ops/pallas_sweep.py, choose_intersector's
          choice on the GPU)
  brute   intersect_brute / occluded_brute
  matmul  intersect_matmul / occluded_matmul (linear-MT)

Each variant is compiled and warmed once, then timed in turns
(sweep, brute, matmul, matmul, brute, sweep) so that drift of the card's
clocks falls on all of them.  Every timing ends in block_until_ready.

    python tools/bench_sweep.py [--spp 64] [--size 256] [--reps 2]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _plain(kind, n_tris, tris):
    import numpy as np
    from gradientdomain_mitsuba_tpu.ops import common
    from gradientdomain_mitsuba_tpu.ops import intersect as isec
    if kind == "brute":
        chunk = min(1024, max(64, n_tris))

        def closest(o, d, mint, maxt, geom):
            return isec.intersect_brute(o, d, mint, maxt, geom.tris, chunk)

        def occl(o, d, mint, maxt, geom):
            return isec.occluded_brute(o, d, mint, maxt, geom.tris, chunk)
    else:
        linC = isec.build_linear_mt(*(np.asarray(a) for a in
                                      (tris.v0, tris.e1, tris.e2)))

        def closest(o, d, mint, maxt, geom):
            return isec.intersect_matmul(o, d, mint, maxt, linC)

        def occl(o, d, mint, maxt, geom):
            return isec.occluded_matmul(o, d, mint, maxt, linC)
    return common.add_sphere_intersections(closest, occl)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()

    import jax
    import numpy as np
    from gradientdomain_mitsuba_tpu.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu.ops import common
    from gradientdomain_mitsuba_tpu.scene import scene as sc

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, found {dev.platform}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; jax {jax.__version__}", flush=True)

    scene, st = sc.load_scene(
        os.path.join(ROOT, "data/scenes/cbox/cbox.xml"),
        {"width": str(args.size), "height": str(args.size),
         "spp": str(args.spp), "maxDepth": "6", "integrator": "gpt"})
    scene = jax.device_put(scene)
    n_tris = int(scene.geom.indices.shape[0])
    tracers = {}
    for kind in ("sweep", "brute", "matmul"):
        tr = GPTracer(scene, st)
        if kind != "sweep":
            tr.closest, tr.occluded = common.instrument_intersectors(
                tr, *_plain(kind, n_tris, scene.geom.tris))
        tr.count_rays = True
        tracers[kind] = tr

    def run(kind, seed):
        t0 = time.perf_counter()
        final, bufs = jax.block_until_ready(tracers[kind].render_final(
            scene, seed, args.spp, alpha=0.2, mode="L1"))
        return time.perf_counter() - t0, float(bufs["rays"]), final

    finals = {}
    for kind in tracers:
        t0 = time.time()
        _, _, finals[kind] = run(kind, 0)
        print(f"{kind}: compile + first render {time.time() - t0:.1f} s",
              flush=True)
    for kind in ("brute", "matmul"):
        diff = float(np.abs(np.asarray(finals[kind]) -
                            np.asarray(finals["sweep"])).mean())
        print(f"mean |final({kind}) - final(sweep)| = {diff:.3e}")
    walls = {k: [] for k in tracers}
    order = ["sweep", "brute", "matmul", "matmul", "brute", "sweep"]
    for rep in range(args.reps):
        for i, kind in enumerate(order):
            wall, rays, _ = run(kind, 1 + rep * len(order) + i)
            walls[kind].append(wall)
            print(f"{kind}: {wall:.4f} s, {rays:.0f} rays, "
                  f"{rays / wall / 1e6:.3f} Mrays/s", flush=True)
    for kind, ws in walls.items():
        print(f"{kind}: median {np.median(ws):.4f} s over {len(ws)} "
              f"renders ({args.size}^2, {args.spp} spp, maxDepth 6, L1) "
              f"[{smi}]")


if __name__ == "__main__":
    main()
