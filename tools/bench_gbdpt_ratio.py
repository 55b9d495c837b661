"""G-BDPT vs BDPT cost ratio.

Measures ms/spp for BDPT and G-BDPT on the Cornell box at the given
depths and prints a table plus the ratio.  The ratio is
backend-portable (both estimators share the traversal/shading stack),
so a CPU run gives the ratio too; pass --size/--spp to scale the
workload to the machine.

Usage: python tools/bench_gbdpt_ratio.py [--size 128] [--spp 4]
       [--depths 6 8]
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")


def _time_render(cls, integrator, size, spp, depth, props=None):
    from gradientdomain_mitsuba_tpu.scene import scene as sc
    scene, st = sc.load_scene(CBOX, {
        "width": str(size), "height": str(size), "spp": str(spp),
        "maxDepth": str(depth), "integrator": integrator})
    if props:
        st.integrator_props.update(props)
    tr = cls(scene, st)
    render = getattr(tr, "render_buffers", None) or tr.render
    import numpy as np

    def sync(out):
        __import__("jax").block_until_ready(out)

    sync(render(scene, seed=0, spp=spp))
    t0 = time.time()
    sync(render(scene, seed=1, spp=spp))
    return (time.time() - t0) * 1000.0 / spp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depths", type=int, nargs="+", default=[6, 8])
    args = ap.parse_args()

    from gradientdomain_mitsuba_tpu.models.bdpt import BDPTracer
    from gradientdomain_mitsuba_tpu.models.gbdpt import GBDPTracer
    import jax
    backend = jax.default_backend()

    rows = []
    for d in args.depths:
        ms_b = _time_render(BDPTracer, "bdpt", args.size, args.spp, d)
        ms_g = _time_render(GBDPTracer, "gbdpt", args.size, args.spp, d)
        # cost knob: light image primal-only (no image-space t=1 shifts
        # — whether the reference shifts t=1 paths is unverified, SURVEY
        # §4.3 [?]; ours does by default, and the measured cost of that
        # capability is the delta between these two rows)
        ms_g0 = _time_render(GBDPTracer, "gbdpt", args.size, args.spp, d,
                             props={"lightImageGradients": False})
        rows.append({"depth": d, "bdpt_ms_per_spp": round(ms_b, 1),
                     "gbdpt_ms_per_spp": round(ms_g, 1),
                     "gbdpt_nolig_ms_per_spp": round(ms_g0, 1),
                     "ratio": round(ms_g / ms_b, 2),
                     "ratio_nolig": round(ms_g0 / ms_b, 2)})
        print(f"depth {d}: bdpt {ms_b:.1f} ms/spp, "
              f"gbdpt {ms_g:.1f} ms/spp (ratio {ms_g / ms_b:.2f}), "
              f"gbdpt[lightImageGradients=false] {ms_g0:.1f} ms/spp "
              f"(ratio {ms_g0 / ms_b:.2f})",
              file=sys.stderr, flush=True)
    print(json.dumps({"backend": backend, "size": args.size,
                      "spp": args.spp, "rows": rows}))


if __name__ == "__main__":
    main()
