"""Compile-time benchmark for the BDPT (s,t) strategy loop: trace+compile
seconds of BDPTracer.render_chunk at several
maxDepth values, with the scanned dynamic-(s,t) kernel vs the unrolled
static loop.  Run on the CPU backend (compile cost is what matters and it
is backend-portable):

    env -u PYTHONPATH JAX_PLATFORMS=cpu python tools/bench_compile.py \
        [--depths 6 8 12] [--size 16]

Each (depth, mode) pair compiles in a FRESH subprocess with the JAX
persistent compilation cache disabled, so numbers are cold and
independent.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import os, sys, time
sys.path.insert(0, %(root)r)
os.environ["GDMT_SCAN_STRATEGIES"] = %(scan)r
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)
from gradientdomain_mitsuba_tpu.models import bdpt as bdpt_mod
from gradientdomain_mitsuba_tpu.scene import scene as sc
scene, st = sc.load_scene(os.path.join(%(root)r, "data/scenes/cbox/cbox.xml"),
                          {"width": %(size)r, "height": %(size)r,
                           "spp": "1", "maxDepth": %(depth)r})
tr = bdpt_mod.BDPTracer(scene, st)
t0 = time.time()
lowered = jax.jit(lambda s, seed: tr.render_chunk(s, seed, 0, 1)).lower(
    scene, 0)
t_trace = time.time() - t0
t0 = time.time()
lowered.compile()
t_compile = time.time() - t0
print(f"RESULT {t_trace:.1f} {t_compile:.1f}")
"""


def run_one(depth, scan, size, timeout):
    code = CHILD % dict(root=ROOT, scan=("1" if scan else "0"),
                        size=str(size), depth=str(depth))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    try:
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return None, None
    for line in r.stdout.splitlines():
        if line.startswith("RESULT"):
            _, tt, tc = line.split()
            return float(tt), float(tc)
    print(r.stdout[-2000:], r.stderr[-2000:], file=sys.stderr)
    return None, None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", type=int, nargs="+", default=[6, 8, 12])
    ap.add_argument("--size", type=int, default=16)
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args()
    rows = []
    for depth in args.depths:
        for scan in (False, True):
            t0 = time.time()
            tt, tc = run_one(depth, scan, args.size, args.timeout)
            label = "scan" if scan else "unrolled"
            if tt is None:
                print(f"depth={depth:2d} {label:8s}  TIMEOUT/FAIL "
                      f"(>{args.timeout}s)", flush=True)
                rows.append(dict(depth=depth, mode=label, timeout=True))
                continue
            print(f"depth={depth:2d} {label:8s}  trace {tt:7.1f}s  "
                  f"compile {tc:7.1f}s  total {tt + tc:7.1f}s "
                  f"(wall {time.time() - t0:.0f}s)", flush=True)
            rows.append(dict(depth=depth, mode=label, trace_s=tt,
                             compile_s=tc))
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
