"""Headline benchmark: G-PT render + screened-Poisson reconstruction on the
Cornell box at 256x256, 64 spp (BASELINE.json config #1 geometry/settings).

Prints JSON lines, ONE per metric; the LAST line is always the cbox
headline:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Metric: total rays traced per second during the G-PT render (camera + NEE
shadow + BSDF + offset reconnection/half-vector rays — the BASELINE.md
protocol).  vs_baseline divides by 5 Mrays/s, the midpoint of BASELINE.md's
anecdotal 1-10 Mrays/s for 8-core CPU Mitsuba plain PT (the repo publishes
no numbers; see BASELINE.md provenance caveat).  XLA compile time is
excluded (warm-up pass first; the persistent compilation cache makes
subsequent processes start warm).

Watchdog architecture: every metric runs in its OWN subprocess with a
hard timeout
(`BENCH_CHILD=<name> python bench.py`), and the proven cbox headline runs
FIRST so nothing can starve it.  The cbox headline line is printed as
soon as it exists and RE-printed after every other metric's line, so the
last stdout line is always the headline (the driver parses the last
line) even if the whole orchestrator is killed mid-run.  A hang or crash
in any metric costs only that metric.

It needs a GPU: a child that finds no GPU fails, and no number is
printed for it.  Every metric line names the device (platform,
device_kind, count), the card's power limit and the peak device memory.
Any failure emits a JSON line with an "error" field instead of a raw
traceback.  Progress goes to stderr — stdout carries exactly the JSON
metric lines.
"""
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

CBOX = os.path.join(ROOT, "data/scenes/cbox/cbox.xml")
BASELINE_MRAYS = 5.0

WIDTH = int(os.environ.get("BENCH_WIDTH", "256"))
HEIGHT = int(os.environ.get("BENCH_HEIGHT", "256"))
SPP = int(os.environ.get("BENCH_SPP", "64"))
MAXDEPTH = int(os.environ.get("BENCH_MAXDEPTH", "6"))

# Per-metric hard timeouts (seconds), compile included.
TIMEOUTS = {
    "cbox": int(os.environ.get("BENCH_TIMEOUT_CBOX", "900")),
    "forest": int(os.environ.get("BENCH_TIMEOUT_FOREST", "900")),
    "forest10m": int(os.environ.get("BENCH_TIMEOUT_FOREST10M", "900")),
}


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def emit(obj):
    print(json.dumps(obj), flush=True)


def guard_timing(wall, rays, where):
    """Timing-methodology guard: if a wall ever silently degrades to
    dispatch time, the implied throughput blows past any physical bound.
    1e10 rays/s on one card is far above what this workload can reach
    (each ray costs >=10^3 device FLOPs plus memory traffic); flag
    anything beyond it rather than publish a dispatch-time wall as a
    render wall."""
    if rays > 0 and wall < rays / 1e10:
        log(f"TIMING GUARD TRIPPED ({where}): wall {wall:.6f}s for "
            f"{rays:.3e} rays implies {rays / wall / 1e6:.0f} Mrays/s "
            "(> 10000 Mrays/s physical bound) — wall is likely dispatch "
            "time, NOT render time. Marking metric suspect.")
        return False
    return True


def count_rays_per_sample(max_depth):
    """Rays per pixel-sample in the G-PT lockstep loop (see gpt.py):
    5 camera rays, then per bounce: 1 main NEE shadow + 1 main BSDF +
    4 offset shadow/visibility + up to 4 offset continuation rays."""
    bounces = max_depth - 1
    return 5 + bounces * (1 + 1 + 4 + 4)


def init_backend():
    """The GPU this benchmark measures, or SystemExit: there is no CPU
    fallback.  Returns (device description dict, devices)."""
    import subprocess
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found "
                         f"{devs[0].platform!r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": smi.splitlines()[0] if smi
            else None}, devs


def peak_gb():
    import jax
    stats = jax.local_devices()[0].memory_stats() or {}
    return round(stats.get("peak_bytes_in_use", 0) / 1e9, 3)


def run(width, height, spp, max_depth, backend):
    from gradientdomain_mitsuba_tpu.models.gpt import GPTracer
    from gradientdomain_mitsuba_tpu.scene import scene as sc
    import jax

    log(f"loading scene {width}x{height} spp={spp} maxDepth={max_depth}")
    scene, st = sc.load_scene(CBOX, {
        "width": str(width), "height": str(height), "spp": str(spp),
        "maxDepth": str(max_depth), "integrator": "gpt"})
    tracer = GPTracer(scene, st)
    tracer.count_rays = True  # measured device-side counter (round 2)
    scene = jax.device_put(scene)

    def one(seed):
        """One render+reconstruct, ended by block_until_ready
        (BASELINE.md protocol: everything but compile).  Returns (wall,
        rays, measured) — measured=False means the closed-form ray
        formula was used, not a device counter."""
        t0 = time.time()
        final, bufs = jax.block_until_ready(tracer.render_final(
            scene, seed, spp, alpha=0.2, mode="L1"))
        wall = time.time() - t0
        if "rays" in bufs:
            rays = float(bufs["rays"])  # counted on device (popcounts)
            measured = True
        else:
            rays = width * height * spp * count_rays_per_sample(max_depth)
            measured = False
        return wall, rays, measured

    log("warm-up (compile + first dispatch, excluded from timing)...")
    t0 = time.time()
    one(0)
    log(f"compile+first run: {time.time() - t0:.1f}s; second warm-up...")
    one(1)
    # keep (wall, rays) PAIRED per seed: RR makes ray counts seed-
    # dependent, so the headline is the best same-run rays/wall
    runs = [one(seed) for seed in (2, 3, 4)]
    wall, rays, measured = max(runs, key=lambda r: r[1] / r[0])
    log(f"timed render+reconstruct (best rays/wall of {len(runs)}): "
        f"{wall:.3f}s (all: {[f'{w:.3f}s/{r:.2e}' for w, r, _ in runs]})")
    log(f"measured rays: {rays:.0f} (formula would say "
        f"{width * height * spp * count_rays_per_sample(max_depth)})")
    timing_ok = guard_timing(wall, rays, "cbox")
    mrays = rays / wall / 1e6
    out = {
        "metric": (f"gpt_cbox_{width}x{height}_{spp}spp_"
                   f"render+reconstruct_mrays_per_sec"),
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 3),
        "device": backend,
        "wall_s": round(wall, 3),
        "rays_measured": measured,
        "peak_device_gb": peak_gb(),
    }
    if not timing_ok:
        out["suspect_timing"] = True
    emit(out)


def run_forest(backend):
    """3.08M-tri forest through the large-scene traversal (the SoA BVH
    stack traversal on the GPU), measured device-side rays."""
    from gradientdomain_mitsuba_tpu.models.path import PathTracer
    from gradientdomain_mitsuba_tpu.scene import scene as sc
    import jax

    # 16 spp runs the scene at 1M-lane wavefronts, the shape any real
    # (hundreds-of-spp) render uses.  The metric name carries the spp.
    spp = int(os.environ.get("BENCH_FOREST_SPP", "16"))
    size = int(os.environ.get("BENCH_FOREST_SIZE", "256"))
    forest = os.path.join(ROOT, "data/scenes/forest/forest.xml")
    log(f"forest scene {size}x{size} spp={spp} (BVH build on host)...")
    t0 = time.time()
    scene, st = sc.load_scene(forest, {
        "width": str(size), "height": str(size), "spp": str(spp),
        "maxDepth": "5"})
    build_s = time.time() - t0
    n_tris = int(scene.geom.indices.shape[0])
    prep = {k: (round(v, 2) if isinstance(v, float) else v)
            for k, v in st.prep_times.items() if k != "geom_key"}
    log(f"forest: {n_tris} tris, prep {build_s:.1f}s "
        f"(breakdown: {prep})")
    scene = jax.device_put(scene)
    tracer = PathTracer(scene, st)
    tracer.count_rays = True

    def one(seed):
        # render() host-reads the scalar ray counter in finalize(), a
        # sync.  (wall, rays) stay PAIRED per seed — RR makes the
        # measured ray count seed-dependent.
        t0 = time.time()
        tracer.render(scene, seed=seed, spp=spp, chunk=spp)
        return time.time() - t0, float(getattr(tracer, "last_ray_count",
                                               0.0))

    t0 = time.time()
    one(0)
    log(f"forest compile+first: {time.time() - t0:.1f}s; warm-up 2...")
    one(1)
    runs = [one(s) for s in (2, 3, 4)]
    wall, rays = max(runs, key=lambda r: r[1] / max(r[0], 1e-9))
    mrays = rays / wall / 1e6
    log(f"forest runs: {[f'{w:.3f}s/{r:.2e}' for w, r in runs]}")
    log(f"forest timed render: {wall:.3f}s, {rays:.0f} rays")
    timing_ok = guard_timing(wall, rays, "forest")
    out = {
        "metric": (f"pt_forest{n_tris // 1000000}M_{size}x{size}_"
                   f"{spp}spp_mrays_per_sec"),
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        # baseline: the same anecdotal 5 Mrays/s 8-core CPU plain-PT
        # midpoint as the headline (BASELINE.md publishes no per-scene
        # figure; this is the closest like-for-like class)
        "vs_baseline": round(mrays / BASELINE_MRAYS, 3),
        "baseline_mrays": BASELINE_MRAYS,
        "device": backend,
        "wall_s": round(wall, 3),
        "n_tris": n_tris,
        "scene_prep_s": round(build_s, 1),
        "scene_prep_breakdown": prep,
        "rays_measured": True,
        "peak_device_gb": peak_gb(),
    }
    if not timing_ok:
        out["suspect_timing"] = True
    emit(out)


def run_forest10m(backend):
    """10.19M-tri forest rendered on-device — the BVH tables at
    San-Miguel scale fit device memory and traverse; reports measured
    Mrays/s and memory (BASELINE config #5)."""
    from gradientdomain_mitsuba_tpu.models.path import PathTracer
    from gradientdomain_mitsuba_tpu.scene import scene as sc
    import jax

    spp = int(os.environ.get("BENCH_FOREST10M_SPP", "2"))
    size = int(os.environ.get("BENCH_FOREST10M_SIZE", "128"))
    forest = os.path.join(ROOT, "data/scenes/forest/forest10m.xml")
    log(f"forest10m scene {size}x{size} spp={spp}...")
    t0 = time.time()
    scene, st = sc.load_scene(forest, {
        "width": str(size), "height": str(size), "spp": str(spp),
        "maxDepth": "4"})
    build_s = time.time() - t0
    n_tris = int(scene.geom.indices.shape[0])
    log(f"forest10m: {n_tris} tris, prep {build_s:.1f}s "
        f"(cache: {st.prep_times.get('cache')})")
    scene = jax.device_put(scene)
    tracer = PathTracer(scene, st)
    tracer.count_rays = True

    def one(seed):
        t0 = time.time()
        tracer.render(scene, seed=seed, spp=spp, chunk=spp)
        return time.time() - t0, float(getattr(tracer, "last_ray_count",
                                               0.0))

    t0 = time.time()
    one(0)
    log(f"forest10m compile+first: {time.time() - t0:.1f}s...")
    runs = [one(s) for s in (1, 2)]
    wall, rays = max(runs, key=lambda r: r[1] / max(r[0], 1e-9))
    mrays = rays / wall / 1e6
    hbm_gb = peak_gb()
    scene_gb = round(sum(
        a.nbytes for a in jax.tree_util.tree_leaves(scene)
        if hasattr(a, "nbytes")) / 2 ** 30, 2)
    log(f"forest10m render: {wall:.3f}s, {rays:.0f} rays, peak {hbm_gb} GB"
        f", scene tables {scene_gb} GB")
    timing_ok = guard_timing(wall, rays, "forest10m")
    out = {
        "metric": (f"pt_forest{n_tris // 1000000}M_{size}x{size}_"
                   f"{spp}spp_mrays_per_sec"),
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 3),
        "baseline_mrays": BASELINE_MRAYS,
        "device": backend,
        "wall_s": round(wall, 3),
        "n_tris": n_tris,
        "peak_device_gb": hbm_gb,
        "device_scene_gb": scene_gb,
        "scene_prep_s": round(build_s, 1),
        "rays_measured": True,
    }
    if not timing_ok:
        out["suspect_timing"] = True
    emit(out)


def child_main(which):
    """Run exactly one metric in this process (spawned by the
    orchestrator).  stdout: that metric's JSON line(s).  rc!=0 or no
    output → the orchestrator records the failure and moves on."""
    backend, _ = init_backend()
    if which == "cbox":
        run(WIDTH, HEIGHT, SPP, MAXDEPTH, backend)
    elif which == "forest":
        run_forest(backend)
    elif which == "forest10m":
        run_forest10m(backend)
    else:
        raise ValueError(f"unknown BENCH_CHILD {which!r}")


def run_child(which):
    """Spawn `BENCH_CHILD=which python bench.py` with a hard timeout.
    Returns (json_lines, status).  The child's stderr streams through to
    our stderr live (no capture deadlock; progress stays visible)."""
    import subprocess
    env = dict(os.environ, BENCH_CHILD=which)
    t0 = time.time()
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__)],
            stdout=subprocess.PIPE, stderr=None, text=True,
            timeout=TIMEOUTS[which], env=env)
        lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
        status = "ok" if (r.returncode == 0 and lines) else \
            f"rc={r.returncode}"
        log(f"child {which}: {status} in {time.time() - t0:.1f}s, "
            f"{len(lines)} line(s)")
        return lines, status
    except subprocess.TimeoutExpired:
        log(f"child {which}: TIMED OUT after {TIMEOUTS[which]}s (killed)")
        return [], "timeout"
    except Exception as e:
        log(f"child {which}: {type(e).__name__}: {e}")
        return [], "error"


def main():
    """Orchestrator: cbox FIRST (the proven headline can never be starved
    by a fragile metric), forest metrics after, each in its own
    subprocess with a hard timeout; the cbox line is re-printed after
    every metric so it is always the last stdout line."""
    order = ["cbox"]
    if os.environ.get("BENCH_FOREST", "1") != "0":
        order.append("forest")
    if os.environ.get("BENCH_FOREST10M", "1") != "0":
        order.append("forest10m")
    t_start = time.time()
    budget = int(os.environ.get("BENCH_TOTAL_BUDGET_S", "2700"))
    results = {}
    results["cbox"], _ = run_child("cbox")
    cbox_lines = results.get("cbox") or [json.dumps({
        "metric": f"gpt_cbox_{WIDTH}x{HEIGHT}_{SPP}spp_"
                  "render+reconstruct_mrays_per_sec",
        "value": 0.0, "unit": "Mrays/s", "vs_baseline": 0.0,
        "error": "cbox child produced no output (crash or timeout)"})]

    def print_cbox():
        # the driver parses the LAST stdout line; re-printing the
        # headline after every metric keeps it last no matter where an
        # external kill lands mid-run (duplicates are harmless)
        for ln in cbox_lines:
            print(ln, flush=True)

    print_cbox()
    for which in order[1:]:
        if time.time() - t_start + TIMEOUTS[which] > budget:
            log(f"skipping {which}: would exceed BENCH_TOTAL_BUDGET_S="
                f"{budget} ({time.time() - t_start:.0f}s elapsed)")
            continue
        lines, _ = run_child(which)
        for ln in lines:
            print(ln, flush=True)
        print_cbox()
    sys.exit(0)


if __name__ == "__main__":
    child = os.environ.get("BENCH_CHILD")
    if child:
        try:
            child_main(child)
        except Exception:
            log(traceback.format_exc())
            sys.exit(1)
    else:
        main()
