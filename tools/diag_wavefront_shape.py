#!/usr/bin/env python3
"""Does G-BDPT's per-lane output depend on the wavefront it is traced in?

Traces cbox with GBDPTracer.trace_pass twice per sample, on one device:
once with the whole film as one wavefront (H*W lanes, as GBDPTracer.render
does) and once as --blocks row blocks of H*W/blocks lanes each (as every
shard of parallel/tiles.render_tiles_gbdpt does).  It compares the
per-lane outputs, then splats both on the host in float64 and a fixed
order, so that any difference in the dx image comes from the lanes alone
and none from the tile path (halo exchange, psum, gather).

This is the one-device stand-in for `chip_smoke.py --multi`'s G-BDPT
comparison: where it reports pixels beyond the bound, the four-device
render will differ from the single-device one at the same pixels.

    python tools/diag_wavefront_shape.py [--size 256] [--spp 4] [--seed 3]
                                         [--blocks 4] [--out report.json]
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NAMES = ("pos", "primal", "very", "grad", "spos", "sval", "t1p", "t1g")


def lane_major(name, a, n):
    """Lane axis first: [n, ...] (trace_pass stacks blocks of n lanes)."""
    import numpy as np
    a = np.asarray(a)
    if name in ("grad", "t1g"):              # [4, nb*n, 3]
        return a.reshape(4, -1, n, 3).transpose(2, 1, 0, 3)
    if name in ("spos", "sval", "t1p"):      # [nb*n, c]
        return a.reshape(-1, n, a.shape[-1]).transpose(1, 0, 2)
    return a


def splat(img, pos, val):
    """film.splat_unfiltered on the host, in float64."""
    import numpy as np
    H, W = img.shape[:2]
    pos = pos.reshape(-1, 2)
    val = val.reshape(-1, 3)
    with np.errstate(invalid="ignore"):
        inside = ((pos[:, 0] >= 0) & (pos[:, 0] < W) & (pos[:, 1] >= 0)
                  & (pos[:, 1] < H))
    px = np.clip(np.nan_to_num(pos[:, 0]).astype(np.int64), 0, W - 1)
    py = np.clip(np.nan_to_num(pos[:, 1]).astype(np.int64), 0, H - 1)
    np.add.at(img, (py, px), (val * inside[:, None]).astype(np.float64))


def dx_images(o, S):
    """(camera-path part, t=1 light-image part) of the dx buffer."""
    import numpy as np
    from gradientdomain_mitsuba_tpu.models.gpt import OFFSETS
    cam, t1 = np.zeros((S, S, 3)), np.zeros((S, S, 3))
    splat(cam, o["pos"], o["grad"][:, 0, 0])
    splat(cam, o["pos"] + OFFSETS[1], -o["grad"][:, 0, 1])
    splat(t1, o["t1p"], o["t1g"][:, :, 0])
    splat(t1, o["t1p"] + OFFSETS[1], -o["t1g"][:, :, 1])
    return cam, t1


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--out", default=None, help="write the report as JSON")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from gradientdomain_mitsuba_tpu.models.gbdpt import GBDPTracer
    from gradientdomain_mitsuba_tpu.scene import scene as sc

    S, nb = args.size, args.blocks
    print(f"{jax.devices()[0].device_kind}, jax {jax.__version__}",
          flush=True)
    scene, st = sc.load_scene(
        os.path.join(ROOT, "data/scenes/cbox/cbox.xml"),
        {"width": str(S), "height": str(S), "spp": str(args.spp),
         "maxDepth": "6", "integrator": "gpt"})
    scene = jax.device_put(scene)
    st = copy.deepcopy(st)
    st.integrator = "gbdpt"
    gb = GBDPTracer(scene, st)
    trace = jax.jit(lambda sc_, seed, i, pid: gb.trace_pass(
        sc_, seed, i, pixel_id=pid))
    N, rows = S * S, S // nb
    report = {}
    acc = {"whole": [0.0, 0.0], "blocks": [0.0, 0.0]}
    t0 = time.time()
    for i in range(args.spp):
        whole = trace(scene, args.seed, i, jnp.arange(N, dtype=jnp.uint32))
        whole = {k: lane_major(k, v, N) for k, v in zip(NAMES, whole)}
        parts = []
        for b in range(nb):
            pid = jnp.asarray(b * rows * S + np.arange(rows * S), jnp.uint32)
            o = trace(scene, args.seed, i, pid)
            parts.append({k: lane_major(k, v, rows * S)
                          for k, v in zip(NAMES, o)})
        blocks = {k: np.concatenate([p[k] for p in parts]) for k in NAMES}
        rs = {}
        for k in NAMES:
            a, b = whole[k], blocks[k]
            d = np.abs(a - b).reshape(N, -1).max(1)
            beyond = d > 1e-5 + 1e-4 * np.abs(a).reshape(N, -1).max(1)
            rs[k] = dict(lanes_differ=int((d > 0).sum()),
                         lanes_beyond=int(beyond.sum()),
                         max_abs=float(np.nanmax(d)),
                         examples=[[int(j), a[j].tolist(), b[j].tolist()]
                                   for j in np.flatnonzero(beyond)[:3]])
        report[f"sample{i}"] = rs
        print(f"sample {i}: " + ", ".join(
            f"{k} {v['lanes_differ']} lanes differ, {v['lanes_beyond']} "
            f"beyond the bound" for k, v in rs.items()), flush=True)
        for key, o in (("whole", whole), ("blocks", blocks)):
            for j, img in enumerate(dx_images(o, S)):
                acc[key][j] = acc[key][j] + img
    for j, part in enumerate(("dx camera paths", "dx t=1 light image",
                              "dx")):
        if j < 2:
            a, b = acc["whole"][j], acc["blocks"][j]
        else:
            a, b = sum(acc["whole"]), sum(acc["blocks"])
        a, b = a / args.spp, b / args.spp
        r = np.abs(a - b) / (1e-5 + 1e-4 * np.abs(a))
        bad = np.argwhere(np.any(r > 1, -1))
        report[part] = dict(worst=float(r.max()), n_bad=int(len(bad)),
                            bad_px=bad[:10].tolist())
        print(f"{part}: worst pixel at {r.max():.3f}x the bound 1e-5 + "
              f"1e-4|whole|, {len(bad)} pixels beyond it, first (row, "
              f"col): {bad[:10].tolist()}", flush=True)
    print(f"done in {time.time() - t0:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
