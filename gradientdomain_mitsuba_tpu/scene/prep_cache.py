"""Geometry prep pipeline + disk cache (SURVEY.md §6.4).

Replacement for the reference's per-run kd-tree rebuild
(src/librender/skdtree.cpp — Mitsuba 0.5 rebuilds the tree on every
invocation; SURVEY §6.4 notes "kd-tree is NOT cached" and commits this
build to a BVH disk cache keyed by scene hash).

Everything that depends ONLY on the triangle soup and the cluster target
is built here in one shot — BVH, cluster decomposition, padded
cluster-major layout — and the
resulting arrays are cached on disk keyed by a blake2b hash of the
geometry inputs.  A 3M-tri scene costs ~30 s to prep and <2 s to reload.

Cache layout: one uncompressed .npz per key under
``<repo>/.gdmt_cache/geom/`` (override with GDMT_GEOM_CACHE; disable with
GDMT_GEOM_CACHE=0).  Writes are atomic (tempfile + rename) so concurrent
renders of the same scene cannot observe a torn file.  Only scenes above
CACHE_MIN_TRIS triangles are written — test scenes prep in milliseconds
and would only churn the directory.
"""
from __future__ import annotations

import hashlib
import os
import tempfile
import time

import numpy as np

from . import bvh as bvh_mod

# Bump whenever the BVH builder, cluster extraction or padded layout
# changes semantically.
GEOM_CACHE_VERSION = "g1"  # g1: no slab or linear-MT tables

CACHE_MIN_TRIS = 100_000


def _cache_dir():
    env = os.environ.get("GDMT_GEOM_CACHE")
    if env == "0":
        return None
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, ".gdmt_cache", "geom")


def geometry_key(p0, p1, p2, target: int) -> str:
    h = hashlib.blake2b(digest_size=20)
    h.update(GEOM_CACHE_VERSION.encode())
    h.update(str(int(target)).encode())
    for a in (p0, p1, p2):
        arr = np.ascontiguousarray(a, np.float32)
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def build_geometry(p0, p1, p2, target: int, times=None) -> dict:
    """Triangle soup [T,3]x3 -> everything the traversal kernels need.

    Returns a dict of numpy arrays + scalars:
      tree_c0min/c0max/c1min/c1max [N,3], tree_c0/c1 [N] (leaf codes
      REMAPPED into the padded layout), tree_depth, order [T],
      window, c_off/c_cnt [K], c_min/c_max [K,3],
      psel [Tp] (padded slot -> bvh-order idx, clamped), valid_slot [Tp],
      v0/e1/e2 [Tp,3], orig_id [Tp].
    """
    times = times if times is not None else {}
    T = len(p0)

    t0 = time.time()
    tree = bvh_mod.build(p0, p1, p2)
    times["bvh_build"] = time.time() - t0

    t0 = time.time()
    order = tree.prim_order
    c_off, c_cnt, c_min, c_max = bvh_mod.extract_clusters(tree, target)
    window = int(c_cnt.max()) if len(c_cnt) else 1
    window = max(128, -(-window // 128) * 128)
    K = len(c_off)
    times["clusters"] = time.time() - t0

    # CLUSTER-MAJOR padded layout: cluster k owns prim slots
    # [k*window, k*window + count_k); window tails are degenerate padding.
    t0 = time.time()
    Tp = K * window
    sl = np.arange(window, dtype=np.int64)
    full = c_off.astype(np.int64)[:, None] + sl[None, :]        # [K, W]
    valid2 = sl[None, :] < c_cnt.astype(np.int64)[:, None]      # [K, W]
    valid_slot = valid2.ravel()
    psel = np.where(valid2, full, 0).ravel()                    # clamped
    new_of_bvh = np.empty(T, np.int64)                          # bvh -> slot
    slot2 = (np.arange(K, dtype=np.int64)[:, None] * window + sl[None, :])
    new_of_bvh[full[valid2]] = slot2[valid2]

    def lay(a, fill=0.0):
        out = a[order][psel]
        out[~valid_slot] = fill
        return out

    v0 = lay(p0).astype(np.float32)
    e1 = lay(p1 - p0).astype(np.float32)
    e2 = lay(p2 - p0).astype(np.float32)
    orig_id = np.where(valid_slot, order[psel], -1).astype(np.int32)

    # remap BVH leaf codes into the padded layout (leaf ranges stay
    # contiguous inside their cluster)
    LEAF_BITS = bvh_mod.LEAF_BITS

    def remap_codes(codes):
        codes = codes.copy()
        leaf = codes < 0
        raw = -codes[leaf].astype(np.int64) - 1
        offs = raw >> LEAF_BITS
        cnts = raw & ((1 << LEAF_BITS) - 1)
        new_offs = np.where(cnts > 0, new_of_bvh[np.minimum(offs, T - 1)],
                            0).astype(np.int64)
        codes[leaf] = (-((new_offs << LEAF_BITS) | cnts) - 1).astype(
            np.int32)
        return codes

    tree_c0 = remap_codes(tree.child0)
    tree_c1 = remap_codes(tree.child1)
    times["layout"] = time.time() - t0

    return dict(
        tree_c0min=tree.child0_min, tree_c0max=tree.child0_max,
        tree_c1min=tree.child1_min, tree_c1max=tree.child1_max,
        tree_c0=tree_c0, tree_c1=tree_c1,
        tree_depth=np.int32(tree.depth),
        order=order.astype(np.int32),
        window=np.int32(window),
        c_off=c_off, c_cnt=c_cnt, c_min=c_min, c_max=c_max,
        psel=psel.astype(np.int64), valid_slot=valid_slot,
        v0=v0, e1=e1, e2=e2, orig_id=orig_id)


def hash_arrays(*arrays, extra: str = "") -> str:
    """blake2b over a tuple of numpy arrays (+ an extra string tag)."""
    h = hashlib.blake2b(digest_size=20)
    h.update(GEOM_CACHE_VERSION.encode())
    h.update(extra.encode())
    for a in arrays:
        if a is None:
            h.update(b"<none>")
            continue
        arr = np.ascontiguousarray(a)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def load_or_build_array(key: str, build_fn, n_items: int, times=None,
                        tag: str = "aux"):
    """Disk-cached single array: load <cache>/<tag>-<key>.npy (mmap) or
    build_fn() + save.  n_items gates caching like CACHE_MIN_TRIS."""
    times = times if times is not None else {}
    cdir = _cache_dir()
    if cdir is None or n_items < CACHE_MIN_TRIS:
        return build_fn()
    path = os.path.join(cdir, f"{tag}-{key}.npy")
    if os.path.exists(path):
        try:
            out = np.load(path, mmap_mode="r", allow_pickle=False)
            times[tag + "_cache"] = "hit"
            return out
        except Exception:
            pass
    times[tag + "_cache"] = "miss"
    arr = build_fn()
    try:
        os.makedirs(cdir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=cdir, suffix=".npy.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, np.ascontiguousarray(arr))
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
    except Exception:
        pass
    return arr


def load_or_build(p0, p1, p2, target: int, times=None) -> dict:
    """Disk-cached build_geometry.  `times` (optional dict) receives the
    phase breakdown plus cache bookkeeping ('cache': 'hit'/'miss'/'off',
    'cache_io' seconds)."""
    times = times if times is not None else {}
    T = len(p0)
    cdir = _cache_dir()
    if cdir is None or T < CACHE_MIN_TRIS:
        times["cache"] = "off"
        return build_geometry(p0, p1, p2, target, times)

    t0 = time.time()
    key = geometry_key(p0, p1, p2, target)
    times["geom_key"] = key
    # one DIRECTORY of raw .npy files per key: np.load with mmap pages
    # arrays in lazily at raw-file speed (np.savez's zip+crc32 path read
    # a 1.2 GB forest pack at ~75 MB/s; this path is ~10x faster and the
    # device upload faults pages straight from the page cache)
    path = os.path.join(cdir, key)
    done = os.path.join(path, ".complete")
    times["cache_key"] = time.time() - t0
    if os.path.exists(done):
        try:
            t0 = time.time()
            out = {}
            for fn in os.listdir(path):
                if fn.endswith(".npy"):
                    out[fn[:-4]] = np.load(os.path.join(path, fn),
                                           mmap_mode="r",
                                           allow_pickle=False)
            times["cache"] = "hit"
            times["cache_io"] = time.time() - t0
            return out
        except Exception:
            pass  # torn/stale dir: rebuild below and overwrite

    times["cache"] = "miss"
    out = build_geometry(p0, p1, p2, target, times)
    t0 = time.time()
    try:
        os.makedirs(cdir, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=cdir, suffix=".tmp")
        try:
            for k, v in out.items():
                np.save(os.path.join(tmp, k + ".npy"),
                        np.ascontiguousarray(v))
            with open(os.path.join(tmp, ".complete"), "w") as f:
                f.write(GEOM_CACHE_VERSION)
            if os.path.exists(path):  # lost a concurrent race: keep theirs
                import shutil
                shutil.rmtree(tmp)
            else:
                os.replace(tmp, path)
        except BaseException:
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)
            raise
    except Exception:
        pass  # read-only fs / out of space: render proceeds uncached
    times["cache_io"] = time.time() - t0
    return out
