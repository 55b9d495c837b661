"""JAX-free verification of every host-side subsystem.

This script checks the host half of the framework (XML front door, mesh
loaders, curvature bake, SAH BVH builder, EXR codec, material table)
without importing jax, so a machine without jaxlib still gets
machine-checked evidence.

    python tools/nojax_check.py        # < 30 s, pure numpy + the C++ builder

Exits non-zero on any failure; prints one OK line per subsystem.
"""
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# --- install a numpy-backed stand-in for jax.numpy -------------------------
# core/math.py imports jax.numpy at module scope, but every function the
# host path calls (np_* transform helpers) is plain array math; a numpy
# alias satisfies the import without touching jaxlib. Installed only when
# jax was not already imported, so the script also runs fine where jax works.
import numpy as np

if "jax" not in sys.modules:
    _jax = types.ModuleType("jax")
    _jnp = types.ModuleType("jax.numpy")
    _jnp.__dict__.update(np.__dict__)
    _jax.numpy = _jnp
    sys.modules["jax"] = _jax
    sys.modules["jax.numpy"] = _jnp

FAIL = 0


def check(name, fn):
    global FAIL
    try:
        fn()
        print(f"OK   {name}")
    except Exception as e:
        FAIL += 1
        import traceback
        traceback.print_exc()
        print(f"FAIL {name}: {type(e).__name__}: {e}")


def xml_front_door():
    from gradientdomain_mitsuba_tpu.scene import xml_loader
    desc = xml_loader.load(os.path.join(ROOT, "data/scenes/cbox/cbox.xml"),
                           {"integrator": "gpt", "width": "64",
                            "height": "64", "spp": "4", "maxDepth": "4"})
    assert desc.sensor is not None and desc.sensor.type == "perspective"
    assert desc.integrator is not None
    assert len(desc.shapes) >= 5, len(desc.shapes)
    kinds = {s.type for s in desc.shapes}
    assert "obj" in kinds or "rectangle" in kinds, kinds
    # $var substitution reached the film
    film = desc.sensor.child("film")
    assert int(film.get("width")) == 64


def mesh_loaders_and_curvature():
    from gradientdomain_mitsuba_tpu.scene import meshes
    sph = meshes.make_sphere(radius=2.0, n_theta=32, n_phi=64)
    assert len(sph.positions) and len(sph.indices)
    r = np.linalg.norm(sph.positions, axis=-1)
    assert np.allclose(r, 2.0, atol=1e-5)
    for mode, want in (("gaussian", 0.25), ("mean", 0.5)):
        c = meshes.vertex_curvature(sph.positions, sph.indices, mode)
        body = np.abs(sph.positions[:, 2] / 2.0) < 0.9
        got = float(np.median(c[body]))
        assert abs(got - want) / want < 0.06, (mode, got)
    cube = meshes.make_cube()
    assert len(cube.indices) == 12


def bvh_builder():
    from gradientdomain_mitsuba_tpu.scene import bvh as bvh_mod
    rs = np.random.RandomState(0)
    n = 5000
    base = rs.uniform(-10, 10, (n, 3)).astype(np.float32)
    v0 = base
    v1 = base + rs.normal(0, 0.5, (n, 3)).astype(np.float32)
    v2 = base + rs.normal(0, 0.5, (n, 3)).astype(np.float32)
    tree = bvh_mod.build(v0, v1, v2)
    # prim_order is a permutation
    assert sorted(tree.prim_order.tolist()) == list(range(n))
    # every child AABB lies inside the scene bounds
    eps = 1e-3
    for lo, hi in ((tree.child0_min, tree.child0_max),
                   (tree.child1_min, tree.child1_max)):
        sel = (lo <= hi).all(-1)  # skip empty-leaf sentinels
        assert (lo[sel] >= tree.scene_min - eps).all()
        assert (hi[sel] <= tree.scene_max + eps).all()
    # numpy reference traversal == brute force on 64 rays
    o = rs.uniform(-12, 12, (64, 3)).astype(np.float32)
    d = rs.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    def mt_brute(o1, d1):
        e1 = v1 - v0
        e2 = v2 - v0
        pv = np.cross(np.broadcast_to(d1, e2.shape), e2)
        det = np.einsum("ij,ij->i", e1, pv)
        inv = np.where(np.abs(det) > 1e-12, 1.0 / det, 0.0)
        tv = o1 - v0
        u = np.einsum("ij,ij->i", tv, pv) * inv
        qv = np.cross(tv, e1)
        vq = np.einsum("j,ij->i", d1, qv) * inv
        t = np.einsum("ij,ij->i", e2, qv) * inv
        hit = (np.abs(det) > 1e-12) & (u >= 0) & (vq >= 0) & \
            (u + vq <= 1) & (t > 1e-4)
        return np.min(np.where(hit, t, np.inf))

    def traverse(o1, d1):
        inv_d = 1.0 / np.where(np.abs(d1) < 1e-12, 1e-12, d1)
        best = np.inf
        stack = [0]
        po = tree.prim_order

        def leaf_hit(code, best):
            raw = -int(code) - 1
            off = raw >> bvh_mod.LEAF_BITS
            cnt = raw & ((1 << bvh_mod.LEAF_BITS) - 1)
            for k in range(off, off + cnt):
                i = po[k]
                t = mt_brute_single(o1, d1, i)
                best = min(best, t)
            return best

        def mt_brute_single(o1, d1, i):
            e1 = v1[i] - v0[i]
            e2 = v2[i] - v0[i]
            pv = np.cross(d1, e2)
            det = e1 @ pv
            if abs(det) < 1e-12:
                return np.inf
            inv = 1.0 / det
            tv = o1 - v0[i]
            u = (tv @ pv) * inv
            qv = np.cross(tv, e1)
            vq = (d1 @ qv) * inv
            t = (e2 @ qv) * inv
            if u >= 0 and vq >= 0 and u + vq <= 1 and t > 1e-4:
                return t
            return np.inf

        def slab(lo, hi, best):
            t0 = (lo - o1) * inv_d
            t1 = (hi - o1) * inv_d
            tn = np.minimum(t0, t1).max()
            tf = np.maximum(t0, t1).min()
            return tn <= tf and tf >= 0 and tn < best

        while stack:
            node = stack.pop()
            for code, lo, hi in ((tree.child0[node],
                                  tree.child0_min[node],
                                  tree.child0_max[node]),
                                 (tree.child1[node],
                                  tree.child1_min[node],
                                  tree.child1_max[node])):
                if not slab(lo, hi, best):
                    continue
                if code < 0:
                    best = leaf_hit(code, best)
                else:
                    stack.append(int(code))
        return best

    for i in range(len(o)):
        tb = mt_brute(o[i], d[i])
        tt = traverse(o[i], d[i])
        if np.isinf(tb):
            assert np.isinf(tt), i
        else:
            assert abs(tb - tt) < 1e-3 * max(1.0, tb), (i, tb, tt)


def exr_codec():
    from gradientdomain_mitsuba_tpu.utils import exr
    img = np.random.RandomState(1).rand(17, 23, 3).astype(np.float32)
    path = "/tmp/nojax_roundtrip.exr"
    exr.write(path, img)
    back = exr.read_rgb(path)
    assert back.shape == img.shape
    # f16 EXR round trip: half precision
    assert np.max(np.abs(back - img)) < 2e-3, np.max(np.abs(back - img))


def material_table():
    from gradientdomain_mitsuba_tpu.scene import materials as M
    from gradientdomain_mitsuba_tpu.scene.ir import Plugin
    mb = M.MaterialBuilder()
    diff = Plugin(kind="bsdf", type="diffuse",
                  props={"reflectance": np.float32([0.5, 0.2, 0.1])})
    rough = Plugin(kind="bsdf", type="roughconductor",
                   props={"alpha": 0.3, "material": "au"})
    coat = Plugin(kind="bsdf", type="roughcoating",
                  props={"alpha": 0.2, "bsdf": diff})
    for n in (diff, rough, coat):
        mb.from_plugin(n)
    mats = mb.finalize()
    assert mats.packed.shape[1] >= 28
    kinds = mats.kind.tolist()
    assert M.DIFFUSE in kinds and M.ROUGH_CONDUCTOR in kinds \
        and M.COATING in kinds
    row = kinds.index(M.COATING)
    assert abs(mats.packed[row, 21] - 0.2) < 1e-6  # rough layer alpha


def main():
    check("xml front door (cbox.xml, $var substitution)", xml_front_door)
    check("mesh loaders + curvature bake (sphere analytic)",
          mesh_loaders_and_curvature)
    check("SAH BVH builder (invariants + numpy traversal == brute)",
          bvh_builder)
    check("EXR codec round trip", exr_codec)
    check("material table (diffuse/roughconductor/roughcoating)",
          material_table)
    if FAIL:
        print(f"{FAIL} subsystem(s) FAILED")
        sys.exit(1)
    print("NOJAX CHECK PASS")


if __name__ == "__main__":
    main()
