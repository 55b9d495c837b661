"""Large-scene traversal benchmark (BASELINE.json config #5 axis).

Builds a procedural "sphere garden" inside a Cornell-style room —
tessellated spheres on a grid, triangle count controlled by --tris —
then times the wavefront path tracer end-to-end on the current backend.
This exercises the large-scene traversal path (the SoA stack traversal on
the GPU, the cluster traversal on the CPU) that cbox (32 tris) never
touches.

Usage:
    python tools/bench_large.py --tris 1000000 --size 256 --spp 4
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_scene(n_tris: int, width: int, height: int, spp: int,
                max_depth: int):
    """Procedural scene via the library API: grid of tessellated spheres
    lit by one area light, built directly as a SceneDesc-equivalent by
    writing a temporary OBJ + XML (exercises the same front door as any
    user scene)."""
    import tempfile
    from gradientdomain_mitsuba_tpu.scene import meshes as mesh_mod

    # grid of spheres, tessellation chosen to hit ~n_tris total
    n_spheres = 25
    per = max(n_tris // n_spheres, 32)
    # lat-long sphere: tris ~= 2 * n_theta * n_phi
    n_theta = max(int(np.sqrt(per / 4)), 4)
    n_phi = max(per // (2 * n_theta), 8)

    tmp = tempfile.mkdtemp(prefix="gdmt_large_")
    verts, faces = [], []
    voff = 0
    rs = np.random.RandomState(0)
    for i in range(n_spheres):
        gx, gz = i % 5, i // 5
        c = np.array([110.0 + gx * 85.0, 60.0 + 40.0 * rs.rand(),
                      110.0 + gz * 85.0])
        r = 35.0 + 10.0 * rs.rand()
        mesh = mesh_mod.make_sphere(center=c, radius=r,
                                    n_theta=n_theta, n_phi=n_phi)
        verts.append(mesh.positions)
        faces.append(mesh.indices + voff)
        voff += len(mesh.positions)
    positions = np.concatenate(verts)
    indices = np.concatenate(faces)
    obj = os.path.join(tmp, "garden.obj")
    with open(obj, "w") as f:
        for p in positions:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for a, b, c in indices + 1:
            f.write(f"f {a} {b} {c}\n")

    xml = os.path.join(tmp, "garden.xml")
    with open(xml, "w") as f:
        f.write(f"""<scene version="0.5.0">
  <integrator type="path"><integer name="maxDepth" value="{max_depth}"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="55"/>
    <transform name="toWorld">
      <lookat origin="278, 273, -700" target="278, 173, 279" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="{spp}"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="{width}"/><integer name="height" value="{height}"/>
      <rfilter type="box"/>
    </film>
  </sensor>
  <bsdf type="diffuse" id="white"><rgb name="reflectance" value="0.7 0.7 0.7"/></bsdf>
  <bsdf type="roughconductor" id="metal">
    <float name="alpha" value="0.1"/><string name="material" value="Al"/>
  </bsdf>
  <shape type="obj">
    <string name="filename" value="{obj}"/>
    <ref id="metal"/>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld">
      <scale x="300" y="300" z="1"/><rotate x="1" angle="-90"/>
      <translate x="278" y="0" z="279"/>
    </transform>
    <ref id="white"/>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld">
      <scale x="65" y="52" z="1"/><rotate x="1" angle="90"/>
      <translate x="278" y="548" z="279"/>
    </transform>
    <ref id="white"/>
    <emitter type="area"><rgb name="radiance" value="15 15 15"/></emitter>
  </shape>
</scene>
""")
    return xml


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tris", type=int, default=1_000_000)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-depth", type=int, default=5)
    args = ap.parse_args()

    xml = build_scene(args.tris, args.size, args.size, args.spp,
                      args.max_depth)
    from gradientdomain_mitsuba_tpu.scene import scene as sc
    t0 = time.time()
    scene, st = sc.load_scene(xml)
    n_tris = int(scene.geom.indices.shape[0])
    k = int(scene.geom.clusters.offset.shape[0])
    print(f"scene: {n_tris} tris, {k} clusters x window "
          f"{st.cluster_window}, load+BVH {time.time()-t0:.1f}s")

    import jax
    from gradientdomain_mitsuba_tpu.models.path import PathTracer
    scene = jax.device_put(scene)
    tracer = PathTracer(scene, st)
    # warm-up MUST use the same chunk (render_chunk is jitted per static
    # sample count)
    img = tracer.render(scene, seed=0, spp=args.spp, chunk=args.spp)
    t0 = time.time()
    img = tracer.render(scene, seed=1, spp=args.spp, chunk=args.spp)
    dt = time.time() - t0
    rays = args.size * args.size * args.spp * (1 + (args.max_depth - 1) * 2)
    print(f"path {args.spp}spp {args.size}^2 maxDepth={args.max_depth}: "
          f"{dt:.2f}s -> {rays/dt/1e6:.1f} Mrays/s")
    print("mean radiance:", float(np.asarray(img).mean()))


if __name__ == "__main__":
    main()
