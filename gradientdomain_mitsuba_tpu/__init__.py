"""Gradient-domain renderer in JAX.

A brand-new JAX/Pallas framework with the capabilities of
``mmanzi/gradientdomain-mitsuba`` (Mitsuba 0.5 + gradient-domain path
tracing [Kettunen et al. 2015] + gradient-domain BDPT [Manzi et al. 2015]
+ screened-Poisson reconstruction), re-designed for accelerators:

- wavefront (not megakernel) light transport over SoA batches in
  device memory
- counter-based RNG so shift-mapped offset paths replay base-path random
  numbers by construction (reference: gradientdomain-mitsuba needs
  explicit sampler state copying in src/integrators/gpt/gpt.cpp)
- scatter-add framebuffers; on-device screened-Poisson reconstruction
- multi-chip tile parallelism via jax.sharding.Mesh + shard_map

Layout (mirrors SURVEY.md layer map):
  core/      math, RNG, sampling warps, records      (ref: src/libcore)
  scene/     XML loader, meshes, BVH build, scene IR (ref: src/librender scene I/O)
  ops/       device kernels: intersect, BSDFs, film, poisson (ref: hot C++ paths)
  models/    integrators: path, gpt, bdpt, gbdpt     (ref: src/integrators)
  parallel/  mesh/tile sharding, halo exchange       (ref: src/libcore/sched*.cpp)
  utils/     EXR I/O, CLI, logging                   (ref: src/libcore/bitmap.cpp, mitsuba.cpp)
"""

__version__ = "0.1.0"

from .utils import jaxconfig as _jaxconfig

_jaxconfig.configure()
