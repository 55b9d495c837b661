"""Multi-host (multi-process) rendering over DCN — the mtssrv analog.

Replacement for Mitsuba's cluster rendering
(src/libcore/sched_remote.cpp + src/mitsuba/mtssrv.cpp, SURVEY.md §6.8):
instead of a TCP daemon receiving serialized scenes and work units, every
process loads the scene from disk itself (replicated resource), joins a
jax.distributed coordination service, and participates in ONE global
`jax.sharding.Mesh` spanning all processes' devices.  The existing
row-sharded tile renderer (parallel/tiles.py) then runs unchanged — its
`ppermute` halo exchange crosses process boundaries over DCN exactly
where the single-host version crosses the local interconnect — and the
final film is
gathered to every host with `process_allgather`.

Tested without a real cluster by spawning N CPU-backend processes on one
machine (tests/test_multihost.py), the same trick the multi-chip tests
use for virtual devices (SURVEY.md §5).
"""
from __future__ import annotations

import numpy as np


def init(coordinator_address: str, num_processes: int, process_id: int,
         local_device_count: int | None = None) -> None:
    """Join the distributed runtime.  Call BEFORE any jax operation.

    coordinator_address: "host:port" of process 0 (reference analog: the
    mtssrv node list passed to `mitsuba -c`).  On CPU backends,
    local_device_count forces that many virtual devices per process."""
    import os
    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        want = f"--xla_force_host_platform_device_count={local_device_count}"
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (flags + " " + want).strip()
    import jax
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh():
    """1-D mesh over ALL processes' devices, in process-major order so
    each process owns a contiguous block of film rows (minimizes DCN
    halo traffic: only the block seams cross hosts)."""
    import jax
    from jax.sharding import Mesh
    from ..parallel.tiles import AXIS
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devs), (AXIS,))


def render_gpt_multihost(tracer, scene, seed, n_samples):
    """Row-sharded G-PT render over the global mesh; returns the fully
    replicated buffers dict on every host (tiles._gather_host performs
    the cross-process film gather)."""
    from ..parallel import tiles
    mesh = global_mesh()
    return tiles.render_tiles_gpt(tracer, scene, mesh, seed, n_samples)


def render_path_multihost(tracer, scene, seed, n_samples):
    """Row-sharded plain-PT render over the global mesh."""
    from ..parallel import tiles
    mesh = global_mesh()
    return tiles.render_tiles_path(tracer, scene, mesh, seed, n_samples)
