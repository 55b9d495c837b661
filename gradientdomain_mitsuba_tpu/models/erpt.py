"""Energy redistribution path tracing (Cline, Talbot, Egbert 2005).

Replacement for src/integrators/erpt/erpt.{h,cpp}: the
reference seeds finite Metropolis chains from ordinary path-tracer
samples and redistributes each seed's energy through SMALL path-space
perturbations (lens/caustic/multi-chain mutations).  Here the same
estimator runs in primary sample space over a lockstep wavefront of
chains (the counter-RNG PSS machinery of models/pssmlt.py):

  - every redistribution ROUND draws a fresh uniform candidate per
    chain (that candidate is an ordinary PT sample — the "deposition
    energy" bootstrap and the chain seed in one),
  - chains are resampled from the candidate pool proportional to
    luminance (equal-energy seeding, the PSS analog of Cline's
    energy-proportional chain count),
  - each chain runs `chainLength` small Kelemen steps, splatting the
    Kelemen-weighted expected-value estimate at x and y,
  - rounds repeat until the mutation budget (spp x W x H) is spent.

The per-round normalization b_r comes from the round's own candidate
pool, so redistribution stays consistent even as the pool is re-drawn —
in the limit of one mutation per chain this degenerates to plain PT,
matching the reference's behavior with numChains -> 0.  Veach-style
path-space mutation kernels (mut_lens/mut_caustic/mut_mchain) are
subsumed by the symmetric Kelemen small-step kernel on the replayed
random stream (documented deviation: same stationary distribution,
different proposal family).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.rng import uniform_float
from ..ops import film as film_ops
from .pssmlt import PSSMLTracer


class ERPTracer(PSSMLTracer):
    """integrator_props: `chains` (parallel chains, default 8192),
    `chainLength` (small steps per redistribution round, default 100,
    erpt.cpp numChains*directSamples analog), maxDepth/rrDepth as
    usual."""

    def __init__(self, scene, settings):
        super().__init__(scene, settings)
        props = settings.integrator_props
        self.chain_len = int(props.get("chainLength", 100))

    @functools.partial(jax.jit, static_argnums=(0, 4))
    def _run_round(self, scene, seed, round_idx, n_steps):
        """One redistribution round: fresh candidates -> b_r + seeds ->
        chainLength small mutations with Kelemen splatting."""
        st = self.settings
        C = self.n_chains
        ids = jnp.arange(C, dtype=jnp.uint32)

        cand_u = self._fresh(seed ^ (0xe271 + round_idx), 0, C)
        _, _, cand_I = self._eval(scene, cand_u)
        b = jnp.mean(cand_I)

        cdf = jnp.cumsum(cand_I)
        cdf = cdf / jnp.maximum(cdf[-1], 1e-30)
        jitter = uniform_float(seed ^ 0x5eed, jnp.zeros(1, jnp.uint32),
                               round_idx, 0)[0]
        picks = jnp.searchsorted(cdf, (jnp.arange(C) + jitter) / C)
        u0 = cand_u[jnp.clip(picks, 0, C - 1)]
        pos0, L0, I0 = self._eval(scene, u0)

        fb = jnp.zeros((st.height, st.width, 3))

        def mstep(it, carry):
            u, pos, L, I, fb = carry
            step = round_idx * n_steps + it
            uy = self._mutate_small(seed, step, u)
            pos_y, Ly, Iy = self._eval(scene, uy)
            a = jnp.clip(Iy / jnp.maximum(I, 1e-30), 0.0, 1.0)
            wx = (1.0 - a) * b / jnp.maximum(I, 1e-30)
            wy = a * b / jnp.maximum(Iy, 1e-30)
            fb = film_ops.splat_unfiltered(fb, pos, L * wx[:, None])
            fb = film_ops.splat_unfiltered(fb, pos_y, Ly * wy[:, None])
            u_acc = uniform_float(seed ^ 0xacce97, ids, step, 1)
            take = u_acc < a
            u = jnp.where(take[:, None], uy, u)
            pos = jnp.where(take[:, None], pos_y, pos)
            L = jnp.where(take[:, None], Ly, L)
            I = jnp.where(take, Iy, I)
            return u, pos, L, I, fb

        _, _, _, _, fb = jax.lax.fori_loop(
            0, n_steps, mstep, (u0, pos0, L0, I0, fb))
        return fb

    def render(self, scene, seed=0, spp=None, **_):
        st = self.settings
        spp = spp or st.spp
        total_mut = st.width * st.height * spp
        per_round = self.n_chains * self.chain_len
        n_rounds = max(1, total_mut // per_round)
        fb = None
        for r in range(n_rounds):
            fbr = self._run_round(scene, seed, jnp.uint32(r),
                                  self.chain_len)
            fb = fbr if fb is None else fb + fbr
        scale = (st.width * st.height) / float(
            n_rounds * self.n_chains * self.chain_len)
        return np.asarray(fb) * scale


def render(scene, settings, seed=0, spp=None):
    return ERPTracer(scene, settings).render(scene, seed=seed, spp=spp)
