"""Primary-sample-space Metropolis light transport (Kelemen et al. 2002).

Replacement for the `pssmlt` integrator
(src/integrators/pssmlt/pssmlt.cpp + libbidir PathSampler in
"unidirectional" mode): instead of one Markov chain per worker thread
mutating a sampler-replay stream, thousands of INDEPENDENT chains run in
lockstep as one wavefront, each chain's state being an explicit vector of
primary samples u in [0,1)^D.  The path tracer consumes u directly — the
counter-RNG sampler closures are overridden to index the chain's PSS
buffer, so the whole of models/path.py (NEE, MIS, RR) is reused verbatim
as the measurement contribution function f(u).

Estimator (Kelemen): chains equilibrate to pi(u) = I(u)/b with
I = luminance(f) and b = E_uniform[I] (bootstrap estimate); every
mutation splats (1-a) b f(x)/I(x) at x and a b f(y)/I(y) at y, and the
final image is splat_sum * (W H / n_mutations).  Expected-value
optimization and two-stage seeding (resampled bootstrap) included;
Veach-MLT's path-space mutations (mlt/erpt, manifold walks) remain out
of scope.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.rng import DimAllocator as DA
from ..core.rng import uniform_float
from ..core.spectrum import luminance
from ..ops import film as film_ops
from ..ops import sensor as sensor_ops
from .path import PathTracer

# Kelemen small-step kernel bounds (pssmlt.cpp defaults)
S1 = 1.0 / 1024.0
S2 = 1.0 / 64.0


def _pss_u1(pss, pixel_id, sample_idx, dim):
    del pixel_id, sample_idx
    return jnp.take(pss, dim, axis=1)


def _pss_u2(pss, pixel_id, sample_idx, dim):
    del pixel_id, sample_idx
    a = jnp.take(pss, dim, axis=1)
    b = jnp.take(pss, jnp.asarray(dim) + 1, axis=1)
    return jnp.stack([a, b], -1)


class _PSSPathTracer(PathTracer):
    """PathTracer whose random stream is an explicit PSS tensor passed
    through the `seed` slot of trace_rays."""

    def __init__(self, scene, settings):
        super().__init__(scene, settings)
        self._u1 = _pss_u1
        self._u2 = _pss_u2


class PSSMLTracer:
    """Parallel-chain PSSMLT.  settings.integrator_props honors
    `pLarge` (large-step probability, default 0.3), `chains`
    (default 8192), `luminanceSamples` (bootstrap size, default 4x
    chains)."""

    def __init__(self, scene, settings):
        self.settings = settings
        self.inner = _PSSPathTracer(scene, settings)
        props = settings.integrator_props
        self.p_large = float(props.get("pLarge", 0.3))
        self.n_chains = int(props.get("chains", 8192))
        self.n_bootstrap = int(props.get("luminanceSamples",
                                         4 * self.n_chains))
        self.n_dims = (DA.NUM_CAMERA_DIMS +
                       self.inner.n_bounces * DA.NUM_BOUNCE_DIMS)

    # -- f(u): trace one path per chain ------------------------------------
    def _eval(self, scene, u):
        st = self.settings
        C = u.shape[0]
        pos_film = u[:, 0:2] * jnp.asarray(
            [st.width, st.height], jnp.float32)
        o, d = sensor_ops.sample_ray(scene.camera, st.width, st.height,
                                     pos_film, u[:, 2:4])
        ids = jnp.arange(C, dtype=jnp.uint32)
        L = self.inner.trace_rays(scene, u, 0, ids, o, d)
        L = jnp.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        return pos_film, L, luminance(L)

    def _fresh(self, seed, it, C):
        """Uniform PSS vectors from the counter RNG (chain, iter, dim) —
        one broadcast draw for the whole [C, D] block."""
        ids = jnp.arange(C, dtype=jnp.uint32)[:, None]
        dims = jnp.arange(self.n_dims, dtype=jnp.uint32)[None, :]
        return uniform_float(seed, ids, it, dims)

    def _mutate_small(self, seed, it, u):
        """Kelemen exponential small step, wrapped to [0,1)."""
        C = u.shape[0]
        ids = jnp.arange(C, dtype=jnp.uint32)[:, None]
        dims = jnp.arange(self.n_dims, dtype=jnp.uint32)[None, :]
        r = uniform_float(seed ^ 0x5bd1, ids, it, 2048 + dims)
        s = uniform_float(seed ^ 0x9e37, ids, it, 4096 + dims)
        mag = S2 * jnp.exp(-jnp.log(S2 / S1) * r)
        delta = jnp.where(s < 0.5, mag, -mag)
        return (u + delta) % 1.0

    @functools.partial(jax.jit, static_argnums=(0, 3))
    def _run(self, scene, seed, n_iters):
        st = self.settings
        C = self.n_chains

        # ---- bootstrap: b and resampled initial states --------------------
        B = self.n_bootstrap
        rounds = max(1, B // C)
        # round 0's candidates seed the chains (resampled ~ I below —
        # that distribution IS pi restricted to the candidate atoms, the
        # standard consistent two-stage seeding); later rounds only
        # refine the luminance normalization b
        cand_u = self._fresh(seed ^ 0xb00, 0, C)
        _, _, cand_I = self._eval(scene, cand_u)

        def boot_round(i, acc):
            u = self._fresh(seed ^ 0xb00, i + 1, C)
            _, _, I = self._eval(scene, u)
            return acc + jnp.sum(I)
        acc = jax.lax.fori_loop(0, rounds - 1, boot_round,
                                jnp.sum(cand_I))
        b = acc / (rounds * C)

        # systematic resampling of initial states ~ I (within the
        # candidate set; removes dead chains, standard two-stage seeding)
        cdf = jnp.cumsum(cand_I)
        cdf = cdf / jnp.maximum(cdf[-1], 1e-30)
        ids = jnp.arange(C, dtype=jnp.uint32)
        jitter = uniform_float(seed ^ 0x5eed, jnp.zeros(1, jnp.uint32),
                               0, 0)[0]
        picks = jnp.searchsorted(cdf, (jnp.arange(C) + jitter) / C)
        u0 = cand_u[jnp.clip(picks, 0, C - 1)]
        pos0, L0, I0 = self._eval(scene, u0)

        fb = jnp.zeros((st.height, st.width, 3))

        def mstep(it, carry):
            u, pos, L, I, fb = carry
            u_ls = uniform_float(seed ^ 0x1a56e, ids, it, 0)
            large = u_ls < self.p_large
            u_large = self._fresh(seed, it, C)
            u_small = self._mutate_small(seed, it, u)
            uy = jnp.where(large[:, None], u_large, u_small)
            pos_y, Ly, Iy = self._eval(scene, uy)

            a = jnp.clip(Iy / jnp.maximum(I, 1e-30), 0.0, 1.0)
            wx = (1.0 - a) * b / jnp.maximum(I, 1e-30)
            wy = a * b / jnp.maximum(Iy, 1e-30)
            fb = film_ops.splat_unfiltered(fb, pos, L * wx[:, None])
            fb = film_ops.splat_unfiltered(fb, pos_y, Ly * wy[:, None])

            u_acc = uniform_float(seed ^ 0xacce97, ids, it, 1)
            take = u_acc < a
            u = jnp.where(take[:, None], uy, u)
            pos = jnp.where(take[:, None], pos_y, pos)
            L = jnp.where(take[:, None], Ly, L)
            I = jnp.where(take, Iy, I)
            return u, pos, L, I, fb

        _, _, _, _, fb = jax.lax.fori_loop(
            0, n_iters, mstep, (u0, pos0, L0, I0, fb))
        scale = (st.width * st.height) / jnp.maximum(
            jnp.asarray(n_iters * C, jnp.float32), 1.0)
        return fb * scale, b

    def render(self, scene, seed=0, spp=None, **_):
        """spp is interpreted as average mutations per pixel (matches the
        reference's equal-sample accounting)."""
        st = self.settings
        spp = spp or st.spp
        n_iters = max(1, (st.width * st.height * spp) // self.n_chains)
        img, b = self._run(scene, seed, n_iters)
        self.last_b = float(np.asarray(b))
        return img


def render(scene, settings, seed=0, spp=None):
    return PSSMLTracer(scene, settings).render(scene, seed=seed, spp=spp)
