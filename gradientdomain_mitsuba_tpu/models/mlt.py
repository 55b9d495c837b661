"""Metropolis light transport over the bidirectional path sampler.

Replacement for the `mlt` integrator
(src/integrators/mlt/mlt.cpp + libbidir PathSampler in "bidirectional"
mode): the reference runs a handful of Markov chains, each mutating a
full bidirectional path with Veach's technique-aware mutations
(bidirectional / lens / caustic / multi-chain perturbations).  Here the
same target function — the FULL BDPT strategy family f(u), every (s,t)
connection including the light-traced t=1 splats, MIS-combined with the
power heuristic — is explored by thousands of independent lockstep
chains in primary sample space with the Kelemen kernel:

  * each chain's state is a compact vector u in [0,1)^D that drives
    BOTH subpath walks of models/bdpt.py (the sparse rng dim space of
    the eye and light streams is bijected onto a dense [0, D) index
    range, so BDPTracer is reused verbatim as the contribution
    function);
  * a mutation perturbs every coordinate (small step) or redraws u
    (large step); acceptance uses the scalar importance
    I(u) = lum(L_eye(u)) + sum_s lum(splat_s(u)) over all light-image
    splats, and every component is deposited at its own film position
    with the Kelemen expected-value weights.

Veach's structured perturbations exist to raise acceptance on specular
chains; `_mutate_small` maps the whole family — multi-chain, lens,
caustic, and the manifold perturbation (libbidir/manifold.cpp) — to
fixed coordinate-subset Kelemen kernels.  The manifold walk comes for
free from the half-vector parameterization of the microfacet samplers:
freezing every bounce coordinate while perturbing an endpoint replays
the specular chain with identical half vectors, the first-order
manifold step, with no Newton iterations and no divergence (one
mutation = one dense [C]-wide BDPT wavefront pass).
Two-stage bootstrap (resampled seeding + luminance normalization b) as
in pssmlt.py.  `sampleDirect`-style separation is unnecessary: all
strategies ride the chains.
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
from .bdpt import BDPTracer, LIGHT_DIM_BASE

# Kelemen small-step kernel bounds (mlt/pssmlt reference defaults)
S1 = 1.0 / 1024.0
S2 = 1.0 / 64.0


class _PSSBDPTracer(BDPTracer):
    """BDPTracer whose random streams read an explicit PSS tensor.

    The `seed` slot of trace_pass carries a [C, D] tensor of primary
    samples; `_u1`/`_u2` remap the integrator's sparse dim ids (eye
    stream at 0.., light stream at LIGHT_DIM_BASE..) onto dense columns.
    The pixel-jitter draw is rescaled to span the whole film so the
    chain position is entirely PSS-driven (pixel_id is passed as 0).
    """

    def __init__(self, scene, settings):
        super().__init__(scene, settings)
        eye_span = DA.NUM_CAMERA_DIMS * (self.TE + 1)
        light_span = DA.NUM_BOUNCE_DIMS * (self.SM + 1)
        self.n_dims = eye_span + light_span
        self.eye_span = eye_span
        wh = jnp.asarray([settings.width, settings.height], jnp.float32)

        def remap(dim):
            d = int(dim)
            if d < LIGHT_DIM_BASE:
                if d >= eye_span:
                    raise ValueError(f"eye dim {d} exceeds span {eye_span}")
                return d
            d = eye_span + (d - LIGHT_DIM_BASE)
            if d >= self.n_dims:
                raise ValueError(f"light dim {dim} exceeds span {self.n_dims}")
            return d

        def u1(pss, pixel_id, sample_idx, dim):
            del pixel_id, sample_idx
            return jnp.take(pss, remap(dim), axis=1)

        def u2(pss, pixel_id, sample_idx, dim):
            del pixel_id, sample_idx
            i = remap(dim)
            u = jnp.stack([jnp.take(pss, i, axis=1),
                           jnp.take(pss, i + 1, axis=1)], -1)
            if int(dim) == DA.PIXEL_JITTER:
                u = u * wh
            return u

        self._u1, self._u2 = u1, u2


class MLTracer:
    """Parallel-chain path-space MLT.  settings.integrator_props honors
    `pLarge` (default 0.3), `chains` (default 4096), `luminanceSamples`
    (bootstrap size, default 4x chains)."""

    def __init__(self, scene, settings):
        self.settings = settings
        self.inner = _PSSBDPTracer(scene, settings)
        props = settings.integrator_props
        self.p_large = float(props.get("pLarge", 0.3))
        self.n_chains = int(props.get("chains", 4096))
        self.n_bootstrap = int(props.get("luminanceSamples",
                                         4 * self.n_chains))
        self.n_dims = self.inner.n_dims
        self.eye_span = self.inner.eye_span

    # -- f(u): one full BDPT evaluation per chain ---------------------------
    def _eval(self, scene, u):
        C = u.shape[0]
        pid = jnp.zeros(C, jnp.uint32)
        pos, L, spos, sval = self.inner.trace_pass(scene, u, 0,
                                                   pixel_id=pid)
        L = jnp.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        sval = jnp.nan_to_num(sval, nan=0.0, posinf=0.0, neginf=0.0)
        K = sval.shape[0] // C if C else 0
        I = luminance(L)
        if K:
            I = I + luminance(sval).reshape(K, C).sum(0)
        return pos, L, spos, sval, I

    def _splat(self, fb, pos, L, spos, sval, w):
        """Deposit one state's full contribution set, scaled by w [C]."""
        fb = film_ops.splat_unfiltered(fb, pos, L * w[:, None])
        if sval.shape[0]:
            K = sval.shape[0] // w.shape[0]
            wt = jnp.tile(w, K)
            fb = film_ops.splat_unfiltered(fb, spos, sval * wt[:, None])
        return fb

    def _fresh(self, seed, it, C):
        ids = jnp.arange(C, dtype=jnp.uint32)[:, None]
        dims = jnp.arange(self.n_dims, dtype=jnp.uint32)[None, :]
        return uniform_float(seed, ids, it, dims)

    def _mutate_small(self, seed, it, u):
        """Structured small-step family (the Veach mutation set of
        mlt.cpp + libbidir's manifold perturbation, mapped to primary
        sample space).  Kernel mix per chain per iteration:

          p=1/2  ALL coordinates (multi-chain perturbation analog);
          p=1/8  EYE subpath only (light subpath frozen, so
                 caustic-casting light chains survive while the camera
                 end explores);
          p=1/8  LIGHT subpath only (caustic perturbation analog);
          p=1/8  LENS-MANIFOLD: camera-sample block only (pixel jitter
                 + aperture), EVERY bounce coordinate frozen on both
                 subpaths.  Because the microfacet BSDF samplers are
                 half-vector-parameterized (ops/bsdf.py draws the NDF
                 half vector from the frozen coordinates), the specular
                 chain re-traces with IDENTICAL half vectors while the
                 lens point moves — the first-order manifold walk of
                 libbidir/manifold.cpp (and the half-vector-space step
                 of Kaplanyan et al.'s HSLT) realized by replay instead
                 of Newton iteration;
          p=1/8  CAUSTIC-MANIFOLD: light-origin block only (emitter
                 pick + position/direction), all other coordinates
                 frozen — slides the light endpoint under a frozen
                 half-vector chain.

        Each restricted kernel acts on a FIXED coordinate subset, so it
        is symmetric and the acceptance ratio is unchanged; mixing fixed
        kernels by an independent coin keeps detailed balance per
        kernel.  (A state-dependent subset — e.g. "the dims of specular
        vertices" — would break symmetry, which is why the manifold
        kernels freeze by position, not by vertex classification.)"""
        C = u.shape[0]
        ids = jnp.arange(C, dtype=jnp.uint32)[:, None]
        dims = jnp.arange(self.n_dims, dtype=jnp.uint32)[None, :]
        r = uniform_float(seed ^ 0x5bd1, ids, it, 2048 + dims)
        s = uniform_float(seed ^ 0x9e37, ids, it, 4096 + dims)
        mag = S2 * jnp.exp(-jnp.log(S2 / S1) * r)
        delta = jnp.where(s < 0.5, mag, -mag)
        kind = uniform_float(seed ^ 0x7e45, ids[:, 0], it, 6144)[:, None]
        is_eye = dims < self.eye_span                      # [1, D]
        is_lens = dims < DA.NUM_CAMERA_DIMS
        is_light_origin = (~is_eye) & (
            dims < self.eye_span + DA.NUM_BOUNCE_DIMS)
        keep = jnp.where(
            kind < 0.5, True,
            jnp.where(kind < 0.625, is_eye,
                      jnp.where(kind < 0.75, ~is_eye,
                                jnp.where(kind < 0.875, is_lens,
                                          is_light_origin))))
        return (u + jnp.where(keep, delta, 0.0)) % 1.0

    @functools.partial(jax.jit, static_argnums=(0, 3))
    def _run(self, scene, seed, n_iters):
        st = self.settings
        C = self.n_chains

        # ---- two-stage bootstrap (normalization b + resampled seeds) ------
        B = self.n_bootstrap
        rounds = max(1, B // C)
        cand_u = self._fresh(seed ^ 0xb00, 0, C)
        _, _, _, _, cand_I = self._eval(scene, cand_u)

        def boot_round(i, acc):
            u = self._fresh(seed ^ 0xb00, i + 1, C)
            _, _, _, _, I = self._eval(scene, u)
            return acc + jnp.sum(I)
        acc = jax.lax.fori_loop(0, rounds - 1, boot_round,
                                jnp.sum(cand_I))
        b = acc / (rounds * C)

        cdf = jnp.cumsum(cand_I)
        cdf = cdf / jnp.maximum(cdf[-1], 1e-30)
        ids = jnp.arange(C, dtype=jnp.uint32)
        jitter = uniform_float(seed ^ 0x5eed, jnp.zeros(1, jnp.uint32),
                               0, 0)[0]
        picks = jnp.searchsorted(cdf, (jnp.arange(C) + jitter) / C)
        u0 = cand_u[jnp.clip(picks, 0, C - 1)]
        pos0, L0, spos0, sval0, I0 = self._eval(scene, u0)

        fb = jnp.zeros((st.height, st.width, 3))

        def mstep(it, carry):
            u, pos, L, spos, sval, I, fb = carry
            u_ls = uniform_float(seed ^ 0x1a56e, ids, it, 0)
            large = u_ls < self.p_large
            uy = jnp.where(large[:, None],
                           self._fresh(seed, it, C),
                           self._mutate_small(seed, it, u))
            pos_y, Ly, spos_y, sval_y, Iy = self._eval(scene, uy)

            a = jnp.clip(Iy / jnp.maximum(I, 1e-30), 0.0, 1.0)
            wx = (1.0 - a) * b / jnp.maximum(I, 1e-30)
            wy = a * b / jnp.maximum(Iy, 1e-30)
            fb = self._splat(fb, pos, L, spos, sval, wx)
            fb = self._splat(fb, pos_y, Ly, spos_y, sval_y, wy)

            take = uniform_float(seed ^ 0xacce97, ids, it, 1) < a
            t1 = take[:, None]
            tk = jnp.tile(take, max(sval.shape[0] // C, 1))[:, None]
            u = jnp.where(t1, uy, u)
            pos = jnp.where(t1, pos_y, pos)
            L = jnp.where(t1, Ly, L)
            spos = jnp.where(tk, spos_y, spos) if sval.shape[0] else spos
            sval = jnp.where(tk, sval_y, sval) if sval.shape[0] else sval
            I = jnp.where(take, Iy, I)
            return u, pos, L, spos, sval, I, fb

        carry = (u0, pos0, L0, spos0, sval0, I0, fb)
        fb = jax.lax.fori_loop(0, n_iters, mstep, carry)[-1]
        scale = (st.width * st.height) / jnp.maximum(
            jnp.asarray(n_iters * C, jnp.float32), 1.0)
        return fb * scale, b

    def render(self, scene, seed=0, spp=None, **_):
        """spp = average mutations per pixel (equal-sample accounting)."""
        st = self.settings
        spp = spp or st.spp
        n_iters = max(1, (st.width * st.height * spp) // self.n_chains)
        img, b = self._run(scene, seed, n_iters)
        self.last_b = float(np.asarray(b))
        return img


def render(scene, settings, seed=0, spp=None):
    return MLTracer(scene, settings).render(scene, seed=seed, spp=spp)
