"""Adaptive sampling wrapper (src/integrators/adaptive/adaptive.cpp).

The reference wraps a SamplingIntegrator and keeps sampling each 32x32
block until a t-test bounds the pixel error below `maxError` relative to
the scene's average luminance (or `maxSampleFactor` is hit).  The
This version keeps the same statistics but replaces block-serial
resampling with WAVEFRONT REFINEMENT: every round gathers the
still-unconverged pixel ids into one fixed-size batch (static shape for
XLA; sorted by error so the worst pixels refine first) and traces them
together — per-lane sample indices keep the counter RNG stream exactly
where each pixel left off, so the result is deterministic and identical
to having rendered each pixel with its final sample count directly.

Child integrator: the wrapped <integrator> child (path/direct/volpath);
depth knobs are inherited at scene compile (scene.py).  Only
path-family children are supported (the reference has the same
SamplingIntegrator restriction).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import film as film_ops
from .path import PathTracer

_LUM_W = np.asarray([0.2126, 0.7152, 0.0722], np.float32)


class AdaptiveTracer:
    """integrator_props: maxError (default 0.05), pValue quantile z
    (default 1.96 ~ 95%), maxSampleFactor (default 32: cap =
    factor * base spp), refineFraction (lanes per refine round as a
    fraction of the film, default 0.25)."""

    def __init__(self, scene, settings):
        self.settings = settings
        props = settings.integrator_props
        child = settings.integrator_children[0] if \
            settings.integrator_children else ("path", {})
        if child[0] not in ("path", "direct", "ao"):
            raise ValueError(
                f"adaptive: unsupported child integrator '{child[0]}'")
        self.inner = PathTracer(scene, settings)
        self.max_error = float(props.get("maxError", 0.05))
        self.quantile = float(props.get("pValue", 1.96))
        self.max_factor = int(props.get("maxSampleFactor", 32))
        self.refine_frac = float(props.get("refineFraction", 0.25))
        self.last_sample_map = None

    @functools.partial(jax.jit, static_argnums=(0,))
    def _base_pass(self, scene, seed, sample_idx, acc, acc2, cnt):
        pos, L = self.inner.trace_pass(scene, seed, sample_idx)
        L = jnp.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        lum = jnp.matmul(L, _LUM_W, precision=jax.lax.Precision.HIGHEST)
        return acc + L, acc2 + lum * lum, cnt + 1.0

    @functools.partial(jax.jit, static_argnums=(0,))
    def _refine_pass(self, scene, seed, ids, live, sample_idx,
                     acc, acc2, cnt):
        """Trace one extra sample for the gathered pixel ids (masked
        lanes contribute nothing)."""
        pos, L = self.inner.trace_pass(scene, seed, sample_idx,
                                       pixel_id=ids)
        L = jnp.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        L = jnp.where(live[:, None], L, 0.0)
        lum = jnp.matmul(L, _LUM_W, precision=jax.lax.Precision.HIGHEST)
        acc = acc.at[ids].add(L)
        acc2 = acc2.at[ids].add(lum * lum)
        cnt = cnt.at[ids].add(jnp.where(live, 1.0, 0.0))
        return acc, acc2, cnt

    @functools.partial(jax.jit, static_argnums=(0, 2))
    def _error(self, stats, avg_floor=1e-3):
        acc, acc2, cnt = stats
        mean_l = jnp.matmul(acc, _LUM_W,
                            precision=jax.lax.Precision.HIGHEST) / cnt
        var = jnp.maximum(acc2 / cnt - mean_l ** 2, 0.0) * (
            cnt / jnp.maximum(cnt - 1.0, 1.0))
        std_err = jnp.sqrt(var / cnt)
        avg = jnp.maximum(jnp.mean(mean_l), avg_floor)
        return self.quantile * std_err / avg

    def render(self, scene, seed=0, spp=None, progress=None, **_):
        st = self.settings
        spp = spp or st.spp
        N = st.width * st.height
        acc = jnp.zeros((N, 3))
        acc2 = jnp.zeros(N)
        cnt = jnp.zeros(N)
        for s in range(spp):
            acc, acc2, cnt = self._base_pass(scene, seed, jnp.uint32(s),
                                             acc, acc2, cnt)
        K = max(256, int(N * self.refine_frac) // 256 * 256)
        K = min(K, N)
        max_rounds = (self.max_factor - 1) * spp * max(N // K, 1)
        for r in range(max_rounds):
            err = np.asarray(self._error((acc, acc2, cnt)))
            unconv = err > self.max_error
            n_un = int(unconv.sum())
            if n_un == 0:
                break
            order = np.argsort(-err)[:K].astype(np.uint32)
            live = unconv[order]
            # per-lane stream position = that pixel's sample count
            s_idx = np.asarray(cnt)[order].astype(np.uint32)
            acc, acc2, cnt = self._refine_pass(
                scene, seed, jnp.asarray(order), jnp.asarray(live),
                jnp.asarray(s_idx), acc, acc2, cnt)
            if progress:
                progress(r + 1, max_rounds)
        cnt_np = np.asarray(cnt)
        self.last_sample_map = cnt_np.reshape(st.height, st.width)
        img = np.asarray(acc) / cnt_np[:, None]
        return img.reshape(st.height, st.width, 3)


def render(scene, settings, seed=0, spp=None):
    return AdaptiveTracer(scene, settings).render(scene, seed=seed,
                                                  spp=spp)
