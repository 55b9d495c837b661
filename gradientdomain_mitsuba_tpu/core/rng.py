"""Counter-based stateless RNG — the keystone primitive of this framework.

The reference (mmanzi/gradientdomain-mitsuba) uses a stateful SFMT Mersenne
twister per worker thread (src/libcore/random.cpp) and needs careful sampler
state replay so that shift-mapped offset paths consume the SAME random
numbers as the base path (cf. libbidir's ReplayableSampler, rsampler.cpp).

Here every random number is a pure function

    u = U(seed, pixel_id, sample_idx, dim)

so replay is free by construction: the lockstep G-PT/G-BDPT kernels draw a
number once per (base pixel, sample, dim) and hand it to the base path and
all four offset paths.  Checkpoint/resume is exact (resume = continue at the
next sample_idx), and multi-chip rendering needs no RNG coordination at all.

The hash is a 3-round Feistel-free mix built from lowbias32-style avalanche
steps over uint32 lanes — cheap (a handful of int ops per draw,
no table lookups) and plenty for Monte Carlo integration.  Statistical
quality is validated by the chi^2 tests in tests/test_rng.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_M1 = np.uint32(0x7FEB352D)
_M2 = np.uint32(0x846CA68B)
_GOLDEN = np.uint32(0x9E3779B9)
# 1/2^32 as float32: maps uint32 -> [0, 1)
_INV_2_32 = np.float32(2.3283064365386963e-10)


def _mix(x):
    """lowbias32-style avalanche of a uint32 array."""
    x = x.astype(jnp.uint32)
    x = x ^ (x >> 16)
    x = x * _M1
    x = x ^ (x >> 15)
    x = x * _M2
    x = x ^ (x >> 16)
    return x


def hash_combine(a, b):
    """Combine two uint32 streams (order-sensitive)."""
    a = jnp.asarray(a, jnp.uint32)
    b = jnp.asarray(b, jnp.uint32)
    return _mix(a ^ (_mix(b) + _GOLDEN + (a << 6) + (a >> 2)))


def random_bits(seed, pixel_id, sample_idx, dim):
    """uint32 random bits, pure function of the 4 counters (any broadcastable
    integer arrays)."""
    s = jnp.asarray(seed, jnp.uint32)
    p = jnp.asarray(pixel_id, jnp.uint32)
    i = jnp.asarray(sample_idx, jnp.uint32)
    d = jnp.asarray(dim, jnp.uint32)
    h = _mix(d + _GOLDEN)
    h = hash_combine(h, i)
    h = hash_combine(h, p)
    h = hash_combine(h, s)
    return h


def uniform_float(seed, pixel_id, sample_idx, dim):
    """f32 in [0, 1)."""
    bits = random_bits(seed, pixel_id, sample_idx, dim)
    return bits.astype(jnp.float32) * _INV_2_32


def uniform_2d(seed, pixel_id, sample_idx, dim):
    """Two consecutive dims as a [..., 2] array."""
    u0 = uniform_float(seed, pixel_id, sample_idx, dim)
    u1 = uniform_float(seed, pixel_id, sample_idx, dim + 1)
    return jnp.stack([u0, u1], axis=-1)


def lhs_float(seed, pixel_id, sample_idx, dim, spp):
    """Latin-hypercube stratified sample: over spp samples each pixel
    covers every 1/spp stratum of every dimension exactly once, with an
    independent per-(pixel,dim) stratum permutation (Cranley-Patterson
    rotation).  Replaces the reference's stratified/ldsampler/sobol
    samplers' main variance win while staying a pure counter function —
    shift replay and checkpoint/resume semantics are unchanged.

    The stratum permutation must be INDEPENDENT per dim: a shared
    `(i + h) % spp` rotation leaves consecutive dims on a correlated
    diagonal, which measurably hurts (relMSE above independent sampling
    on cbox).  For power-of-two spp an odd-multiplier LCG step gives a
    cheap per-(pixel, dim) bijection; otherwise fall back to rotation."""
    h = random_bits(jnp.asarray(seed, jnp.uint32) ^ jnp.uint32(0x51A7E),
                    pixel_id, 0, dim)
    i = jnp.asarray(sample_idx, jnp.uint32)
    if spp & (spp - 1) == 0:
        stratum = (i * (h | jnp.uint32(1)) + (h >> 16)) % jnp.uint32(spp)
    else:
        stratum = (i + h) % jnp.uint32(spp)
    u = uniform_float(seed, pixel_id, sample_idx, dim)
    return (stratum.astype(jnp.float32) + u) / spp


def lhs_2d(seed, pixel_id, sample_idx, dim, spp):
    return jnp.stack([lhs_float(seed, pixel_id, sample_idx, dim, spp),
                      lhs_float(seed, pixel_id, sample_idx, dim + 1, spp)],
                     axis=-1)


# --- scrambled (0,2)-sequence (ldsampler / sobol parity) -------------------
# Direction numbers of the 2nd Sobol dimension; dim 1 is van der Corput
# (bit reversal).  XOR-scrambling per (pixel, dim) preserves the (0,2)
# elementary-interval stratification (same construction as the reference's
# ldsampler, src/samplers/ldsampler.cpp) while staying a pure counter
# function of (seed, pixel, sample, dim).
_SOBOL2_DIRS = np.zeros(32, np.uint32)
_v = np.uint32(1 << 31)
for _k in range(32):
    _SOBOL2_DIRS[_k] = _v
    _v = np.uint32(_v ^ (_v >> np.uint32(1)))
del _v, _k


def _reverse_bits32(x):
    x = ((x & np.uint32(0x55555555)) << 1) | ((x & np.uint32(0xAAAAAAAA)) >> 1)
    x = ((x & np.uint32(0x33333333)) << 2) | ((x & np.uint32(0xCCCCCCCC)) >> 2)
    x = ((x & np.uint32(0x0F0F0F0F)) << 4) | ((x & np.uint32(0xF0F0F0F0)) >> 4)
    x = ((x & np.uint32(0x00FF00FF)) << 8) | ((x & np.uint32(0xFF00FF00)) >> 8)
    return (x << 16) | (x >> 16)


def _sobol2_bits(n):
    """2nd Sobol dimension of index n (uint32 bits)."""
    n = jnp.asarray(n, jnp.uint32)
    r = jnp.zeros_like(n)
    for k in range(32):   # static unroll: 32 int ops
        r = r ^ jnp.where((n >> np.uint32(k)) & np.uint32(1),
                          _SOBOL2_DIRS[k], np.uint32(0))
    return r


def sobol02_2d(seed, pixel_id, sample_idx, dim, spp):
    """Scrambled (0,2)-sequence point pair: jointly 2D-stratified over every
    base-2 elementary interval (vs LHS which stratifies marginals only).
    With power-of-two spp each pixel's spp points hit every elementary
    interval of area 1/spp exactly once."""
    i = jnp.asarray(sample_idx, jnp.uint32)
    b0 = _reverse_bits32(i)
    b1 = _sobol2_bits(i)
    s = jnp.asarray(seed, jnp.uint32) ^ np.uint32(0x50B01)
    u0 = (b0 ^ random_bits(s, pixel_id, 0, dim)).astype(jnp.float32)
    u1 = (b1 ^ random_bits(s, pixel_id, 0,
                           jnp.asarray(dim) + 1)).astype(jnp.float32)
    return jnp.stack([u0, u1], axis=-1) * _INV_2_32


# --- scrambled Halton (halton / hammersley samplers) -----------------------
# Per-dimension prime-base radical inverse with a per-(pixel, dim)
# Cranley-Patterson rotation (the rotation replaces the reference's
# permutation scrambling, src/samplers/halton.cpp, and keeps the draw a
# pure counter function).  hammersley maps to the same construction: its
# only difference in the reference is one dimension replaced by i/N,
# which the rotation-decorrelated radical inverse matches in
# discrepancy for the per-pixel sample counts used here.
_PRIMES = np.array([
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61,
    67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137,
    139, 149, 151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199,
    211, 223, 227, 229, 233, 239, 241, 251, 257, 263, 269, 271, 277,
    281, 283, 293, 307, 311], np.uint32)


def halton_float(seed, pixel_id, sample_idx, dim):
    """Rotated radical inverse in base prime[dim % 64] of sample_idx."""
    base = jnp.asarray(_PRIMES)[jnp.asarray(dim) % 64].astype(jnp.uint32)
    n0, pix = jnp.broadcast_arrays(jnp.asarray(sample_idx, jnp.uint32),
                                   jnp.asarray(pixel_id, jnp.uint32))
    inv_b = 1.0 / base.astype(jnp.float32)

    def body(i, c):
        n, res, f = c
        d = (n % base).astype(jnp.float32)
        return n // base, res + d * f, f * inv_b

    # 24 digits covers 2^24 samples in the worst (base 2) case; higher
    # bases just run out of digits early (n becomes 0)
    _, res, _ = jax.lax.fori_loop(
        0, 24, body,
        (n0, jnp.zeros(n0.shape, jnp.float32),
         jnp.broadcast_to(inv_b, n0.shape)))
    s = jnp.asarray(seed, jnp.uint32) ^ np.uint32(0x8A170)
    rot = random_bits(s, pix, 0, dim).astype(jnp.float32) * _INV_2_32
    return (res + rot) % 1.0


def halton_2d(seed, pixel_id, sample_idx, dim):
    return jnp.stack(
        [halton_float(seed, pixel_id, sample_idx, dim),
         halton_float(seed, pixel_id, sample_idx,
                      jnp.asarray(dim) + 1)], axis=-1)


STRATIFIED_SAMPLERS = ()
LDS_SAMPLERS = ("stratified", "ldsampler", "sobol")
HALTON_SAMPLERS = ("halton", "hammersley")


def make_sampler(sampler: str, spp: int):
    """Returns (u1, u2) draw functions for the configured sampler type.
    Unknown types fall back to independent."""
    if sampler in HALTON_SAMPLERS and spp > 1:
        return halton_float, halton_2d
    if sampler in LDS_SAMPLERS and spp > 1:
        def u1(seed, pixel_id, sample_idx, dim):
            return lhs_float(seed, pixel_id, sample_idx, dim, spp)

        def u2(seed, pixel_id, sample_idx, dim):
            return sobol02_2d(seed, pixel_id, sample_idx, dim, spp)
        return u1, u2
    if sampler in STRATIFIED_SAMPLERS and spp > 1:
        def u1(seed, pixel_id, sample_idx, dim):
            return lhs_float(seed, pixel_id, sample_idx, dim, spp)

        def u2(seed, pixel_id, sample_idx, dim):
            return lhs_2d(seed, pixel_id, sample_idx, dim, spp)
        return u1, u2
    return uniform_float, uniform_2d


class DimAllocator:
    """Static bookkeeping of the per-bounce random dimension layout.

    Integrators consume a FIXED number of dims per bounce so that the dim
    counter is a static function of the bounce index (XLA-friendly; no
    data-dependent sampler state).  Layout mirrors what the reference's
    per-bounce sampler calls would consume, in a fixed order.
    """
    # camera-sample dims (before the bounce loop)
    PIXEL_JITTER = 0      # 2 dims
    APERTURE = 2          # 2 dims (thinlens)
    TIME = 4              # 1 dim (reserved)
    NUM_CAMERA_DIMS = 8   # padded

    # per-bounce dims
    D_LIGHT_SELECT = 0    # 1 dim: NEE emitter pick
    D_LIGHT_UV = 1        # 2 dims: position/direction on emitter
    D_BSDF_COMPONENT = 3  # 1 dim: lobe selection
    D_BSDF_UV = 4         # 2 dims: direction sampling
    D_RR = 6              # 1 dim: russian roulette
    NUM_BOUNCE_DIMS = 8   # padded to keep layout stable

    @classmethod
    def bounce_dim(cls, bounce, which):
        return cls.NUM_CAMERA_DIMS + bounce * cls.NUM_BOUNCE_DIMS + which
