"""RGB spectrum helpers (reference: src/libcore/spectrum.cpp with the
default SPECTRUM_SAMPLES=3 build).  A spectrum is any [..., 3] f32 array."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# ITU-R BT.709 luminance weights — same as Mitsuba's Spectrum::getLuminance.
LUMINANCE_WEIGHTS = np.array([0.212671, 0.715160, 0.072169], np.float32)


def luminance(s):
    w = LUMINANCE_WEIGHTS
    return s[..., 0] * w[0] + s[..., 1] * w[1] + s[..., 2] * w[2]


def max_component(s):
    return jnp.max(s, axis=-1)


def is_black(s, eps=0.0):
    return jnp.all(s <= eps, axis=-1)


def srgb_to_linear(c):
    c = jnp.asarray(c)
    return jnp.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    c = jnp.asarray(c)
    return jnp.where(c <= 0.0031308, 12.92 * c, 1.055 * c ** (1.0 / 2.4) - 0.055)
