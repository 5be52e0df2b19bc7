"""Pointwise color ops (all integer-exact unless noted).

``grayscale`` mirrors the reference op (``ppmx-edward.c:986-1003``); the rest
are north-star extension ops whose semantics are defined by the golden model
(`golden/model.py`). Everything here is shape-preserving, jit/vmap-friendly,
and fuses into neighboring ops under XLA.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from imageprocessingtools_tpu.ops.common import as_i32


def grayscale(img: jnp.ndarray) -> jnp.ndarray:
    """uint8[H, W, 3] -> uint8[H, W]; exact integer (r+g+b)/3
    (``ppmx-edward.c:1000``; truncating division, bit-exact on device).
    """
    s = jnp.sum(as_i32(img), axis=-1)
    return (s // 3).astype(jnp.uint8)


def invert(img: jnp.ndarray) -> jnp.ndarray:
    """255 - v, exact."""
    return (255 - as_i32(img)).astype(jnp.uint8)


def brightness(img: jnp.ndarray, delta) -> jnp.ndarray:
    """clamp(v + delta) with integer delta; exact."""
    return jnp.clip(as_i32(img) + delta, 0, 255).astype(jnp.uint8)


@functools.lru_cache(maxsize=64)
def _contrast_lut(factor: float) -> np.ndarray:
    """256-entry LUT computed on host in float64 so the device gather is
    bit-exact against the golden model for any factor."""
    v = (np.arange(256, dtype=np.float64) - 128.0) * float(factor) + 128.0
    return np.clip(np.floor(v + 0.5), 0, 255).astype(np.uint8)


def contrast(img: jnp.ndarray, factor: float) -> jnp.ndarray:
    """clamp(round_half_up((v - 128) * factor + 128)); factor is static."""
    from imageprocessingtools_tpu.ops.histogram import apply_lut

    return apply_lut(img, jnp.asarray(_contrast_lut(float(factor))))


def threshold(img: jnp.ndarray, thresh) -> jnp.ndarray:
    """v >= thresh -> 255 else 0; exact."""
    return jnp.where(as_i32(img) >= thresh, 255, 0).astype(jnp.uint8)
