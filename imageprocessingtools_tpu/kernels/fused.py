"""Flagship fused pipeline: grayscale -> 5x5 Gaussian -> histogram equalize.

The benchmark pipeline from BASELINE.json. The whole pipeline is one jitted
graph, so XLA fuses the elementwise stages into the stencil reads; the
histogram is the exact nibble one-hot contraction of `ops.histogram`. Its
time on the GPU is not measured here; `chip_smoke.py` prints it beside the
byte bound computed from its shapes.
"""

from __future__ import annotations

import jax
import math

import jax.numpy as jnp

from imageprocessingtools_tpu.ops.color import grayscale
from imageprocessingtools_tpu.ops.histogram import _equalize_lut, apply_lut, histogram
from imageprocessingtools_tpu.ops.stencil import gaussian_blur


def fused_pipeline_xla(img: jnp.ndarray) -> jnp.ndarray:
    """uint8[H, W, 3] -> uint8[H, W]; traceable (jit/vmap/shard_map-safe)."""
    g = grayscale(img)
    blurred = gaussian_blur(g)
    n_pixels = math.prod(map(int, blurred.shape))
    lut = _equalize_lut(histogram(blurred), n_pixels)
    return apply_lut(blurred, lut)


fused_gray_gauss_histeq = jax.jit(fused_pipeline_xla)
