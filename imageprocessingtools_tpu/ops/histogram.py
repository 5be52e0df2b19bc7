"""256-bin histogram, LUT application, and histogram equalization.

- histogram: an exact matmul on the value's nibbles (v = 16*hi + lo):
  hist2d[h, l] = <onehot(hi), onehot(lo)> — one [16, N] @ [N, 16] matmul
  (XLA fuses the one-hot producers into it); bin b = 16*h + l, so hist2d
  reshapes row-major to the 256 counts. EXACT: 0/1 operands in bfloat16,
  f32 accumulation exact below 2^24 (larger pixel counts are chunked).
- LUT apply: one gather from the 256-entry table. (The nibble one-hot
  matmul form materializes an f32 [..., 16] product, 34 GB for a batch of
  64 4K frames, which does not fit on one GPU.)

Whether a scatter-add histogram is faster on the GPU is not measured.

Equalization: lut[v] = round_half_up((cdf[v] - cdf_min) * 255 / (N - cdf_min))
with cdf_min the first nonzero CDF value; constant images pass through. The
LUT arithmetic itself is float32 on device (f64 golden spec carries a
documented +-1 LSB budget).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
from jax import lax

from imageprocessingtools_tpu.ops.common import as_i32, round_half_up

_F32_EXACT_COUNT = 1 << 24  # f32 integer-exactness limit for accumulation


def _iota16():
    return jnp.arange(16, dtype=jnp.int32)


def _histogram_chunk(v: jnp.ndarray) -> jnp.ndarray:
    """int32[M] values in [0, 256) -> int32[256] counts (M < 2^24)."""
    hi_oh = (v[:, None] >> 4 == _iota16()[None, :]).astype(jnp.bfloat16)
    lo_oh = ((v[:, None] & 15) == _iota16()[None, :]).astype(jnp.bfloat16)
    h2 = lax.dot_general(
        hi_oh,
        lo_oh,
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return h2.reshape(256).astype(jnp.int32)


def histogram(img: jnp.ndarray) -> jnp.ndarray:
    """uint8[...] -> int32[256] bin counts (exact; < 2^31 total elements)."""
    v = as_i32(img).reshape(-1)
    n = v.shape[0]
    if n >= 2**31:
        # int32 bins (and the equalization CDF downstream) would silently
        # wrap; make the ceiling explicit. 2^31 px is ~259 stacked 4K frames
        # — batch callers should histogram per-image and sum in int64 on
        # host if they truly need a fleet-wide histogram.
        raise ValueError("histogram requires < 2^31 total elements")
    if n < _F32_EXACT_COUNT:
        return _histogram_chunk(v)
    # Chunk to stay within f32 exact integer range, then sum in int32.
    n_chunks = -(-n // (_F32_EXACT_COUNT // 2))
    chunk = -(-n // n_chunks)
    pad = n_chunks * chunk - n
    v = jnp.pad(v, (0, pad))  # pads count into bin 0; subtracted below
    hists = [
        _histogram_chunk(v[i * chunk : (i + 1) * chunk]) for i in range(n_chunks)
    ]
    total = sum(hists[1:], hists[0])
    return total.at[0].add(-pad)


def apply_lut(values: jnp.ndarray, lut: jnp.ndarray) -> jnp.ndarray:
    """uint8 values through a 256-entry integer LUT (one gather). Exact.

    ``lut`` must hold integers in [0, 256) (uint8 or wider).
    """
    return jnp.asarray(lut).astype(jnp.uint8)[as_i32(values)]


def _equalize_lut(hist: jnp.ndarray, n_pixels: int) -> jnp.ndarray:
    """uint8[256] LUT from int32[256] counts (n_pixels static)."""
    cdf = jnp.cumsum(hist)
    cdf_min = jnp.min(jnp.where(cdf > 0, cdf, n_pixels))
    denom = jnp.maximum(n_pixels - cdf_min, 1).astype(jnp.float32)
    lut = round_half_up((cdf - cdf_min).astype(jnp.float32) * 255.0 / denom)
    lut = jnp.clip(lut, 0, 255).astype(jnp.uint8)
    identity = jnp.arange(256, dtype=jnp.uint8)
    return jnp.where(cdf_min == n_pixels, identity, lut)


def equalize_histogram(img: jnp.ndarray) -> jnp.ndarray:
    """Classic CDF equalization of a gray uint8 image."""
    n_pixels = math.prod(map(int, img.shape))
    lut = _equalize_lut(histogram(img), n_pixels)
    return apply_lut(img, lut)
