"""Bayer 4x4 ordered dithering to bilevel (``ppmx-edward.c:949-971``).

The reference indexes its flat threshold matrix ``matrix[(x%4)*4 + (y%4)]``
(transposed), averages channels with truncating integer division, and maps
``avg >= m*255 -> 0`` (white) else ``1`` (black, PBM convention). Because the
average is an integer and the thresholds ``k/16*255`` are non-integral (except
255), integer thresholds ``ceil(k*255/16)`` reproduce the double comparison
bit-exactly (see ``ops/_exact.BAYER_THRESHOLD_INT``).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from imageprocessingtools_tpu.ops import _exact
from imageprocessingtools_tpu.ops.common import as_i32


@functools.lru_cache(maxsize=32)
def _threshold_plane(h: int, w: int) -> np.ndarray:
    """Full uint8[h, w] threshold constant, tiled on host."""
    reps = ((h + 3) // 4, (w + 3) // 4)
    return np.tile(_exact.BAYER_THRESHOLD_INT.astype(np.uint8), reps)[:h, :w]


def mono_dither(img: jnp.ndarray) -> jnp.ndarray:
    """uint8[H, W, 3] -> uint8[H, W] in {0, 1}, 1 = black. Bit-exact."""
    h, w = img.shape[0], img.shape[1]
    avg = (jnp.sum(as_i32(img), axis=-1) // 3).astype(jnp.uint8)
    thr = jnp.asarray(_threshold_plane(h, w))
    return (avg < thr).astype(jnp.uint8)
