"""Device-side P4 bit packing for the batched encode path.

The reference packs bits on the host one byte at a time
(``ppmx-edward.c:268-284``); for batched serving the packing runs on device:
rows reshaped to groups of 8 bits and contracted with the MSB-first weight
vector [128, 64, ..., 1] — pure integer math, bit-identical to np.packbits.
"""

from __future__ import annotations

import jax.numpy as jnp


def pack_bits_device(bits: jnp.ndarray) -> jnp.ndarray:
    """uint8[..., H, W] in {0,1} -> uint8[..., H, ceil(W/8)] MSB-first.

    Rows are zero-padded to a byte boundary, matching the reference encoder
    and np.packbits(axis=-1).
    """
    w = bits.shape[-1]
    row_bytes = -(-w // 8)
    pad = row_bytes * 8 - w
    if pad:
        pad_cfg = [(0, 0)] * (bits.ndim - 1) + [(0, pad)]
        bits = jnp.pad(bits, pad_cfg)
    weights = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], dtype=jnp.int32)
    grouped = bits.reshape(bits.shape[:-1] + (row_bytes, 8)).astype(jnp.int32)
    return jnp.sum(grouped * weights, axis=-1).astype(jnp.uint8)
