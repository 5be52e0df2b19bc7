"""Shared device-side helpers: exact rounding and uint8 quantization.

The reference rounds with ``floor(v + 0.5)`` (round-half-up, ``ppmx-edward.c:27``)
and clamps with ``< 0 -> 0``, ``>= 256 -> 255`` (``ppmx-edward.c:831-837``).
``jnp.round`` is banker's rounding and must never be used on a parity path.
"""

from __future__ import annotations

import jax.numpy as jnp


def round_half_up(x: jnp.ndarray) -> jnp.ndarray:
    """floor(x + 0.5) — the reference's rounding everywhere."""
    return jnp.floor(x + 0.5)


def clamp_u8(x: jnp.ndarray) -> jnp.ndarray:
    """Reference clamp: < 0 -> 0, >= 256 -> 255 (works for float or int x)."""
    x = jnp.where(x < 0, 0, x)
    x = jnp.where(x >= 256, 255, x)
    return x.astype(jnp.uint8)


def quantize_u8(acc: jnp.ndarray) -> jnp.ndarray:
    """round-half-up + reference clamp + uint8 cast (resize epilogue)."""
    return clamp_u8(round_half_up(acc))


def as_f32(img: jnp.ndarray) -> jnp.ndarray:
    return img.astype(jnp.float32)


def as_i32(img: jnp.ndarray) -> jnp.ndarray:
    return img.astype(jnp.int32)


def float_stage_budget(has_resize: bool, has_float_rotation: bool) -> int:
    """Max |ours - reference| in LSB for a float-op chain.

    The f32 device paths carry a +-1 LSB rounding budget PER QUANTIZED
    STAGE vs the reference's f64 accumulation, and stages COMPOUND because
    the reference requantizes to uint8 between them (``ppmx-edward.c:
    1102-1120`` resize pass 1 -> pass 2; ``:1084-1155`` resize -> rotate):
    a +-1 on a stage's uint8 output feeds the next stage's taps and can
    stack with that stage's own +-1.

    - resize alone: two internally-quantized passes -> 2
    - arbitrary rotation alone: one quantized stage -> 1
    - resize then rotation: -> 3

    Empirically the compound cases are single-pixel-rare: the 2,080-case
    CLI fuzz campaign's first two >1 hits (seeds 950088, 960030 — one
    pixel each at exactly 2, tools/fuzz_campaign.py) are reproduced as
    regression tests in tests/test_fuzz_differential.py, where the f64
    golden model is verified bit-exact vs the C binary on the same cases.
    """
    return (2 if has_resize else 0) + (1 if has_float_rotation else 0)
