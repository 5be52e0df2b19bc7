"""Small-stencil convolution ops: box blur, sharpen, Gaussian, Sobel.

North-star extension ops (the reference has no convolutions). Semantics are
integer-exact so device float rounding can't cause divergence:

- box 3x3:     out = floor(sum9 / 9 + 1/2)  == (2*sum9 + 9) // 18
- gaussian 5x5: binomial [1,4,6,4,1] x 2 / 256; out = (acc + 128) // 256
- sharpen 3x3: integer kernel [[0,-1,0],[-1,5,-1],[0,-1,0]], clamp to u8
- sobel:       k = round_half_up(sqrt(gx^2 + gy^2)) computed exactly via a
               float estimate + integer fix-up (k^2 - k + 1 <= m <= k^2 + k)

Edges use replicate padding. Implementation is shifted-window adds in int32,
which XLA fuses into one elementwise pass.
"""

from __future__ import annotations

import jax.numpy as jnp

from imageprocessingtools_tpu.ops.common import as_i32


def _pad_edge(img: jnp.ndarray, r: int) -> jnp.ndarray:
    pad = [(r, r), (r, r)] + [(0, 0)] * (img.ndim - 2)
    return jnp.pad(img, pad, mode="edge")


def _window_sum(src: jnp.ndarray, h: int, w: int, weights) -> jnp.ndarray:
    """sum_{dy,dx} weights[dy][dx] * src[dy:dy+h, dx:dx+w] in int32."""
    k = len(weights)
    acc = None
    for dy in range(k):
        for dx in range(k):
            coeff = weights[dy][dx]
            if coeff == 0:
                continue
            tap = src[dy : dy + h, dx : dx + w]
            term = tap if coeff == 1 else coeff * tap
            acc = term if acc is None else acc + term
    return acc


def box_blur(img: jnp.ndarray) -> jnp.ndarray:
    h, w = img.shape[0], img.shape[1]
    src = _pad_edge(as_i32(img), 1)
    s = _window_sum(src, h, w, [[1, 1, 1]] * 3)
    return ((2 * s + 9) // 18).astype(jnp.uint8)


def sharpen(img: jnp.ndarray) -> jnp.ndarray:
    h, w = img.shape[0], img.shape[1]
    src = _pad_edge(as_i32(img), 1)
    s = _window_sum(src, h, w, [[0, -1, 0], [-1, 5, -1], [0, -1, 0]])
    return jnp.clip(s, 0, 255).astype(jnp.uint8)


def gaussian_blur(img: jnp.ndarray) -> jnp.ndarray:
    """Separable binomial 5x5: two integer passes, then one rounding divide."""
    h, w = img.shape[0], img.shape[1]
    src = _pad_edge(as_i32(img), 2)
    taps = (1, 4, 6, 4, 1)
    rows = None  # vertical pass: [h, w + 4]
    for dy, k in enumerate(taps):
        term = k * src[dy : dy + h, :]
        rows = term if rows is None else rows + term
    acc = None
    for dx, k in enumerate(taps):
        term = k * rows[:, dx : dx + w]
        acc = term if acc is None else acc + term
    return ((acc + 128) >> 8).astype(jnp.uint8)


def _isqrt_round(m: jnp.ndarray) -> jnp.ndarray:
    """Exact round-half-up integer sqrt via f32 estimate + integer fix-up.

    round_half_up(sqrt(m)) = k  <=>  k^2 - k + 1 <= m <= k^2 + k, so a +-1
    correction of the float estimate is always exact (m <= ~2^22 here).
    """
    k = jnp.floor(jnp.sqrt(m.astype(jnp.float32)) + 0.5).astype(jnp.int32)
    k = jnp.where(m > k * k + k, k + 1, k)
    # guard k > 0: the down-correction would take m = 0 to -1 (0 < 1)
    k = jnp.where((k > 0) & (m < k * k - k + 1), k - 1, k)
    return k


def sobel(img: jnp.ndarray) -> jnp.ndarray:
    """Gradient magnitude round_half_up(sqrt(gx^2 + gy^2)), clamped."""
    h, w = img.shape[0], img.shape[1]
    src = _pad_edge(as_i32(img), 1)
    gx = _window_sum(src, h, w, [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]])
    gy = _window_sum(src, h, w, [[-1, -2, -1], [0, 0, 0], [1, 2, 1]])
    mag = _isqrt_round(gx * gx + gy * gy)
    return jnp.clip(mag, 0, 255).astype(jnp.uint8)
