"""Pure-numpy golden model: bit-exact, device-free oracle for every op.

Each function replicates the verified semantics of the reference op —
including its float64 accumulation ORDER where it matters (resize, rotate) —
so CI can check the JAX path without the C toolchain, and the
differential suite can check this model against the compiled C binary.

Ops beyond the reference (invert .. equalize) define this framework's
extension semantics; the golden versions here are the spec the device
kernels are tested against.
"""

from __future__ import annotations

import numpy as np

from imageprocessingtools_tpu.ops import _exact


def grayscale(img: np.ndarray) -> np.ndarray:
    """(r+g+b)/3 integer division, exact (``ppmx-edward.c:998-1000``)."""
    s = img.astype(np.int32).sum(axis=2)
    return (s // 3).astype(np.uint8)


def mono_dither(img: np.ndarray) -> np.ndarray:
    """Bayer 4x4 ordered dither to {0,1}, 1 = black (``ppmx-edward.c:949-971``)."""
    h, w = img.shape[:2]
    avg = (img.astype(np.int32).sum(axis=2) // 3).astype(np.uint8)
    thresh = _exact.BAYER_THRESHOLD_INT[
        np.arange(h)[:, None] % 4, np.arange(w)[None, :] % 4
    ]
    return np.where(avg.astype(np.int32) >= thresh, 0, 1).astype(np.uint8)


def flip_vertical(img: np.ndarray) -> np.ndarray:
    return img[::-1].copy()


def flip_horizontal(img: np.ndarray) -> np.ndarray:
    return img[:, ::-1].copy()


def rotate90(img: np.ndarray) -> np.ndarray:
    """CW 90: out[x][H-1-y] = in[y][x] (``ppmx-edward.c:714-717``)."""
    return np.flip(img.swapaxes(0, 1), axis=1).copy()


def rotate180(img: np.ndarray) -> np.ndarray:
    return img[::-1, ::-1].copy()


def rotate270(img: np.ndarray) -> np.ndarray:
    """CCW 90: out[W-1-y][x] = in[x][y] (``ppmx-edward.c:722-725``)."""
    return np.flip(img.swapaxes(0, 1), axis=0).copy()


def _apply_contributions(img: np.ndarray, contrib: _exact.Contributions, dim: int) -> np.ndarray:
    """One separable resize pass with the C tap-accumulation order
    (``ppmx-edward.c:820-868``): float64 MACs tap-by-tap, round-half-up,
    clamp <0 -> 0 and >= 256 -> 255, then uint8.
    """
    indices, weights = contrib.indices, contrib.weights
    out_size, taps = indices.shape
    src = img.astype(np.float64)
    trail = (1,) * (img.ndim - 2)
    if dim == 0:
        acc = np.zeros((out_size,) + img.shape[1:], dtype=np.float64)
        for z in range(taps):
            acc += src[indices[:, z], :] * weights[:, z].reshape(-1, 1, *trail)
    else:
        acc = np.zeros(img.shape[:1] + (out_size,) + img.shape[2:], dtype=np.float64)
        for z in range(taps):
            acc += src[:, indices[:, z]] * weights[:, z].reshape(1, -1, *trail)
    acc = np.floor(acc + 0.5)
    out = np.where(acc < 0.0, 0.0, np.where(acc >= 256.0, 255.0, acc))
    return out.astype(np.uint8)


def resize_width(img: np.ndarray, new_width: int) -> np.ndarray:
    """MATLAB-compatible separable bicubic resize to a target width
    (``ppmx-edward.c:1084-1120``): height truncates, smaller scale first,
    uint8 requantization between the two passes.
    """
    plan = _exact.plan_resize(img.shape[0], img.shape[1], new_width)
    out = img
    for dim, contrib in plan.passes:
        out = _apply_contributions(out, contrib, dim)
    return out


def rotate(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """CW rotation with the reference's exact zone logic
    (``ppmx-edward.c:673-785``): 0/90/180/270 fast paths, otherwise
    inverse-map with black outside, nearest on the edge band, 4x4 bicubic
    interior with float64 accumulation in the C's j-then-i order, clamp
    <0 -> 0 / >= 256 -> 255, and truncation (not rounding) to int.
    """
    if angle_deg == 0:
        return img.copy()
    if angle_deg == 90:
        return rotate90(img)
    if angle_deg == 180:
        return rotate180(img)
    if angle_deg == 270:
        return rotate270(img)

    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    plan = _exact.plan_rotation(img.shape[0], img.shape[1], angle_deg)
    src = img.astype(np.float64)
    acc = np.zeros((plan.new_height, plan.new_width, img.shape[2]), dtype=np.float64)
    # Clamp each tap index: plan bases are clipped to [0, max(dim-4, 0)], so
    # for dims < 4 base+3 would still overrun (numpy fancy indexing gathers
    # before masking). Clamped taps only occur where the interior mask is
    # false (interior needs round(n) in (1, dim-2), impossible for dim < 4),
    # so the garbage values are discarded; for dims >= 4 the clip is a no-op.
    for j in range(4):
        ty = np.clip(plan.base_y + j, 0, src.shape[0] - 1)
        p = np.zeros_like(acc)
        for i in range(4):
            tx = np.clip(plan.base_x + i, 0, src.shape[1] - 1)
            tap = src[ty, tx]
            p += tap * plan.weights_x[:, :, i][:, :, None]
        acc += p * plan.weights_y[:, :, j][:, :, None]
    acc = np.where(acc < 0.0, 0.0, acc)
    acc = np.where(acc >= 256.0, 255.0, acc)
    interior_val = acc.astype(np.int64).astype(np.uint8)  # (int) cast truncates

    nearest_val = img[plan.nearest_y, plan.nearest_x]

    out = np.zeros_like(interior_val)
    out = np.where(plan.edge[:, :, None], nearest_val, out)
    out = np.where(plan.interior[:, :, None], interior_val, out)
    return out[:, :, 0] if squeeze else out


# ---------------------------------------------------------------------------
# Extension ops (north-star surface; semantics defined by this framework).
# ---------------------------------------------------------------------------


def invert(img: np.ndarray) -> np.ndarray:
    return (255 - img.astype(np.int32)).astype(np.uint8)


def brightness(img: np.ndarray, delta: int) -> np.ndarray:
    return np.clip(img.astype(np.int32) + int(delta), 0, 255).astype(np.uint8)


def contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """out = clamp(round_half_up((v - 128) * factor + 128))."""
    v = (img.astype(np.float64) - 128.0) * float(factor) + 128.0
    return np.clip(np.floor(v + 0.5), 0, 255).astype(np.uint8)


def threshold(img: np.ndarray, thresh: int) -> np.ndarray:
    """v >= thresh -> 255 else 0 (applied channelwise or on gray)."""
    return np.where(img.astype(np.int32) >= int(thresh), 255, 0).astype(np.uint8)


def _conv2d_replicate(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """float64 2D correlation with replicate padding, per channel."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    if img.ndim == 2:
        src = np.pad(img.astype(np.float64), ((ph, ph), (pw, pw)), mode="edge")
        out = np.zeros(img.shape, dtype=np.float64)
        for dy in range(kh):
            for dx in range(kw):
                out += kernel[dy, dx] * src[dy : dy + img.shape[0], dx : dx + img.shape[1]]
        return out
    src = np.pad(img.astype(np.float64), ((ph, ph), (pw, pw), (0, 0)), mode="edge")
    out = np.zeros(img.shape, dtype=np.float64)
    for dy in range(kh):
        for dx in range(kw):
            out += kernel[dy, dx] * src[dy : dy + img.shape[0], dx : dx + img.shape[1], :]
    return out


BOX3 = np.ones((3, 3))
SHARPEN3 = np.array([[0.0, -1.0, 0.0], [-1.0, 5.0, -1.0], [0.0, -1.0, 0.0]])
GAUSS5 = np.outer(
    np.array([1.0, 4.0, 6.0, 4.0, 1.0]), np.array([1.0, 4.0, 6.0, 4.0, 1.0])
)
SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])
SOBEL_Y = np.array([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]])


def box_blur(img: np.ndarray) -> np.ndarray:
    """out = round_half_up(sum9 / 9) == (2*sum9 + 9) // 18; integer-exact."""
    s = _conv2d_replicate(img, BOX3).astype(np.int64)
    return ((2 * s + 9) // 18).astype(np.uint8)


def sharpen(img: np.ndarray) -> np.ndarray:
    """Integer kernel [[0,-1,0],[-1,5,-1],[0,-1,0]], clamped; exact."""
    s = _conv2d_replicate(img, SHARPEN3).astype(np.int64)
    return np.clip(s, 0, 255).astype(np.uint8)


def gaussian_blur(img: np.ndarray) -> np.ndarray:
    """Binomial [1,4,6,4,1]^T x [1,4,6,4,1] / 256; out = (acc+128) // 256."""
    acc = _conv2d_replicate(img, GAUSS5).astype(np.int64)
    return ((acc + 128) // 256).astype(np.uint8)


def sobel(img: np.ndarray) -> np.ndarray:
    """k = round_half_up(sqrt(gx^2+gy^2)) computed exactly: a float estimate
    fixed up with the integer test k^2 - k + 1 <= m <= k^2 + k, then clamped.
    """
    gx = _conv2d_replicate(img, SOBEL_X).astype(np.int64)
    gy = _conv2d_replicate(img, SOBEL_Y).astype(np.int64)
    m = gx * gx + gy * gy
    k = np.floor(np.sqrt(m.astype(np.float64)) + 0.5).astype(np.int64)
    k = np.where(m > k * k + k, k + 1, k)
    k = np.where(m < k * k - k + 1, k - 1, k)
    return np.clip(k, 0, 255).astype(np.uint8)


def histogram(img: np.ndarray) -> np.ndarray:
    return np.bincount(img.reshape(-1), minlength=256).astype(np.int32)


def equalize_histogram(img: np.ndarray) -> np.ndarray:
    """Classic CDF equalization on a gray uint8 image.

    lut[v] = round_half_up((cdf[v] - cdf_min) * 255 / (N - cdf_min)); constant
    images are returned unchanged.
    """
    hist = histogram(img).astype(np.float64)
    cdf = np.cumsum(hist)
    n = cdf[-1]
    nonzero = cdf[hist > 0]
    cdf_min = nonzero[0] if nonzero.size else 0.0
    if n == cdf_min:
        return img.copy()
    lut = np.floor((cdf - cdf_min) * 255.0 / (n - cdf_min) + 0.5)
    lut = np.clip(lut, 0, 255).astype(np.uint8)
    return lut[img]

