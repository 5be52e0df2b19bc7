"""Exact host-side math shared by the golden model and the device ops.

Everything here is float64 numpy replicating the reference's double-precision
precompute bit-for-bit:

- ``cubic``: the Keys a=-0.5 bicubic kernel (``ppmx-edward.c:477-489``).
- ``calc_contributions``: MATLAB-imresize-style tap indices + normalized
  weights with antialiasing on downscale, mirror boundary handling via the
  reflect-index ``aux`` array, and zero-weight tap pruning decided from output
  row 0 (``ppmx-edward.c:516-641``).
- ``calc_rot_size`` + rotation plan: bounding box from the folded angle and the
  per-destination-pixel inverse map (``ppmx-edward.c:643-698``).

These run once per (shape, param) on host — O(out_size * taps) — while the
O(H*W) apply happens on device: the reference's weights-precompute / apply
structure (survey CS-2).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

# Quirk-B9 resource bound for -wN outputs (see plan_resize): per-dimension
# and total-pixel caps standing in for the reference's platform-dependent
# malloc failure at ppmx-edward.c:537. The message is the C's fast-fail
# surface; cli.main and serve share it for their MemoryError backstops.
_MAX_RESIZE_DIM = 2**26
_MAX_RESIZE_OUT_PX = 2**31
B9_MESSAGE = "error. allocating indices\n"


def resize_output_height(height: int, width: int, new_width: int) -> int:
    """The C's ``-wN`` output height (``ppmx-edward.c:1099``):
    ``(unsigned)((double) height * ((double) new_width / width))`` —
    f64 truncation that WRAPS mod 2^32 out of range (see plan_resize)."""
    return int(float(height) * (float(new_width) / float(width))) & 0xFFFFFFFF


KERNEL_WIDTH = 4.0  # bicubic support, ref doProcessPPM passes 4.0 (:1108-1109)


def round_half_up(x):
    """The reference's ``round(v) = floor(v + 0.5)`` (``ppmx-edward.c:27``).

    NOT banker's rounding — must be used everywhere the reference rounds.
    """
    return np.floor(np.asarray(x, dtype=np.float64) + 0.5)


def cubic(x: np.ndarray) -> np.ndarray:
    """Keys bicubic kernel, exact expression order of ``ppmx-edward.c:477-489``."""
    x = np.asarray(x, dtype=np.float64)
    absx = np.abs(x)
    absx2 = absx * absx
    absx3 = absx2 * absx
    ret = np.where(absx <= 1.0, (1.5 * absx3) - (2.5 * absx2) + 1.0, 0.0)
    ret = np.where(
        (1.0 < absx) & (absx <= 2.0),
        ret + ((-0.5 * absx3) + (2.5 * absx2) - (4.0 * absx) + 2.0),
        ret,
    )
    return ret


class Contributions(NamedTuple):
    """Tap indices/weights for one separable resize pass.

    ``indices``: int64[out_size, taps] source coordinates (mirror-reflected
    into range). ``weights``: float64[out_size, taps], rows sum to 1.
    """

    indices: np.ndarray
    weights: np.ndarray


def calc_contributions(in_size: int, out_size: int, scale: float) -> Contributions:
    """Exact replica of ``calc_contributions`` (``ppmx-edward.c:516-641``)."""
    k_width = KERNEL_WIDTH
    if scale < 1.0:
        k_width = k_width / scale  # antialiasing: stretch kernel (:533)
    P = int(math.ceil(k_width)) + 2

    # u: source-space center for each output coordinate (:562).
    y = np.arange(out_size, dtype=np.float64)
    u = ((y + 1.0) / scale) + (0.5 * (1.0 - (1.0 / scale)))
    left = np.floor(u - (k_width / 2.0))
    x = np.arange(P, dtype=np.float64)
    indices = (left[:, None] + (x[None, :] - 1.0)).astype(np.int64)

    if scale < 1.0:
        weights = scale * cubic((u[:, None] - indices.astype(np.float64) - 1.0) * scale)
    else:
        weights = cubic(u[:, None] - indices.astype(np.float64) - 1.0)

    # Row normalization with the reference's sequential accumulation order
    # (:581-585) so float64 results match the C binary bit-for-bit.
    total = np.zeros(out_size, dtype=np.float64)
    for col in range(P):
        total += weights[:, col]
    weights = weights / total[:, None]

    # Mirror boundary: reflect out-of-range indices through the aux array
    # [0..n-1, n-1..0] (:551-555, :587-589).
    aux_size = in_size * 2
    aux = np.concatenate(
        [np.arange(in_size, dtype=np.int64), np.arange(in_size - 1, -1, -1, dtype=np.int64)]
    )
    indices = aux[np.mod(indices, aux_size)]

    # Prune taps whose weight is zero in output row 0 (:591-624). The ref
    # decides which columns to keep from row 0 only.
    keep = weights[0, :] != 0.0
    return Contributions(indices=indices[:, keep], weights=weights[:, keep])


class ResizePlan(NamedTuple):
    """Both separable passes for -wN, in the reference's application order."""

    new_width: int
    new_height: int
    # pass order: each entry is (dim, contributions); dim 0 = height, 1 = width
    passes: tuple[tuple[int, Contributions], tuple[int, Contributions]]


def plan_resize(height: int, width: int, new_width: int) -> ResizePlan:
    """Replicates the -wN driver block (``ppmx-edward.c:1084-1120``).

    new_height truncates (B6): ``(unsigned)(height * new_width / width)``.
    The smaller-scale dimension is resized first (:1102-1103).
    """
    if int(new_width) < 1:
        raise ValueError("invalid option for new width\n")
    scale_w = float(new_width) / float(width)
    # (unsigned)((double) height * scale): truncation, not rounding, and the
    # out-of-range conversion WRAPS mod 2^32 on the oracle platform
    # (cvttsd2si to a 64-bit register, 32-bit store). Binary-verified:
    # 4294968x1 -w1000 -> new_height 704 (a real 2 MB output), and
    # 4096x1 -w1048576 -> exactly 2^32 -> 0 -> the B7 ind2store surface.
    # The i64 intermediate can't itself overflow: 9-digit header/flag
    # bounds cap height*scale at ~1e18 < 2^63.
    new_height = resize_output_height(height, width, new_width)
    if new_height < 1:
        # Degenerate downscale (height*new_width < width -> truncated
        # new_height 0). The reference's failure here is deterministic on
        # the oracle platform and asserted by the differential suite:
        # scale 0 -> k_width = 4.0/0.0 = inf (:533), P = (int)ceil(inf)+2
        # = INT_MIN+2 (:535), and the first P-sized malloc to run with
        # out_size 0 rows is ind2store's (:595), whose huge size_t fails
        # -> "error: allocating ind2store", exit 255. Found by the 200-case
        # fresh-seed campaign (tools/fuzz_campaign.py, seed 50022).
        raise ValueError("error: allocating ind2store\n")
    if (
        new_height > _MAX_RESIZE_DIM
        or int(new_width) > _MAX_RESIZE_DIM
        or new_height * int(new_width) > _MAX_RESIZE_OUT_PX
    ):
        # Huge-output bound (quirk B9, found by direct probing of the huge
        # -w corner): the reference's first per-output-row malloc is
        # indices = malloc(out_size * sizeof(int*)) (ppmx-edward.c:537).
        # For infeasible outputs the oracle platform's overcommit heuristic
        # either rejects that malloc immediately -> stdout "error.
        # allocating indices", exit 255 (observed: 200x10 -w999999999,
        # whose (unsigned)(double) new_height wraps mod 2^32 to 2.8e9) or
        # lets it succeed and grinds for minutes in O(out*P) loops before
        # dying on first touch. The boundary between those two outcomes is
        # the host's overcommit policy, not program logic, so we replace it
        # with a deterministic bound and the C's fast-fail surface: any
        # output dimension beyond 2^26 or more than 2^31 output pixels is
        # rejected up front. Real resizes sit orders of magnitude below
        # (a 16K x 16K output is 2.7e8 px).
        raise ValueError(B9_MESSAGE)
    scale_h = float(new_height) / float(height)

    contrib_h = calc_contributions(height, new_height, scale_h)
    contrib_w = calc_contributions(width, new_width, scale_w)
    if scale_h < scale_w:
        order = ((0, contrib_h), (1, contrib_w))
    else:
        order = ((1, contrib_w), (0, contrib_h))
    return ResizePlan(new_width=int(new_width), new_height=new_height, passes=order)


def dense_weights(contrib: Contributions, in_size: int) -> np.ndarray:
    """Scatter taps into a dense float64 [out, in] matrix for the matmul path.

    Mirror-reflected indices can repeat near boundaries; duplicate taps
    accumulate, matching the sequential tap sum.
    """
    out_size, taps = contrib.indices.shape
    W = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.repeat(np.arange(out_size), taps)
    np.add.at(W, (rows, contrib.indices.ravel()), contrib.weights.ravel())
    return W


def fold_angle(angle: float) -> float:
    """Fold an angle to [0, 90] for the bounding box (``ppmx-edward.c:687-689``)."""
    if angle >= 270.0:
        return 360.0 - angle
    if angle > 180.0:
        return angle - 180.0
    if angle > 90.0:
        return 180.0 - angle
    return angle


def calc_rot_size(angle: float, old_width: int, old_height: int) -> tuple[int, int]:
    """Rotated bounding box, round-half-up (``ppmx-edward.c:649-656``).

    ``angle`` is the already-folded angle in degrees.
    """
    theta = (angle * math.pi) / 180.0
    new_w = int(math.floor((old_width * math.cos(theta)) + (old_height * math.sin(theta)) + 0.5))
    new_h = int(math.floor((old_width * math.sin(theta)) + (old_height * math.cos(theta)) + 0.5))
    return new_w, new_h


class RotationPlan(NamedTuple):
    """Host-precomputed geometry for one arbitrary-angle rotation.

    All decisions the reference makes in double (zone tests, nearest indices,
    tap bases) are made here in float64 so the device apply only does gathers
    and multiply-accumulates.
    """

    new_width: int
    new_height: int
    interior: np.ndarray  # bool[outH, outW] — 4x4 bicubic zone
    edge: np.ndarray      # bool[outH, outW] — nearest-neighbor band
    nearest_y: np.ndarray  # int32[outH, outW], clipped into range
    nearest_x: np.ndarray
    base_y: np.ndarray     # int32[outH, outW]: floor(nY) - 1, clipped
    base_x: np.ndarray
    weights_y: np.ndarray  # float64[outH, outW, 4] cubic(nY - v_j)
    weights_x: np.ndarray  # float64[outH, outW, 4] cubic(nX - u_i)


def plan_rotation(height: int, width: int, angle_deg: float) -> RotationPlan:
    """Inverse-map rotation geometry (``ppmx-edward.c:673-785``), vectorized.

    Zones (verified semantics):
      - out of bounds (round(nX/nY) outside the source) -> black;
      - interior (round in (1, dim-2) exclusive)        -> 4x4 bicubic;
      - remaining in-bounds band                        -> nearest neighbor.
    """
    folded = fold_angle(float(angle_deg))
    new_w, new_h = calc_rot_size(folded, width, height)
    theta = (float(angle_deg) * math.pi) / 180.0

    x_center = width // 2
    y_center = height // 2
    x_offset = new_w // 2 - x_center
    y_offset = new_h // 2 - y_center

    ys = np.arange(new_h, dtype=np.float64)[:, None] - y_offset - y_center
    xs = np.arange(new_w, dtype=np.float64)[None, :] - x_offset - x_center
    cos_t, sin_t = math.cos(theta), math.sin(theta)
    # Ref rotation formula (:741-742): CW inverse map around the centers.
    nX = (cos_t * xs) + (sin_t * ys) + x_center
    nY = (-sin_t * xs) + (cos_t * ys) + y_center

    rX = np.floor(nX + 0.5)
    rY = np.floor(nY + 0.5)
    in_bounds = (rX < width) & (rY < height) & (rY >= 0) & (rX >= 0)
    interior = (
        in_bounds
        & (rX > 1)
        & (rY > 1)
        & (rX < max(width - 2, 0))
        & (rY < max(height - 2, 0))
    )
    edge = in_bounds & ~interior

    nearest_y = np.clip(rY, 0, height - 1).astype(np.int32)
    nearest_x = np.clip(rX, 0, width - 1).astype(np.int32)

    base_y = np.floor(nY) - 1.0
    base_x = np.floor(nX) - 1.0
    taps = np.arange(4, dtype=np.float64)
    weights_y = cubic(nY[:, :, None] - (base_y[:, :, None] + taps))
    weights_x = cubic(nX[:, :, None] - (base_x[:, :, None] + taps))

    # Clip bases so device gathers are always in range; interior pixels never
    # need the clip (their taps are in range by the zone test), and clipped
    # taps only occur where the mask discards the result anyway.
    base_y = np.clip(base_y, 0, max(height - 4, 0)).astype(np.int32)
    base_x = np.clip(base_x, 0, max(width - 4, 0)).astype(np.int32)

    return RotationPlan(
        new_width=new_w,
        new_height=new_h,
        interior=interior,
        edge=edge,
        nearest_y=nearest_y,
        nearest_x=nearest_x,
        base_y=base_y,
        base_x=base_x,
        weights_y=weights_y,
        weights_x=weights_x,
    )


# Bayer 4x4 threshold matrix (``ppmx-edward.c:954``), stored flat in the ref
# and indexed matrix[(x%4)*4 + (y%4)] (:967) — i.e. transposed. BAYER_T[y%4,
# x%4] is the threshold for pixel (y, x). Values are k/16 for the k below.
_BAYER_K = np.array(
    [2, 16, 3, 13, 10, 6, 11, 7, 4, 14, 1, 15, 12, 8, 9, 5], dtype=np.int64
).reshape(4, 4)
# matrix[(x%4)*4 + (y%4)] == _BAYER_K.T in (y, x) layout.
BAYER_T = _BAYER_K.T.copy()

# avg >= (k/16)*255 with integer avg  <=>  avg >= ceil(k*255/16); exact since
# k*255/16 is non-integral for all k except 16 (-> 255, where ceil also works).
BAYER_THRESHOLD_INT = np.array(
    [[-(-255 * int(k) // 16) for k in row] for row in BAYER_T], dtype=np.int32
)
