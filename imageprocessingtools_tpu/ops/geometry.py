"""Geometric ops: flips, orthogonal rotations, arbitrary-angle rotation.

Flips and 90/180/270 rotations are pure index permutations (bit-exact by
construction), expressed as transpose/reverse so XLA lowers them to copies
(``ppmx-edward.c:888-913``, ``:714-725``).

Arbitrary-angle rotation splits reference-style (``ppmx-edward.c:673-785``):
the 1-D geometry terms come from host f64, per-pixel decisions replicate the
C's f64 arithmetic on device via double-f32 pairs (`_floor_df32`), and the
compute runs as dense matmuls (`_rotate_apply_blocked`: output tiles,
per-tile source blocks, banded-weight matmuls) with a 16-gather XLA fallback
for images smaller than one source block. Interior pixels carry the +-1 LSB
budget from f32 accumulation; zone choice and nearest indices match the C
bit-for-bit (audited by `rotation_decisions_safe`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from imageprocessingtools_tpu.ops import _exact


def flip_vertical(img: jnp.ndarray) -> jnp.ndarray:
    """Row reversal (``ppmx-edward.c:898-904``)."""
    return jnp.flip(img, axis=0)


def flip_horizontal(img: jnp.ndarray) -> jnp.ndarray:
    """Column reversal (``ppmx-edward.c:906-911``)."""
    return jnp.flip(img, axis=1)


def _transpose_hw(img: jnp.ndarray) -> jnp.ndarray:
    """Swap H/W, one 2-D transpose per channel plane for HWC input."""
    if img.ndim == 2:
        return jnp.swapaxes(img, 0, 1)
    return jnp.stack(
        [jnp.swapaxes(img[:, :, i], 0, 1) for i in range(img.shape[2])], axis=-1
    )


def rotate90(img: jnp.ndarray) -> jnp.ndarray:
    """CW 90: out[x][H-1-y] = in[y][x] (``ppmx-edward.c:714-717``)."""
    return jnp.flip(_transpose_hw(img), axis=1)


def rotate180(img: jnp.ndarray) -> jnp.ndarray:
    return jnp.flip(jnp.flip(img, axis=0), axis=1)


def rotate270(img: jnp.ndarray) -> jnp.ndarray:
    """CCW 90: out[W-1-y][x] = in[x][y] (``ppmx-edward.c:722-725``)."""
    return jnp.flip(_transpose_hw(img), axis=0)


def _split_f64(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """float64 -> (f32 hi, f32 lo) with hi + lo == x to double-f32 precision."""
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


@functools.lru_cache(maxsize=64)
def _rotation_geometry(height: int, width: int, angle: float):
    """O(H + W) host-side rotation geometry (float64, exact C expressions).

    The per-pixel inverse map separates: nX[i, j] = (cos*x0)[j] + (sin*y0)[i]
    + x_center (``ppmx-edward.c:741-742``), so only the 1-D terms are
    computed on host; the O(outH*outW) combination happens on device in
    double-f32 (see `_rotate_apply`). This replaces a ~600 MB, minutes-long
    host plan at 4K with kilobytes.
    """
    folded = _exact.fold_angle(float(angle))
    new_w, new_h = _exact.calc_rot_size(folded, width, height)
    theta = (float(angle) * np.pi) / 180.0
    x_center = width // 2
    y_center = height // 2
    x_offset = new_w // 2 - x_center
    y_offset = new_h // 2 - y_center

    xs = np.arange(new_w, dtype=np.float64) - x_offset - x_center
    ys = np.arange(new_h, dtype=np.float64) - y_offset - y_center
    cos_t, sin_t = np.cos(theta), np.sin(theta)
    ax = cos_t * xs       # nX = ax[j] + bx[i] + x_center
    bx = sin_t * ys
    ay = -sin_t * xs      # nY = ay[j] + by[i] + y_center
    by = cos_t * ys
    return (
        new_h,
        new_w,
        _split_f64(ax),
        _split_f64(bx),
        _split_f64(ay),
        _split_f64(by),
        float(x_center),
        float(y_center),
    )


def _two_sum(p, q):
    """Knuth two-sum: p + q = s + err exactly (f32)."""
    s = p + q
    bb = s - p
    err = (p - (s - bb)) + (q - bb)
    return s, err


def _combine_df32(a_hi, a_lo, b_hi, b_lo, c):
    """(a + b + c) as (hi, lo) double-f32; a, b are broadcast row/col terms."""
    s, e = _two_sum(a_hi, b_hi)
    s2, e2 = _two_sum(s, c)
    return s2, e + e2 + (a_lo + b_lo)


def _half_ulp64(x):
    """Half-ulp of float64 at |x|, from the f32 exponent bits (exact)."""
    bits = jax.lax.bitcast_convert_type(x, jnp.int32)
    e = ((bits >> 23) & 0xFF) - 127          # floor(log2|x|) for normals
    e_eps = e - 53                           # ulp64(x) = 2^(e-52)
    eps_bits = jnp.where(e_eps >= -126, (e_eps + 127) << 23, 0)
    return jax.lax.bitcast_convert_type(eps_bits.astype(jnp.int32), jnp.float32)


def _floor_df32(hi, lo, add=0.0):
    """floor(round_f64(hi + lo + add)) — bit-faithful to the C's f64 path.

    Two precision subtleties, both found by the rotation_decisions_safe
    audit (full-pixel divergences at e.g. 30 and 300 deg otherwise):

    1. The residual d = (hi + lo + add) - t must be kept as a NORMALIZED
       double-f32 pair: hi - t is exact (Sterbenz), then two-sums fold in
       add and lo. A naive `(hi - t) + (lo + add)` swallows lo against
       add=0.5 (f32 keeps 2^-24 relative), flipping round() where sin/cos
       land coordinates ~1e-15 from an x.5 boundary (60/120/240/300 deg:
       cos is 0.5 +- 1 f64 ulp).
    2. The pair can be MORE precise than the C: the C's nY = a + b + c
       rounds to 53 bits, so a true value half-an-f64-ulp below x.5 becomes
       EXACTLY x.5 in the C and rounds up, while the pair keeps the dust
       and would floor down (30 deg: sin*ys + yc = 10.5 - 4.4e-16 -> C sees
       10.5). Decisions therefore shift by eps = half-ulp64(|value|): the
       boundary where the C's rounding tips.
    """
    t = jnp.floor(hi + (lo + add))          # first guess, off by at most 1
    r = hi - t                              # exact
    s1, e1 = _two_sum(r, add)
    s2, e2 = _two_sum(s1, lo)
    d_hi, e3 = _two_sum(s2, e1)             # renormalize: |d_lo| <= ulp(d_hi)/2
    d_lo = e3 + e2
    eps = _half_ulp64(hi)
    # (eps << ulp32(1)/2, so no f32 value sits in (1-eps, 1): the == tests
    # cover the boundary cases exactly.)
    ge1 = (d_hi > 1.0) | ((d_hi == 1.0) & (d_lo >= -eps))
    lt0 = (d_hi < -eps) | ((d_hi == -eps) & (d_lo < 0.0))
    t = jnp.where(ge1, t + 1.0, t)
    t = jnp.where(lt0 & ~ge1, t - 1.0, t)
    return t


def _cubic_f32(x):
    """Keys a=-0.5 bicubic kernel in f32 (``ppmx-edward.c:477-489``)."""
    absx = jnp.abs(x)
    absx2 = absx * absx
    absx3 = absx2 * absx
    ret = jnp.where(absx <= 1.0, (1.5 * absx3) - (2.5 * absx2) + 1.0, 0.0)
    return jnp.where(
        (1.0 < absx) & (absx <= 2.0),
        ret + ((-0.5 * absx3) + (2.5 * absx2) - (4.0 * absx) + 2.0),
        ret,
    )


@functools.partial(jax.jit, static_argnames=("new_h", "new_w"))
def _rotate_apply(img, ax, bx, ay, by, xc, yc, *, new_h: int, new_w: int):
    """Device-side inverse-map rotation (``ppmx-edward.c:727-785``).

    Coordinates combine in double-f32 (hi/lo pairs from the exact f64 host
    terms), so zone masks, nearest indices, and tap bases match the C's
    float64 decisions except within ~1e-7 of a rounding boundary; interior
    bicubic accumulates in f32 (the documented +-1 LSB budget).
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    height, width = img.shape[0], img.shape[1]
    (ax_hi, ax_lo), (bx_hi, bx_lo) = ax, bx
    (ay_hi, ay_lo), (by_hi, by_lo) = ay, by

    nx_hi, nx_lo = _combine_df32(
        ax_hi[None, :], ax_lo[None, :], bx_hi[:, None], bx_lo[:, None], xc
    )
    ny_hi, ny_lo = _combine_df32(
        ay_hi[None, :], ay_lo[None, :], by_hi[:, None], by_lo[:, None], yc
    )

    rX = _floor_df32(nx_hi, nx_lo, 0.5)  # round half up, integer-valued f32
    rY = _floor_df32(ny_hi, ny_lo, 0.5)
    in_bounds = (rX < width) & (rY < height) & (rY >= 0) & (rX >= 0)
    interior = (
        in_bounds
        & (rX > 1)
        & (rY > 1)
        & (rX < max(width - 2, 0))
        & (rY < max(height - 2, 0))
    )
    edge = in_bounds & ~interior

    nearest_y = jnp.clip(rY, 0, height - 1).astype(jnp.int32)
    nearest_x = jnp.clip(rX, 0, width - 1).astype(jnp.int32)

    fbase_x = _floor_df32(nx_hi, nx_lo) - 1.0
    fbase_y = _floor_df32(ny_hi, ny_lo) - 1.0
    base_x = jnp.clip(fbase_x, 0, max(width - 4, 0)).astype(jnp.int32)
    base_y = jnp.clip(fbase_y, 0, max(height - 4, 0)).astype(jnp.int32)

    # Tap weights cubic(nX - u); (hi - u) is Sterbenz-exact, lo restores the
    # f64-grade fraction.
    wx = [
        _cubic_f32((nx_hi - (fbase_x + i)) + nx_lo) for i in range(4)
    ]
    wy = [
        _cubic_f32((ny_hi - (fbase_y + j)) + ny_lo) for j in range(4)
    ]

    src = img.astype(jnp.float32)
    out_shape = (new_h, new_w, img.shape[2])
    acc = jnp.zeros(out_shape, dtype=jnp.float32)
    # C accumulation structure (:753-769): inner i-sum weighted by cubic in x,
    # outer j-sum weighted by cubic in y. 16 static gathers.
    for j in range(4):
        p = jnp.zeros(out_shape, dtype=jnp.float32)
        for i in range(4):
            tap = src[base_y + j, base_x + i]
            p = p + tap * wx[i][:, :, None]
        acc = acc + p * wy[j][:, :, None]
    acc = jnp.where(acc < 0.0, 0.0, acc)
    acc = jnp.where(acc >= 256.0, 255.0, acc)
    interior_val = acc.astype(jnp.int32).astype(jnp.uint8)  # (int) truncation

    nearest_val = img[nearest_y, nearest_x]

    out = jnp.zeros(out_shape, dtype=jnp.uint8)
    out = jnp.where(edge[:, :, None], nearest_val, out)
    out = jnp.where(interior[:, :, None], interior_val, out)
    return out[:, :, 0] if squeeze else out


# ---------------------------------------------------------------------------
# Blocked rotation: gather-free arbitrary-angle path.
#
# This path re-expresses the 16-gather formulation above as dense math:
# the output is tiled into G x L tiles; for each tile one dynamic_slice
# pulls the BH x BW source block that contains every tap (block starts
# precomputed on host in f64), and the 4x4 bicubic gather+MAC becomes
#     out[c, p] = sum_r ( sum_w block[c, r, w] * Wx[w, p] ) * Wy[r, p]
# where Wx/Wy are banded selection matrices built on device from the same
# double-f32 geometry (4 cubic-weighted taps per output pixel). The w-sum
# is a matmul; the r-sum an elementwise multiply-reduce. Edge-band pixels
# reuse the SAME matmul with one-hot weights (their nearest tap is always
# inside the 4x4 window), so zone semantics are identical to `_rotate_apply`:
# outside -> black, edge -> nearest, interior -> bicubic (+-1 LSB budget).
# ---------------------------------------------------------------------------

def _zone_taps(ax_pair, bx_pair, ay_pair, by_pair, xc, yc, width, height):
    """Zone/tap decision core of the blocked path.

    Combines the split-f64 geometry terms in double-f32, makes the C's zone
    decisions (``ppmx-edward.c:744-783``), and returns
    ``(base_x, base_y, wxs[4], wys[4])`` where the per-tap weights already
    fold the zone masks: interior -> cubic, edge band -> one-hot on the
    nearest tap (always inside the 4x4 window), outside -> all-zero (black).
    Shape-agnostic: callers pass broadcastable hi/lo pairs.
    """
    nx_hi, nx_lo = _combine_df32(*ax_pair, *bx_pair, xc)
    ny_hi, ny_lo = _combine_df32(*ay_pair, *by_pair, yc)
    rX = _floor_df32(nx_hi, nx_lo, 0.5)
    rY = _floor_df32(ny_hi, ny_lo, 0.5)
    in_bounds = (rX < width) & (rY < height) & (rY >= 0) & (rX >= 0)
    interior = (
        in_bounds
        & (rX > 1) & (rY > 1)
        & (rX < max(width - 2, 0)) & (rY < max(height - 2, 0))
    )
    edge = in_bounds & ~interior
    fbase_x = _floor_df32(nx_hi, nx_lo) - 1.0
    fbase_y = _floor_df32(ny_hi, ny_lo) - 1.0
    base_x = jnp.clip(fbase_x, 0, max(width - 4, 0)).astype(jnp.int32)
    base_y = jnp.clip(fbase_y, 0, max(height - 4, 0)).astype(jnp.int32)
    # In-bounds pixels have nearest == round(n) in [0, dim); it always
    # falls inside the 4x4 tap window (offset 1 or 2 unclipped, 0..3 at
    # the clip boundaries), so edge pixels ride the same matmul with
    # one-hot weights instead of cubic ones.
    nearest_x = jnp.clip(rX, 0, width - 1).astype(jnp.int32)
    nearest_y = jnp.clip(rY, 0, height - 1).astype(jnp.int32)
    offx = nearest_x - base_x
    offy = nearest_y - base_y

    one = jnp.float32(1.0)
    zero = jnp.float32(0.0)
    wxs, wys = [], []
    for t in range(4):
        cub_x = _cubic_f32((nx_hi - (fbase_x + t)) + nx_lo)
        cub_y = _cubic_f32((ny_hi - (fbase_y + t)) + ny_lo)
        wxs.append(jnp.where(
            interior, cub_x, jnp.where(edge & (offx == t), one, zero)))
        wys.append(jnp.where(
            interior, cub_y, jnp.where(edge & (offy == t), one, zero)))
    return base_x, base_y, wxs, wys


# Output tile shape (untuned): G rows x L columns per tile. G trades the
# source-block height against per-tile fixed cost.
_BLOCK_G = 16
_BLOCK_L = 128
# Precision of the blocked path's f32 dot (source block x cubic x-weights):
# the cheapest option that keeps every 4K case within the +-1 budget on the
# GPU (TF32 there; tools/precision_compare.py compares it with HIGHEST and
# BF16_BF16_F32_X3, which round fewer pixels the other way but cost more).
ROTATE_DOT_PRECISION = jax.lax.Precision.HIGH


@functools.lru_cache(maxsize=64)
def _blocked_plan(height: int, width: int, angle: float):
    """Host-side f64 plan for the blocked path; None if the image is smaller
    than one source block (fallback to the gather path)."""
    G, L = _BLOCK_G, _BLOCK_L
    folded = _exact.fold_angle(float(angle))
    new_w, new_h = _exact.calc_rot_size(folded, width, height)
    theta = (float(angle) * np.pi) / 180.0
    cos_t, sin_t = np.cos(theta), np.sin(theta)
    # Source extent any G x L output tile can touch (+4 taps, +3 safety).
    bh = int(np.ceil(abs(sin_t) * (L - 1) + abs(cos_t) * (G - 1))) + 7
    bw = int(np.ceil(abs(cos_t) * (L - 1) + abs(sin_t) * (G - 1))) + 7
    if height < bh or width < bw:
        return None
    x_center = width // 2
    y_center = height // 2
    x_offset = new_w // 2 - x_center
    y_offset = new_h // 2 - y_center

    n_g = -(-new_h // G)
    n_k = -(-new_w // L)
    xs = np.arange(new_w, dtype=np.float64) - x_offset - x_center
    ys = np.arange(new_h, dtype=np.float64) - y_offset - y_center
    # Edge-pad to full tiles; padded outputs are cropped, their geometry only
    # has to stay in-range for the block-start min/max below.
    xs = np.pad(xs, (0, n_k * L - new_w), mode="edge")
    ys = np.pad(ys, (0, n_g * G - new_h), mode="edge")
    ax = cos_t * xs      # nX = ax[x] + bx[y] + x_center
    bx = sin_t * ys
    ay = -sin_t * xs     # nY = ay[x] + by[y] + y_center
    by = cos_t * ys

    # Per-tile block starts from f64 corner minima (nX/nY are linear, so the
    # tile extrema live at tile corners).
    ax2 = ax.reshape(n_k, L)
    ay2 = ay.reshape(n_k, L)
    bx2 = bx.reshape(n_g, G)
    by2 = by.reshape(n_g, G)
    ax_min = np.minimum(ax2[:, 0], ax2[:, -1])
    ay_min = np.minimum(ay2[:, 0], ay2[:, -1])
    bx_min = np.minimum(bx2[:, 0], bx2[:, -1])
    by_min = np.minimum(by2[:, 0], by2[:, -1])
    nx_min = bx_min[:, None] + ax_min[None, :] + x_center   # [n_g, n_k]
    ny_min = by_min[:, None] + ay_min[None, :] + y_center
    sx = np.clip(np.floor(nx_min) - 1, 0, width - bw).astype(np.int32)
    sy = np.clip(np.floor(ny_min) - 1, 0, height - bh).astype(np.int32)

    return (
        new_h, new_w, bh, bw, n_g, n_k,
        tuple(map(_split_f64, (ax, bx, ay, by))),
        sy, sx, float(x_center), float(y_center),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "new_h", "new_w", "bh", "bw", "n_g", "n_k", "zone_hw",
    ),
)
def _rotate_apply_blocked(
    img, axh, axl, bxh, bxl, ayh, ayl, byh, byl, sy, sx, xc, yc,
    row_base=None,
    *, new_h: int, new_w: int, bh: int, bw: int, n_g: int, n_k: int,
    zone_hw: tuple[int, int] | None = None,
):
    """Device side of the blocked path (see module comment above).

    Inputs: split f64 geometry terms reshaped to tiles (axh/axl/ayh/ayl
    [n_k, L]; bxh/bxl/byh/byl [n_g, G]); block starts sy/sx [n_g, n_k].
    lax.scan over output row-groups, vmap over column chunks.

    ``zone_hw`` gives the GLOBAL (height, width) for the zone/bounds
    decisions when ``img`` is only a row WINDOW of the full image (the
    spatial band-exchange path passes each device its m-shard band);
    default: ``img``'s own dims. ``row_base`` is the window's global
    starting row: ``sy`` stays GLOBAL (the tap geometry needs it) and is
    rebased by ``row_base`` only where the source block is sliced out of
    the window.
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    win_h, win_w, nch = img.shape
    height, width = zone_hw if zone_hw is not None else (win_h, win_w)
    base_row = jnp.int32(0) if row_base is None else row_base
    G, L = _BLOCK_G, _BLOCK_L
    P = G * L
    planes = jnp.stack([img[:, :, c] for c in range(nch)], axis=0)  # [C,H,W]
    col_iota = jnp.arange(bw, dtype=jnp.int32)[:, None]
    row_iota = jnp.arange(bh, dtype=jnp.int32)[:, None]

    def chunk(axh_k, axl_k, ayh_k, ayl_k, syk, sxk, bxg, bxgl, byg, bygl):
        # Identical double-f32 geometry to _rotate_apply, on one tile.
        base_x, base_y, wxs, wys = _zone_taps(
            (axh_k[None, :], axl_k[None, :]),
            (bxg[:, None], bxgl[:, None]),
            (ayh_k[None, :], ayl_k[None, :]),
            (byg[:, None], bygl[:, None]),
            xc, yc, width, height,
        )

        zero = jnp.float32(0.0)
        relx = (base_x - sxk).reshape(P)
        rely = (base_y - syk).reshape(P)
        dx = col_iota - relx[None, :]                      # [BW, P]
        dy = row_iota - rely[None, :]                      # [BH, P]
        w_x = sum(
            jnp.where(dx == t, wxs[t].reshape(P)[None, :], zero)
            for t in range(4)
        )
        w_y = sum(
            jnp.where(dy == t, wys[t].reshape(P)[None, :], zero)
            for t in range(4)
        )
        blk = jax.lax.dynamic_slice(
            planes, (0, syk - base_row, sxk), (nch, bh, bw)
        ).astype(jnp.float32)
        h1 = jax.lax.dot_general(                          # [C, BH, P]
            blk, w_x, (((2,), (0,)), ((), ())),
            precision=ROTATE_DOT_PRECISION,
            preferred_element_type=jnp.float32,
        )
        acc = (h1 * w_y[None, :, :]).sum(axis=1)           # [C, P]
        acc = jnp.where(acc < 0.0, 0.0, acc)
        acc = jnp.where(acc >= 256.0, 255.0, acc)
        # int cast truncates (:781); edge/outside values are exact integers.
        return acc.astype(jnp.int32).astype(jnp.uint8).reshape(nch, G, L)

    def row_group(carry, xs_g):
        bxg, bxgl, byg, bygl, sy_row, sx_row = xs_g
        outs = jax.vmap(
            lambda a, b, c, d, e, f: chunk(a, b, c, d, e, f, bxg, bxgl, byg, bygl)
        )(axh, axl, ayh, ayl, sy_row, sx_row)              # [n_k, C, G, L]
        rows = jnp.transpose(outs, (2, 0, 3, 1)).reshape(G, n_k * L, nch)
        return carry, rows

    _, rows = jax.lax.scan(row_group, None, (bxh, bxl, byh, byl, sy, sx))
    out = rows.reshape(n_g * G, n_k * L, nch)[:new_h, :new_w]
    return out[:, :, 0] if squeeze else out


def _rotate_blocked(img, angle: float):
    """Blocked-path dispatch; returns None when the plan doesn't apply."""
    plan = _blocked_plan(img.shape[0], img.shape[1], angle)
    if plan is None:
        return None
    new_h, new_w, bh, bw, n_g, n_k, splits, sy, sx, xc, yc = plan
    (axh, axl), (bxh, bxl), (ayh, ayl), (byh, byl) = splits
    G, L = _BLOCK_G, _BLOCK_L
    return _rotate_apply_blocked(
        jnp.asarray(img),
        jnp.asarray(axh.reshape(n_k, L)), jnp.asarray(axl.reshape(n_k, L)),
        jnp.asarray(bxh.reshape(n_g, G)), jnp.asarray(bxl.reshape(n_g, G)),
        jnp.asarray(ayh.reshape(n_k, L)), jnp.asarray(ayl.reshape(n_k, L)),
        jnp.asarray(byh.reshape(n_g, G)), jnp.asarray(byl.reshape(n_g, G)),
        jnp.asarray(sy), jnp.asarray(sx), xc, yc,
        new_h=new_h, new_w=new_w, bh=bh, bw=bw, n_g=n_g, n_k=n_k,
    )


def rotate_exact(img, angle_deg: float):
    """float64 exactness mode (survey §4): bit-exact vs the C binary.

    Runs the golden host path (f64 j-then-i accumulation). For verification
    or when the f32 interior's +-1 LSB budget is unacceptable.
    """
    from imageprocessingtools_tpu.golden import model as _golden

    return _golden.rotate(np.asarray(img), float(angle_deg))


def _round_df32_host(a: np.ndarray, b: np.ndarray, c: float) -> np.ndarray:
    """Numpy f32 replica of the device's _combine_df32 + _floor_df32(+0.5).

    Bit-for-bit the same IEEE f32 operations the device runs, so comparing
    its output with the f64 truth audits the REAL decision divergence, not a
    margin model. Returns round-half-up(a + b + c) as f32 integers.
    """
    f32 = np.float32
    a_hi = a.astype(f32)
    a_lo = (a - a_hi).astype(f32)
    b_hi = b.astype(f32)
    b_lo = (b - b_hi).astype(f32)
    a_hi, a_lo = a_hi[None, :], a_lo[None, :]
    b_hi, b_lo = b_hi[:, None], b_lo[:, None]
    s = a_hi + b_hi
    bb = s - a_hi
    e = (a_hi - (s - bb)) + (b_hi - bb)
    c32 = f32(c)
    s2 = s + c32
    bb2 = s2 - s
    e2 = (s - (s2 - bb2)) + (c32 - bb2)
    hi = s2
    lo = e + e2 + (a_lo + b_lo)
    add = f32(0.5)

    def two_sum(p, q):
        ts = p + q
        tb = ts - p
        return ts, (p - (ts - tb)) + (q - tb)

    t = np.floor(hi + (lo + add))
    r = hi - t
    s1, e1 = two_sum(r, np.broadcast_to(add, r.shape).astype(f32))
    sB, eB = two_sum(s1, lo)
    d_hi, e3 = two_sum(sB, e1)
    d_lo = e3 + eB
    bits = np.abs(hi).view(np.int32)
    e_exp = ((bits >> 23) & 0xFF) - 127
    e_eps = e_exp - 53
    eps_bits = np.where(e_eps >= -126, (e_eps + 127) << 23, 0).astype(np.int32)
    eps = eps_bits.view(f32)
    ge1 = (d_hi > f32(1.0)) | ((d_hi == f32(1.0)) & (d_lo >= -eps))
    lt0 = (d_hi < -eps) | ((d_hi == -eps) & (d_lo < f32(0.0)))
    t = np.where(ge1, t + f32(1.0), t)
    t = np.where(lt0 & ~ge1, t - f32(1.0), t)
    return t


@functools.lru_cache(maxsize=64)
def rotation_decisions_safe(height: int, width: int, angle: float) -> bool:
    """True if the device's double-f32 zone/nearest decisions match the C's
    f64 decisions for EVERY output pixel (host audit, cached per geometry).

    Replicates the device's f32 arithmetic on host and compares the
    observables — zone masks and, where the nearest-neighbor band applies,
    the nearest index. Tap-base (floor) divergences are ignored: the cubic
    kernel is continuous across a base shift, so those stay inside the +-1
    budget. O(outH*outW) on host, so verdicts PERSIST across processes
    (utils/audit_cache, keyed by a code-version hash): the CLI is
    process-per-image and would otherwise re-pay the audit on every
    same-geometry rotation.
    """
    from imageprocessingtools_tpu.utils import audit_cache

    cached = audit_cache.get(height, width, angle)
    if cached is not None:
        return cached
    verdict = _rotation_decisions_safe_compute(height, width, angle)
    audit_cache.put(height, width, angle, verdict)
    return verdict


def _rotation_decisions_safe_compute(
    height: int, width: int, angle: float
) -> bool:
    # Chunked over output rows: the whole-plane form materialized ~15 f64
    # arrays of outH*outW (~1.5 GB at 4K), each above glibc's mmap
    # threshold, so every call re-paid first-touch page faults. Row chunks
    # keep every temporary a few MB, arena-recycled after the first chunk,
    # and allow early exit on the first divergent row band.
    folded = _exact.fold_angle(float(angle))
    new_w, new_h = _exact.calc_rot_size(folded, width, height)
    theta = (float(angle) * np.pi) / 180.0
    x_center, y_center = width // 2, height // 2
    xs = np.arange(new_w, dtype=np.float64) - (new_w // 2 - x_center) - x_center
    ys = np.arange(new_h, dtype=np.float64) - (new_h // 2 - y_center) - y_center

    def decisions(rX, rY):
        in_b = (rX < width) & (rY < height) & (rY >= 0) & (rX >= 0)
        interior = (
            in_b & (rX > 1) & (rY > 1)
            & (rX < max(width - 2, 0)) & (rY < max(height - 2, 0))
        )
        edge = in_b & ~interior
        return interior, edge

    cos_xs = np.cos(theta) * xs
    sin_xs = -np.sin(theta) * xs
    chunk = max(1, (1 << 19) // max(new_w, 1))  # ~0.5 M elems / temporary
    for r0 in range(0, new_h, chunk):
        ysb = ys[r0 : r0 + chunk]
        nx64 = cos_xs[None, :] + np.sin(theta) * ysb[:, None] + x_center
        ny64 = sin_xs[None, :] + np.cos(theta) * ysb[:, None] + y_center
        rx64 = np.floor(nx64 + 0.5)
        ry64 = np.floor(ny64 + 0.5)
        rx32 = _round_df32_host(cos_xs, np.sin(theta) * ysb, x_center)
        ry32 = _round_df32_host(sin_xs, np.cos(theta) * ysb, y_center)
        i64, e64 = decisions(rx64, ry64)
        i32, e32 = decisions(rx32.astype(np.float64), ry32.astype(np.float64))
        if (i64 != i32).any() or (e64 != e32).any():
            return False
        if e64.any():
            same_nearest = (rx64 == rx32) & (ry64 == ry32)
            if not bool(same_nearest[e64].all()):
                return False
    return True


def rotate(img: jnp.ndarray, angle_deg: float, strict: bool = False) -> jnp.ndarray:
    """CW rotation by ``angle_deg`` with the reference's exact zone logic.

    ``angle_deg`` must be static (output shape depends on it). 0/90/180/270
    take exact permutation fast paths (``ppmx-edward.c:701-725``).
    ``strict=True`` additionally verifies on host (f64, cached per
    shape/angle) that no pixel's zone decision is ambiguous at double-f32
    precision, falling back to the bit-exact host path when one is.
    """
    angle = float(angle_deg)
    if angle == 0.0:
        return jnp.asarray(img)
    if angle == 90.0:
        return rotate90(img)
    if angle == 180.0:
        return rotate180(img)
    if angle == 270.0:
        return rotate270(img)
    if strict and not rotation_decisions_safe(img.shape[0], img.shape[1], angle):
        return jnp.asarray(rotate_exact(img, angle))
    blocked = _rotate_blocked(img, angle)
    if blocked is not None:
        return blocked
    new_h, new_w, ax, bx, ay, by, xc, yc = _rotation_geometry(
        img.shape[0], img.shape[1], angle
    )
    to_dev = lambda pair: (jnp.asarray(pair[0]), jnp.asarray(pair[1]))
    return _rotate_apply(
        jnp.asarray(img),
        to_dev(ax),
        to_dev(bx),
        to_dev(ay),
        to_dev(by),
        xc,
        yc,
        new_h=new_h,
        new_w=new_w,
    )
