"""Separable bicubic resize as two dense matmuls.

The reference precomputes per-output-row tap indices/weights and applies them
with scalar loops (``ppmx-edward.c:516-641, 808-872``). Here those taps are
scattered into dense weight matrices ``W_h [outH, H]`` and ``W_w [outW, W]``
on host (float64, exact — `ops/_exact`), and applied as ``quantize(W_h @ img)``
then ``quantize(img @ W_w^T)`` on device — each pass one dense matmul, with
the reference's uint8 requantization between passes and its pass order
(smaller scale factor first, ``ppmx-edward.c:1102-1120``).

float32 accumulation vs the C double carries the documented +-1 LSB budget
PER QUANTIZED PASS; because the reference requantizes to uint8 between the
two passes, a pass-1 flip can stack with pass-2's own rounding — worst
observed |diff| is 2 at a single pixel (first hits after 2,080 fuzz
campaign cases: seeds 950088/960030; see ops/common.py::float_stage_budget
and the regression tests in tests/test_fuzz_differential.py). The
contributions themselves (indices, weights, pruning) are exact.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from imageprocessingtools_tpu.ops import _exact
from imageprocessingtools_tpu.ops.common import quantize_u8


# Dense weight matrices above this element count take the f64 host path
# instead (see resize_width): ~1 GB of f32 weights per pass, and such
# geometries are extreme-aspect corner cases, not throughput paths.
_DENSE_LIMIT = 2**28

# Precision of every f32 resize dot (dense, banded and the spatial halo
# form): the cheapest option that keeps every 4K case within the budget on
# the GPU (TF32 there; tools/precision_compare.py compares it with HIGHEST
# and BF16_BF16_F32_X3). Pixel values are exact in TF32; the weights carry
# its 2^-11 rounding, under 0.2 LSB per pass.
RESIZE_DOT_PRECISION = jax.lax.Precision.HIGH


def _dense_infeasible(height: int, width: int, new_width: int) -> bool:
    new_height = _exact.resize_output_height(height, width, new_width)
    if new_height < 1:
        return False  # let plan_resize raise the B7 surface
    return max(new_height * height, new_width * width) > _DENSE_LIMIT


@functools.lru_cache(maxsize=32)
def _resize_plan_arrays(height: int, width: int, new_width: int):
    # Cache host numpy only: caching jnp arrays would leak tracers when the
    # first call happens inside a jit trace (constants are trace-local).
    plan = _exact.plan_resize(height, width, new_width)
    mats = []
    for dim, contrib in plan.passes:
        in_size = height if dim == 0 else width
        mats.append((dim, _exact.dense_weights(contrib, in_size).astype(np.float32)))
    return plan.new_height, plan.new_width, tuple(mats)


def _apply_pass(img: jnp.ndarray, weight: jnp.ndarray, dim: int) -> jnp.ndarray:
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    src = img.astype(jnp.float32)
    if dim == 0:
        # out[o, w, c] = sum_h W[o, h] * img[h, w, c]
        acc = jnp.einsum(
            "oh,hwc->owc",
            weight,
            src,
            precision=RESIZE_DOT_PRECISION,
            preferred_element_type=jnp.float32,
        )
    else:
        # out[h, o, c] = sum_w img[h, w, c] * W[o, w]
        acc = jnp.einsum(
            "ow,hwc->hoc",
            weight,
            src,
            precision=RESIZE_DOT_PRECISION,
            preferred_element_type=jnp.float32,
        )
    out = quantize_u8(acc)
    return out[:, :, 0] if squeeze else out


# ---------------------------------------------------------------------------
# Banded apply: exploit the weight matrices' band structure.
#
# Each W row has <= ceil(4/scale)+2 nonzero taps in a contiguous (mirror-
# reflected at edges, still local) index range, so the dense [out, in]
# matmul does mostly zero MACs — at 4K -> 1080p, 2160 columns vs a ~26-wide
# band. Rows are grouped (static group size) and each group contracts only
# its band. f32 sums over the extra zeros are exact, so banded and dense
# agree except for accumulation-order ulps — both inside the documented +-1
# budget. Off by default: which of the two is faster on the GPU is not
# measured.
# ---------------------------------------------------------------------------

_BAND_GROUP = 32  # output rows per block: band stays small, M-dim utilization ok


@functools.lru_cache(maxsize=32)
def _banded_blocks(height: int, width: int, new_width: int):
    """Per-pass banded weight blocks: tuple of (dim, ((start, Wb), ...))."""
    plan = _exact.plan_resize(height, width, new_width)
    passes = []
    for dim, contrib in plan.passes:
        idx, wts = contrib.indices, contrib.weights
        out_size, taps = idx.shape
        blocks = []
        for s in range(0, out_size, _BAND_GROUP):
            e = min(s + _BAND_GROUP, out_size)
            lo = int(idx[s:e].min())
            hi = int(idx[s:e].max()) + 1
            wb = np.zeros((e - s, hi - lo), dtype=np.float64)
            rows = np.repeat(np.arange(e - s), taps)
            np.add.at(wb, (rows, (idx[s:e] - lo).ravel()), wts[s:e].ravel())
            blocks.append((lo, hi, wb.astype(np.float32)))
        passes.append((dim, tuple(blocks)))
    return plan.new_height, plan.new_width, tuple(passes)


def _apply_pass_banded(img: jnp.ndarray, blocks, dim: int) -> jnp.ndarray:
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    if dim == 1:
        # Resize W as a row-banded pass on per-plane transposed data.
        from imageprocessingtools_tpu.ops.geometry import _transpose_hw

        out = _apply_pass_banded(_transpose_hw(img), blocks, 0)
        out = _transpose_hw(out)
        return out[:, :, 0] if squeeze else out
    h, w, c = img.shape
    flat = img.reshape(h, w * c).astype(jnp.float32)
    parts = [
        jax.lax.dot(
            jnp.asarray(wb), flat[lo:hi],
            precision=RESIZE_DOT_PRECISION,
            preferred_element_type=jnp.float32,
        )
        for lo, hi, wb in blocks
    ]
    acc = jnp.concatenate(parts, axis=0).reshape(-1, w, c)
    out = quantize_u8(acc)
    return out[:, :, 0] if squeeze else out


def resize_width(
    img: jnp.ndarray, new_width: int, banded: bool | None = None
) -> jnp.ndarray:
    """Resize to ``new_width``; height = trunc(H * new_width / W) (B6).

    Matches ``-wN``: MATLAB-imresize-compatible bicubic with antialiasing on
    downscale and mirror boundaries. ``banded=True`` selects the
    banded-matmul apply (see the banded section above); dense is the
    default.
    """
    if banded is None:
        banded = False
    if _dense_infeasible(img.shape[0], img.shape[1], int(new_width)) and not isinstance(
        img, jax.core.Tracer
    ):
        # Extreme aspect geometries (e.g. the B9 wrap case 4294968x1 -w1000,
        # a real 1000x704 output per the reference) make the dense [out, in]
        # weight matrix enormous even though the output and the contributions
        # [out, taps] are small. The f64 golden path applies taps directly —
        # O(out*taps) memory — and is bit-exact vs the C, strictly stronger
        # than the device path's +-1 budget. Concrete arrays only: under a jit
        # trace there is no host escape (and the dense constant would not
        # compile anyway).
        return jnp.asarray(resize_width_exact(img, int(new_width)))
    if banded:
        _, _, passes = _banded_blocks(img.shape[0], img.shape[1], int(new_width))
        out = img
        for dim, blocks in passes:
            out = _apply_pass_banded(out, blocks, dim)
        return out
    _, _, mats = _resize_plan_arrays(img.shape[0], img.shape[1], int(new_width))
    out = img
    for dim, weight in mats:
        out = _apply_pass(out, jnp.asarray(weight), dim)
    return out


def _hw_passes(height: int, width: int, new_height: int, new_width: int):
    """Both contribution passes for an explicit (H, W) target, smaller
    scale first (the reference's -wN ordering rule, applied generally)."""
    scale_h = float(new_height) / float(height)
    scale_w = float(new_width) / float(width)
    contrib_h = _exact.calc_contributions(height, new_height, scale_h)
    contrib_w = _exact.calc_contributions(width, new_width, scale_w)
    return (
        ((0, contrib_h), (1, contrib_w))
        if scale_h < scale_w
        else ((1, contrib_w), (0, contrib_h))
    )


@functools.lru_cache(maxsize=32)
def _resize_hw_plan_arrays(height: int, width: int, new_height: int, new_width: int):
    """General (H, W) target: both passes as dense f32 weight matrices."""
    mats = []
    for dim, contrib in _hw_passes(height, width, new_height, new_width):
        in_size = height if dim == 0 else width
        mats.append((dim, _exact.dense_weights(contrib, in_size).astype(np.float32)))
    return tuple(mats)


def resize_width_exact(img, new_width: int):
    """float64 exactness mode (survey §4): bit-exact vs the C binary.

    Runs the golden host path (sequential f64 tap accumulation on host).
    Use for verification / when +-1 LSB is unacceptable.
    """
    import numpy as np

    from imageprocessingtools_tpu.golden import model as _golden

    return _golden.resize_width(np.asarray(img), int(new_width))


def resize(img: jnp.ndarray, new_height: int, new_width: int) -> jnp.ndarray:
    """Library extension: resize to an explicit (new_height, new_width).

    Same guards as `resize_width`: outputs beyond the resource caps raise
    up front (a clear extension message, not the -wN parity surface), and
    extreme-aspect geometries whose dense weight matrix would exceed the
    feasible size take the f64 host tap path (bit-exact, O(out*taps)
    memory) instead of materializing an O(out*in) matrix.
    """
    new_height, new_width = int(new_height), int(new_width)
    if new_height < 1 or new_width < 1:
        raise ValueError("invalid option for new width\n")
    if (
        max(new_height, new_width) > _exact._MAX_RESIZE_DIM
        or new_height * new_width > _exact._MAX_RESIZE_OUT_PX
    ):
        raise ValueError(
            f"resize output {new_height}x{new_width} exceeds the supported "
            f"bound (dim <= 2^26, pixels <= 2^31)"
        )
    height, width = img.shape[0], img.shape[1]
    if max(new_height * height, new_width * width) > _DENSE_LIMIT and not isinstance(
        img, jax.core.Tracer
    ):
        from imageprocessingtools_tpu.golden.model import _apply_contributions

        out_np = np.asarray(img)
        for dim, contrib in _hw_passes(height, width, new_height, new_width):
            out_np = _apply_contributions(out_np, contrib, dim)
        return jnp.asarray(out_np)
    mats = _resize_hw_plan_arrays(height, width, new_height, new_width)
    out = img
    for dim, weight in mats:
        out = _apply_pass(out, jnp.asarray(weight), dim)
    return out
