"""Parity on the GPU at 4K: the float ops within budget, the one-hot dots exact.

Marked ``gpu``: skipped unless JAX runs on an NVIDIA GPU. Run there with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

The CPU runs every dot in full f32, so only the card can show what the
chosen dot precisions (``ops.resize.RESIZE_DOT_PRECISION``,
``ops.geometry.ROTATE_DOT_PRECISION``) do at real widths.
"""

import os
import sys

import numpy as np
import pytest

from imageprocessingtools_tpu.golden import model as golden
from imageprocessingtools_tpu.ops import _exact
from imageprocessingtools_tpu.ops.histogram import apply_lut, histogram

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import precision_compare as pc  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("op,h,w,param", pc.CASES)
def test_parity_4k_within_budget(op, h, w, param):
    img = pc.case_image(h, w)
    out = np.asarray(pc.device_fn(op, param)(img))
    ref = pc.golden_out(op, img, param)
    assert out.shape == ref.shape
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= pc.case_budget(op), (diff.max(), np.count_nonzero(diff))
    if op == "rotate":
        # Zone decisions carry no float budget: black and nearest pixels
        # are exact.
        plan = _exact.plan_rotation(h, w, float(param))
        assert diff[~plan.interior].max() == 0


def test_histogram_4k_exact():
    gray = golden.grayscale(pc.case_image(2160, 3840, seed=1))
    np.testing.assert_array_equal(np.asarray(histogram(gray)), golden.histogram(gray))


def test_apply_lut_4k_exact():
    gray = golden.grayscale(pc.case_image(2160, 3840, seed=2))
    lut = np.random.default_rng(3).integers(0, 256, 256, dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(apply_lut(gray, lut)), lut[gray])
