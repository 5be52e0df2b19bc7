"""Blocked rotation path: parity with golden + the C zone semantics.

Images here are large enough that `geometry._blocked_plan` applies (the
gather fallback covers the small shapes in the other suites). Budget: zone
masks and edge/outside values exact; interior bicubic +-1 LSB (f32 matmul
vs the golden f64 accumulation).
"""

import numpy as np
import pytest

from imageprocessingtools_tpu.golden import model as golden
from imageprocessingtools_tpu.ops import _exact, geometry


def _check(img, angle):
    plan = geometry._blocked_plan(img.shape[0], img.shape[1], float(angle))
    assert plan is not None, "test shape must take the blocked path"
    out = np.asarray(geometry.rotate(img, angle))
    exp = golden.rotate(img, angle)
    assert out.shape == exp.shape
    rp = _exact.plan_rotation(img.shape[0], img.shape[1], float(angle))
    outside = ~(rp.interior | rp.edge)
    diff = np.abs(out.astype(np.int64) - exp.astype(np.int64))
    np.testing.assert_array_equal(diff[outside], 0)
    np.testing.assert_array_equal(diff[rp.edge], 0)
    assert diff.max() <= 1


@pytest.mark.parametrize("angle", [1, 30, 45, 77, 135, 222, 359])
def test_blocked_rotate_rgb(angle):
    rng = np.random.default_rng(angle)
    img = rng.integers(0, 256, size=(200, 300, 3), dtype=np.uint8)
    _check(img, angle)


@pytest.mark.parametrize("shape,angle", [((160, 200), 30), ((160, 200), 135),
                                         ((180, 220), 61.0)])
def test_blocked_rotate_gray_2d(shape, angle):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    _check(img, angle)


@pytest.mark.parametrize("angle", [30, 117.5, 245, 333.3])
def test_blocked_rotate_fractional_and_reflex_angles(angle):
    rng = np.random.default_rng(int(angle))
    img = rng.integers(0, 256, size=(160, 200, 3), dtype=np.uint8)
    _check(img, angle)


def test_blocked_plan_too_small_for_one_block():
    assert geometry._blocked_plan(40, 40, 30.0) is None


def test_blocked_rotate_gradient():
    """Smooth image: rounding boundaries exercised differently than noise."""
    from tests.conftest import make_gradient

    _check(make_gradient(176, 240), 30)


def test_small_image_falls_back():
    assert geometry._blocked_plan(48, 64, 30.0) is None
    # and the gather path still serves it (covered by the main suites).
    img = np.random.default_rng(0).integers(0, 256, (48, 64, 3), np.uint8)
    out = np.asarray(geometry.rotate(img, 30))
    assert out.shape == golden.rotate(img, 30).shape


def test_blocked_vs_c_binary(ref_runner):
    """End-to-end differential vs the compiled reference at blocked size."""
    from imageprocessingtools_tpu.codec import ppm

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(160, 208, 3), dtype=np.uint8)
    assert geometry._blocked_plan(160, 208, 30.0) is not None
    code, _, out_bytes = ref_runner.run(ppm.encode_ppm(img), ["-r30"])
    assert code == 0
    lines = out_bytes.split(b"\n", 3)
    w, h = (int(t) for t in lines[2].split(b" ") if t)
    payload = lines[3].split(b"\n", 1)[1]
    expected = np.frombuffer(payload, np.uint8).reshape(h, w, 3)
    actual = np.asarray(geometry.rotate(img, 30))
    assert actual.shape == expected.shape
    rp = _exact.plan_rotation(160, 208, 30.0)
    diff = np.abs(actual.astype(np.int64) - expected.astype(np.int64))
    np.testing.assert_array_equal(diff[~rp.interior], 0)
    assert diff.max() <= 1


def test_rotation_decisions_safe_and_strict():
    """Opt-in f64 boundary audit: safe angles use the device
    path; an artificially huge margin forces the bit-exact fallback."""
    from imageprocessingtools_tpu.ops.geometry import (
        rotate, rotation_decisions_safe)

    # The audit replicates the device's f32 decisions; these geometries
    # must agree with f64 everywhere (the differential suites prove the
    # same empirically).
    for a in (30.0, 45.0, 135.0, 1.0):
        assert rotation_decisions_safe(48, 64, a)
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8)
    out = np.asarray(rotate(img, 30, strict=True))
    assert out.shape == golden.rotate(img, 30).shape
    # An (injected) ambiguous geometry -> strict must go bit-exact.
    orig = geometry.rotation_decisions_safe
    geometry.rotation_decisions_safe = lambda h, w, a: False
    try:
        out = np.asarray(rotate(img, 30, strict=True))
    finally:
        geometry.rotation_decisions_safe = orig
    np.testing.assert_array_equal(out, golden.rotate(img, 30))


@pytest.mark.parametrize("angle", [60, 120, 240, 300])
def test_half_ulp_boundary_family(angle):
    """cos/sin = 0.5 +- 1 f64 ulp family: zone/nearest decisions must match
    the C's f64 rounding exactly (regression for the _floor_df32 eps shift;
    the naive form diverged by full pixels here)."""
    rng = np.random.default_rng(angle)
    img = rng.integers(0, 256, size=(200, 300, 3), dtype=np.uint8)
    _check(img, angle)
    assert geometry.rotation_decisions_safe(200, 300, float(angle))


@pytest.mark.parametrize("shape", [(13, 17), (48, 64)])
def test_half_ulp_boundary_family_gather_path(shape):
    """Same regression through the gather fallback (small images)."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=shape + (3,), dtype=np.uint8)
    assert geometry._blocked_plan(shape[0], shape[1], 300.0) is None
    out = np.asarray(geometry.rotate(img, 300))
    exp = golden.rotate(img, 300)
    rp = _exact.plan_rotation(shape[0], shape[1], 300.0)
    diff = np.abs(out.astype(np.int64) - exp.astype(np.int64))
    np.testing.assert_array_equal(diff[~rp.interior], 0)
    assert diff.max() <= 1


@pytest.mark.parametrize("shape", [(1, 5), (2, 8), (3, 3), (8, 2)])
@pytest.mark.parametrize("angle", [30, 300])
def test_device_rotate_tiny_dims(shape, angle):
    """H or W < 4 on the DEVICE path (no interior zone; gathers clamp):
    exact vs golden (which is differential-verified against the C)."""
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    img = rng.integers(0, 256, size=shape + (3,), dtype=np.uint8)
    out = np.asarray(geometry.rotate(img, angle))
    exp = golden.rotate(img, angle)
    np.testing.assert_array_equal(out, exp)


def test_angle_sweep_all_cli_angles_small_sizes():
    """EVERY CLI-reachable resampling angle (integers 1..359 minus the
    permutation set) passes the double-f32 decision audit at the small
    size-grid points; tools/angle_audit.py runs the same sweep at HD/4K.
    Together with the CLI's strict_rotation=True
    (which runs this audit per geometry and falls back to the bit-exact
    host path on failure), the parity argument covers the whole CLI domain."""
    for h, w in ((16, 16), (37, 23)):
        unsafe = [
            a for a in range(1, 360)
            if a not in (90, 180, 270)
            and not geometry.rotation_decisions_safe(h, w, float(a))
        ]
        assert unsafe == [], (h, w, unsafe)


def test_cli_uses_strict_rotation(tmp_path, monkeypatch):
    """The eager CLI path must run the zone audit (strict_rotation=True)."""
    import os

    from imageprocessingtools_tpu import cli
    from imageprocessingtools_tpu.codec import ppm

    calls = []
    orig = geometry.rotation_decisions_safe

    def spy(h, w, a):
        calls.append((h, w, a))
        return orig(h, w, a)

    monkeypatch.setattr(geometry, "rotation_decisions_safe", spy)
    rng = np.random.default_rng(0)
    p = os.path.join(str(tmp_path), "s.ppm")
    ppm.write_ppm(p, rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
    assert cli.main(["-r33", p]) == 0
    assert (24, 32, 33.0) in calls


@pytest.mark.parametrize("shape,angle", [((160, 200), 30.0), ((20, 28), 30.0)])
def test_vmapped_rotation_matches_per_image(shape, angle):
    """vmap(rotate) over a batch == per-image rotate, bit for bit — both the
    blocked path (160x200 exceeds the 30deg source block) and the gather
    fallback (20x28 is below it). Serving's batched-rotation story."""
    import jax

    rng = np.random.default_rng(3)
    batch = rng.integers(0, 256, size=(4,) + shape + (3,), dtype=np.uint8)
    out = np.asarray(jax.jit(jax.vmap(lambda c: geometry.rotate(c, angle)))(batch))
    for i in range(4):
        np.testing.assert_array_equal(
            out[i], np.asarray(geometry.rotate(batch[i], angle))
        )
