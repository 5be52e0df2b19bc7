"""Randomized differential fuzzing: random shapes x random flag combos vs
the C binary (survey §4 property-test strategy).

Combos avoid the B1 class (flip + gray/mono WITHOUT resize/rotate — the
reference emits garbage there by bug; see test_quirk_b1_documented). Exact
combos compare byte-for-byte; combos containing resize or arbitrary
rotation allow the STAGE-AWARE budget of ops/common.py:float_stage_budget
(+-1 per quantized f32 stage, compounding across the reference's uint8
requantization points: resize=2, rotation=1, chain=3) on P5/P6 payloads
and are skipped for P4 (a +-1 gray change legitimately flips dither bits).
The compound corners are real but single-pixel-rare — see the regression
tests at the bottom (campaign seeds 950088 / 960030, the first maxdiff-2
hits in 2,080 campaign cases).
"""

import numpy as np
import pytest

from imageprocessingtools_tpu import cli
from imageprocessingtools_tpu.codec import ppm
from imageprocessingtools_tpu.ops.common import float_stage_budget
from tests.conftest import make_image


def _budget(args):
    has_w = any(a.startswith("-w") for a in args)
    has_r = any(
        a.startswith("-r") and a[2:] not in ("0", "90", "180", "270")
        for a in args
    )
    return float_stage_budget(has_w, has_r)


def _random_args(rng):
    args = []
    resize = rng.random() < 0.4
    rot = rng.random() < 0.5
    if resize:
        args.append(f"-w{int(rng.integers(1, 40))}")
    if rot:
        args.append(f"-r{int(rng.integers(0, 360))}")
    color = rng.integers(0, 3)
    if color == 1:
        args.append("-gray")
    elif color == 2:
        args.append("-mono")
    flip = rng.integers(0, 3)
    if flip and (resize or rot or color == 0):
        # flips without resize/rotate are fine alone, but pair them with
        # gray/mono only when renewBuffer runs (B1 guard)
        if color == 0 or resize or rot:
            args.append("-fv" if flip == 1 else "-fh")
    if not args:
        args.append("-gray")
    if "-r0" in args and len(args) > 1:
        # B8: -r0 + any later stage is a use-after-free in the reference
        # (the r0 alias is freed by the next renewBuffer) — garbage or a
        # crash, proven in test_quirk_b8_documented / test_sanitizers.
        # -r0 alone stays covered by test_r0_is_copy.
        args[args.index("-r0")] = "-r1"
    rng.shuffle(args)
    return args


def _has_float_op(args):
    return any(
        a.startswith("-w")
        or (a.startswith("-r") and a[2:] not in ("0", "90", "180", "270"))
        for a in args
    )


@pytest.mark.parametrize("case", range(40))
def test_fuzz_vs_reference(ref_runner, tmp_path, capsys, case):
    rng = np.random.default_rng(1000 + case)
    h = int(rng.integers(4, 40))
    w = int(rng.integers(4, 40))
    img = make_image(h, w, seed=case)
    args = _random_args(rng)
    data = ppm.encode_ppm(img)

    ref_code, ref_stdout, ref_out = ref_runner.run(data, args)

    import os

    in_path = os.path.join(str(tmp_path), "f.ppm")
    with open(in_path, "wb") as f:
        f.write(data)
    our_code = cli.main(args + [in_path])
    our_stdout = capsys.readouterr().out
    our_out = None
    if os.path.exists(in_path + ".out"):
        with open(in_path + ".out", "rb") as f:
            our_out = f.read()

    assert our_code == ref_code, (args, h, w, ref_stdout, our_stdout)
    assert our_stdout == ref_stdout, (args, h, w)
    if ref_code != 0:
        return
    assert our_out is not None and ref_out is not None, (args, h, w)
    if not _has_float_op(args):
        assert our_out == ref_out, (args, h, w)
    elif ref_out[:2] != b"P4":
        head_r, pay_r = ref_out.split(b"\n", 3)[:3], ref_out.split(b"\n", 3)[3]
        head_o, pay_o = our_out.split(b"\n", 3)[:3], our_out.split(b"\n", 3)[3]
        assert head_r == head_o, (args, h, w)
        a = np.frombuffer(pay_r, np.uint8).astype(np.int16)
        b = np.frombuffer(pay_o, np.uint8).astype(np.int16)
        assert a.shape == b.shape, (args, h, w)
        assert np.abs(a - b).max() <= _budget(args), (args, h, w)


@pytest.mark.parametrize("case", range(12))
def test_fuzz_vs_reference_midsize(ref_runner, tmp_path, capsys, case):
    """Same differential at 120-320 px: these sizes route rotation through
    the blocked matmul path (and resize through full-size weight matrices),
    unlike the small-shape fuzz above which exercises the fallbacks."""
    rng = np.random.default_rng(7000 + case)
    h = int(rng.integers(120, 320))
    w = int(rng.integers(120, 320))
    img = make_image(h, w, seed=900 + case)
    args = []
    if rng.random() < 0.5:
        args.append(f"-w{int(rng.integers(60, 400))}")
    args.append(f"-r{int(rng.integers(1, 360))}")  # always rotate (the point)
    color = rng.integers(0, 3)
    if color == 1:
        args.append("-gray")
    elif color == 2:
        args.append("-mono")
    if rng.integers(0, 2):
        args.append("-fv" if rng.integers(0, 2) else "-fh")
    rng.shuffle(args)
    data = ppm.encode_ppm(img)
    ref_code, ref_stdout, ref_out = ref_runner.run(data, args)

    import os

    in_path = os.path.join(str(tmp_path), "m.ppm")
    with open(in_path, "wb") as f:
        f.write(data)
    our_code = cli.main(args + [in_path])
    our_stdout = capsys.readouterr().out
    our_out = None
    if os.path.exists(in_path + ".out"):
        with open(in_path + ".out", "rb") as f:
            our_out = f.read()
    assert our_code == ref_code and our_stdout == ref_stdout, (args, h, w)
    if ref_code != 0:
        return
    if not _has_float_op(args):
        assert our_out == ref_out, (args, h, w)
    elif ref_out[:2] != b"P4":
        head_r, pay_r = ref_out.split(b"\n", 3)[:3], ref_out.split(b"\n", 3)[3]
        head_o, pay_o = our_out.split(b"\n", 3)[:3], our_out.split(b"\n", 3)[3]
        assert head_r == head_o, (args, h, w)
        a = np.frombuffer(pay_r, np.uint8).astype(np.int16)
        b = np.frombuffer(pay_o, np.uint8).astype(np.int16)
        assert a.shape == b.shape, (args, h, w)
        assert np.abs(a - b).max() <= _budget(args), (args, h, w)


# ---------------------------------------------------------------------------
# Compound-rounding regressions: the first two maxdiff>1 float cases found
# by the fresh-seed campaign (tools/fuzz_campaign.py) after 2,080 clean
# ones. Each is a SINGLE pixel at exactly 2 on the CPU backend: a +-1 f32
# rounding flip on one quantized stage feeding the next stage's taps
# through the reference's uint8 requantization (ppmx-edward.c:1102-1120
# between resize passes; :1084-1155 resize -> rotate). The f64 golden
# model stays bit-exact vs the binary on both — the drift is f32-only.
# ---------------------------------------------------------------------------

_COMPOUND_CASES = [
    # (campaign seed, h, w, args) — image is the campaign's seed^0xABCD gen
    (950088, 16, 35, ["-fv", "-w53"]),  # both resize passes compound
    (960030, 197, 220, ["-r197", "-w373"]),  # resize +-1 amplified by rotate
]


@pytest.mark.parametrize("seed,h,w,args", _COMPOUND_CASES)
def test_compound_rounding_regression(ref_runner, tmp_path, capsys,
                                      seed, h, w, args):
    import os

    img = np.random.default_rng(seed ^ 0xABCD).integers(
        0, 256, (h, w, 3), dtype=np.uint8)
    data = ppm.encode_ppm(img)
    ref_code, ref_stdout, ref_out = ref_runner.run(data, args)
    assert ref_code == 0

    in_path = os.path.join(str(tmp_path), "c.ppm")
    with open(in_path, "wb") as f:
        f.write(data)
    our_code = cli.main(args + [in_path])
    our_stdout = capsys.readouterr().out
    with open(in_path + ".out", "rb") as f:
        our_out = f.read()
    assert our_code == ref_code and our_stdout == ref_stdout

    head_r, pay_r = ref_out.split(b"\n", 3)[:3], ref_out.split(b"\n", 3)[3]
    head_o, pay_o = our_out.split(b"\n", 3)[:3], our_out.split(b"\n", 3)[3]
    assert head_r == head_o
    a = np.frombuffer(pay_r, np.uint8).astype(np.int16)
    b = np.frombuffer(pay_o, np.uint8).astype(np.int16)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= _budget(args)


@pytest.mark.parametrize("seed,h,w,args", _COMPOUND_CASES)
def test_compound_cases_golden_is_exact(ref_runner, seed, h, w, args):
    """On the same compound-rounding geometries, the f64 golden model is
    BIT-EXACT vs the C binary — isolating the device diff to f32 stage
    rounding, not a contributions/zone/order divergence."""
    from imageprocessingtools_tpu.golden import model as golden

    img = np.random.default_rng(seed ^ 0xABCD).integers(
        0, 256, (h, w, 3), dtype=np.uint8)
    data = ppm.encode_ppm(img)
    ref_code, _, ref_out = ref_runner.run(data, args)
    assert ref_code == 0

    out = img
    for a in args:  # pipeline order: resize -> rotate -> flips
        if a.startswith("-w"):
            out = golden.resize_width(out, int(a[2:]))
    for a in args:
        if a.startswith("-r"):
            out = golden.rotate(out, int(a[2:]))
    for a in args:
        if a == "-fv":
            out = golden.flip_vertical(out)
        elif a == "-fh":
            out = golden.flip_horizontal(out)

    pay_r = ref_out.split(b"\n", 3)[3]
    ref_px = np.frombuffer(pay_r, np.uint8)[4:]  # strip the "255\n" maxval
    np.testing.assert_array_equal(out.ravel(), ref_px)
