"""Differential suite: golden numpy model vs the compiled C reference binary.

Every reference op is checked BIT-EXACT (including resize and arbitrary
rotation, which the golden model reproduces with the C's float64 accumulation
order). This validates the golden model as the oracle for the device suites.
"""

import numpy as np
import pytest

from imageprocessingtools_tpu.codec import ppm
from imageprocessingtools_tpu.golden import model as golden
from tests.conftest import SHAPES, SHAPES_ROT, make_gradient, make_image


def _p6(img):
    return ppm.encode_ppm(img, ppm.FILETYPE_PPM)


def _decode_out(out_bytes, expect_magic):
    assert out_bytes is not None
    assert out_bytes.startswith(expect_magic)
    # Parse the oracle's fixed header layout: magic\n#comment\nW H\n[maxval\n]
    lines = out_bytes.split(b"\n", 3)
    w, h = (int(t) for t in lines[2].split(b" ") if t)
    if expect_magic == b"P4":
        payload = lines[3]
        return h, w, payload
    maxval, payload = lines[3].split(b"\n", 1)
    assert int(maxval) == 255
    return h, w, payload


@pytest.mark.parametrize("shape", SHAPES)
def test_gray(ref_runner, shape):
    img = make_image(*shape)
    code, _, out = ref_runner.run(_p6(img), ["-gray"])
    assert code == 0
    h, w, payload = _decode_out(out, b"P5")
    expected = golden.grayscale(img)
    assert (h, w) == expected.shape
    np.testing.assert_array_equal(
        np.frombuffer(payload, np.uint8).reshape(h, w), expected
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_mono_p4_packing(ref_runner, shape):
    img = make_image(*shape, seed=1)
    code, _, out = ref_runner.run(_p6(img), ["-mono"])
    assert code == 0
    h, w, payload = _decode_out(out, b"P4")
    expected_bits = golden.mono_dither(img)
    assert (h, w) == expected_bits.shape
    assert payload == np.packbits(expected_bits, axis=1).tobytes()


@pytest.mark.parametrize("flag,fn", [("-fv", golden.flip_vertical), ("-fh", golden.flip_horizontal)])
@pytest.mark.parametrize("shape", SHAPES)
def test_flips(ref_runner, shape, flag, fn):
    img = make_image(*shape, seed=2)
    code, _, out = ref_runner.run(_p6(img), [flag])
    assert code == 0
    h, w, payload = _decode_out(out, b"P6")
    expected = fn(img)
    np.testing.assert_array_equal(
        np.frombuffer(payload, np.uint8).reshape(h, w, 3), expected
    )


@pytest.mark.parametrize("angle", [0, 90, 180, 270])
@pytest.mark.parametrize("shape", [(12, 16), (13, 17), (29, 7)])
def test_rotate_orthogonal(ref_runner, shape, angle):
    img = make_image(*shape, seed=3)
    code, _, out = ref_runner.run(_p6(img), [f"-r{angle}"])
    assert code == 0
    h, w, payload = _decode_out(out, b"P6")
    expected = golden.rotate(img, angle)
    assert (h, w) == expected.shape[:2]
    np.testing.assert_array_equal(
        np.frombuffer(payload, np.uint8).reshape(h, w, 3), expected
    )


@pytest.mark.parametrize("angle", [1, 30, 45, 60, 77, 120, 135, 179, 181, 222, 240, 269, 271, 300, 359])
@pytest.mark.parametrize("shape", SHAPES_ROT)
def test_rotate_arbitrary_bit_exact(ref_runner, shape, angle):
    img = make_gradient(*shape)
    code, _, out = ref_runner.run(_p6(img), [f"-r{angle}"])
    assert code == 0
    h, w, payload = _decode_out(out, b"P6")
    expected = golden.rotate(img, angle)
    assert (h, w) == expected.shape[:2]
    np.testing.assert_array_equal(
        np.frombuffer(payload, np.uint8).reshape(h, w, 3), expected
    )


@pytest.mark.parametrize("shape,new_width", [
    ((12, 16), 10),   # downscale
    ((12, 16), 24),   # upscale
    ((13, 17), 8),    # odd downscale
    ((13, 17), 40),   # odd upscale
    ((48, 64), 64),   # identity width
    ((29, 7), 21),    # tall upscale
    ((12, 16), 10),   # truncated new_height case: 12*10/16 = 7.5 -> 7
])
def test_resize_bit_exact(ref_runner, shape, new_width):
    img = make_image(*shape, seed=4)
    code, _, out = ref_runner.run(_p6(img), [f"-w{new_width}"])
    assert code == 0
    h, w, payload = _decode_out(out, b"P6")
    expected = golden.resize_width(img, new_width)
    assert (h, w) == expected.shape[:2]
    np.testing.assert_array_equal(
        np.frombuffer(payload, np.uint8).reshape(h, w, 3), expected
    )


def test_resize_height_truncates_b6(ref_runner):
    """12 rows * (10/16) = 7.5 -> 7 rows (B6, verified)."""
    img = make_image(12, 16, seed=5)
    code, _, out = ref_runner.run(_p6(img), ["-w10"])
    assert code == 0
    h, w, _ = _decode_out(out, b"P6")
    assert (h, w) == (7, 10)


@pytest.mark.parametrize("args,ops", [
    (["-w10", "-gray"], lambda im: golden.grayscale(golden.resize_width(im, 10))),
    (["-w24", "-r90"], lambda im: golden.rotate90(golden.resize_width(im, 24))),
    (["-r90", "-mono"], lambda im: golden.mono_dither(golden.rotate90(im))),
    (["-w10", "-fv"], lambda im: golden.flip_vertical(golden.resize_width(im, 10))),
    (["-r30", "-gray"], lambda im: golden.grayscale(golden.rotate(im, 30))),
    (
        ["-w20", "-r45", "-gray", "-fh"],
        lambda im: golden.flip_horizontal(
            golden.grayscale(golden.rotate(golden.resize_width(im, 20), 45))
        ),
    ),
])
def test_pipeline_combos(ref_runner, args, ops):
    """Fixed-order combos. Flip combos here always include resize/rotate so
    the reference's renewBuffer path makes flips compose correctly (B1 only
    fires for flip+gray/mono without resize/rotate; see test_quirk_b1)."""
    img = make_gradient(16, 12)
    code, _, out = ref_runner.run(_p6(img), args)
    assert code == 0
    expected = ops(img)
    magic = b"P5" if "-gray" in args else (b"P4" if "-mono" in args else b"P6")
    h, w, payload = _decode_out(out, magic)
    if magic == b"P4":
        assert payload == np.packbits(expected, axis=1).tobytes()
    else:
        np.testing.assert_array_equal(
            np.frombuffer(payload, np.uint8).reshape(expected.shape), expected
        )


def test_quirk_b1_documented(ref_runner):
    """B1: -gray -fv in the reference emits the red channel of the flipped
    COLOR image, not flipped grayscale. We verify the quirk exists (so the
    divergence is intentional) — our framework implements the compose."""
    img = make_image(8, 8, seed=6)
    code, _, out = ref_runner.run(_p6(img), ["-gray", "-fv"])
    assert code == 0
    h, w, payload = _decode_out(out, b"P5")
    ref_result = np.frombuffer(payload, np.uint8).reshape(h, w)
    buggy = golden.flip_vertical(img)[:, :, 0]  # red of flipped color
    intended = golden.flip_vertical(golden.grayscale(img))
    np.testing.assert_array_equal(ref_result, buggy)
    assert not np.array_equal(ref_result, intended)


def test_quirk_b2_noop_fails(ref_runner):
    img = make_image(4, 4)
    code, stdout, out = ref_runner.run(_p6(img), [])
    assert code == 255
    assert "no data to write" in stdout
    assert out is None


def test_quirk_b3_errors_to_stdout_exit_255(ref_runner):
    code, stdout, _ = ref_runner.run(b"P5\n1 1\n255\n\x00", ["-gray"])
    assert code == 255
    assert "invalid file format" in stdout


def test_r0_is_identity_copy(ref_runner):
    img = make_image(6, 9, seed=7)
    code, _, out = ref_runner.run(_p6(img), ["-r0"])
    assert code == 0
    h, w, payload = _decode_out(out, b"P6")
    np.testing.assert_array_equal(
        np.frombuffer(payload, np.uint8).reshape(h, w, 3), img
    )


@pytest.mark.parametrize("shape,new_width", [((16, 20), 13), ((31, 24), 37)])
def test_resize_gradient_bit_exact(ref_runner, shape, new_width):
    """Smooth gradients hit more .5 rounding boundaries than noise."""
    img = make_gradient(*shape)
    code, _, out = ref_runner.run(_p6(img), [f"-w{new_width}"])
    assert code == 0
    h, w, payload = _decode_out(out, b"P6")
    expected = golden.resize_width(img, new_width)
    np.testing.assert_array_equal(
        np.frombuffer(payload, np.uint8).reshape(h, w, 3), expected
    )


@pytest.mark.parametrize("value", [0, 127, 128, 255])
def test_constant_images(ref_runner, value):
    """Constant images stress rounding/normalization paths."""
    img = np.full((9, 11, 3), value, dtype=np.uint8)
    for args in (["-gray"], ["-mono"], ["-w7"], ["-r45"]):
        code, _, out = ref_runner.run(_p6(img), args)
        assert code == 0
        magic = b"P5" if args == ["-gray"] else (b"P4" if args == ["-mono"] else b"P6")
        h, w, payload = _decode_out(out, magic)
        fn = {
            "-gray": lambda im: golden.grayscale(im),
            "-mono": lambda im: golden.mono_dither(im),
            "-w7": lambda im: golden.resize_width(im, 7),
            "-r45": lambda im: golden.rotate(im, 45),
        }[args[0]]
        expected = fn(img)
        if magic == b"P4":
            assert payload == np.packbits(expected, axis=1).tobytes()
        else:
            np.testing.assert_array_equal(
                np.frombuffer(payload, np.uint8).reshape(expected.shape), expected
            )


@pytest.mark.parametrize("angle", [30, 45, 135])
@pytest.mark.parametrize("shape", [(3, 3), (2, 8), (8, 2), (1, 5), (3, 17)])
def test_rotate_arbitrary_tiny_dims(ref_runner, shape, angle):
    """H or W < 4: no interior zone exists (nearest/black only); the golden
    model must clamp tap gathers instead of crashing."""
    img = make_image(*shape, seed=11)
    code, _, out = ref_runner.run(_p6(img), [f"-r{angle}"])
    assert code == 0
    h, w, payload = _decode_out(out, b"P6")
    expected = golden.rotate(img, angle)
    assert (h, w) == expected.shape[:2]
    np.testing.assert_array_equal(
        np.frombuffer(payload, np.uint8).reshape(h, w, 3), expected
    )


def test_quirk_b8_documented(ref_runner):
    """B8 (found by the thin-class fuzz campaign, seed 70085): the -r0 fast
    path ALIASES new_buff = buff (ppmx-edward.c:701-705); any later stage's
    renewBuffer then frees buff — and the alias with it — so the stage
    reads freed rows: deterministic garbage for -r0 -mono / -r0 -gray
    (ASan: heap-use-after-free at :1000 in gray, see test_sanitizers), and
    a crash for -r0 -fv on this platform. Like B1 we implement the
    obviously-intended compose (-r0 is the identity); this test proves the
    C bug exists so the divergence is intentional."""
    img = make_image(12, 7, seed=8)

    # the C's own -r0 -mono disagrees with its -mono (= the intended result)
    code_a, _, out_a = ref_runner.run(_p6(img), ["-r0", "-mono"])
    code_b, _, out_b = ref_runner.run(_p6(img), ["-mono"])
    assert code_a == 0 and code_b == 0
    assert out_a != out_b

    # ours composes: -r0 -mono == -mono == the golden dither
    import os
    import tempfile

    from imageprocessingtools_tpu import cli
    from imageprocessingtools_tpu.codec import ppm as _ppm

    with tempfile.TemporaryDirectory() as d:
        outs = []
        for args in (["-r0", "-mono"], ["-mono"]):
            p = os.path.join(d, "b8.ppm")
            _ppm.write_ppm(p, img)
            assert cli.main(args + [p]) == 0
            with open(p + ".out", "rb") as f:
                outs.append(f.read())
            os.remove(p + ".out")
    assert outs[0] == outs[1] == out_b
