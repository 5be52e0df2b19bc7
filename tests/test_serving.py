"""Batched serving path: files -> native decode -> device -> encoded files.

Outputs must be byte-identical to running the single-image CLI per file
(modulo the documented float budget; exact ops are compared byte-for-byte).
"""

import os

import numpy as np
import pytest

from imageprocessingtools_tpu import serving
from imageprocessingtools_tpu.codec import ppm
from imageprocessingtools_tpu.golden import model as golden
from imageprocessingtools_tpu.ops.packing import pack_bits_device
from imageprocessingtools_tpu.pipeline import PipelineConfig
from tests.conftest import make_image


@pytest.mark.parametrize("width", [1, 5, 8, 13, 40])
def test_pack_bits_device_matches_packbits(width):
    rng = np.random.default_rng(width)
    bits = rng.integers(0, 2, size=(6, width), dtype=np.uint8)
    out = np.asarray(pack_bits_device(bits))
    np.testing.assert_array_equal(out, np.packbits(bits, axis=1))


def test_pack_bits_device_batched():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(4, 6, 13), dtype=np.uint8)
    out = np.asarray(pack_bits_device(bits))
    np.testing.assert_array_equal(out, np.packbits(bits, axis=2))


def _write_inputs(tmp_path, shapes):
    paths = []
    for i, (h, w) in enumerate(shapes):
        p = os.path.join(str(tmp_path), f"img_{i}.ppm")
        ppm.write_ppm(p, make_image(h, w, seed=i))
        paths.append(p)
    return paths


def test_process_files_gray(tmp_path):
    paths = _write_inputs(tmp_path, [(12, 16)] * 3 + [(8, 20)] * 2)
    outs = serving.process_files(paths, PipelineConfig(gray=True))
    assert len(outs) == 5
    for i, p in enumerate(outs):
        img, _ = (
            np.frombuffer(open(p, "rb").read().split(b"255\n", 1)[1], np.uint8),
            None,
        )
        h, w = (12, 16) if i < 3 else (8, 20)
        expected = golden.grayscale(make_image(h, w, seed=i))
        np.testing.assert_array_equal(img.reshape(h, w), expected)


def test_process_files_mono_matches_cli_bytes(tmp_path):
    """Batched mono output == single-image CLI output, byte for byte."""
    from imageprocessingtools_tpu import cli

    paths = _write_inputs(tmp_path, [(9, 13)] * 4)
    outs = serving.process_files(paths, PipelineConfig(mono=True), suffix=".batch")
    for i, p in enumerate(paths):
        assert cli.main(["-mono", p]) == 0
        with open(p + ".out", "rb") as f:
            expected = f.read()
        with open(p + ".batch", "rb") as f:
            got = f.read()
        assert got == expected


def test_process_files_resize_mono(tmp_path):
    """Shape-changing op before mono: P4 header uses post-resize dims."""
    paths = _write_inputs(tmp_path, [(16, 24)] * 2)
    outs = serving.process_files(
        paths, PipelineConfig(new_width=12, mono=True), suffix=".batch"
    )
    with open(outs[0], "rb") as f:
        data = f.read()
    assert data.startswith(b"P4\n# generated by ppmx_edward\n12 8\n")
    expected_bits = golden.mono_dither(
        golden.resize_width(make_image(16, 24, seed=0), 12)
    )
    assert data.endswith(np.packbits(expected_bits, axis=1).tobytes())


def test_process_files_sharded_mesh(tmp_path):
    """Serving with a device mesh shards the batch and stays correct."""
    import jax
    from imageprocessingtools_tpu.parallel.batch import default_mesh

    paths = _write_inputs(tmp_path, [(8, 16)] * 8)
    outs = serving.process_files(
        paths, PipelineConfig(gray=True), mesh=default_mesh(), suffix=".sh"
    )
    assert len(outs) == 8
    for i, p in enumerate(outs):
        payload = open(p, "rb").read().split(b"255\n", 1)[1]
        expected = golden.grayscale(make_image(8, 16, seed=i))
        np.testing.assert_array_equal(
            np.frombuffer(payload, np.uint8).reshape(8, 16), expected
        )


def test_process_files_mesh_non_divisible(tmp_path):
    """A shape bucket whose chunk doesn't divide the mesh size pads up to a
    multiple of the device count and slices back."""
    from imageprocessingtools_tpu.parallel.batch import default_mesh

    paths = _write_inputs(tmp_path, [(8, 16)] * 5)  # 5 files, 8 devices
    outs = serving.process_files(
        paths, PipelineConfig(gray=True), mesh=default_mesh(), suffix=".nd"
    )
    assert len(outs) == 5
    for i, p in enumerate(outs):
        payload = open(p, "rb").read().split(b"255\n", 1)[1]
        expected = golden.grayscale(make_image(8, 16, seed=i))
        np.testing.assert_array_equal(
            np.frombuffer(payload, np.uint8).reshape(8, 16), expected
        )


def test_process_files_mesh_tiny_remainder(tmp_path):
    """Remainder chunk smaller than the mesh (1 file after a full chunk)."""
    from imageprocessingtools_tpu.parallel.batch import default_mesh

    paths = _write_inputs(tmp_path, [(8, 16)] * 9)
    outs = serving.process_files(
        paths, PipelineConfig(gray=True), mesh=default_mesh(),
        suffix=".tr", max_batch=8,
    )
    assert len(outs) == 9
    payload = open(outs[8], "rb").read().split(b"255\n", 1)[1]
    expected = golden.grayscale(make_image(8, 16, seed=8))
    np.testing.assert_array_equal(
        np.frombuffer(payload, np.uint8).reshape(8, 16), expected
    )


@pytest.mark.parametrize("overlap", [True, False])
def test_process_files_pipelined_chunks(tmp_path, overlap):
    """Multi-chunk run with reader/writer threads matches the golden model."""
    paths = _write_inputs(tmp_path, [(8, 16)] * 9)
    outs = serving.process_files(
        paths, PipelineConfig(gray=True), suffix=".ov", max_batch=2,
        overlap=overlap,
    )
    assert len(outs) == 9
    for i, p in enumerate(outs):
        payload = open(p, "rb").read().split(b"255\n", 1)[1]
        expected = golden.grayscale(make_image(8, 16, seed=i))
        np.testing.assert_array_equal(
            np.frombuffer(payload, np.uint8).reshape(8, 16), expected
        )


def test_process_files_bad_input_raises(tmp_path):
    """A malformed file in the set surfaces as a PPMError, not silence."""
    paths = _write_inputs(tmp_path, [(8, 16)] * 6)
    with open(paths[4], "wb") as f:
        f.write(b"P6\n8 16\n255\n")  # truncated payload
    with pytest.raises(ppm.PPMError):
        serving.process_files(
            paths, PipelineConfig(gray=True), suffix=".er", max_batch=2
        )


def test_process_file_spatial_fused(tmp_path):
    """Single giant image H-sharded (fused pipeline) == unsharded result."""
    from imageprocessingtools_tpu.kernels.fused import fused_pipeline_xla

    img = make_image(32, 48, seed=3)
    p = os.path.join(str(tmp_path), "big.ppm")
    ppm.write_ppm(p, img)
    out = serving.process_file_spatial(p, "fused", suffix=".sp")
    payload = open(out, "rb").read().split(b"255\n", 1)[1]
    expected = np.asarray(fused_pipeline_xla(img))
    np.testing.assert_array_equal(
        np.frombuffer(payload, np.uint8).reshape(32, 48), expected
    )


@pytest.mark.parametrize("h", [32, 12])  # 12 % 8 != 0 -> submesh of 6
def test_process_file_spatial_reference_ops(tmp_path, h):
    """Reference pipeline under spatial sharding (GSPMD collectives) is
    bit-identical to the unsharded device pipeline, including an H not
    divisible by the mesh (submesh fallback)."""
    from imageprocessingtools_tpu.pipeline import run_pipeline

    img = make_image(h, 24, seed=h)
    p = os.path.join(str(tmp_path), f"sp{h}.ppm")
    ppm.write_ppm(p, img)
    cfg = PipelineConfig(new_width=16, angle=90, gray=True, flip_h=True)
    out = serving.process_file_spatial(p, cfg, suffix=".spr")
    payload = open(out, "rb").read().split(b"255\n", 1)[1]
    expected = np.asarray(run_pipeline(img, cfg)[0])
    np.testing.assert_array_equal(
        np.frombuffer(payload, np.uint8).reshape(expected.shape), expected
    )
    # and within the documented +-1 budget of the exact golden pipeline
    gold = golden.flip_horizontal(
        golden.grayscale(golden.rotate90(golden.resize_width(img, 16)))
    )
    assert np.abs(expected.astype(int) - gold.astype(int)).max() <= 1


def test_process_file_spatial_halo_resize(tmp_path):
    """A divisible geometry routes the resize stage through the halo-
    exchange shard_map path (not GSPMD) and stays bit-identical."""
    from imageprocessingtools_tpu.parallel.spatial import _spatial_resize_plan
    from imageprocessingtools_tpu.pipeline import run_pipeline

    img = make_image(64, 96, seed=7)
    # H=64, outH=32 both divide the 8-device mesh: the halo plan applies.
    assert _spatial_resize_plan(64, 96, 48, 8) is not None
    p = os.path.join(str(tmp_path), "halo.ppm")
    ppm.write_ppm(p, img)
    cfg = PipelineConfig(new_width=48, gray=True)
    out = serving.process_file_spatial(p, cfg, suffix=".hr")
    payload = open(out, "rb").read().split(b"255\n", 1)[1]
    expected = np.asarray(run_pipeline(img, cfg)[0])
    np.testing.assert_array_equal(
        np.frombuffer(payload, np.uint8).reshape(expected.shape), expected
    )


def test_process_file_spatial_mono_p4(tmp_path):
    img = make_image(16, 24, seed=5)
    p = os.path.join(str(tmp_path), "spm.ppm")
    ppm.write_ppm(p, img)
    out = serving.process_file_spatial(p, PipelineConfig(mono=True), suffix=".spm")
    data = open(out, "rb").read()
    assert data.startswith(b"P4\n# generated by ppmx_edward\n24 16\n")
    expected = np.packbits(golden.mono_dither(img), axis=1)
    assert data.endswith(expected.tobytes())


def test_process_files_device_error_no_deadlock(tmp_path, monkeypatch):
    """An exception in the device stage propagates without deadlocking the
    reader thread on a full decode queue."""
    paths = _write_inputs(tmp_path, [(8, 16)] * 12)
    real = serving.process_batch
    calls = {"n": 0}

    def flaky(batch, config, mesh=None):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("boom")
        return real(batch, config, mesh=mesh)

    monkeypatch.setattr(serving, "process_batch", flaky)
    with pytest.raises(RuntimeError, match="boom"):
        serving.process_files(
            paths, PipelineConfig(gray=True), suffix=".dk", max_batch=2
        )


def test_process_files_blocked_rotation(tmp_path):
    """Rotation at blocked-path size through the vmapped serving pipeline
    (scan+vmap under vmap) stays within the documented budget."""
    from imageprocessingtools_tpu.ops import _exact

    paths = _write_inputs(tmp_path, [(160, 208)] * 3)
    outs = serving.process_files(
        paths, PipelineConfig(angle=30, gray=True), suffix=".rot"
    )
    rp = _exact.plan_rotation(160, 208, 30.0)
    for i, p in enumerate(outs):
        payload = open(p, "rb").read().split(b"255\n", 1)[1]
        expected = golden.grayscale(golden.rotate(make_image(160, 208, seed=i), 30))
        got = np.frombuffer(payload, np.uint8).reshape(expected.shape)
        diff = np.abs(got.astype(int) - expected.astype(int))
        assert diff.max() <= 1
        np.testing.assert_array_equal(diff[~rp.interior], 0)


def test_serve_cli_batch(tmp_path, capsys):
    """python -m imageprocessingtools_tpu.serve over many files."""
    from imageprocessingtools_tpu import serve

    paths = _write_inputs(tmp_path, [(8, 16)] * 5)
    rc = serve.main(["-gray"] + paths)
    assert rc == 0
    for i, p in enumerate(paths):
        payload = open(p + ".out", "rb").read().split(b"255\n", 1)[1]
        expected = golden.grayscale(make_image(8, 16, seed=i))
        np.testing.assert_array_equal(
            np.frombuffer(payload, np.uint8).reshape(8, 16), expected
        )


def test_serve_cli_spatial(tmp_path):
    from imageprocessingtools_tpu import serve
    from imageprocessingtools_tpu.pipeline import PipelineConfig, run_pipeline

    paths = _write_inputs(tmp_path, [(32, 24)])
    rc = serve.main(["--spatial", "-gray", "-fv"] + paths)
    assert rc == 0
    payload = open(paths[0] + ".out", "rb").read().split(b"255\n", 1)[1]
    expected = np.asarray(
        run_pipeline(make_image(32, 24, seed=0),
                     PipelineConfig(gray=True, flip_v=True))[0]
    )
    np.testing.assert_array_equal(
        np.frombuffer(payload, np.uint8).reshape(32, 24), expected
    )


def test_process_files_skip_bad(tmp_path):
    """on_error='skip': corrupt header, truncated payload (caught at the
    chunk-decode layer), and missing file are recorded with their
    single-image messages; good files still produce correct outputs."""
    paths = _write_inputs(tmp_path, [(8, 16)] * 4)
    with open(paths[1], "wb") as f:
        f.write(b"P5 not a ppm")  # wrong magic: header pass
    data = open(paths[2], "rb").read()
    with open(paths[2], "wb") as f:
        f.write(data[:-5])  # short payload: passes header, fails decode
    os.remove(paths[3])  # open failure
    failures: dict = {}
    outs = serving.process_files(paths, PipelineConfig(gray=True),
                                 on_error="skip", failures=failures)
    assert outs == [paths[0] + ".out"]
    assert set(failures) == {paths[1], paths[2], paths[3]}
    assert failures[paths[3]] == "error. can not open file\n"
    assert "end of file" in failures[paths[2]]
    payload = open(paths[0] + ".out", "rb").read().split(b"255\n", 1)[1]
    np.testing.assert_array_equal(
        np.frombuffer(payload, np.uint8).reshape(8, 16),
        golden.grayscale(make_image(8, 16, seed=0)),
    )


def test_process_files_skip_bad_fanout_and_overlap(tmp_path):
    """skip-bad composes with fan-out and the overlap threads: the failed
    file's row is dropped from the returned list, survivors match the
    single-preset outputs."""
    paths = _write_inputs(tmp_path, [(8, 16)] * 6)
    with open(paths[2], "wb") as f:
        f.write(open(paths[2], "rb").read()[:-3])
    failures: dict = {}
    outs = serving.process_files(paths, ("enhance", "print_ready"),
                                 max_batch=2, on_error="skip",
                                 failures=failures)
    assert set(failures) == {paths[2]}
    assert len(outs) == 5 and all(len(o) == 2 for o in outs)
    serving.process_files([paths[0]], "enhance", suffix=".ref")
    assert (open(paths[0] + ".enhance.out", "rb").read()
            == open(paths[0] + ".ref", "rb").read())


def test_process_files_on_error_validation(tmp_path):
    paths = _write_inputs(tmp_path, [(8, 8)])
    with pytest.raises(ValueError, match="on_error"):
        serving.process_files(paths, PipelineConfig(gray=True),
                              on_error="ignore")


def test_serve_cli_skip_bad(tmp_path, capsys):
    from imageprocessingtools_tpu import serve

    paths = _write_inputs(tmp_path, [(8, 16)] * 3)
    with open(paths[1], "wb") as f:
        f.write(b"garbage")
    rc = serve.main(["--skip-bad", "-gray"] + paths)
    cap = capsys.readouterr()
    assert rc == 0 and cap.out == ""  # stdout stays differential-clean
    assert "2 files processed" in cap.err and "1 bad skipped" in cap.err
    assert f"skipped {paths[1]}:" in cap.err
    assert os.path.exists(paths[0] + ".out")
    assert os.path.exists(paths[2] + ".out")
    assert not os.path.exists(paths[1] + ".out")
    # Default stays fail-fast with the reference's stdout/exit surface.
    rc = serve.main(["-gray"] + paths)
    cap = capsys.readouterr()
    assert rc == 255 and cap.out.startswith("error")


def test_serve_cli_skip_bad_spatial_write_error(tmp_path, capsys, monkeypatch):
    """--spatial --skip-bad covers INPUT errors only: a corrupt input is
    probe-skipped, but an OSError while writing an OUTPUT fails the run
    (exit 255) — and the already-skipped files are still reported."""
    from imageprocessingtools_tpu import serve, serving

    paths = _write_inputs(tmp_path, [(16, 24)] * 2)
    with open(paths[0], "wb") as f:
        f.write(b"garbage")  # input probe failure -> skipped

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(serving.ppm, "write_ppm", boom)
    rc = serve.main(["--spatial", "--skip-bad", "-gray"] + paths)
    cap = capsys.readouterr()
    assert rc == 255
    assert cap.out == "error. can not open file\n"  # B3 surface
    assert f"skipped {paths[0]}:" in cap.err  # skip record survives failure
    assert not os.path.exists(paths[1] + ".out")


def test_serve_cli_resume(tmp_path, capsys):
    """--resume skips inputs whose output exists: a pre-existing .out is
    left untouched (stale content preserved — skip is by presence), the
    rest are processed, and a full rerun processes nothing."""
    from imageprocessingtools_tpu import serve

    paths = _write_inputs(tmp_path, [(8, 16)] * 3)
    stale = b"stale sentinel"
    with open(paths[1] + ".out", "wb") as f:
        f.write(stale)
    rc = serve.main(["--resume", "-gray"] + paths)
    assert rc == 0
    err = capsys.readouterr().err
    assert "2 files processed" in err and "1 skipped" in err
    assert open(paths[1] + ".out", "rb").read() == stale
    for i in (0, 2):
        payload = open(paths[i] + ".out", "rb").read().split(b"255\n", 1)[1]
        np.testing.assert_array_equal(
            np.frombuffer(payload, np.uint8).reshape(8, 16),
            golden.grayscale(make_image(8, 16, seed=i)),
        )
    # Second pass: everything exists now -> zero work, still exit 0.
    rc = serve.main(["--resume", "-gray"] + paths)
    assert rc == 0
    err = capsys.readouterr().err
    assert "0 files processed" in err and "3 skipped" in err


def test_serve_cli_help(capsys):
    """--help prints the documented surface to STDERR (stdout stays
    differential-clean) and exits 0."""
    from imageprocessingtools_tpu import serve

    assert serve.main(["--help"]) == 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "--max-batch" in captured.err and "--spatial" in captured.err


def test_serve_cli_errors(tmp_path, capsys):
    from imageprocessingtools_tpu import serve

    assert serve.main([]) == 255
    assert "no input files" in capsys.readouterr().out
    assert serve.main(["--bogus", "x.ppm"]) == 255
    capsys.readouterr()
    assert serve.main(["-gray", "-mono", "a.ppm"]) == 255
    assert "Conflicting options" in capsys.readouterr().out
    p = os.path.join(str(tmp_path), "bad.ppm")
    with open(p, "wb") as f:
        f.write(b"P6\n4 4\n255\nxx")
    assert serve.main(["-gray", p]) == 255
    assert "unexpected end of file" in capsys.readouterr().out


def test_process_files_writer_error_no_deadlock(tmp_path, monkeypatch):
    """A failure in the WRITER thread (e.g. disk full) raises instead of
    deadlocking the main thread on the bounded encode queue."""
    paths = _write_inputs(tmp_path, [(8, 16)] * 12)
    calls = {"n": 0}
    real = serving._encode_chunk

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("No space left on device")
        return real(*args, **kw)

    monkeypatch.setattr(serving, "_encode_chunk", flaky)
    with pytest.raises(OSError, match="No space left"):
        serving.process_files(
            paths, PipelineConfig(gray=True), suffix=".wd", max_batch=2
        )


def test_serve_cli_missing_file(capsys):
    from imageprocessingtools_tpu import serve

    rc = serve.main(["-gray", "/nonexistent/definitely-missing.ppm"])
    assert rc == 255
    assert capsys.readouterr().out == "error. can not open file\n"


def test_serve_cli_max_batch_zero(capsys, tmp_path):
    from imageprocessingtools_tpu import serve

    rc = serve.main(["--max-batch", "0", "-gray", "x.ppm"])
    assert rc == 255
    assert "positive integer" in capsys.readouterr().out


def test_process_file_spatial_one_row(tmp_path):
    """A 1-row image degrades to the single-device pipeline cleanly."""
    from imageprocessingtools_tpu.kernels.fused import fused_pipeline_xla

    img = make_image(1, 24, seed=9)
    p = os.path.join(str(tmp_path), "row.ppm")
    ppm.write_ppm(p, img)
    out = serving.process_file_spatial(p, "fused", suffix=".1r")
    payload = open(out, "rb").read().split(b"255\n", 1)[1]
    np.testing.assert_array_equal(
        np.frombuffer(payload, np.uint8).reshape(1, 24),
        np.asarray(fused_pipeline_xla(img)),
    )
    out2 = serving.process_file_spatial(
        p, PipelineConfig(gray=True), suffix=".1g")
    payload = open(out2, "rb").read().split(b"255\n", 1)[1]
    np.testing.assert_array_equal(
        np.frombuffer(payload, np.uint8).reshape(1, 24),
        golden.grayscale(img),
    )


def test_serve_huge_resize_b9_surface(tmp_path, capsys):
    """A B9-infeasible -w through the batch front-end surfaces the same
    deterministic fast-fail as the single-image CLI (plan_resize bound),
    and a raw MemoryError anywhere in the pipeline maps to the identical
    message instead of a traceback."""
    from imageprocessingtools_tpu import serve
    from imageprocessingtools_tpu.codec import ppm
    from tests.conftest import make_image

    p = os.path.join(str(tmp_path), "b9.ppm")
    ppm.write_ppm(p, make_image(5, 6, seed=9))
    assert serve.main(["-w100000", p]) == 255
    assert capsys.readouterr().out == "error. allocating indices\n"

    # MemoryError backstop
    import imageprocessingtools_tpu.serving as serving_mod

    def boom(*a, **kw):
        raise MemoryError

    orig = serving_mod.process_files
    serving_mod.process_files = boom
    try:
        assert serve.main(["-gray", p]) == 255
        assert capsys.readouterr().out == "error. allocating indices\n"
    finally:
        serving_mod.process_files = orig


# ---------------------------------------------------------------------------
# Preset ("models") serving: process_files / serve --preset.
# ---------------------------------------------------------------------------


def _golden_preset(name, img):
    gray = golden.grayscale(img)
    if name == "edge_detect":
        return golden.sobel(golden.gaussian_blur(gray))
    if name == "enhance":
        return golden.sharpen(golden.equalize_histogram(gray))
    if name == "thumbnail":
        return golden.resize_width(img, 256)
    if name == "print_ready":
        eq = golden.equalize_histogram(gray)
        rgb = np.broadcast_to(eq[..., None], eq.shape + (3,))
        return golden.mono_dither(rgb)
    raise AssertionError(name)


@pytest.mark.parametrize("name", ["edge_detect", "enhance", "print_ready"])
def test_process_files_preset_exact(tmp_path, name):
    """Integer-exact presets match the golden composition bit-for-bit,
    across two shape buckets, with the right output encoding."""
    shapes = [(12, 16)] * 2 + [(9, 21)]
    paths = _write_inputs(tmp_path, shapes)
    outs = serving.process_files(paths, name)
    for i, p in enumerate(outs):
        h, w = shapes[i]
        expected = _golden_preset(name, make_image(h, w, seed=i))
        img, _, ft = ppm.read_pnm(p)
        if name == "print_ready":
            assert ft == ppm.FILETYPE_PBM
        else:
            assert ft == ppm.FILETYPE_PGM
        np.testing.assert_array_equal(img, expected, err_msg=f"{name} file {i}")


def test_process_files_preset_thumbnail(tmp_path):
    """thumbnail resizes to width 256 (P6 out, +-1 resize budget)."""
    paths = _write_inputs(tmp_path, [(10, 64)])
    outs = serving.process_files(paths, "thumbnail")
    img, _, ft = ppm.read_pnm(outs[0])
    assert ft == ppm.FILETYPE_PPM
    expected = _golden_preset("thumbnail", make_image(10, 64, seed=0))
    assert img.shape == expected.shape
    assert np.max(np.abs(img.astype(int) - expected.astype(int))) <= 1


def test_process_files_preset_unknown_raises(tmp_path):
    paths = _write_inputs(tmp_path, [(8, 8)])
    with pytest.raises(ValueError, match="unknown preset"):
        serving.process_files(paths, "nope")


def test_process_batch_preset_mesh(tmp_path):
    """Preset batches shard over the mesh like reference configs."""
    import jax
    from imageprocessingtools_tpu.parallel.batch import default_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device CPU config")
    mesh = default_mesh()
    batch = np.stack([make_image(8, 16, seed=i) for i in range(5)])
    out, ft = serving.process_batch(batch, "edge_detect", mesh=mesh)
    assert ft == ppm.FILETYPE_PGM
    for i in range(5):
        np.testing.assert_array_equal(
            np.asarray(out)[i], _golden_preset("edge_detect", batch[i])
        )


def test_process_batch_fanout_matches_single():
    """A preset tuple returns one output per preset from ONE dispatch,
    each bit-identical to its single-preset run."""
    batch = np.stack([make_image(8, 16, seed=i) for i in range(3)])
    out, fts = serving.process_batch(batch, ("enhance", "print_ready"))
    assert isinstance(out, tuple) and len(out) == 2
    assert fts == (ppm.FILETYPE_PGM, ppm.FILETYPE_PBM)
    for k, name in enumerate(("enhance", "print_ready")):
        single, _ = serving.process_batch(batch, name)
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(single))


def test_process_files_fanout(tmp_path):
    """Fan-out over files: per-preset outputs byte-identical to the
    single-preset runs; chunked so the reader/writer overlap threads carry
    tuple outputs; two shape buckets."""
    shapes = [(12, 16)] * 5 + [(9, 21)] * 2
    paths = _write_inputs(tmp_path, shapes)
    # thumbnail changes the output SHAPE (resize): per-preset unpacked
    # dims and encodings must not leak across the fan-out tuple.
    names = ("edge_detect", "thumbnail", "print_ready")
    outs = serving.process_files(paths, names, max_batch=2)
    assert len(outs) == len(paths) and all(len(o) == 3 for o in outs)
    for name in names:
        serving.process_files(paths, name, suffix=".single_" + name)
    for i, p in enumerate(paths):
        for k, name in enumerate(names):
            assert outs[i][k] == p + "." + name + ".out"
            assert (
                open(outs[i][k], "rb").read()
                == open(p + ".single_" + name, "rb").read()
            ), (i, name)


def test_process_files_fanout_mesh(tmp_path):
    """Fan-out composes with mesh sharding (non-divisible batch pads and
    slices per PRESET batch axis, not the preset tuple)."""
    import jax
    from imageprocessingtools_tpu.parallel.batch import default_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device CPU config")
    paths = _write_inputs(tmp_path, [(8, 16)] * 5)  # 5 % 8 != 0 -> pad path
    names = ("enhance", "edge_detect")
    outs = serving.process_files(paths, names, mesh=default_mesh())
    for i, p in enumerate(paths):
        for k, name in enumerate(names):
            img, _, ft = ppm.read_pnm(outs[i][k])
            assert ft == ppm.FILETYPE_PGM
            np.testing.assert_array_equal(
                img, _golden_preset(name, make_image(8, 16, seed=i))
            )


def test_process_files_fanout_errors(tmp_path):
    paths = _write_inputs(tmp_path, [(8, 8)])
    with pytest.raises(ValueError, match="duplicate"):
        serving.process_files(paths, ("edge_detect", "edge_detect"))
    with pytest.raises(ValueError, match="unknown preset"):
        serving.process_files(paths, ("edge_detect", "nope"))
    with pytest.raises(ValueError, match="empty"):
        serving.process_files(paths, ())


def test_serve_cli_fanout(tmp_path, capsys):
    """--preset a,b writes <input>.<preset>.out per preset; --resume skips
    only when EVERY preset output exists; duplicate/unknown lists error."""
    from imageprocessingtools_tpu import serve

    paths = _write_inputs(tmp_path, [(8, 16)] * 2)
    rc = serve.main(["--preset", "edge_detect,print_ready"] + paths)
    assert rc == 0
    capsys.readouterr()
    for i, p in enumerate(paths):
        img, _, _ = ppm.read_pnm(p + ".edge_detect.out")
        np.testing.assert_array_equal(
            img, _golden_preset("edge_detect", make_image(8, 16, seed=i))
        )
        assert os.path.exists(p + ".print_ready.out")
    # Partial outputs do NOT skip; complete outputs do.
    os.remove(paths[0] + ".print_ready.out")
    rc = serve.main(["--resume", "--preset", "edge_detect,print_ready"] + paths)
    assert rc == 0
    err = capsys.readouterr().err
    assert "1 files processed" in err and "1 skipped" in err
    assert os.path.exists(paths[0] + ".print_ready.out")
    assert serve.main(["--preset", "edge_detect,edge_detect"] + paths) == 255
    assert "duplicate preset" in capsys.readouterr().out
    assert serve.main(["--preset", "edge_detect,"] + paths) == 255
    assert "unknown preset" in capsys.readouterr().out


def test_serve_cli_preset(tmp_path):
    from imageprocessingtools_tpu import serve

    paths = _write_inputs(tmp_path, [(8, 16)] * 3)
    rc = serve.main(["--preset", "enhance"] + paths)
    assert rc == 0
    for i, p in enumerate(paths):
        img, _, ft = ppm.read_pnm(p + ".out")
        assert ft == ppm.FILETYPE_PGM
        np.testing.assert_array_equal(
            img, _golden_preset("enhance", make_image(8, 16, seed=i))
        )


def test_serve_cli_preset_errors(tmp_path, capsys):
    from imageprocessingtools_tpu import serve

    paths = _write_inputs(tmp_path, [(8, 8)])
    cases = [
        (["--preset"], "needs a name"),  # nothing after the flag
        # "--preset <path>" consumes the path as the (unknown) preset name
        (["--preset"] + paths, "no input files"),
        (["--preset", "nope"] + paths, "unknown preset"),
        (["--preset", "enhance", "-gray"] + paths, "excludes op flags"),
    ]
    for argv, frag in cases:
        rc = serve.main(argv)
        out = capsys.readouterr().out
        assert rc == 255 and frag in out, (argv, rc, out)


def test_serve_cli_suffix(tmp_path, capsys):
    from imageprocessingtools_tpu import serve

    paths = _write_inputs(tmp_path, [(8, 16)] * 2)
    rc = serve.main(["--suffix", ".gray.pgm", "-gray"] + paths)
    assert rc == 0
    for i, p in enumerate(paths):
        img, _, ft = ppm.read_pnm(p + ".gray.pgm")
        assert ft == ppm.FILETYPE_PGM
        np.testing.assert_array_equal(
            img, golden.grayscale(make_image(8, 16, seed=i)))
        assert not os.path.exists(p + ".out")
    rc = serve.main(["--suffix", "", "-gray"] + paths)
    out = capsys.readouterr().out
    assert rc == 255 and "non-empty" in out


# ---------------------------------------------------------------------------
# Spatial (H-sharded) preset pipelines.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["edge_detect", "enhance", "print_ready",
                                  "thumbnail"])
def test_preset_pipeline_spatial_matches_unsharded(name):
    from imageprocessingtools_tpu.models import PRESETS
    from imageprocessingtools_tpu.parallel.batch import default_mesh
    from imageprocessingtools_tpu.parallel.spatial import preset_pipeline_spatial

    img = make_image(32, 48, seed=7)
    out = np.asarray(preset_pipeline_spatial(img, name, default_mesh()))
    ref = np.asarray(PRESETS[name](img))
    np.testing.assert_array_equal(out, ref, err_msg=name)


@pytest.mark.parametrize("name,h", [("edge_detect", 32), ("print_ready", 32),
                                    ("enhance", 12)])  # 12 -> submesh of 6
def test_process_file_spatial_preset(tmp_path, name, h):
    """Spatial preset serving writes the same pixels as the batch preset
    path, with the right encoding (incl. the global-Bayer-phase P4 case
    and the non-divisible-H submesh fallback)."""
    img = make_image(h, 24, seed=h)
    p = os.path.join(str(tmp_path), f"pre_{name}_{h}.ppm")
    ppm.write_ppm(p, img)
    out = serving.process_file_spatial(p, name, suffix=".pre")
    got, _, ft = ppm.read_pnm(out)
    expected = _golden_preset(name, img)
    if name == "print_ready":
        assert ft == ppm.FILETYPE_PBM
    else:
        assert ft == ppm.FILETYPE_PGM
    np.testing.assert_array_equal(got, expected)


def test_process_file_spatial_preset_degenerate_1shard(tmp_path):
    """A 1-row image forces the 1-device submesh: the jitted batch preset
    fn carries it, identical result."""
    img = make_image(1, 16, seed=2)
    p = os.path.join(str(tmp_path), "tiny.ppm")
    ppm.write_ppm(p, img)
    out = serving.process_file_spatial(p, "enhance", suffix=".pre")
    got, _, ft = ppm.read_pnm(out)
    np.testing.assert_array_equal(got, _golden_preset("enhance", img))


def test_process_file_spatial_preset_unknown(tmp_path):
    p = _write_inputs(tmp_path, [(8, 8)])[0]
    with pytest.raises(ValueError, match="unknown preset"):
        serving.process_file_spatial(p, "nope")


def test_serve_cli_spatial_preset(tmp_path):
    from imageprocessingtools_tpu import serve

    paths = _write_inputs(tmp_path, [(16, 24)])
    rc = serve.main(["--spatial", "--preset", "edge_detect"] + paths)
    assert rc == 0
    got, _, ft = ppm.read_pnm(paths[0] + ".out")
    assert ft == ppm.FILETYPE_PGM
    np.testing.assert_array_equal(
        got, _golden_preset("edge_detect", make_image(16, 24, seed=0)))


def test_config_tag():
    """Tags are the reference flags in fixed pipeline order; no-op configs
    hit the B2 surface."""
    assert serving.config_tag("edge_detect") == "edge_detect"
    assert serving.config_tag(PipelineConfig(gray=True)) == "gray"
    assert (
        serving.config_tag(
            PipelineConfig(new_width=1920, angle=30, gray=True, flip_h=True)
        )
        == "w1920-r30-gray-fh"
    )
    assert serving.config_tag(PipelineConfig(mono=True, flip_v=True)) == "mono-fv"
    with pytest.raises(ValueError, match="no data to write"):
        serving.config_tag(PipelineConfig())


def test_process_files_fanout_configs(tmp_path):
    """Fan-out over a tuple of reference PipelineConfigs: one decode +
    upload per chunk, each element's output byte-identical to its
    single-config run. Covers P5 (gray), P4 (mono, device packing) and a
    shape-changing resize in one tuple, across two shape buckets and the
    overlap threads (max_batch=2)."""
    shapes = [(12, 16)] * 5 + [(9, 21)] * 2
    paths = _write_inputs(tmp_path, shapes)
    configs = (
        PipelineConfig(gray=True),
        PipelineConfig(mono=True),
        PipelineConfig(new_width=10, flip_h=True),
    )
    tags = ("gray", "mono", "w10-fh")
    outs = serving.process_files(paths, configs, max_batch=2)
    assert len(outs) == len(paths) and all(len(o) == 3 for o in outs)
    for k, cfg in enumerate(configs):
        serving.process_files(paths, cfg, suffix=".single" + str(k))
    for i, p in enumerate(paths):
        for k in range(3):
            assert outs[i][k] == p + "." + tags[k] + ".out"
            assert (
                open(outs[i][k], "rb").read()
                == open(p + ".single" + str(k), "rb").read()
            ), (i, tags[k])


def test_process_files_fanout_mixed_presets_and_configs(tmp_path):
    """Preset names and PipelineConfigs share one fan-out dispatch."""
    paths = _write_inputs(tmp_path, [(8, 16)] * 3)
    outs = serving.process_files(
        paths, ("edge_detect", PipelineConfig(gray=True)))
    serving.process_files(paths, "edge_detect", suffix=".sp")
    serving.process_files(paths, PipelineConfig(gray=True), suffix=".sc")
    for i, p in enumerate(paths):
        assert outs[i][0] == p + ".edge_detect.out"
        assert outs[i][1] == p + ".gray.out"
        assert open(outs[i][0], "rb").read() == open(p + ".sp", "rb").read()
        assert open(outs[i][1], "rb").read() == open(p + ".sc", "rb").read()


def test_process_files_fanout_config_errors(tmp_path):
    paths = _write_inputs(tmp_path, [(8, 8)])
    with pytest.raises(ValueError, match="duplicate"):
        serving.process_files(
            paths, (PipelineConfig(gray=True), PipelineConfig(gray=True)))
    with pytest.raises(ValueError, match="no data to write"):
        serving.process_files(paths, (PipelineConfig(),))


def test_serve_cli_fanout_configs(tmp_path, capsys):
    """--fanout groups write <input>.<tag>.out, byte-identical to the
    single-image CLI; --resume skips only complete tag sets; bad groups
    and bare-op-flag mixing hit the 255 surface."""
    from imageprocessingtools_tpu import cli, serve

    paths = _write_inputs(tmp_path, [(9, 13)] * 2)
    rc = serve.main(["--fanout", "-gray;-mono;-w7 -fv"] + paths)
    assert rc == 0
    capsys.readouterr()
    for i, p in enumerate(paths):
        for flags, tag in ((["-gray"], "gray"), (["-mono"], "mono"),
                           (["-w7", "-fv"], "w7-fv")):
            assert cli.main(flags + [p]) == 0
            assert (
                open(p + "." + tag + ".out", "rb").read()
                == open(p + ".out", "rb").read()
            ), (i, tag)
    # resume: a complete tag set skips, a partial one reruns
    os.remove(paths[0] + ".mono.out")
    rc = serve.main(["--resume", "--fanout", "-gray;-mono;-w7 -fv"] + paths)
    assert rc == 0
    err = capsys.readouterr().err
    assert "1 files processed" in err and "1 skipped" in err
    assert os.path.exists(paths[0] + ".mono.out")
    # error surfaces
    assert serve.main(["--fanout", "-gray;-gray"] + paths) == 255
    assert "duplicate" in capsys.readouterr().out
    assert serve.main(["--fanout", "-zap"] + paths) == 255
    capsys.readouterr()
    assert serve.main(["--fanout", "-gray", "-mono"] + paths) == 255
    assert "excludes bare op flags" in capsys.readouterr().out
    assert serve.main(["--fanout", " ; "] + paths) == 255
    capsys.readouterr()
    assert serve.main(["--fanout"] + [paths[0]]) == 255
    capsys.readouterr()


def test_serve_cli_fanout_with_preset(tmp_path, capsys):
    """--preset names join the --fanout dispatch."""
    from imageprocessingtools_tpu import serve

    paths = _write_inputs(tmp_path, [(8, 16)] * 2)
    rc = serve.main(
        ["--preset", "edge_detect", "--fanout", "-gray"] + paths)
    assert rc == 0
    capsys.readouterr()
    for i, p in enumerate(paths):
        img, _, _ = ppm.read_pnm(p + ".edge_detect.out")
        np.testing.assert_array_equal(
            img, _golden_preset("edge_detect", make_image(8, 16, seed=i)))
        img, _, _ = ppm.read_pnm(p + ".gray.out")
        np.testing.assert_array_equal(
            img, golden.grayscale(make_image(8, 16, seed=i)))
