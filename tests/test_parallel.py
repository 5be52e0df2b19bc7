"""Multi-device paths on the virtual 8-device CPU mesh (survey §4)."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import imageprocessingtools_tpu as ipt
from imageprocessingtools_tpu.golden import model as golden
from imageprocessingtools_tpu.kernels.fused import fused_pipeline_xla
from imageprocessingtools_tpu.parallel import (
    batch_apply,
    batched_fused_pipeline,
    default_mesh,
    fused_pipeline_spatial,
)
from tests.conftest import make_gradient, make_image


def _golden_fused(img):
    g = golden.grayscale(img)
    b = golden.gaussian_blur(g)
    return golden.equalize_histogram(b)


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_fused_pipeline_single_device_matches_golden():
    img = make_gradient(32, 48)
    out = np.asarray(fused_pipeline_xla(img))
    exp = _golden_fused(img)
    assert np.abs(out.astype(int) - exp.astype(int)).max() <= 1  # equalize LUT budget


# Widths off 128 and ragged row counts, incl. H < 8.
FUSED_SHAPES = [
    (64, 128), (130, 384), (7, 128), (40, 256), (50, 256), (43, 128),
    (48, 120), (64, 200), (96, 683), (40, 500), (56, 300),
]


@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_pipeline_stages_match_golden(shape):
    """The flagship's stages vs the golden chain: blur and histogram exact,
    the equalized output within the LUT's +-1."""
    from imageprocessingtools_tpu.ops.color import grayscale
    from imageprocessingtools_tpu.ops.histogram import histogram
    from imageprocessingtools_tpu.ops.stencil import gaussian_blur

    img = np.random.default_rng(shape[1]).integers(0, 256, shape + (3,), np.uint8)
    blurred = np.asarray(gaussian_blur(grayscale(img)))
    expected_blur = golden.gaussian_blur(golden.grayscale(img))
    np.testing.assert_array_equal(blurred, expected_blur)
    np.testing.assert_array_equal(np.asarray(histogram(blurred)),
                                  golden.histogram(expected_blur))
    out = np.asarray(fused_pipeline_xla(img))
    assert np.abs(out.astype(int) - _golden_fused(img).astype(int)).max() <= 1


@pytest.mark.parametrize("shape,n", [((16, 144), 8), ((24, 200), 16), ((7, 128), 8)])
def test_batched_fused_pipeline_on_mesh(shape, n):
    """The batch DP flagship over the 8-device mesh == per-image pipeline."""
    imgs = np.stack([make_image(*shape, seed=s) for s in range(n)])
    out = np.asarray(batched_fused_pipeline(imgs, mesh=default_mesh()))
    assert out.shape == (n,) + shape
    for i in range(n):
        np.testing.assert_array_equal(out[i], np.asarray(fused_pipeline_xla(imgs[i])))


def test_batch_apply_sharded_matches_single():
    imgs = np.stack([make_image(16, 24, seed=s) for s in range(8)])
    mesh = default_mesh()
    out = np.asarray(batched_fused_pipeline(imgs, mesh=mesh))
    for i in range(8):
        single = np.asarray(fused_pipeline_xla(imgs[i]))
        np.testing.assert_array_equal(out[i], single)


def test_batch_apply_any_op():
    imgs = np.stack([make_image(8, 8, seed=s) for s in range(16)])
    out = np.asarray(batch_apply(ipt.grayscale, imgs))
    for i in range(16):
        np.testing.assert_array_equal(out[i], golden.grayscale(imgs[i]))


def test_batch_indivisible_raises():
    imgs = np.stack([make_image(8, 8, seed=s) for s in range(3)])
    with pytest.raises(ValueError, match="not divisible"):
        batch_apply(ipt.grayscale, imgs)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_spatial_sharded_fused_exact_vs_single(n_shards):
    """H-sharded halo-exchange pipeline == single-device pipeline, bit-exact."""
    img = make_gradient(64, 48)
    devices = np.asarray(jax.devices()[:n_shards])
    mesh = Mesh(devices, ("sp",))
    out = np.asarray(fused_pipeline_spatial(img, mesh))
    single = np.asarray(fused_pipeline_xla(img))
    np.testing.assert_array_equal(out, single)


def test_spatial_noise_image_exact():
    img = make_image(32, 40, seed=11)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("sp",))
    out = np.asarray(fused_pipeline_spatial(img, mesh))
    np.testing.assert_array_equal(out, np.asarray(fused_pipeline_xla(img)))


def test_spatial_bad_shard_count():
    img = make_image(30, 16)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("sp",))
    with pytest.raises(ValueError, match="divisible"):
        fused_pipeline_spatial(img, mesh)


# ---------------------------------------------------------------------------
# Halo-exchange spatial resize (contributions-derived halo; survey §5).
# ---------------------------------------------------------------------------

from imageprocessingtools_tpu.parallel.spatial import (  # noqa: E402
    _spatial_resize_plan,
    resize_width_spatial,
)


def _sharded(img, mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(img, NamedSharding(mesh, P("sp")))


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize(
    "shape",
    [
        (64, 96, 48),    # downscale: antialias-widened taps
        (64, 96, 192),   # upscale
        (128, 50, 200),  # W-pass first order
        (64, 96, 96),    # identity scale
    ],
)
def test_spatial_resize_bit_identical(n_shards, shape):
    """Halo-exchange H-sharded resize == single-device op, BIT-identical."""
    h, w, nw = shape
    img = make_image(h, w, seed=n_shards)
    mesh = Mesh(np.asarray(jax.devices()[:n_shards]), ("sp",))
    # The halo plan must actually apply (this test is about the halo path).
    assert _spatial_resize_plan(h, w, nw, n_shards) is not None
    out = np.asarray(resize_width_spatial(_sharded(img, mesh), nw, mesh))
    ref = np.asarray(ipt.resize_width(img, nw))
    np.testing.assert_array_equal(out, ref)


def test_spatial_resize_halo_rows_exact():
    """The planned halo depth equals the contributions-index overhang."""
    plan = _spatial_resize_plan(64, 96, 48, 4)
    assert plan is not None
    _, passes = plan
    kinds = [p[0] for p in passes]
    assert "h" in kinds and "w" in kinds
    for kind, _, top, bot in passes:
        if kind == "h":
            # 2:1 downscale: kernel width 8 -> taps reach ~4 rows past the
            # shard boundary at most; halos must be small, nonzero, and
            # bounded by the analytic support ceil(4/scale)+2.
            assert 0 < top <= 6 and 0 < bot <= 6
        else:
            assert top == 0 and bot == 0


def test_spatial_resize_gspmd_fallback_exact():
    """Non-divisible truncated output height falls back to GSPMD, same bytes."""
    img = make_image(48, 64, seed=3)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("sp",))
    assert _spatial_resize_plan(48, 64, 21, 4) is None  # outH 15 not divisible
    out = np.asarray(resize_width_spatial(_sharded(img, mesh), 21, mesh))
    np.testing.assert_array_equal(out, np.asarray(ipt.resize_width(img, 21)))


def test_spatial_resize_2d_gray_input():
    img = make_image(32, 48, seed=5)[:, :, 0]
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("sp",))
    out = np.asarray(resize_width_spatial(_sharded(img, mesh), 24, mesh))
    np.testing.assert_array_equal(out, np.asarray(ipt.resize_width(img, 24)))


# ---------------------------------------------------------------------------
# Spatial rotation: all-gathered input, output row-groups sharded.
# ---------------------------------------------------------------------------

from imageprocessingtools_tpu.parallel.spatial import rotate_spatial  # noqa: E402


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("angle", [30.0, 135.0, 100.0])
def test_spatial_rotate_bit_identical(n_shards, angle):
    """Row-group-sharded blocked rotation == single-device op, bit-identical
    (same per-tile math on the all-gathered input, by construction)."""
    img = make_image(128, 160, seed=int(angle))
    mesh = Mesh(np.asarray(jax.devices()[:n_shards]), ("sp",))
    out = np.asarray(rotate_spatial(_sharded(img, mesh), angle, mesh))
    np.testing.assert_array_equal(out, np.asarray(ipt.rotate(img, angle)))


@pytest.mark.parametrize("angle", [3.0, 5.0, 12.0, 175.0, 185.0, 355.0])
def test_spatial_rotate_band_exchange_small_angles(angle):
    """Small folded angles take the round-5 BAND EXCHANGE (m-shard
    ppermute windows instead of the full all-gather) and stay bit-identical
    to the single-device op. Covers reversed group->row maps (175/185)
    and clamped windows at the mesh edges."""
    from imageprocessingtools_tpu.parallel.spatial import rotate_band_info

    img = make_image(256, 256, seed=int(angle))
    n = min(8, len(jax.devices()))
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))
    info = rotate_band_info(256, 256, angle, n)
    assert info is not None and info["m"] <= n - 2, info
    out = np.asarray(rotate_spatial(_sharded(img, mesh), angle, mesh))
    np.testing.assert_array_equal(out, np.asarray(ipt.rotate(img, angle)))


def test_spatial_rotate_band_gate_mid_angles():
    """Mid folded angles keep the all-gather: their source band spans
    nearly the whole height, so the band would move MORE bytes."""
    from imageprocessingtools_tpu.parallel.spatial import rotate_band_info

    for angle in (30.0, 45.0, 135.0, 225.0):
        assert rotate_band_info(256, 256, angle, 8) is None, angle


def test_spatial_rotate_band_bytes_ratio():
    """The band moves m/(n-1) of the all-gather's per-device ICI bytes."""
    from imageprocessingtools_tpu.parallel.spatial import rotate_band_info

    info = rotate_band_info(512, 512, 3.0, 8)
    assert info is not None
    assert info["bytes_ratio_vs_all_gather"] == round(info["m"] / 7, 3)
    assert info["bytes_ratio_vs_all_gather"] < 1.0


def test_spatial_rotate_permutation_and_small_fallback():
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("sp",))
    img = make_image(120, 160, seed=9)
    out = np.asarray(rotate_spatial(_sharded(img, mesh), 90.0, mesh))
    np.testing.assert_array_equal(out, np.asarray(ipt.rotate(img, 90.0)))
    # too small for a source block: GSPMD fallback, still exact
    tiny = make_image(16, 24, seed=10)
    out2 = np.asarray(rotate_spatial(tiny, 30.0, mesh))
    np.testing.assert_array_equal(out2, np.asarray(ipt.rotate(tiny, 30.0)))
