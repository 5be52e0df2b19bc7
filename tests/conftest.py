"""Test config: JAX on a virtual 8-device CPU mesh, or on the GPU.

Sharding/jit/shard_map paths are exercised without hardware via
``--xla_force_host_platform_device_count=8``; the env must be set before jax
initializes a backend. With ``JAX_PLATFORMS`` naming ``cuda`` the suite runs
on the GPU instead; run only the ``gpu``-marked tests there:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os
import subprocess

_ON_GPU = "cuda" in os.environ.get("JAX_PLATFORMS", "")
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

REFERENCE_C = "/root/reference/ppmx-edward.c"
ORACLE_BIN = os.path.join(os.path.dirname(__file__), "..", ".cache", "ppmx_ref")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless JAX's first device is a GPU.

    Decided here, per test, never at import: every xdist worker must
    collect the same tests.
    """
    if (
        request.node.get_closest_marker("gpu") is not None
        and jax.devices()[0].platform != "gpu"
    ):
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")


@pytest.fixture(scope="session")
def ref_binary():
    """Compile the reference C tool as the differential oracle (survey §4).

    The source stays in /root/reference; only the build artifact lands in
    .cache/ (gitignored). Skips differential tests if no C toolchain.
    """
    path = os.path.abspath(ORACLE_BIN)
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        proc = subprocess.run(
            ["gcc", "-O2", "-o", path, REFERENCE_C, "-lm"],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            pytest.skip(f"cannot build reference oracle: {proc.stderr[:500]}")
    return path


class RefRunner:
    """Run the oracle on an encoded P6 and collect (exit, stdout, out bytes)."""

    def __init__(self, binary, tmpdir):
        self.binary = binary
        self.tmpdir = tmpdir
        self._n = 0

    def run(self, ppm_bytes: bytes, args: list[str]):
        self._n += 1
        in_path = os.path.join(str(self.tmpdir), f"in_{self._n}.ppm")
        with open(in_path, "wb") as f:
            f.write(ppm_bytes)
        proc = subprocess.run(
            [self.binary] + args + [in_path],
            capture_output=True,
            cwd=str(self.tmpdir),
        )
        out_path = in_path + ".out"
        out_bytes = None
        if os.path.exists(out_path):
            with open(out_path, "rb") as f:
                out_bytes = f.read()
            os.remove(out_path)
        os.remove(in_path)
        return proc.returncode, proc.stdout.decode(errors="replace"), out_bytes


@pytest.fixture
def ref_runner(ref_binary, tmp_path):
    return RefRunner(ref_binary, tmp_path)


def make_image(height: int, width: int, seed: int = 0) -> np.ndarray:
    """Deterministic random RGB test image."""
    rng = np.random.default_rng(seed + height * 7919 + width * 104729)
    return rng.integers(0, 256, size=(height, width, 3), dtype=np.uint8)


def make_gradient(height: int, width: int) -> np.ndarray:
    """Smooth gradient image (exercises resampling differently than noise)."""
    y = np.arange(height, dtype=np.int64)[:, None]
    x = np.arange(width, dtype=np.int64)[None, :]
    r = (x * 255 // max(width - 1, 1)).astype(np.uint8)
    g = (y * 255 // max(height - 1, 1)).astype(np.uint8)
    b = ((x + y) * 255 // max(height + width - 2, 1)).astype(np.uint8)
    return np.stack([np.broadcast_to(r, (height, width)),
                     np.broadcast_to(g, (height, width)),
                     np.broadcast_to(b, (height, width))], axis=2)


# Shape grid used across suites: odd widths, width % 8 != 0 (P4 padding),
# 1x1, tall, wide.
SHAPES = [(1, 1), (3, 5), (12, 16), (13, 17), (48, 64), (29, 7), (8, 40)]
SHAPES_ROT = [(16, 16), (13, 17), (48, 64), (29, 7)]  # >= 3 in each dim
