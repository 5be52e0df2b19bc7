"""Smoke test of the main path on NVIDIA GPUs.

    python chip_smoke.py [--seed N]          # one card
    python chip_smoke.py --four [--seed N]   # the multi-card paths on four

With no option it drives, at 4K (3840x2160 P6, the reference tool's own
use), the CLI and `serving.process_files` through the entry points a user
calls, and the fused flagship pipeline; it compares every output with the
golden model (`golden/model.py`) and runs the gpu-marked tests. Phases:

  a. device: JAX must find a GPU; prints the card's name and power limit
  b. CLI: ten flag sets, one child process each, vs the golden pipeline
  e. `pytest -m gpu` in a child (before this process takes the card)
  c. serve: 64 seeded files in one chunk, a reference config and a fan-out
  d. fused pipeline: vs the golden chain; time beside its byte bound

``--four`` runs only the paths that exist across cards: ``serve --mesh`` on
the phase-c files, and `process_file_spatial` on one 16384x16384 image,
each compared with the single-card result of the same process.

Every input is generated from ``--seed``; scratch files live in the
checkout's ``.cache/`` and are removed at exit. Times printed here are
smoke readings, not benchmark results. Exits non-zero, printing no result,
when JAX finds no GPU or any phase fails; otherwise the last line of stdout
is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from imageprocessingtools_tpu import serve, serving
from imageprocessingtools_tpu.cli import _parse_args
from imageprocessingtools_tpu.codec import ppm
from imageprocessingtools_tpu.golden import model as golden
from imageprocessingtools_tpu.ops.common import float_stage_budget
from imageprocessingtools_tpu.pipeline import PipelineConfig
from imageprocessingtools_tpu.utils.compile_cache import (
    DEFAULT_CACHE_DIR,
    enable_persistent_cache,
)

REPO = os.path.dirname(os.path.abspath(__file__))
UHD = (2160, 3840)
CLI_FLAG_SETS = (
    "-gray", "-mono", "-fh", "-fv", "-r90", "-r270", "-w1920", "-r30",
    "-r135", "-w1920 -r30 -gray -fh",
)
SERVE_FILES = 64
SERVE_SAMPLE = 8
SERVE_CONFIG = PipelineConfig(new_width=1920, gray=True)
SERVE_FANOUT = ("edge_detect", "enhance", "print_ready")
# |device - golden| allowed per preset: edge_detect is integer-exact; the
# equalize LUT's f32 arithmetic carries +-1, which sharpen's kernel
# (|5| + 4 * |-1|) amplifies to 9 and which can flip a dither bit.
PRESET_TOL = {"edge_detect": 0, "enhance": 9, "print_ready": 1}
SPATIAL_HW = (16384, 16384)
SPATIAL_CONFIGS = ("fused", "edge_detect", PipelineConfig(new_width=8192, angle=30.0))
H100_BYTES_PER_S = 3.35e12  # published H100 SXM memory bandwidth


class SmokeError(Exception):
    """A phase's output or exit status is wrong."""


# ---------------------------------------------------------------------------
# Comparison with the golden model
# ---------------------------------------------------------------------------


def diff_stats(actual: np.ndarray, expected: np.ndarray) -> tuple[int, int]:
    """(max |actual - expected|, number of differing values)."""
    if actual.shape != expected.shape:
        raise SmokeError(f"shape {actual.shape} != expected {expected.shape}")
    d = np.abs(actual.astype(np.int16) - expected.astype(np.int16))
    return (int(d.max()) if d.size else 0), int(np.count_nonzero(d))


def check(label: str, actual: np.ndarray, expected: np.ndarray, tol: int) -> None:
    """Print the difference of one output and fail past ``tol``."""
    max_diff, n_diff = diff_stats(actual, expected)
    print(f"  {label}: max_diff={max_diff} differing={n_diff} budget={tol}",
          flush=True)
    if max_diff > tol:
        raise SmokeError(f"{label}: max diff {max_diff} > budget {tol}")


def golden_pipeline(img: np.ndarray, config: PipelineConfig) -> np.ndarray:
    """The golden model composed in the pipeline's fixed order."""
    out = img
    if config.new_width is not None:
        out = golden.resize_width(out, int(config.new_width))
    if config.angle is not None:
        out = golden.rotate(out, float(config.angle))
    if config.gray:
        out = golden.grayscale(out)
    if config.mono:
        out = golden.mono_dither(out)
    if config.flip_v:
        out = golden.flip_vertical(out)
    if config.flip_h:
        out = golden.flip_horizontal(out)
    return out


def config_budget(config: PipelineConfig) -> int:
    """0 for the exact ops; the float-stage budget for resize/rotation."""
    float_rotation = config.angle is not None and float(config.angle) % 90 != 0
    return float_stage_budget(config.new_width is not None, float_rotation)


def golden_preset(img: np.ndarray, name: str) -> np.ndarray:
    g = golden.grayscale(img)
    if name == "edge_detect":
        return golden.sobel(golden.gaussian_blur(g))
    eq = golden.equalize_histogram(g)
    if name == "enhance":
        return golden.sharpen(eq)
    if name == "print_ready":
        return golden.mono_dither(np.repeat(eq[:, :, None], 3, axis=2))
    raise ValueError(f"no golden chain for preset {name!r}")


def read_out(path: str) -> np.ndarray:
    return ppm.read_pnm(path)[0]


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def child_env(platform: str, cache_dir: str) -> dict:
    return dict(os.environ, JAX_PLATFORMS=platform,
                JAX_COMPILATION_CACHE_DIR=cache_dir)


def probe_devices(env: dict) -> dict:
    """Platform, kind and count of JAX's devices, read by a child process."""
    code = (
        "import json, sys, jax\n"
        "try:\n"
        "    d = jax.devices()\n"
        "except Exception as e:\n"
        "    sys.exit(f'jax.devices() raised {type(e).__name__}: {e}')\n"
        "print(json.dumps({'platform': d[0].platform, 'kind': d[0].device_kind,"
        " 'count': len(d), 'jax': jax.__version__}))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        last = (r.stderr.strip().splitlines() or ["(no output)"])[-1]
        raise SmokeError(
            f"JAX found no GPU (JAX_PLATFORMS={env['JAX_PLATFORMS']}): {last}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def phase_cli(workdir: str, img: np.ndarray, flag_sets, env: dict) -> None:
    """Each flag set through ``python -m imageprocessingtools_tpu.cli``."""
    path = os.path.join(workdir, "cli_input.ppm")
    ppm.write_ppm(path, img)
    for flags in flag_sets:
        argv = flags.split()
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "imageprocessingtools_tpu.cli", *argv, path],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise SmokeError(f"cli {flags}: exit {r.returncode}: "
                             f"{r.stdout}{r.stderr[-3000:]}")
        config, _ = _parse_args(argv + [path])
        check(f"cli {flags} ({wall:.1f} s wall, one process)",
              read_out(path + ".out"), golden_pipeline(img, config),
              config_budget(config))


def phase_gpu_tests(env: dict) -> None:
    """The gpu-marked tests, in a child so only one process holds the card."""
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "tests/"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1200)
    lines = r.stdout.strip().splitlines()
    summary = lines[-1] if lines else "(no output)"
    print(f"  pytest -m gpu: {summary}", flush=True)
    if r.returncode != 0 or "passed" not in summary or any(
            w in summary for w in ("failed", "skipped", "error")):
        raise SmokeError("gpu-marked tests did not all pass:\n"
                         + "\n".join(lines[-40:]) + r.stderr[-3000:])


def write_inputs(workdir: str, rng, n: int, hw: tuple[int, int],
                 stem: str = "serve") -> list[str]:
    paths = []
    for i in range(n):
        p = os.path.join(workdir, f"{stem}_{i:03d}.ppm")
        ppm.write_ppm(p, rng.integers(0, 256, hw + (3,), dtype=np.uint8))
        paths.append(p)
    return paths


def _peak(device) -> str:
    stats = device.memory_stats()
    return str(stats["peak_bytes_in_use"]) if stats else "not available"


def phase_serve(paths: list[str], sample: int, device,
                config: PipelineConfig = SERVE_CONFIG,
                fanout: tuple = SERVE_FANOUT) -> None:
    """Both serve runs in one chunk each, then golden checks on a sample."""
    picks = np.linspace(0, len(paths) - 1, sample).astype(int)
    for label, task in ((serving.config_tag(config), config), ("fanout", fanout)):
        t0 = time.perf_counter()
        outs = serving.process_files(paths, task)
        wall = time.perf_counter() - t0
        print(f"  serve {label}: {len(paths)} files, wall {wall:.3f} s incl. "
              f"compile, peak_bytes_in_use {_peak(device)} "
              "(smoke reading, not a benchmark result)", flush=True)
        for i in picks:
            img, _ = ppm.read_ppm(paths[i])
            if isinstance(task, tuple):
                for name, out_path in zip(task, outs[i]):
                    check(f"serve {name} file {i}", read_out(out_path),
                          golden_preset(img, name), PRESET_TOL[name])
            else:
                check(f"serve {label} file {i}", read_out(outs[i]),
                      golden_pipeline(img, task), config_budget(task))


def fused_bytes(height: int, width: int) -> int:
    """Bytes the fused pipeline must move per frame, from its shapes: read
    the RGB frame, write the blurred gray frame, read it for the histogram
    and again for the LUT, write the output."""
    return 3 * height * width + 4 * height * width


def time_calls(fn, x, iters: int) -> tuple[float, float]:
    """Host-clock seconds per call of ``fn(x)`` after warm-up: (``iters``
    calls queued with one block_until_ready on the last, block on each)."""
    for _ in range(3):
        fn(x).block_until_ready()
    t0 = time.perf_counter()
    outs = [fn(x) for _ in range(iters)]
    outs[-1].block_until_ready()
    queued = (time.perf_counter() - t0) / iters
    del outs
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x).block_until_ready()
    return queued, (time.perf_counter() - t0) / iters


def phase_fused(img: np.ndarray, iters: int) -> None:
    import jax

    from imageprocessingtools_tpu.kernels.fused import fused_gray_gauss_histeq

    x = jax.device_put(img)
    expected = golden.equalize_histogram(golden.gaussian_blur(golden.grayscale(img)))
    check("fused vs golden", np.asarray(fused_gray_gauss_histeq(x)), expected, 1)
    queued, blocking = time_calls(fused_gray_gauss_histeq, x, iters)
    nbytes = fused_bytes(img.shape[0], img.shape[1])
    print(f"  fused {img.shape[1]}x{img.shape[0]}: {queued * 1e6:.1f} us/frame "
          f"({iters} calls queued, one block_until_ready), {blocking * 1e6:.1f} "
          f"us/frame (block each call), host clock, smoke reading; byte bound "
          f"{nbytes} B = {nbytes / H100_BYTES_PER_S * 1e6:.1f} us at "
          f"{H100_BYTES_PER_S / 1e12:.2f} TB/s", flush=True)


def phase_four(workdir: str, rng, n_files: int, serve_hw, spatial_hw,
               spatial_configs, config: PipelineConfig = SERVE_CONFIG) -> None:
    """serve --mesh and spatial mode on all devices vs one device.

    The all-device runs go first, so the per-device peak memory printed
    after them covers those runs only."""
    import jax

    from imageprocessingtools_tpu.parallel.batch import default_mesh

    devices = jax.devices()
    paths = write_inputs(workdir, rng, n_files, serve_hw)
    giant = write_inputs(workdir, rng, 1, spatial_hw, stem="giant")[0]
    runs = (
        ["-" + t for t in serving.config_tag(config).split("-")],
        ["--preset", ",".join(SERVE_FANOUT)],
    )
    for tag, mesh_flag in (("mesh", ["--mesh"]), ("one", [])):
        if tag == "one":
            print("  per-device peak_bytes_in_use after the all-device runs: "
                  + ", ".join(_peak(d) for d in devices), flush=True)
        for flags in runs:
            t0 = time.perf_counter()
            rc = serve.main(mesh_flag + flags + ["--suffix", f".{tag}", *paths])
            if rc != 0:
                raise SmokeError(f"serve {' '.join(mesh_flag + flags)}: exit {rc}")
            print(f"  serve {' '.join(mesh_flag + flags)}: wall "
                  f"{time.perf_counter() - t0:.3f} s incl. compile", flush=True)
        n = len(devices) if tag == "mesh" else 1
        mesh = default_mesh(devices=devices[:n])
        for spatial in spatial_configs:
            t0 = time.perf_counter()
            serving.process_file_spatial(
                giant, spatial, mesh=mesh,
                suffix=f".{serving.config_tag(spatial)}.{tag}")
            print(f"  spatial {serving.config_tag(spatial)} on {n} device(s): "
                  f"wall {time.perf_counter() - t0:.3f} s incl. compile", flush=True)
    for p in paths:
        check(f"serve --mesh {serving.config_tag(config)} {os.path.basename(p)}",
              read_out(p + ".mesh"), read_out(p + ".one"), config_budget(config))
        for name in SERVE_FANOUT:
            check(f"serve --mesh {name} {os.path.basename(p)}",
                  read_out(f"{p}.{name}.mesh"), read_out(f"{p}.{name}.one"), 0)
    for spatial in spatial_configs:
        tag = serving.config_tag(spatial)
        tol = 0 if isinstance(spatial, str) else config_budget(spatial)
        check(f"spatial {tag}", read_out(f"{giant}.{tag}.mesh"),
              read_out(f"{giant}.{tag}.one"), tol)


# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card paths")
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cuda")  # never fall back to the CPU
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    env = child_env("cuda", cache_dir)

    print("== a. device", flush=True)
    info = probe_devices(env)
    need = 4 if args.four else 1
    if info["platform"] != "gpu" or info["count"] < need:
        raise SmokeError(f"need {need} GPU(s), JAX found {info}")
    print(card_line())
    print(f"  platform={info['platform']} device_kind={info['kind']} "
          f"count={info['count']} jax={info['jax']} compile_cache={cache_dir}",
          flush=True)

    rng = np.random.default_rng(args.seed)
    os.makedirs(os.path.join(REPO, ".cache"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, ".cache")) as workdir:
        if args.four:
            enable_persistent_cache()
            print("== four cards: serve --mesh and spatial mode", flush=True)
            phase_four(workdir, rng, SERVE_FILES, UHD, SPATIAL_HW, SPATIAL_CONFIGS)
        else:
            print("== b. CLI", flush=True)
            phase_cli(workdir, rng.integers(0, 256, UHD + (3,), dtype=np.uint8),
                      CLI_FLAG_SETS, env)
            print("== e. gpu-marked tests", flush=True)
            phase_gpu_tests(env)
            enable_persistent_cache()
            print("== c. serve", flush=True)
            phase_serve(write_inputs(workdir, rng, SERVE_FILES, UHD),
                        SERVE_SAMPLE, jax.devices()[0])
            print("== d. fused pipeline", flush=True)
            phase_fused(rng.integers(0, 256, UHD + (3,), dtype=np.uint8), 200)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SmokeError(f"ran on {dev.platform}, not a GPU")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
