"""chip_smoke.py off the card: its refusal without a GPU, its golden
comparisons, and every phase rehearsed at a tiny size on the CPU."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs
from imageprocessingtools_tpu import models
from imageprocessingtools_tpu.pipeline import PipelineConfig, run_pipeline
from imageprocessingtools_tpu.utils.compile_cache import DEFAULT_CACHE_DIR
from tests.conftest import make_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_result(stdout: str) -> bool:
    return '"ok"' not in stdout


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "JAX found no GPU" in r.stderr
    assert _no_result(r.stdout)


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert _no_result(r.stdout)


def test_check_and_diff_stats():
    a = np.array([[0, 5], [9, 200]], np.uint8)
    b = np.array([[0, 6], [9, 198]], np.uint8)
    assert cs.diff_stats(a, b) == (2, 2)
    cs.check("within", a, b, 2)
    with pytest.raises(cs.SmokeError, match="max diff 2 > budget 1"):
        cs.check("past", a, b, 1)
    with pytest.raises(cs.SmokeError, match="shape"):
        cs.diff_stats(a, b[:1])


@pytest.mark.parametrize("config,budget", [
    (PipelineConfig(gray=True), 0),
    (PipelineConfig(angle=270.0), 0),
    (PipelineConfig(new_width=10), 2),
    (PipelineConfig(angle=30.0), 1),
    (PipelineConfig(new_width=10, angle=135.0, mono=True), 3),
])
def test_config_budget(config, budget):
    assert cs.config_budget(config) == budget


@pytest.mark.parametrize("flags", cs.CLI_FLAG_SETS)
def test_golden_pipeline_matches_device(flags):
    """The golden composition phase b compares against agrees with the
    device pipeline within its budget (at a tiny size: -w1920 -> -w40)."""
    from imageprocessingtools_tpu.cli import _parse_args

    img = make_image(24, 32, seed=len(flags))
    config, _ = _parse_args(flags.replace("-w1920", "-w40").split() + ["x.ppm"])
    out, _ = run_pipeline(img, config, strict_rotation=True)
    cs.check(flags, np.asarray(out), cs.golden_pipeline(img, config),
             cs.config_budget(config))


@pytest.mark.parametrize("name", cs.SERVE_FANOUT)
def test_golden_preset_matches_device(name):
    img = make_image(20, 28, seed=3)
    out = np.asarray(models.get_preset(name)(img))
    cs.check(name, out, cs.golden_preset(img, name), cs.PRESET_TOL[name])


def test_fused_bytes_4k():
    n = cs.fused_bytes(2160, 3840)
    assert n == 7 * 2160 * 3840
    assert 17e-6 < n / cs.H100_BYTES_PER_S < 18e-6


def test_phase_cli_tiny(tmp_path):
    env = cs.child_env("cpu", DEFAULT_CACHE_DIR)
    cs.phase_cli(str(tmp_path), make_image(24, 32, seed=1),
                 ("-gray", "-r30", "-w20 -r30 -gray -fh"), env)


def test_phase_serve_tiny(tmp_path):
    paths = cs.write_inputs(str(tmp_path), np.random.default_rng(0), 6, (16, 24))
    cs.phase_serve(paths, 3, jax.devices()[0],
                   config=PipelineConfig(new_width=12, gray=True))


def test_phase_fused_tiny(capsys):
    cs.phase_fused(make_image(24, 40, seed=2), 3)
    assert "byte bound 6720 B" in capsys.readouterr().out


def test_phase_four_tiny(tmp_path, capsys):
    """The --four phase on the 8 virtual CPU devices: serve --mesh and the
    spatial paths agree with their one-device runs."""
    cs.phase_four(str(tmp_path), np.random.default_rng(1), 8, (16, 24), (64, 64),
                  ("fused", "edge_detect", PipelineConfig(new_width=32, angle=30.0)),
                  config=PipelineConfig(new_width=12, gray=True))
    out = capsys.readouterr().out
    assert "spatial w32-r30 on 8 device(s)" in out
    assert "spatial fused on 1 device(s)" in out
