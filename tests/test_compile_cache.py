"""Persistent compilation cache wiring (utils/compile_cache.py).

The cache is an optimization with a correctness obligation: a cache-hit
run must produce byte-identical output to a cold run, the disable value
must leave JAX config untouched, and enabling must never raise even when
the dir is hostile. Its directory is ``JAX_COMPILATION_CACHE_DIR`` when set
(and then no other is set in code), else the fixed ``<checkout>/.cache/jax``.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np

from imageprocessingtools_tpu.codec.ppm import write_ppm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli_env(cache: str) -> dict:
    env = dict(os.environ)
    env["IPT_PLATFORM"] = "cpu"
    env["JAX_COMPILATION_CACHE_DIR"] = cache
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_cli(args, env):
    return subprocess.run(
        [sys.executable, "-m", "imageprocessingtools_tpu.cli", *args],
        capture_output=True,
        env=env,
    )


def test_cli_cache_roundtrip(tmp_path):
    cache = tmp_path / "xla-cache"
    img = np.random.default_rng(5).integers(0, 256, (24, 32, 3), dtype=np.uint8)
    a = tmp_path / "a.ppm"
    b = tmp_path / "b.ppm"
    write_ppm(str(a), img)
    write_ppm(str(b), img)

    r1 = _run_cli(["-gray", "-w16", str(a)], _cli_env(str(cache)))
    assert r1.returncode == 0, r1.stdout + r1.stderr
    assert cache.is_dir() and any(cache.iterdir()), "cache not populated"

    r2 = _run_cli(["-gray", "-w16", str(b)], _cli_env(str(cache)))
    assert r2.returncode == 0, r2.stdout + r2.stderr
    out_a = pathlib.Path(str(a) + ".out").read_bytes()
    out_b = pathlib.Path(str(b) + ".out").read_bytes()
    assert out_a == out_b, "cache-hit output differs from cold output"


def test_disable_value_leaves_config_untouched(monkeypatch):
    import jax

    from imageprocessingtools_tpu.utils.compile_cache import (
        enable_persistent_cache,
    )

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("IPT_COMPILE_CACHE", "0")
    assert enable_persistent_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_hostile_dir_degrades_to_none(monkeypatch, tmp_path):
    from imageprocessingtools_tpu.utils.compile_cache import (
        enable_persistent_cache,
    )

    from imageprocessingtools_tpu.utils import compile_cache

    blocker = tmp_path / "not-a-dir"
    blocker.write_text("file in the way")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(compile_cache, "DEFAULT_CACHE_DIR", str(blocker / "sub"))
    assert enable_persistent_cache() is None


_PROBE = (
    "import jax; "
    "from imageprocessingtools_tpu.utils.compile_cache import enable_persistent_cache; "
    "print(enable_persistent_cache()); print(jax.config.jax_compilation_cache_dir)"
)


def _probe(env) -> list[str]:
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                       text=True, env=env, cwd=REPO, check=True)
    return r.stdout.split()


def test_env_dir_is_used_as_is(tmp_path):
    """JAX reads JAX_COMPILATION_CACHE_DIR itself; the code sets no other."""
    env = _cli_env(str(tmp_path / "from-env"))
    assert _probe(env) == [str(tmp_path / "from-env")] * 2


def test_default_dir_is_fixed_inside_checkout():
    """Without the env var: <checkout>/.cache/jax, the same in every process
    (no temp name, PID or time in the path)."""
    env = _cli_env("")
    env.pop("JAX_COMPILATION_CACHE_DIR")
    want = os.path.join(REPO, ".cache", "jax")
    assert _probe(env) == [want] * 2
    assert _probe(env) == [want] * 2


def test_serve_uses_env_cache_dir(tmp_path):
    cache = tmp_path / "serve-cache"
    img = np.random.default_rng(6).integers(0, 256, (16, 24, 3), dtype=np.uint8)
    p = tmp_path / "s.ppm"
    write_ppm(str(p), img)
    r = subprocess.run(
        [sys.executable, "-m", "imageprocessingtools_tpu.serve", "-gray", str(p)],
        capture_output=True, env=_cli_env(str(cache)))
    assert r.returncode == 0, r.stdout + r.stderr
    assert cache.is_dir() and any(cache.iterdir()), "cache not populated"
