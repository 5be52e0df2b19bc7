"""Packaging metadata sanity: pyproject entry points and package data.

A standalone framework must be installable; these tests pin the pieces an
install depends on without actually running pip: entry-point callables
resolve, package-data files exist where the globs point, and the native
codec builds into the directory ``IPT_CACHE_DIR`` names.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys

import pytest

# pyproject declares requires-python >= 3.10; tomllib is stdlib only from
# 3.11, so skip (not fail) metadata parsing on 3.10.
tomllib = pytest.importorskip("tomllib")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pyproject():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def test_entry_points_resolve(pyproject):
    scripts = pyproject["project"]["scripts"]
    assert set(scripts) == {"ppmx-tpu", "ppmx-tpu-serve"}
    for target in scripts.values():
        mod_name, func_name = target.split(":")
        fn = getattr(importlib.import_module(mod_name), func_name)
        assert callable(fn)


def test_package_data_files_exist(pyproject):
    data = pyproject["tool"]["setuptools"]["package-data"]
    for pkg, globs in data.items():
        pkg_dir = os.path.join(REPO, *pkg.split("."))
        for pattern in globs:
            import glob as _glob

            matches = _glob.glob(os.path.join(pkg_dir, pattern))
            assert matches, f"package-data glob {pkg}:{pattern} matches nothing"


def test_version_consistent(pyproject):
    import imageprocessingtools_tpu as ipt

    assert pyproject["project"]["version"] == ipt.__version__


def test_native_codec_user_cache_fallback(tmp_path):
    """With IPT_CACHE_DIR pointing at a fresh dir, the native codec builds
    there (or cleanly falls back) without touching the checkout's cache."""
    code = (
        "import glob, os\n"
        "from imageprocessingtools_tpu.codec import native\n"
        "cache = native._cache_dir()\n"
        "assert cache == os.environ['IPT_CACHE_DIR'], cache\n"
        "lib = native._load()\n"
        "assert lib is None or glob.glob(\n"
        "    os.path.join(os.environ['IPT_CACHE_DIR'], 'libppmcodec-*.so'))\n"
    )
    env = dict(os.environ, IPT_CACHE_DIR=str(tmp_path / "cache"))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(tmp_path))
