"""Fixed-seed CI slice of the serving-layer fuzz (tools/serving_fuzz.py).

The full campaign (tools/serving_fuzz.py, fresh seeds) is a one-off
evidence run; this keeps a small deterministic slice
in CI so regressions in the serving machinery (bucketing, chunk overlap,
fan-out, skip-bad, resume) surface on every run. Seeds are fixed and
disjoint from the campaign's 300000+ range.
"""

import os
import sys
import tempfile

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))


@pytest.mark.parametrize("seed", [7001, 7002, 7003, 7004])
def test_serving_fuzz_round(seed):
    from serving_fuzz import run_round

    with tempfile.TemporaryDirectory() as workdir:
        rec, fails = run_round(seed, workdir)
    assert not fails, (rec, fails)


@pytest.mark.parametrize("seed", [7101, 7102])
def test_serving_fuzz_spatial_round(seed):
    """CI slice of the spatial fuzz class (campaign seeds from 1100000):
    serve --spatial /
    process_file_spatial over random shapes incl. submesh fallback,
    spatial presets incl. P4, fused pipelines, and skip-bad."""
    from serving_fuzz import run_spatial_round

    with tempfile.TemporaryDirectory() as workdir:
        rec, fails = run_spatial_round(seed, workdir)
    assert not fails, (rec, fails)
