"""Per-device wire evidence for the small-angle rotation BAND EXCHANGE.

At small folded angles
`parallel.spatial.rotate_spatial` ppermutes only the m input shards each
device's output row-groups actually read, instead of all-gathering the
whole image. This tool compiles BOTH forms for the same geometries on the
8-virtual-device CPU mesh and records, like tools/sharding_report.py:

- the optimized-HLO collective inventory of each form (collective-permute
  vs all-gather),
- the per-device byte counts (band: m shards; gather: n-1 shards),
- a bit-identity probe of band vs all-gather vs the single-device op.

    python tools/band_exchange_report.py > band_exchange.json
"""

from __future__ import annotations

import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

import imageprocessingtools_tpu as ipt  # noqa: E402
from imageprocessingtools_tpu.parallel import spatial  # noqa: E402

_COLLECTIVES = (
    "all-reduce", "all-gather", "collective-permute", "reduce-scatter",
    "all-to-all",
)


def _inventory(txt: str) -> dict:
    counts = {}
    for name in _COLLECTIVES:
        n = len(re.findall(rf"\b{name}(?:-start)?\(", txt))
        if n:
            counts[name] = n
    return counts


def _compiled_text(height, width, angle, mesh):
    fn, plan_arrays, _, _ = spatial._rotate_spatial_cached(
        height, width, angle, mesh, "sp")
    dummy = np.zeros((height, width, 3), np.uint8)
    return fn.lower(dummy, *plan_arrays).compile().as_text()


def main() -> None:
    n = 8
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))
    sharding = NamedSharding(mesh, P("sp"))
    rng = np.random.default_rng(0)
    doc = {"devices": n, "platform": jax.default_backend(), "geometries": []}

    for (h, w, angle) in [(512, 512, 3.0), (256, 256, 5.0),
                          (256, 256, 175.0), (512, 384, 355.0)]:
        info = spatial.rotate_band_info(h, w, angle, n)
        assert info is not None, (h, w, angle)
        S, C = h // n, 3
        img = rng.integers(0, 256, (h, w, 3), np.uint8)

        # Band form (the default for this geometry).
        spatial._rotate_spatial_cached.cache_clear()
        band_txt = _compiled_text(h, w, angle, mesh)
        out_band = np.asarray(spatial.rotate_spatial(
            jax.device_put(img, sharding), angle, mesh))

        # All-gather form: force the fallback for the same geometry.
        spatial._rotate_spatial_cached.cache_clear()
        orig = spatial._band_windows
        spatial._band_windows = lambda *a, **k: None
        try:
            gather_txt = _compiled_text(h, w, angle, mesh)
            out_gather = np.asarray(spatial.rotate_spatial(
                jax.device_put(img, sharding), angle, mesh))
        finally:
            spatial._band_windows = orig
            spatial._rotate_spatial_cached.cache_clear()

        ref = np.asarray(ipt.rotate(img, angle))
        doc["geometries"].append({
            "shape": [h, w, 3],
            "angle": angle,
            "band_window_shards_m": info["m"],
            "ppermute_calls": info["ppermute_calls"],
            "band_collectives": _inventory(band_txt),
            "all_gather_collectives": _inventory(gather_txt),
            "per_device_recv_bytes_band": info["m"] * S * w * C,
            "per_device_recv_bytes_all_gather": (n - 1) * S * w * C,
            "bytes_ratio": info["bytes_ratio_vs_all_gather"],
            "bit_identical_band_vs_single": bool((out_band == ref).all()),
            "bit_identical_gather_vs_single": bool((out_gather == ref).all()),
        })
    json.dump(doc, sys.stdout, indent=2)
    print()


if __name__ == "__main__":
    main()
