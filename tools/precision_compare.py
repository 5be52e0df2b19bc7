"""Compare f32 dot precisions on the parity path against the golden model.

    python tools/precision_compare.py          # on a GPU

For each candidate precision of the resize and rotation dots, runs the 4K
parity cases (resize 4K->1920, 1920->3840 and 4K->1366; rotation of a 4K
frame at 5, 30, 85, 135 and 333.3 degrees) on the device and prints, per case, the
maximum |device - golden| against `ops.common.float_stage_budget`, the
count of pixels off by one or more, and the device time of the op.
`tests/test_gpu.py` runs the same cases at the chosen precision.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import importlib  # noqa: E402

import jax  # noqa: E402

from imageprocessingtools_tpu.golden import model as golden  # noqa: E402
from imageprocessingtools_tpu.ops import geometry  # noqa: E402
from imageprocessingtools_tpu.ops.common import float_stage_budget  # noqa: E402

# The ops package re-exports the resize function under the module's name.
resize_mod = importlib.import_module("imageprocessingtools_tpu.ops.resize")

# (op, input height, input width, new width or angle)
CASES = (
    ("resize", 2160, 3840, 1920),
    ("resize", 1080, 1920, 3840),
    # 2:1 scales give dyadic cubic weights, exact in TF32; 1366 does not.
    ("resize", 2160, 3840, 1366),
    ("rotate", 2160, 3840, 5.0),
    ("rotate", 2160, 3840, 30.0),
    ("rotate", 2160, 3840, 85.0),
    ("rotate", 2160, 3840, 135.0),
    ("rotate", 2160, 3840, 333.3),
)

OPTIONS = {
    "HIGH": jax.lax.Precision.HIGH,
    "HIGHEST": jax.lax.Precision.HIGHEST,
    "BF16_BF16_F32_X3": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
}


def case_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + h * 7919 + w).integers(
        0, 256, (h, w, 3), dtype=np.uint8)


def device_fn(op: str, param):
    """The jitted device op of one case, at the module's current precision."""
    if op == "resize":
        return jax.jit(lambda x: resize_mod.resize_width(x, int(param)))
    return jax.jit(lambda x: geometry.rotate(x, float(param)))


def golden_out(op: str, img: np.ndarray, param) -> np.ndarray:
    if op == "resize":
        return golden.resize_width(img, int(param))
    return golden.rotate(img, float(param))


def case_budget(op: str) -> int:
    return float_stage_budget(op == "resize", op == "rotate")


def _time(fn, x, reps: int = 5) -> float:
    fn(x).block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(x).block_until_ready()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = jax.devices()[0]
    print(f"card: {card}; device_kind: {dev.device_kind}; jax {jax.__version__}")
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    rows = []
    for op, h, w, param in CASES:
        img = case_image(h, w)
        ref = golden_out(op, img, param)
        x = jax.device_put(img)
        for name, prec in OPTIONS.items():
            resize_mod.RESIZE_DOT_PRECISION = prec
            geometry.ROTATE_DOT_PRECISION = prec
            jax.clear_caches()
            fn = device_fn(op, param)
            out = np.asarray(fn(x))
            d = np.abs(out.astype(np.int16) - ref.astype(np.int16))
            row = {
                "op": op, "shape": [h, w], "param": param, "precision": name,
                "max_diff": int(d.max()), "budget": case_budget(op),
                "n_off": int(np.count_nonzero(d)), "n_px": int(d.size),
                "seconds": _time(fn, x),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
    for name in OPTIONS:
        mine = [r for r in rows if r["precision"] == name]
        ok = all(r["max_diff"] <= r["budget"] for r in mine)
        print(json.dumps({
            "precision": name, "within_budget_everywhere": ok,
            "n_off_total": sum(r["n_off"] for r in mine),
            "seconds_total": sum(r["seconds"] for r in mine),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
