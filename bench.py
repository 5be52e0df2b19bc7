"""Benchmark: the fused 4K pipeline (grayscale -> 5x5 Gaussian -> hist-eq)
on one GPU.

    python bench.py

Times `kernels.fused.fused_gray_gauss_histeq` on a seeded 3840x2160 frame:
200 calls queued, one block_until_ready on the last, host clock. Prints ONE
JSON line naming the device and the card's power limit. Refuses to run
without a GPU.
"""

from __future__ import annotations

import json

import numpy as np

H, W = 2160, 3840  # 4K
ITERS = 200


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cuda")  # no GPU: jax.devices() raises

    from chip_smoke import card_line, time_calls
    from imageprocessingtools_tpu.kernels.fused import fused_gray_gauss_histeq

    dev = jax.devices()[0]
    img = np.random.default_rng(0).integers(0, 256, (H, W, 3), dtype=np.uint8)
    per_frame, _ = time_calls(fused_gray_gauss_histeq, jax.device_put(img), ITERS)
    print(json.dumps({
        "metric": "fused_4k_pipeline",
        "value": round(H * W / per_frame / 1e6, 1),
        "unit": "MPix/s",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card_line(),
    }))


if __name__ == "__main__":
    main()
