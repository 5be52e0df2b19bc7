"""Exhaustive double-f32 rotation-decision audit over the CLI angle domain.

The CLI accepts integer angles 0..359 (``ppmx-edward.c:159-162``); 0/90/180/
270 take exact permutation paths, leaving 356 resampling angles. For each of
those, `ops.geometry.rotation_decisions_safe` replicates the device's
double-f32 zone/nearest arithmetic on host bit-for-bit and compares every
output pixel's decision against the C's float64 decisions (the observable
parity surface: zone masks + nearest indices; tap-base shifts stay inside
the +-1 interior budget because the cubic kernel is continuous).

This sweep turns the double-f32 parity argument from a fuzz result into a
verified statement over the ENTIRE CLI-reachable angle domain x a size grid
(tiny, odd, HD, 4K). Sizes outside the grid are covered operationally: the
CLI runs with strict_rotation=True, which executes this same audit per
geometry (cached) and falls back to the bit-exact host path
on any failure; serving audits each shape bucket the same way.

    python tools/angle_audit.py > angle_audit.json
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from imageprocessingtools_tpu.ops.geometry import rotation_decisions_safe  # noqa: E402

SIZES = [
    (16, 16, "tiny"),
    (37, 23, "odd"),
    (1080, 1920, "hd"),
    (2160, 3840, "4k"),
]
PERMUTATION_ANGLES = {0, 90, 180, 270}


def main():
    report = {"angle_domain": "integers 1..359 minus {90, 180, 270}",
              "sizes": {}}
    for h, w, name in SIZES:
        t0 = time.time()
        unsafe = []
        checked = 0
        for angle in range(1, 360):
            if angle in PERMUTATION_ANGLES:
                continue
            checked += 1
            if not rotation_decisions_safe(h, w, float(angle)):
                unsafe.append(angle)
        report["sizes"][name] = {
            "height": h,
            "width": w,
            "angles_checked": checked,
            "all_safe": not unsafe,
            "unsafe_angles": unsafe,
            "wall_s": round(time.time() - t0, 1),
        }
        print(f"# {name} {h}x{w}: {checked} angles, "
              f"{'ALL SAFE' if not unsafe else unsafe} "
              f"({report['sizes'][name]['wall_s']}s)", file=sys.stderr)
    report["all_safe"] = all(v["all_safe"] for v in report["sizes"].values())
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
