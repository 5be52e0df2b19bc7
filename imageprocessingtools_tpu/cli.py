"""Command-line interface mirroring the reference 1:1.

Flag surface, duplicate/conflict validation, fixed pipeline order, ``.out``
output naming, stdout error messages, and exit codes all match
``ppmx-edward.c:117-205`` (errors print to STDOUT and exit 255; success exits
0 — quirk B3). Divergences: bug B1 is fixed (flips compose after gray/mono)
and unsafe inputs are rejected instead of invoking UB (B4).
"""

from __future__ import annotations

import os
import sys

if os.environ.get("IPT_PLATFORM"):
    # Pin the JAX platform (e.g. IPT_PLATFORM=cpu for testing; float ops
    # carry a +-1 LSB budget PER QUANTIZED f32 STAGE on any backend —
    # stages compound across the reference's uint8 requantization points,
    # see ops/common.py::float_stage_budget). The config update also takes
    # effect when something imported jax before this module.
    import jax

    os.environ["JAX_PLATFORMS"] = os.environ["IPT_PLATFORM"]
    jax.config.update("jax_platforms", os.environ["IPT_PLATFORM"])

import numpy as np

from imageprocessingtools_tpu.codec.ppm import PPMError, read_ppm, write_ppm
from imageprocessingtools_tpu.ops import _exact
from imageprocessingtools_tpu.pipeline import PipelineConfig, run_pipeline
from imageprocessingtools_tpu.utils import log

USAGE = (
    "ppmx-edward [options] (input filename)\n"
    "Options -fv  Flip vertically\n"
    "        -fh  Flip horizontally\n"
    "        -w(new width) Scale to the new width\n"
    "        -w100 means new width is 100\n"
    "        -r(angle)  Rotate (CW)\n"
    "        -r30 means rotate 30 degree CW.\n"
    "        -mono Convert to bilevel (.pbm) format\n"
    "        -gray  Convert to grayscale (.pgm) format\n"
)


class _CliError(Exception):
    def __init__(self, message: str, show_usage: bool = False):
        super().__init__(message)
        self.message = message
        self.show_usage = show_usage


_LONG_MAX = 2**63 - 1


def _c_atoi(digits: str) -> int:
    """glibc ``atoi`` on an all-digit token (``ppmx-edward.c:151,164``).

    strtol saturates to LONG_MAX on overflow (ERANGE) and the long->int
    conversion truncates mod 2^32 on the oracle platform, so huge digit
    strings WRAP: binary-verified ``-r4294967333`` == ``-r37`` and
    ``-w8589934604`` == ``-w12`` byte-identical; ``-r4294967295`` -> -1 ->
    "invalid option for rotate."; ``-w2147483649`` -> negative ->
    "invalid option for new width". Python's ``int()`` is unbounded (and
    refuses >4300-digit strings outright), so the saturate+truncate must
    be explicit. ``atoi("") == 0``.
    """
    digits = digits.lstrip("0")  # no overflow from leading zeros
    n = _LONG_MAX if len(digits) > 19 else min(int(digits or "0"), _LONG_MAX)
    n &= 0xFFFFFFFF
    return n - 2**32 if n >= 2**31 else n


def _parse_args(argv: list[str]) -> tuple[PipelineConfig, str]:
    """Replicates the char-by-char argv scan (``ppmx-edward.c:125-183``)."""
    flip_v = flip_h = gray = mono = False
    new_width: int | None = None
    angle: float | None = None
    filename: str | None = None

    for arg in argv:
        if arg.startswith("-"):
            rest = arg[1:]
            if rest[:1] == "f":
                sub = rest[1:2]
                if sub == "h":
                    if flip_h:
                        raise _CliError("Error: Duplicate options not allowed\n")
                    if flip_v:
                        raise _CliError("Error: Conflicting options not allowed\n")
                    flip_h = True
                elif sub == "v":
                    if flip_v:
                        raise _CliError("Error: Duplicate options not allowed\n")
                    if flip_h:
                        raise _CliError("Error: Conflicting options not allowed\n")
                    flip_v = True
                else:
                    raise _CliError(
                        "Error: invalid option for flip.\n"
                        "allowed options are -fh -fv only.\n"
                    )
            elif rest[:1] == "w":
                digits = rest[1:]
                if not all(c in "0123456789" for c in digits):
                    raise _CliError("Error: invalid option for scaling.\n")
                if new_width is not None:
                    raise _CliError("Error: Duplicate options not allowed\n")
                # atoi semantics incl. "" -> 0 and mod-2^32 wrap; 0 and
                # negatives are rejected later by the pipeline with
                # "invalid option for new width".
                new_width = _c_atoi(digits)
            elif rest[:1] == "r":
                digits = rest[1:]
                if digits == "":
                    raise _CliError("Error: invalid option for rotate\n")
                if angle is not None:
                    raise _CliError("Error: Duplicate options not allowed\n")
                if not all(c in "0123456789" for c in digits):
                    raise _CliError("Error: invalid option for rotate.\n")
                value = _c_atoi(digits)
                if value < 0 or value >= 360:
                    raise _CliError("Error: invalid option for rotate.\n")
                angle = float(value)
            elif rest == "gray":
                if gray:
                    raise _CliError("Error: Duplicate options not allowed\n")
                if mono:
                    raise _CliError("Error: Conflicting options not allowed\n")
                gray = True
            elif rest == "mono":
                if mono:
                    raise _CliError("Error: Duplicate options not allowed\n")
                if gray:
                    raise _CliError("Error: Conflicting options not allowed\n")
                mono = True
            else:
                raise _CliError(
                    "Error: invalid option: %s\n" % rest, show_usage=True
                )
        else:
            if filename is not None:
                raise _CliError("Error: invalid options\n")
            filename = arg

    if filename is None:
        raise _CliError("", show_usage=True)

    config = PipelineConfig(
        new_width=new_width,
        angle=angle,
        gray=gray,
        mono=mono,
        flip_v=flip_v,
        flip_h=flip_h,
    )
    return config, filename


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # One process per invocation (like the reference binary): reload
    # compiled programs from the persistent cache instead of re-paying the
    # per-geometry XLA compile every run (see utils/compile_cache.py).
    from imageprocessingtools_tpu.utils.compile_cache import (
        enable_persistent_cache,
    )

    enable_persistent_cache()
    try:
        config, filename = _parse_args(argv)
    except _CliError as e:
        sys.stdout.write(e.message)
        if e.show_usage:
            sys.stdout.write(USAGE)
        log.emit("arg_error", message=e.message.strip())
        return 255

    try:
        img, max_color = read_ppm(filename)
        # strict_rotation: the eager CLI path audits the double-f32 zone
        # decisions per geometry (cached, ~0.5 s at 4K) and takes the
        # bit-exact host rotation if any decision is ambiguous.
        result, file_type = run_pipeline(img, config, strict_rotation=True)
        write_ppm(
            filename + ".out",
            np.asarray(result),
            file_type=file_type,
            max_color=max_color,  # pass-through, quirk B5
        )
    except (PPMError, ValueError) as e:
        message = e.message if isinstance(e, PPMError) else str(e)
        sys.stdout.write(message)
        log.emit("pipeline_error", file=filename, message=message.strip())
        return 255
    except MemoryError:
        # Backstop for allocation failure anywhere in the pipeline: the
        # reference's every malloc site prints through CHECK_ERROR and
        # exits 255 (ppmx-edward.c:31-36); the first to fail on oversized
        # resizes is the indices table (:537). plan_resize's B9 bound
        # rejects those before allocation — this catch keeps the B3 error
        # surface (stdout message, exit 255, no traceback) even if the host
        # runs out of memory on a nominally feasible case.
        sys.stdout.write(_exact.B9_MESSAGE)
        log.emit("pipeline_error", file=filename, message="MemoryError")
        return 255
    log.emit("ok", file=filename, out=filename + ".out", file_type=file_type)
    return 0


if __name__ == "__main__":
    sys.exit(main())
