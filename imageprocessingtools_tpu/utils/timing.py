"""Device timing utilities (survey §5: tracing/profiling subsystem).

Two measurement modes; completion is observed via a dependent tiny
device-to-host transfer:

- `device_loop_rate`: iterate an image->image op ON DEVICE inside one jitted
  `lax.fori_loop`, rebuilding each iteration's input from the previous
  output so nothing hoists; a 0-iteration loop fetch is subtracted as the
  harness baseline.
- `dispatch_time`: single dispatch + dependent fetch: what one CLI-style
  call costs end to end.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def _fetch_tiny(x) -> None:
    np.asarray(jnp.ravel(x)[:1])


def device_loop_rate(
    body, img, iters: int = 20, repeats: int = 3, stat: str = "min"
) -> float:
    """Seconds per iteration of ``body`` (uint8 array -> uint8 array).

    The output is recycled into the next input (any shape) via ravel/tile —
    the measured time includes that feedback materialization, so rates are
    slight underestimates of the pure op.

    The 0-iter baseline and the timed loop are run as ADJACENT pairs so
    both sides share one noise window; a pair whose delta is nonpositive
    is discarded. ``stat`` picks min (same-run A/B convention) or median
    (robust absolute reporting) over the surviving pair deltas.
    """
    shape = tuple(img.shape)
    need = 1
    for d in shape:
        need *= int(d)

    @functools.partial(jax.jit, static_argnums=1)
    def loop(x, n):
        def b(_, carry):
            out = body(carry)
            if (
                out.ndim == 2
                and len(shape) == 3
                and out.shape == shape[:2]
                and shape[2] == 3
            ):
                # Cheap feedback for the common [H, W] -> HWC case:
                # stack + rolls instead of the general ravel/tile
                # reconstruction below.
                out = out.astype(jnp.uint8)
                return jnp.stack(
                    [out, jnp.roll(out, 1, axis=0), jnp.roll(out, 7, axis=1)],
                    axis=-1,
                )
            if (
                out.ndim == 3
                and len(shape) == 4
                and out.shape == shape[:3]
                and shape[3] == 3
            ):
                # Batched [N, H, W] -> [N, H, W, 3]: same stack+roll
                # feedback, vectorized over the batch dim.
                out = out.astype(jnp.uint8)
                return jnp.stack(
                    [out, jnp.roll(out, 1, axis=1), jnp.roll(out, 7, axis=2)],
                    axis=-1,
                )
            if (
                out.ndim == 1
                and len(shape) == 2
                and shape[1] % out.shape[0] == 0
            ):
                # 1-D outputs (e.g. a histogram): tile only to one row and
                # broadcast down H.
                row = jnp.tile(out.astype(jnp.uint8), shape[1] // out.shape[0])
                return jnp.broadcast_to(row[None, :], shape)
            if out.ndim == 3 and len(shape) == 3 and out.shape != shape:
                # Shape-changing HWC output (resize/thumbnail): carry the
                # ORIGINAL input forward perturbed by a scalar REDUCTION of
                # the output. The reduction consumes every output element
                # (XLA cannot dead-code-narrow the op to one pixel) and the
                # xor keeps the loop-carried dependency (nothing hoists);
                # feedback cost is one elementwise pass over the input.
                s = jnp.sum(out.astype(jnp.int32)).astype(jnp.uint8)
                return carry ^ s
            flat = jnp.ravel(out.astype(jnp.uint8))
            reps = -(-need // flat.shape[0])
            return jnp.tile(flat, reps)[:need].reshape(shape)

        return lax.fori_loop(0, n, b, x)

    img = jax.device_put(np.asarray(img))
    _fetch_tiny(loop(img, iters))  # compile n=iters
    _fetch_tiny(loop(img, 0))  # compile n=0

    def run(n):
        t0 = time.perf_counter()
        _fetch_tiny(loop(img, n))
        return time.perf_counter() - t0

    deltas = []
    for _ in range(repeats):
        b = run(0)
        t = run(iters)
        if t > b:
            deltas.append((t - b) / iters)
    if not deltas:
        # Every pair underflowed: the loop cost is below this window's
        # noise floor; report the floor rather than a fantasy rate.
        return 1e-9
    if stat == "median":
        deltas.sort()
        mid = len(deltas) // 2
        return (
            deltas[mid]
            if len(deltas) % 2
            else (deltas[mid - 1] + deltas[mid]) / 2
        )
    return min(deltas)


def dispatch_time(fn, *args, repeats: int = 5) -> float:
    """Seconds for one dispatch + dependent tiny fetch."""
    jitted = jax.jit(fn)
    _fetch_tiny(jitted(*args))

    def run():
        t0 = time.perf_counter()
        _fetch_tiny(jitted(*args))
        return time.perf_counter() - t0

    return min(run() for _ in range(repeats))
