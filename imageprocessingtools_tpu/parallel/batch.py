"""Batch (data-parallel) API: vmap + sharding over a device mesh.

The reference processes one image per process; here a uint8[N, H, W, C] batch
is sharded over the mesh's data axis and each device runs the vmapped
pipeline on its slice — pure DP, no cross-image communication.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def default_mesh(axis_name: str = "data", devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis_name,))


def batch_apply(fn, images: jnp.ndarray, mesh: Mesh | None = None, axis_name: str = "data"):
    """Apply a single-image op/pipeline to a batch, sharded over the mesh.

    ``fn``: traceable uint8[H, W, C] -> array. ``images``: uint8[N, H, W, C]
    with N divisible by the mesh axis size (pad-and-bucket upstream).
    """
    if mesh is None:
        mesh = default_mesh(axis_name)
    if axis_name not in mesh.shape:
        if len(mesh.shape) == 1:
            axis_name = next(iter(mesh.shape))  # 1-D mesh: use its axis name
        else:
            raise ValueError(
                f"axis_name {axis_name!r} not in mesh axes {tuple(mesh.shape)}"
            )
    n_dev = mesh.shape[axis_name]
    if images.shape[0] % n_dev != 0:
        raise ValueError(
            f"batch size {images.shape[0]} not divisible by mesh axis "
            f"{axis_name}={n_dev}; pad the batch"
        )
    # The jit's in_shardings places the host batch on the mesh.
    return _jitted_vmap(fn, mesh, axis_name)(images)


@functools.lru_cache(maxsize=128)
def _jitted_vmap(fn, mesh: Mesh, axis_name: str):
    """Cache the jitted vmap per (fn, mesh, axis): jax.jit caches by function
    identity, so rebuilding the wrapper per call would recompile every chunk."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.jit(jax.vmap(fn), in_shardings=sharding, out_shardings=sharding)


def batched_fused_pipeline(images, mesh: Mesh | None = None, axis_name: str = "data"):
    """Sharded batched flagship pipeline: uint8[N,H,W,3] -> uint8[N,H,W]."""
    from imageprocessingtools_tpu.kernels.fused import fused_pipeline_xla

    return batch_apply(fused_pipeline_xla, images, mesh=mesh, axis_name=axis_name)
