"""Parallelism layer (new design — the reference is strictly serial).

- `batch`: pure data parallelism — vmapped pipelines over N same-shape
  images, sharded across a mesh axis with `jax.sharding` (zero cross-image
  communication; collectives only for the optional global histogram).
- `spatial`: one giant image sharded over H with `shard_map` — the image
  analog of sequence parallelism; stencil ops exchange a 2-row halo with
  `lax.ppermute` and the histogram reduces with `psum`
  (survey §5, long-context row).
"""

from imageprocessingtools_tpu.parallel.batch import (  # noqa: F401
    default_mesh,
    batch_apply,
    batched_fused_pipeline,
)
from imageprocessingtools_tpu.parallel.spatial import (  # noqa: F401
    fused_pipeline_spatial,
)
