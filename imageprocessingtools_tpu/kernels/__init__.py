"""Performance layer: the fused flagship pipeline.

`fused.py` holds gray -> 5x5 Gaussian -> histogram equalization as one
jitted XLA graph. No hand-written kernel lives here: one is added only
where a measured cell shows XLA far from its bound.
"""

from imageprocessingtools_tpu.kernels.fused import (  # noqa: F401
    fused_gray_gauss_histeq,
    fused_pipeline_xla,
)
