"""imageprocessingtools_tpu — a JAX image-processing framework.

A from-scratch JAX/XLA rebuild of the capabilities of
``e19293001/ImageProcessingTools`` (``ppmx-edward.c``): a PPM-family codec that
decodes straight to device-resident ``uint8`` HWC arrays, every reference
operation (grayscale, Bayer-4x4 bilevel dither, flips, MATLAB-compatible
separable bicubic resize expressed as dense matmuls, orthogonal +
arbitrary-angle bicubic rotation) with bit-exact (or +-1 LSB for
rounding-divergent float ops) parity, plus extension stencil / histogram
ops, a vmap+jit batch API, spatial (height) sharding with halo exchange over
a device mesh, and a CLI mirroring the reference flag surface.

Layering (bottom-up):
  codec/     host + native PPM/PGM/PBM codec        (ref: ppmx-edward.c:221-456)
  ops/       jitted reference + extension ops       (ref: ppmx-edward.c:477-1003)
  kernels/   fused flagship pipeline (perf layer)
  parallel/  batch (DP) + spatial (halo) sharding   (new design; ref has none)
  pipeline   fixed-order op pipeline                (ref: ppmx-edward.c:1053-1172)
  cli        flag-compatible command line           (ref: ppmx-edward.c:117-205)
"""

__version__ = "0.1.0"

from imageprocessingtools_tpu.codec.ppm import (  # noqa: F401
    PPMError,
    decode_ppm,
    decode_pnm,
    encode_ppm,
    read_ppm,
    read_pnm,
    write_ppm,
    FILETYPE_PPM,
    FILETYPE_PGM,
    FILETYPE_PBM,
)
from imageprocessingtools_tpu.ops import (  # noqa: F401
    grayscale,
    mono_dither,
    flip_horizontal,
    flip_vertical,
    rotate,
    rotate_exact,
    resize_width,
    resize_width_exact,
    resize,
    apply_lut,
    pack_bits_device,
    invert,
    brightness,
    contrast,
    threshold,
    box_blur,
    sharpen,
    gaussian_blur,
    sobel,
    histogram,
    equalize_histogram,
)
from imageprocessingtools_tpu.pipeline import PipelineConfig, run_pipeline  # noqa: F401
