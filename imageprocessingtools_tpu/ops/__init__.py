"""Jitted device ops.

Reference-parity ops (bit-exact, or +-1 LSB where noted):
  grayscale, mono_dither, flip_vertical, flip_horizontal, rotate (0/90/180/270
  exact; arbitrary-angle interior +-1), resize_width (+-1).

Extension ops (north-star surface, semantics in golden/model.py):
  invert, brightness, contrast, threshold, box_blur, sharpen, gaussian_blur,
  sobel, histogram, equalize_histogram, resize (explicit H, W).
"""

from imageprocessingtools_tpu.ops.color import (  # noqa: F401
    grayscale,
    invert,
    brightness,
    contrast,
    threshold,
)
from imageprocessingtools_tpu.ops.dither import mono_dither  # noqa: F401
from imageprocessingtools_tpu.ops.geometry import (  # noqa: F401
    flip_vertical,
    flip_horizontal,
    rotate,
    rotate_exact,
    rotate90,
    rotate180,
    rotate270,
)
from imageprocessingtools_tpu.ops.resize import (  # noqa: F401
    resize_width,
    resize_width_exact,
    resize,
)
from imageprocessingtools_tpu.ops.stencil import (  # noqa: F401
    box_blur,
    sharpen,
    gaussian_blur,
    sobel,
)
from imageprocessingtools_tpu.ops.histogram import (  # noqa: F401
    histogram,
    equalize_histogram,
    apply_lut,
)
from imageprocessingtools_tpu.ops.packing import pack_bits_device  # noqa: F401
