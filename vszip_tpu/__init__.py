"""vszip_tpu: a JAX rebuild of the vszip frame-processing toolkit.

The reference (dnjulek/vapoursynth-zip) is a VapourSynth plugin of 23
hand-SIMD Zig filters scheduled per-frame by the VS core thread pool.  This
package re-designs the same surface for an accelerator under XLA:

* frames are batched ``(N, H, W)`` plane tensors in device memory (`Clip`);
* every filter is a pure jitted ``Clip -> Clip`` (or ``-> metrics``) op,
  monomorphized by jit static args where the reference used comptime, and
  written in plain ``jax.numpy``/``lax`` that XLA compiles and fuses;
* frame-level parallelism is the batch axis; multi-device scaling shards
  the batch over a ``jax.sharding.Mesh`` (vszip_tpu.parallel);
* whole clips stream host to host through ``process_stream``
  (vszip_tpu.runtime.stream).

64-bit arithmetic is required for the bit-exact integer fixed-point paths
(e.g. BoxBlur's ``(sum*inv + 2^31) >> 16`` chain), so x64 is enabled at
import.  All ops request explicit dtypes; nothing relies on defaults.
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

from .core.clip import Clip, VariableClip  # noqa: E402
from .core.format import (  # noqa: E402
    ColorFamily,
    ColorRange,
    SampleType,
    VideoFormat,
    get_format,
)
from .core.params import VSZipError  # noqa: E402
from .core.resample import (  # noqa: E402
    bit_depth,
    resize,
    srgb_to_linear,
    to_rgbs,
)
from .io import image_read  # noqa: E402
from .runtime.stream import (  # noqa: E402
    ArraySource,
    SyntheticSource,
    process_stream,
)
from .ops import *  # noqa: E402,F401,F403

__version__ = "0.1.0"
