"""Clip: the batched frame-tensor replacing VapourSynth's node/frame model.

A clip is a pytree of per-plane arrays shaped ``(N, H, W)`` (N = frames)
plus static format metadata.  Subsampled chroma planes are separate arrays
(ragged shapes rule out one packed tensor for 4:2:0).  This is the batched
analogue of the reference's lazy frame graph: instead of per-frame
``getFrame`` callbacks scheduled by the VS thread pool
(reference ``src/vapoursynth/boxblur.zig:29-116``), whole batches of frames
live in device memory and ops are pure jitted ``Clip -> Clip`` functions; frame-level
parallelism becomes the leading batch axis (and, across devices, a sharded
batch axis — see vszip_tpu.parallel).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import jax
import numpy as np

from .format import ColorFamily, ColorRange, SampleType, VideoFormat


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Clip:
    """Batched planar video clip.

    planes: tuple of arrays, one per plane, each (num_frames, h, w) in the
        format's storage dtype.
    format: static VideoFormat.
    props: per-clip/per-frame properties (metric outputs, color range, ...).
        Values may be arrays of shape (num_frames,) or plain scalars; carried
        as pytree leaves when they are arrays.
    """

    planes: tuple
    format: VideoFormat
    props: dict = dataclasses.field(default_factory=dict)

    # -- pytree protocol -----------------------------------------------------

    def tree_flatten(self):
        prop_keys = tuple(sorted(self.props))
        children = (self.planes, tuple(self.props[k] for k in prop_keys))
        return children, (self.format, prop_keys)

    @classmethod
    def tree_unflatten(cls, aux, children):
        fmt, prop_keys = aux
        planes, prop_vals = children
        return cls(tuple(planes), fmt, dict(zip(prop_keys, prop_vals)))

    # -- constructors ---------------------------------------------------------

    @classmethod
    def from_planes(cls, planes, fmt: VideoFormat, props: Mapping[str, Any] | None = None) -> "Clip":
        planes = tuple(planes)
        if len(planes) != fmt.num_planes:
            raise ValueError(
                f"{fmt.name} needs {fmt.num_planes} planes, got {len(planes)}"
            )
        w, h = planes[0].shape[2], planes[0].shape[1]
        for p, arr in enumerate(planes):
            if arr.ndim != 3:
                raise ValueError(f"plane {p} must be (N, H, W), got {arr.shape}")
            pw, ph = fmt.plane_dims(w, h, p)
            if arr.shape[1:] != (ph, pw):
                raise ValueError(
                    f"plane {p} shape {arr.shape[1:]} != expected {(ph, pw)}"
                )
            if np.dtype(arr.dtype) != fmt.storage_dtype:
                raise ValueError(
                    f"plane {p} dtype {arr.dtype} != {fmt.storage_dtype} for {fmt.name}"
                )
        return cls(planes, fmt, dict(props or {}))

    @classmethod
    def blank(cls, fmt: VideoFormat, width: int, height: int, num_frames: int = 1,
              value=None, backend=np) -> "Clip":
        """BlankClip equivalent: neutral gray unless `value` given."""
        planes = []
        for p in range(fmt.num_planes):
            pw, ph = fmt.plane_dims(width, height, p)
            if value is not None:
                v = value[p] if isinstance(value, (list, tuple)) else value
            elif fmt.sample_type is SampleType.FLOAT:
                v = 0.0
            else:
                chroma = fmt.color_family is ColorFamily.YUV and p > 0
                v = (1 << (fmt.bits_per_sample - 1)) if chroma else 0
            planes.append(
                backend.full((num_frames, ph, pw), v, dtype=fmt.storage_dtype)
            )
        return cls.from_planes(planes, fmt)

    # -- accessors -------------------------------------------------------------

    @property
    def num_planes(self) -> int:
        return len(self.planes)

    @property
    def num_frames(self) -> int:
        return int(self.planes[0].shape[0])

    @property
    def width(self) -> int:
        return int(self.planes[0].shape[2])

    @property
    def height(self) -> int:
        return int(self.planes[0].shape[1])

    def plane_dims(self, plane: int) -> tuple[int, int]:
        return self.format.plane_dims(self.width, self.height, plane)

    def color_range(self) -> ColorRange:
        """Frame-prop probe with the reference's fallback rule
        (RGB -> FULL, else LIMITED; reference src/helper.zig:261-279)."""
        cr = self.props.get("_ColorRange")
        if cr is not None:
            return ColorRange.FULL if int(np.asarray(cr).reshape(-1)[0]) == 0 else ColorRange.LIMITED
        return (
            ColorRange.FULL
            if self.format.color_family is ColorFamily.RGB
            else ColorRange.LIMITED
        )

    def with_planes(self, planes, fmt: VideoFormat | None = None) -> "Clip":
        return Clip(tuple(planes), fmt or self.format, dict(self.props))

    def with_props(self, **props) -> "Clip":
        d = dict(self.props)
        d.update(props)
        return Clip(self.planes, self.format, d)

    def numpy(self) -> "Clip":
        return Clip(tuple(np.asarray(p) for p in self.planes), self.format, dict(self.props))

    def device(self) -> "Clip":
        import jax.numpy as jnp

        return Clip(tuple(jnp.asarray(p) for p in self.planes), self.format, dict(self.props))

    def frame(self, n: int) -> "Clip":
        """Single-frame view (length-1 clip) of frame n."""
        return Clip(
            tuple(p[n : n + 1] for p in self.planes), self.format, dict(self.props)
        )


class _WipedFormat:
    """Sentinel for a wiped (variable) format: falsy, and any attribute
    access raises the host runtime's constant-format error so filters fail
    clearly instead of with an opaque AttributeError."""

    def __bool__(self):
        return False

    def __repr__(self):
        return "<variable format>"

    def __getattr__(self, name):
        from .params import VSZipError

        raise VSZipError(
            "clip must have constant format and dimensions: this is a "
            "variable-format clip (RFS mismatch output); process per frame "
            "via get_frame(n) instead."
        )


WIPED_FORMAT = _WipedFormat()


class VariableClip:
    """Variable-format clip: per-frame references into heterogeneous sources.

    The reference's RFS ``mismatch=True`` wipes width/height/format on the
    output VideoInfo and serves each frame wholesale from clip a or b
    (reference src/vapoursynth/rfs.zig:150-188 + the getFrame passthrough
    :18-29).  Batched plane tensors can't hold ragged frames, so the
    batched equivalent is this lazy union: ``get_frame(n)`` materializes a
    single-frame Clip from whichever source owns frame n.  Dimensions report
    0 and format the falsy WIPED_FORMAT sentinel when the sources disagree,
    mirroring the wiped VideoInfo; piping the clip into any filter raises
    the host runtime's constant-format error (see _WipedFormat / the
    .planes guard below).
    """

    def __init__(self, sources, table):
        """sources: sequence of Clip; table: per-frame (source_idx, frame_idx)."""
        self.sources = tuple(sources)
        self.table = tuple((int(s), int(f)) for s, f in table)

    @property
    def num_frames(self) -> int:
        return len(self.table)

    def _common(self, getter, wipe):
        vals = {getter(s) for s in self.sources}
        return vals.pop() if len(vals) == 1 else wipe

    @property
    def width(self) -> int:
        return self._common(lambda s: s.width, 0)

    @property
    def height(self) -> int:
        return self._common(lambda s: s.height, 0)

    @property
    def format(self):
        return self._common(lambda s: s.format, WIPED_FORMAT)

    def get_frame(self, n: int) -> Clip:
        src_idx, frame_idx = self.table[n]
        return self.sources[src_idx].frame(frame_idx)

    # -- filter-input guard ----------------------------------------------
    # Ops consume clips through .planes (and friends); raise a clear,
    # actionable error instead of an opaque AttributeError when a
    # variable-format clip is piped into a filter (the reference host
    # runtime rejects variable-format input at filter Create time with
    # "clip must have constant format and dimensions").

    def _reject(self):
        from .params import VSZipError

        raise VSZipError(
            "clip must have constant format and dimensions: this is a "
            "variable-format clip (RFS mismatch output); process per frame "
            "via get_frame(n) instead."
        )

    @property
    def planes(self):
        self._reject()

    @property
    def num_planes(self):
        self._reject()

    @property
    def props(self):
        self._reject()

    def plane_dims(self, plane: int):
        self._reject()
