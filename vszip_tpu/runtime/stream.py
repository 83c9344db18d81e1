"""Streaming executor: run an op over a clip larger than device memory.

The reference's host runtime streams frames through the filter graph with a
request-pattern prefetcher (SURVEY §2.3; the VS core requests frames ahead
of the consumer and caches them).  The batched analogue is a chunked
pipeline over one device (or a frames mesh):

* the source yields host frame ranges on demand (never materializing the
  whole clip),
* host->device transfers are double-buffered: batch i+1 is enqueued with
  ``jax.device_put`` (async) while batch i computes,
* the compiled step donates its input buffers (``donate_argnums``), so device
  memory holds at most ~2 batches regardless of clip length,
* results drain to a host ``sink`` callback (or accumulate per-frame props
  for metric ops), which is the only blocking point — by the time batch i
  is read back, batch i+1 is already in flight.

Temporal ops (Checkmate, XPSNR temporal terms, MosquitoNR radius) need
neighbor frames across chunk boundaries; ``overlap=r`` feeds each chunk r
halo frames on both sides and trims them from the outputs, reproducing the
reference's boundary semantics exactly as long as the op's temporal radius
is <= r (the halo frames are recomputed, not approximated).
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import numpy as np

from ..core.clip import Clip
from ..core.format import VideoFormat
from ..core.params import VSZipError


class ArraySource:
    """FrameSource over in-memory (or memory-mapped) per-plane arrays."""

    def __init__(self, planes: Sequence[np.ndarray], fmt: VideoFormat,
                 props: dict | None = None):
        self.planes = tuple(planes)
        self.format = fmt
        self.props = dict(props or {})
        self.num_frames = self.planes[0].shape[0]

    def __call__(self, start: int, stop: int):
        return tuple(p[start:stop] for p in self.planes)


class SyntheticSource:
    """FrameSource that fabricates frames on demand (benchmarks: the
    README's 5000-frame workload does not fit host RAM either)."""

    def __init__(self, make: Callable[[int, int], tuple], fmt: VideoFormat,
                 num_frames: int, props: dict | None = None):
        self._make = make
        self.format = fmt
        self.props = dict(props or {})
        self.num_frames = num_frames

    def __call__(self, start: int, stop: int):
        return self._make(start, stop)


def _trim(arr, lead: int, tail: int):
    n = arr.shape[0]
    return arr[lead: n - tail if tail else n]


def process_stream(source, op, *, batch: int = 32, overlap: int = 0,
                   sink: Callable[[int, Clip], None] | None = None,
                   donate: bool = True, mesh=None) -> dict:
    """Stream ``source`` through ``op`` in ``batch``-frame chunks.

    source: ``ArraySource``/``SyntheticSource`` or any object with
        ``num_frames``, ``format``, ``props`` and ``(start, stop) ->
        tuple[np.ndarray per plane]``.
    op: a ``Clip -> Clip`` function (jitted here with buffer donation).
    overlap: temporal halo fed to each chunk on both sides and trimmed
        from its outputs (set to the op's temporal radius).
    sink: called as ``sink(frame_index, chunk_clip_numpy)`` for every
        output chunk; when None, plane data is dropped and only per-frame
        props (metrics) are accumulated.
    mesh: optional ``jax.sharding.Mesh`` with a ``frames`` axis
        (``parallel.frames_mesh``): each chunk is placed frames-sharded
        across the mesh so the op runs data-parallel over devices, with
        the same chunking/halo semantics.  Chunks whose frame count does
        not divide the mesh (the tail) fall back to single-device
        placement — results are identical either way (the sharding only
        changes placement).

    Returns a dict of accumulated per-frame props (each a (num_frames,)
    numpy array for array-valued props, else the last scalar value).
    """
    n = int(source.num_frames)
    fmt = source.format
    if n <= 0:
        raise VSZipError("process_stream: empty source.")
    if batch <= 0 or overlap < 0:
        raise VSZipError("process_stream: batch must be > 0, overlap >= 0.")

    jop = jax.jit(op, donate_argnums=(0,) if donate else ())

    sharding = None
    mesh_n = 0
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        from ..parallel.mesh import FRAMES_AXIS

        sharding = NamedSharding(mesh, PartitionSpec(FRAMES_AXIS, None, None))
        mesh_n = int(np.prod(mesh.devices.shape))

    starts = list(range(0, n, batch))
    prop_chunks: dict[str, list] = {}
    prop_scalars: dict[str, object] = {}

    def load(start: int):
        """device_put the chunk [start-overlap, start+batch+overlap)."""
        lo = max(0, start - overlap)
        hi = min(n, start + batch + overlap)
        host = source(lo, hi)
        sh = sharding if sharding is not None and (hi - lo) % mesh_n == 0 \
            else None
        dev = tuple(
            jax.device_put(np.ascontiguousarray(p), sh) for p in host)
        return Clip(dev, fmt, dict(source.props)), start - lo, hi - min(n, start + batch)

    pending = None   # (start, out_clip, lead, tail) awaiting readback
    nxt = load(starts[0])
    for idx, start in enumerate(starts):
        clip, lead, tail = nxt
        in_frames = clip.planes[0].shape[0]
        out = jop(clip)                      # async dispatch
        out_frames = out.planes[0].shape[0]
        m = 1
        if out_frames != in_frames:
            # frame-count-changing ops (EEDI3/EEDI3H field=2/3 double the
            # rate: input frame i -> output frames m*i .. m*i+m-1, a
            # contiguous run, so halo trimming scales by m).  Non-multiple
            # changes (trims, arbitrary selectors) can't be chunk-trimmed.
            if out_frames % in_frames:
                raise VSZipError(
                    "process_stream: op changed the chunk frame count "
                    f"{in_frames} -> {out_frames} (not an integer "
                    "multiple); this op cannot be streamed in chunks.")
            m = out_frames // in_frames
            lead, tail = m * lead, m * tail
        if idx + 1 < len(starts):
            nxt = load(starts[idx + 1])      # H2D overlaps the compute
        if pending is not None:
            _drain(pending, sink, prop_chunks, prop_scalars)
        # sink indices are in OUTPUT-frame units: frame-multiplying ops
        # place source chunk [start, start+batch) at m*start in the output.
        pending = (m * start, out, lead, tail)
    _drain(pending, sink, prop_chunks, prop_scalars)

    props: dict = dict(prop_scalars)
    for k, chunks in prop_chunks.items():
        props[k] = np.concatenate(chunks)
    _finalize_aggregates(props)
    return props


def _finalize_aggregates(props: dict) -> None:
    """Recompute end-of-run aggregate props from accumulated per-frame
    state.  Scalar props otherwise keep the LAST chunk's value, which for
    metrics whose aggregate spans all frames (XPSNR's average — reference
    src/vapoursynth/xpsnr.zig:89-96,114-128) would silently report only the
    final chunk.  Ops opt in by attaching an ``_<OP>_AggMeta`` scalar prop
    plus whatever per-frame arrays their finalizer needs; the recompute
    reuses the op's own jitted aggregate math, so a streamed run is
    bit-equal to a resident one."""
    if "_XPSNR_WSSE" in props:
        from ..ops.xpsnr import _prop_math

        wsse = props.pop("_XPSNR_WSSE")
        num64 = props.pop("_XPSNR_Num64")
        _, avg = _prop_math(jax.numpy.asarray(wsse),
                            jax.numpy.asarray(num64))
        props["XPSNR_AVG"] = np.asarray(avg)


# props that are constant metadata for the aggregate finalizers: never
# per-frame even if their length happens to match a chunk's frame count
_SCALAR_PROPS = frozenset({"_XPSNR_Num64"})

# internal streaming-support props consumed by _finalize_aggregates; they
# are stripped from the clips handed to sinks (sinks see only the
# reference's public prop surface)
_INTERNAL_PROPS = frozenset({"_XPSNR_WSSE", "_XPSNR_Num64"})


def _drain(pending, sink, prop_chunks, prop_scalars):
    start, out, lead, tail = pending
    host_planes = tuple(np.asarray(p)[lead: p.shape[0] - tail if tail else p.shape[0]]
                        for p in out.planes) if sink is not None else None
    for k, v in out.props.items():
        if k not in _SCALAR_PROPS and hasattr(v, "shape") \
                and getattr(v, "ndim", 0) >= 1 \
                and v.shape[0] == out.planes[0].shape[0]:
            prop_chunks.setdefault(k, []).append(
                _trim(np.asarray(v), lead, tail))
        else:
            prop_scalars[k] = np.asarray(v) if hasattr(v, "shape") else v
    if sink is not None:
        props = {k: v for k, v in out.props.items() if k not in _INTERNAL_PROPS}
        sink(start, Clip(host_planes, out.format, props))
