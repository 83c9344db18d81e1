"""Streaming-runtime tests: chunked double-buffered execution must be
indistinguishable from one resident batch (planes bit-exact, per-frame
props identical), including temporal ops fed boundary halos.

The reference's host runtime streams frames with prefetch + cache
(SURVEY §2.3); process_stream is the batched equivalent
(vszip_tpu/runtime/stream.py)."""

import numpy as np
import pytest

from vszip_tpu import (
    ArraySource,
    Clip,
    SyntheticSource,
    VSZipError,
    get_format,
    process_stream,
)
from vszip_tpu.ops.boxblur import boxblur
from vszip_tpu.ops.checkmate import checkmate
from vszip_tpu.ops.planeaverage import plane_average


def _planes(n=13, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 65536, (n, h, w), dtype=np.uint16),
        rng.integers(0, 65536, (n, h // 2, w // 2), dtype=np.uint16),
        rng.integers(0, 65536, (n, h // 2, w // 2), dtype=np.uint16),
    )


@pytest.fixture()
def src():
    return ArraySource(_planes(), get_format("YUV420P16"))


def _collect(fmt):
    chunks = {}

    def sink(start, clip):
        chunks[start] = clip

    def assemble():
        planes = []
        for p in range(fmt.num_planes):
            planes.append(np.concatenate(
                [chunks[s].planes[p] for s in sorted(chunks)]))
        return planes

    return sink, assemble


def test_spatial_op_matches_resident(src):
    resident = boxblur(
        Clip.from_planes(src.planes, src.format), hradius=3, vradius=2)
    sink, assemble = _collect(src.format)
    process_stream(src, lambda c: boxblur(c, hradius=3, vradius=2),
                   batch=4, sink=sink)
    for got, want in zip(assemble(), resident.planes):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_temporal_op_overlap_matches_resident():
    planes = tuple(
        (p >> 8).astype(np.uint8) for p in _planes())
    src = ArraySource(planes, get_format("YUV420P8"))
    resident = checkmate(
        Clip.from_planes(src.planes, src.format), thr=12, tmax=12, tthr2=8)
    sink, assemble = _collect(src.format)
    process_stream(src, lambda c: checkmate(c, thr=12, tmax=12, tthr2=8),
                   batch=4, overlap=2, sink=sink)
    for got, want in zip(assemble(), resident.planes):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_metric_props_accumulate(src):
    resident = plane_average(
        Clip.from_planes(src.planes, src.format), exclude=[-1])
    props = process_stream(src, lambda c: plane_average(c, exclude=[-1]),
                           batch=5)
    np.testing.assert_allclose(
        props["psmAvg"],
        np.asarray(resident.props["psmAvg"]),
        rtol=0, atol=0)


def test_synthetic_source_never_materializes():
    fmt = get_format("GRAY16")
    calls = []

    def make(start, stop):
        calls.append((start, stop))
        rng = np.random.default_rng(start)
        return (rng.integers(0, 65536, (stop - start, 32, 48), np.uint16),)

    source = SyntheticSource(make, fmt, num_frames=11)
    props = process_stream(source, lambda c: plane_average(c, exclude=[-1]),
                           batch=4)
    assert props["psmAvg"].shape == (11, 1)
    assert calls == [(0, 4), (4, 8), (8, 11)]


def test_errors(src):
    with pytest.raises(VSZipError, match="batch"):
        process_stream(src, lambda c: c, batch=0)
    empty = ArraySource((np.zeros((0, 8, 8), np.uint16),), get_format("GRAY16"))
    with pytest.raises(VSZipError, match="empty"):
        process_stream(empty, lambda c: c)


def test_streamed_xpsnr_avg_matches_resident():
    """The end-of-run XPSNR average must accumulate across ALL chunks
    (reference src/vapoursynth/xpsnr.zig:89-96,114-128 sums sqrt(wsse) over
    every frame) — round 3 kept only the last chunk's scalar."""
    from vszip_tpu.ops.xpsnr import xpsnr

    rng = np.random.default_rng(3)
    n, h, w = 13, 48, 64
    ref_p = tuple(
        rng.integers(0, 256, (n, h >> s, w >> s), dtype=np.uint8)
        for s in (0, 1, 1))
    dist_p = tuple(
        np.clip(p.astype(np.int32) + rng.integers(-9, 9, p.shape), 0, 255)
        .astype(np.uint8) for p in ref_p)
    fmt = get_format("YUV420P8")
    ref = Clip.from_planes(ref_p, fmt)
    resident = xpsnr(ref, Clip.from_planes(dist_p, fmt), fps=24)

    src = ArraySource(dist_p, fmt)
    # 13 frames / batch 4 -> 4 chunks; chunks arrive in order, so the op
    # reconstructs each chunk's [lo, hi) window from its index
    batch, overlap = 4, 2
    idx = iter(range(0, n, batch))

    def op(chunk):
        start = next(idx)
        lo = max(0, start - overlap)
        hi = min(n, start + batch + overlap)
        r = Clip.from_planes(tuple(p[lo:hi] for p in ref_p), fmt)
        return xpsnr(r, chunk, fps=24)

    props = process_stream(src, op, batch=4, overlap=2, donate=False)
    for k in ("XPSNR_Y", "XPSNR_U", "XPSNR_V"):
        np.testing.assert_array_equal(
            props[k], np.asarray(resident.props[k]))
    np.testing.assert_array_equal(
        props["XPSNR_AVG"], np.asarray(resident.props["XPSNR_AVG"]))
    assert "_XPSNR_WSSE" not in props and "_XPSNR_Num64" not in props


def test_streamed_frame_doubling_eedi3_matches_resident():
    """EEDI3 field=2 doubles the frame count: chunk halo trimming must
    scale by the output/input frame ratio."""
    from vszip_tpu.ops.eedi3 import eedi3

    rng = np.random.default_rng(5)
    x = rng.random((7, 24, 32), dtype=np.float32)
    fmt = get_format("GRAYS")
    resident = eedi3(Clip.from_planes((x,), fmt), field=2)

    src = ArraySource((x,), fmt)
    sink, assemble = _collect(fmt)
    process_stream(src, lambda c: eedi3(c, field=2), batch=3, sink=sink,
                   donate=False)
    np.testing.assert_array_equal(assemble()[0],
                                  np.asarray(resident.planes[0]))


def test_frame_doubling_sink_index_in_output_units():
    """Sink indices are in OUTPUT-frame units: a frame-doubling op's chunk
    starting at source frame s lands at output frame 2*s, so writing each
    chunk at its index reassembles the clip without gaps or overlaps."""
    from vszip_tpu.ops.eedi3 import eedi3

    rng = np.random.default_rng(6)
    x = rng.random((7, 24, 32), dtype=np.float32)
    fmt = get_format("GRAYS")
    resident = np.asarray(
        eedi3(Clip.from_planes((x,), fmt), field=2).planes[0])

    out = np.full_like(resident, np.nan)

    def sink(start, clip):
        chunk = clip.planes[0]
        out[start: start + chunk.shape[0]] = chunk

    process_stream(ArraySource((x,), fmt), lambda c: eedi3(c, field=2),
                   batch=3, sink=sink, donate=False)
    np.testing.assert_array_equal(out, resident)


def test_sink_does_not_see_internal_props():
    """Streaming-support props (_XPSNR_*) are stripped from sink clips —
    sinks observe only the reference's public prop surface."""
    from vszip_tpu.ops.xpsnr import xpsnr

    rng = np.random.default_rng(7)
    p = tuple(rng.integers(0, 256, (6, 16 >> s, 16 >> s), np.uint8)
              for s in (0, 1, 1))
    fmt = get_format("YUV420P8")
    ref = tuple(a.copy() for a in p)
    seen = []

    def op(chunk):
        r = Clip.from_planes(tuple(a[: chunk.planes[0].shape[0]] for a in ref),
                             fmt)
        return xpsnr(r, chunk, fps=24)

    def sink(start, clip):
        seen.append(set(clip.props))

    process_stream(ArraySource(p, fmt), op, batch=6, sink=sink, donate=False)
    assert seen and all(
        not any(k.startswith("_XPSNR_") for k in ks) for ks in seen)
    assert all("XPSNR_Y" in ks for ks in seen)


def test_streamed_non_multiple_frame_change_rejected(src):
    def bad(c):
        return c.with_planes(tuple(p[:-1] for p in c.planes))

    with pytest.raises(VSZipError, match="frame count"):
        process_stream(src, bad, batch=4, donate=False)


def test_streamed_over_mesh_matches_resident(src):
    """Chunked streaming composed with the 8-device frames mesh via the
    first-class ``mesh=`` parameter: full chunks are placed
    frames-sharded, the indivisible tail falls back to single-device, and
    the assembled result equals the resident run bit for bit."""
    from vszip_tpu.parallel.mesh import frames_mesh

    mesh = frames_mesh(8)
    resident = boxblur(
        Clip.from_planes(src.planes, src.format), hradius=3, vradius=2)

    sink, assemble = _collect(src.format)
    # 13 frames / batch 8: one sharded chunk + a 5-frame unsharded tail
    process_stream(src, lambda c: boxblur(c, hradius=3, vradius=2),
                   batch=8, sink=sink, donate=False, mesh=mesh)
    for got, want in zip(assemble(), resident.planes):
        np.testing.assert_array_equal(got, np.asarray(want))
