"""Compress tests: block-level literal oracle + golden sweeps."""

import numpy as np
import pytest

from fixtures import crop_abs
from golden import Case, sweep
from vszip_tpu import VSZipError
from vszip_tpu.ops.compress import compress

# The reference's exact case list (reference tests/test_compress.py:14-41).
from golden import grid  # noqa: E402

YUV8 = ("YUV420P8", "YUV422P8", "YUV444P8")

MPEG_CASES = (
    sweep(
        base_fmt="GRAY8",
        base_args={"codec": 0, "qscale": 8},
        formats=("GRAY8",) + YUV8,
        args=grid(qscale=[1, 4, 20, 31]) + grid(dc_prec=[1, 2, 3]),
        geometries=("odd", "tiny"),
    )
    + [
        Case("YUV420P8", args={"codec": 0, "qscale": 20, "chroma": False}),
        Case("YUV444P8", args={"codec": 0, "qscale": 20, "chroma": False}),
    ]
)

JPEG_CASES = sweep(
    base_fmt="GRAY8",
    base_args={"codec": 1, "quality": 25},
    formats=("GRAY8",) + YUV8,
    args=grid(quality=[8, 50, 98]),
    geometries=("odd", "tiny"),
) + [
    Case("YUV420P8", args={"codec": 1, "quality": 25, "chroma": False}),
]

CASES = MPEG_CASES + JPEG_CASES


@pytest.mark.parametrize("case", CASES, ids=str)
def test_golden(golden, make_clip, case):
    clip = make_clip(case.fmt, case.geometry)
    out = compress(clip, **case.args)
    golden.check("compress", case, out)


@pytest.mark.parametrize(
    "args",
    [
        {"codec": 0, "qscale": 8},
        {"codec": 0, "qscale": 31, "dc_prec": 2},
        {"codec": 1, "quality": 50},
        {"codec": 1, "quality": 7},
    ],
    ids=str,
)
def test_matches_literal_oracle(make_seeded_clip, args):
    from oracle.compress_ref import compress_block_ref

    clip = crop_abs(make_seeded_clip("GRAY8"), width=32, height=24, left=200, top=100)
    out = np.asarray(compress(clip, **args).planes[0][0])
    src = np.asarray(clip.planes[0][0])
    codec = "jpeg" if args.get("codec") == 1 else "mpeg2"
    for by in range(0, 24, 8):
        for bx in range(0, 32, 8):
            blk = src[by : by + 8, bx : bx + 8]
            ref = compress_block_ref(
                blk, codec, qscale=args.get("qscale", 8),
                dc_prec=args.get("dc_prec", 0), quality=args.get("quality", 50),
            )
            np.testing.assert_array_equal(
                out[by : by + 8, bx : bx + 8], ref,
                err_msg=f"block ({by},{bx}) {args}",
            )


def test_flat_block_roundtrip():
    """A constant block survives MPEG-2 with minimal DC error."""
    from vszip_tpu import Clip, get_format

    clip = Clip.blank(get_format("GRAY8"), 16, 16, value=128)
    out = np.asarray(compress(clip, qscale=1).planes[0])
    assert np.abs(out.astype(int) - 128).max() <= 1


def test_higher_qscale_more_loss(make_clip):
    clip = make_clip("GRAY8")
    src = np.asarray(clip.planes[0][0]).astype(np.int64)
    e2 = np.abs(np.asarray(compress(clip, qscale=2).planes[0][0]) - src).mean()
    e31 = np.abs(np.asarray(compress(clip, qscale=31).planes[0][0]) - src).mean()
    assert e31 > e2


def test_chroma_passthrough(make_clip):
    clip = make_clip("YUV420P8")
    out = compress(clip, chroma=False)
    np.testing.assert_array_equal(np.asarray(out.planes[1]), np.asarray(clip.planes[1]))


def test_errors(make_clip):
    with pytest.raises(VSZipError, match="only 8-bit integer Gray or YUV"):
        compress(make_clip("GRAY16"))
    with pytest.raises(VSZipError, match="only 8-bit integer Gray or YUV"):
        compress(make_clip("RGB24"))
    with pytest.raises(VSZipError, match="codec must be 0"):
        compress(make_clip("GRAY8"), codec=2)
    with pytest.raises(VSZipError, match="qscale must be between"):
        compress(make_clip("GRAY8"), qscale=0)
    with pytest.raises(VSZipError, match="quality must be between"):
        compress(make_clip("GRAY8"), codec=1, quality=0)
