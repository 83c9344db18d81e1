"""CLAHE tests."""

import numpy as np
import pytest

from fixtures import crop_abs
from golden import Case, sweep
from oracle.clahe_ref import clahe_ref
from vszip_tpu import VSZipError
from vszip_tpu.ops.clahe import clahe

# The reference's exact case list (reference tests/test_clahe.py:15-75) so ids
# resolve against goldens/clahe.json, plus extra self-pinned sweeps.
from golden import grid  # noqa: E402

CASES = (
    sweep(
        base_fmt="GRAY8",
        base_args={"limit": 4, "tiles": 3},
        formats=("GRAY8", "GRAY16", "YUV420P8", "YUV444P8", "YUV420P16",
                 "YUV444P16", "RGB24", "RGB48"),
        args=grid(limit=[2, 4, 10])
        + [
            {"tiles": 2},
            {"tiles": 8},
            {"tiles": [2, 4]},
            {"tiles": [8, 2]},
            {"tiles": [4, 8]},
        ],
        geometries=("odd", "tiny"),
    )
    + [
        Case("GRAY16", args={"limit": 512, "tiles": 4}),
        Case("GRAY16", args={"limit": 1024, "tiles": 4}),
        Case("GRAY16", args={"limit": 2560, "tiles": 4}),
        Case("GRAY16", args={"limit": 2560, "tiles": [8, 2]}),
        Case("GRAY16", args={"limit": 2560, "tiles": [2, 8]}),
        Case("GRAY8", args={"limit": 4, "tiles": [3, 2]}),
        Case("GRAY8", args={"limit": 4, "tiles": [2, 3]}),
        Case("GRAY8", args={"limit": 4, "tiles": 4}),
        Case("GRAY8", args={"limit": 2, "tiles": 8}),
        Case("YUV420P8", args={"limit": 10, "tiles": [4, 8]}),
        Case("YUV420P8", args={"limit": 2, "tiles": 2}),
        Case("YUV420P16", args={"limit": 1024, "tiles": [8, 2]}),
        Case("YUV444P8", args={"limit": 2, "tiles": [2, 4]}),
        Case("YUV444P16", args={"limit": 2560, "tiles": [2, 8]}),
        Case("GRAY16", "odd", args={"limit": 2560, "tiles": 4}),
        Case("GRAY16", "tiny", args={"limit": 4, "tiles": 3}),
        Case("YUV420P16", "odd", args={"limit": 4, "tiles": 3}),
        Case("YUV420P16", "tiny", args={"limit": 4, "tiles": 3}),
        Case("YUV444P16", "odd", args={"limit": 4, "tiles": 3}),
        Case("YUV420P8", "tiny", args={"limit": 4, "tiles": 3}),
        Case("RGB24", args={"limit": 10, "tiles": [4, 8]}),
        Case("RGB24", args={"limit": 2, "tiles": 2}),
        Case("RGB48", args={"limit": 2560, "tiles": [8, 2]}),
        Case("RGB24", "odd", args={"limit": 4, "tiles": 3}),
        Case("RGB48", "tiny", args={"limit": 4, "tiles": 3}),
    ]
    # extra self-pinned coverage
    + [
        Case("GRAY16", args={"limit": 0}),
        Case("GRAY16", args={"tiles": [1, 1]}),
    ]
)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_golden(golden, make_clip, case):
    clip = make_clip(case.fmt, case.geometry)
    out = clahe(clip, **case.args)
    golden.check("clahe", case, out)


@pytest.mark.parametrize(
    "fmt,args",
    [
        ("GRAY8", {}),
        ("GRAY8", {"limit": 2, "tiles": [4, 2]}),
        ("GRAY8", {"limit": 100}),
        ("GRAY16", {"tiles": [3, 3]}),
        ("GRAY8", {"tiles": [1, 1]}),
    ],
    ids=str,
)
def test_matches_literal_oracle(make_seeded_clip, fmt, args):
    clip = crop_abs(make_seeded_clip(fmt), width=64, height=48, left=100, top=60)
    out = np.asarray(clahe(clip, **args).planes[0][0])
    full = dict(limit=7, tiles=[3, 3])
    full.update(args)
    tiles = full["tiles"] if isinstance(full["tiles"], list) else [full["tiles"]]
    tx = tiles[0]
    ty = tiles[1] if len(tiles) == 2 else tx
    ref = clahe_ref(np.asarray(clip.planes[0][0]), full["limit"], tx, ty)
    np.testing.assert_array_equal(out, ref)


def test_color_range_prop(make_clip):
    out = clahe(make_clip("GRAY8"))
    assert out.props["_ColorRange"] == 0


def test_errors(make_clip):
    with pytest.raises(VSZipError, match="only 8 or 16 bit int formats"):
        clahe(make_clip("GRAYS"))
    with pytest.raises(VSZipError, match="only 8 or 16 bit int formats"):
        clahe(make_clip("GRAY10"))
    with pytest.raises(VSZipError, match="more than 2 values"):
        clahe(make_clip("GRAY8"), tiles=[2, 2, 2])
    with pytest.raises(VSZipError, match="must be >= 1"):
        clahe(make_clip("GRAY8"), tiles=[0])
    with pytest.raises(VSZipError, match="must not exceed"):
        clahe(make_clip("YUV420P8"), tiles=[500, 3])
