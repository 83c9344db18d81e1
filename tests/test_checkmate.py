"""Checkmate tests (temporal fixture)."""

import numpy as np
import pytest

from fixtures import crop_abs
from golden import Case, sweep
from oracle.pointwise_ref import checkmate_ref
from vszip_tpu import VSZipError
from vszip_tpu.ops.checkmate import checkmate

# The reference's exact case list (reference tests/test_checkmate.py:15-63).
from golden import grid  # noqa: E402

CASES = (
    sweep(
        base_fmt="GRAY8",
        base_args={"thr": 12, "tmax": 12, "tthr2": 0},
        formats=("GRAY8", "YUV420P8", "YUV422P8", "YUV444P8"),
        args=grid(thr=[4, 12, 40], tmax=[1, 12, 64])
        + [
            {"thr": 12, "tmax": 12, "tthr2": 4},
            {"thr": 12, "tmax": 12, "tthr2": 16},
            {"thr": 12, "tmax": 12, "tthr2": 64},
            {"thr": 4, "tmax": 4, "tthr2": 8},
            {"thr": 40, "tmax": 64, "tthr2": 32},
        ],
        geometries=("odd", "tiny"),
    )
    + [
        Case("GRAY8", args={"thr": 0, "tmax": 1, "tthr2": 0}),
        Case("GRAY8", args={"thr": 255, "tmax": 255, "tthr2": 0}),
        Case("YUV420P8", args={"thr": 14, "tmax": 11, "tthr2": 4}),
        Case("YUV422P8", args={"thr": 14, "tmax": 11, "tthr2": 8}),
    ]
)

RGB_CASES = [
    Case("RGB24", args={"thr": 12, "tmax": 12, "tthr2": 0}),
    Case("RGB24", args={"thr": 14, "tmax": 11, "tthr2": 8}),
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_golden(golden, make_temporal_clip, case):
    clip = make_temporal_clip(case.fmt, case.geometry)
    out = checkmate(clip, **case.args)
    golden.check("checkmate", case, out, n=1)


@pytest.mark.parametrize("case", RGB_CASES, ids=str)
def test_golden_rgb(golden, case):
    """RGB24 path straight from the temporal RGB source
    (reference tests/test_checkmate.py:54-63)."""
    from fixtures import temporal_rgb24

    out = checkmate(temporal_rgb24(), **case.args)
    golden.check("checkmate", case, out, n=1)


# Frame-1 averages (reference tests/test_checkmate.py:70-73).
REF_AVGS = [
    ({"thr": 12, "tmax": 12, "tthr2": 0}, 0.4871367378982843),
    ({"thr": 14, "tmax": 11, "tthr2": 4}, 0.48752056525735293),
]


@pytest.mark.parametrize(("args", "expected"), REF_AVGS, ids=lambda v: str(v)[:24])
def test_reference_literal_averages(make_temporal_clip, args, expected):
    from golden import plane_stats

    out = checkmate(make_temporal_clip("GRAY8"), **args)
    assert plane_stats(out, n=1)["avg"] == pytest.approx(expected, rel=1e-6)


@pytest.mark.parametrize(
    "args", [{}, {"tthr2": 10}, {"thr": 40, "tmax": 3}, {"tmax": 255}], ids=str
)
def test_matches_literal_oracle(make_seeded_temporal_clip, args):
    clip = crop_abs(make_seeded_temporal_clip("GRAY8"), width=32, height=24, left=90, top=40)
    out = checkmate(clip, **args)
    full = dict(thr=12, tmax=12, tthr2=0)
    full.update(args)
    frames = np.asarray(clip.planes[0])
    for n in range(clip.num_frames):
        ref = checkmate_ref(frames, n, full["thr"], full["tmax"], full["tthr2"])
        np.testing.assert_array_equal(
            np.asarray(out.planes[0][n]), ref, err_msg=f"frame {n}"
        )


def test_edge_rows_passthrough(make_temporal_clip):
    clip = make_temporal_clip("GRAY8")
    out = checkmate(clip)
    src = np.asarray(clip.planes[0])
    got = np.asarray(out.planes[0])
    np.testing.assert_array_equal(got[:, :2], src[:, :2])
    np.testing.assert_array_equal(got[:, -2:], src[:, -2:])


def test_errors(make_clip):
    clip = make_clip("GRAY8")
    with pytest.raises(VSZipError, match="tmax value should be in range"):
        checkmate(clip, tmax=0)
    with pytest.raises(VSZipError, match="tthr2 should be non-negative"):
        checkmate(clip, tthr2=-1)
    with pytest.raises(VSZipError, match="thr value should be in range"):
        checkmate(clip, thr=256)
    with pytest.raises(VSZipError, match="only 8 bit int"):
        checkmate(make_clip("GRAY16"))
