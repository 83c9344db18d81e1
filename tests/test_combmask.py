"""CombMask + CombMaskMT tests (temporal fixture for the motion path)."""

import numpy as np
import pytest

from fixtures import crop_abs
from golden import Case, sweep
from oracle.pointwise_ref import comb_mask_mt_ref, comb_mask_ref
from vszip_tpu import VSZipError
from vszip_tpu.ops.comb_mask import comb_mask
from vszip_tpu.ops.comb_mask_mt import comb_mask_mt

# The reference's exact case lists (reference tests/test_combmask.py:31-106):
# both filters share goldens/combmask.json, keys prefixed via the variant tag.
from golden import grid  # noqa: E402

CASES = (
    sweep(
        base_fmt="GRAY8",
        base_args={"cthresh": 8, "mthresh": 50},
        formats=("GRAY8", "YUV420P8", "YUV444P8"),
        args=grid(cthresh=[4, 8, 16, 32])
        + grid(mthresh=[0, 50, 100, 150])
        + [
            {"cthresh": 8, "mthresh": 50, "metric": 1},
            {"cthresh": 8, "mthresh": 0, "metric": 1},
            {"cthresh": 8, "mthresh": 50, "expand": False},
            {"cthresh": 8, "mthresh": 50, "metric": 1, "expand": False},
            {"cthresh": 8, "mthresh": 0, "expand": False},
            {"cthresh": 8, "mthresh": 0, "metric": 1, "expand": False},
            {"cthresh": 400, "mthresh": 50, "metric": 1},
        ],
        geometries=("odd", "tiny"),
        variant="CombMask",
    )
    + [
        Case("GRAY8", args={}, variant="CombMask"),
        Case("YUV420P8", args={"cthresh": 16, "mthresh": 100, "metric": 1,
                               "expand": False}, variant="CombMask"),
        Case("YUV420P8", args={"cthresh": 8, "mthresh": 0, "metric": 1},
             variant="CombMask"),
    ]
)

MT_CASES = (
    sweep(
        base_fmt="GRAY8",
        base_args={"thY1": 30, "thY2": 30},
        formats=("GRAY8", "YUV420P8", "YUV444P8"),
        args=[
            {"thY1": 10, "thY2": 10},
            {"thY1": 60, "thY2": 60},
            {"thY1": 100, "thY2": 100},
            {"thY1": 0, "thY2": 255},
            {"thY1": 10, "thY2": 200},
            {"thY1": 30, "thY2": 120},
            {"thY1": 0, "thY2": 0},
            {"thY1": 255, "thY2": 255},
            {"thY1": 0, "thY2": 30},
            {"thY1": 200, "thY2": 255},
        ],
        geometries=("odd", "tiny"),
        variant="CombMaskMT",
    )
    + [
        Case("GRAY8", args={}, variant="CombMaskMT"),
        Case("YUV420P8", args={"thY1": 0, "thY2": 255}, variant="CombMaskMT"),
        Case("YUV444P8", args={"thY1": 20, "thY2": 150}, variant="CombMaskMT"),
    ]
)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_combmask_golden(golden, make_temporal_clip, case):
    clip = make_temporal_clip(case.fmt, case.geometry)
    out = comb_mask(clip, **case.args)
    golden.check("combmask", case, out, n=1)


@pytest.mark.parametrize("case", MT_CASES, ids=str)
def test_combmask_mt_golden(golden, make_clip, case):
    clip = make_clip(case.fmt, case.geometry)
    out = comb_mask_mt(clip, **case.args)
    golden.check("combmask", case, out, n=0)


@pytest.mark.parametrize(
    "args",
    [
        {},
        {"metric": True, "cthresh": 80},
        {"mthresh": 0},
        {"expand": False},
        {"cthresh": 3, "mthresh": 30},
    ],
    ids=str,
)
def test_combmask_matches_oracle(make_seeded_temporal_clip, args):
    clip = crop_abs(make_seeded_temporal_clip("GRAY8"), width=40, height=32, left=80, top=50)
    out = comb_mask(clip, **args)
    full = dict(cthresh=6, mthresh=9, expand=True, metric=False)
    full.update(args)
    frames = np.asarray(clip.planes[0])
    for n in range(clip.num_frames):
        prev = frames[max(0, n - 1)]
        ref = comb_mask_ref(frames[n], prev, full["cthresh"], full["mthresh"],
                            full["expand"], full["metric"])
        np.testing.assert_array_equal(np.asarray(out.planes[0][n]), ref, err_msg=f"frame {n}")


@pytest.mark.parametrize("thy", [(30, 30), (10, 60), (0, 0)])
def test_combmask_mt_matches_oracle(make_seeded_clip, thy):
    clip = crop_abs(make_seeded_clip("GRAY8"), width=40, height=32, left=80, top=50)
    out = comb_mask_mt(clip, thY1=thy[0], thY2=thy[1])
    ref = comb_mask_mt_ref(np.asarray(clip.planes[0][0]), thy[0], thy[1])
    np.testing.assert_array_equal(np.asarray(out.planes[0][0]), ref)


def test_first_frame_motion_blank(make_temporal_clip):
    """With motion enabled, frame 0 compares against itself -> all zeros."""
    clip = make_temporal_clip("GRAY8")
    out = comb_mask(clip, mthresh=9)
    assert (np.asarray(out.planes[0][0]) == 0).all()


def test_errors(make_clip):
    clip = make_clip("GRAY8")
    with pytest.raises(VSZipError, match="cthresh must be between 0 and 255"):
        comb_mask(clip, cthresh=256)
    with pytest.raises(VSZipError, match="cthresh must be between 0 and 65025"):
        comb_mask(clip, cthresh=70000, metric=True)
    with pytest.raises(VSZipError, match="mthresh must be between"):
        comb_mask(clip, mthresh=256)
    with pytest.raises(VSZipError, match="only 8 bit int"):
        comb_mask(make_clip("GRAY16"))
    with pytest.raises(VSZipError, match="thY1 can't be greater"):
        comb_mask_mt(clip, thY1=50, thY2=10)
    with pytest.raises(VSZipError, match="only 8 bit int"):
        comb_mask_mt(make_clip("GRAYS"))
