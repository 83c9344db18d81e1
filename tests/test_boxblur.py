"""BoxBlur tests: golden snapshots, literal-oracle cross-checks, algebraic
identities, and create-time validation errors (mirrors the reference's
tests/test_boxblur.py strategy)."""

import numpy as np
import pytest

from fixtures import crop_abs
from golden import Case, sweep
from oracle.boxblur_ref import boxblur_ref
from vszip_tpu import VSZipError
from vszip_tpu.ops.boxblur import boxblur

# The reference's exact case list (reference tests/test_boxblur.py:13-49), so
# every id resolves against the reference's own goldens/boxblur.json values.
# Radii straddle the comptime/runtime dispatch boundary (1..22 -> comptime,
# 23+/asymmetric/multipass -> runtime).
CASES = (
    sweep(
        base_fmt="GRAY16",
        base_args={"hradius": 2, "vradius": 2},
        formats=("GRAY8", "GRAY16", "GRAYH", "GRAYS", "YUV420P8", "YUV420P16",
                 "RGBS"),
        args=(
            {"hradius": 1, "vradius": 1},
            {"hradius": 8, "vradius": 8},
            {"hradius": 22, "vradius": 22},
            {"hradius": 23, "vradius": 23},
            {"hradius": 40, "vradius": 40},
            {"hradius": 4, "vradius": 9},
            {"hradius": 9, "vradius": 4},
            {"hradius": 7, "vradius": 0, "vpasses": 0},
            {"hradius": 0, "hpasses": 0, "vradius": 7},
            {"hradius": 5, "vradius": 5, "hpasses": 2, "vpasses": 1},
            {"hradius": 5, "vradius": 5, "hpasses": 1, "vpasses": 2},
            {"hradius": 5, "vradius": 5, "hpasses": 3, "vpasses": 3},
        ),
        geometries=("odd", "tiny"),
    )
    + [
        Case("YUV420P16", args={"hradius": 5, "vradius": 5, "planes": [0]}),
        Case("YUV420P16", args={"hradius": 5, "vradius": 5, "planes": [1, 2]}),
        Case("RGBS", args={"hradius": 6, "vradius": 3, "hpasses": 2, "vpasses": 3}),
        Case("GRAYH", args={"hradius": 6, "vradius": 3, "hpasses": 2, "vpasses": 2}),
    ]
    # extra self-pinned coverage beyond the reference list (subsampling
    # variants + large-format sanity)
    + [
        Case("YUV422P16", args={"hradius": 13, "vradius": 13}),
        Case("YUV440P8", args={"hradius": 13, "vradius": 13}),
        Case("RGB48", args={"hradius": 13, "vradius": 13}),
        Case("YUV444PS", args={"hradius": 13, "vradius": 13}),
    ]
)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_golden(golden, make_clip, case):
    clip = make_clip(case.fmt, case.geometry)
    out = boxblur(clip, **case.args)
    golden.check("boxblur", case, out)


# Reference-pinned literal averages (reference tests/test_boxblur.py:59-64,
# values carried from its old .vpy suite; same source pipeline).
REF_AVGS = [
    ("GRAYS", {"hradius": 30, "vradius": 60, "hpasses": 6, "vpasses": 8},
     0.49595518544825606),
    ("GRAYS", {"hradius": 3, "vradius": 3}, 0.49599070191539796),
    ("GRAY16", {"hradius": 30, "vradius": 33, "hpasses": 1, "vpasses": 3},
     0.4867611337214847),
    ("GRAY16", {"hradius": 10, "vradius": 10}, 0.4869014934022612),
]


@pytest.mark.parametrize(("fmt", "args", "expected"), REF_AVGS,
                         ids=lambda v: str(v)[:32])
def test_reference_literal_averages(make_clip, fmt, args, expected):
    from golden import plane_stats

    out = boxblur(make_clip(fmt), **args)
    assert plane_stats(out)["avg"] == pytest.approx(expected, rel=1e-6)


ORACLE_CASES = [
    ("GRAY8", {"hradius": 3, "vradius": 3}),          # comptime int
    ("GRAY16", {"hradius": 5, "vradius": 5}),          # comptime int 16-bit
    ("GRAY16", {"hradius": 2, "vradius": 7}),          # runtime int asym
    ("GRAY16", {"hradius": 4, "vradius": 4, "hpasses": 3, "vpasses": 2}),
    ("GRAY8", {"hradius": 30, "vradius": 30}),         # runtime large radius
    ("GRAYS", {"hradius": 3, "vradius": 3}),           # comptime float
    ("GRAYS", {"hradius": 2, "vradius": 5}),           # runtime float
    ("GRAYH", {"hradius": 3, "vradius": 3}),           # comptime f16
    ("GRAYH", {"hradius": 6, "vradius": 2, "hpasses": 2}),
    ("GRAY16", {"hradius": 5, "vradius": 0, "vpasses": 0}),  # h only
    ("GRAY16", {"hradius": 0, "hpasses": 0, "vradius": 5}),  # v only
]


@pytest.mark.parametrize("fmt,args", ORACLE_CASES, ids=lambda v: str(v))
def test_matches_literal_oracle(make_seeded_clip, fmt, args):
    """The vectorized op must match the sequential per-pixel oracle:
    bit-exact for ints, close for floats."""
    clip = crop_abs(make_seeded_clip(fmt), width=72, height=64, left=50, top=30)
    out = np.asarray(boxblur(clip, **args).planes[0][0])
    ref = boxblur_ref(np.asarray(clip.planes[0][0]), **args)
    if np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(out, ref)
    else:
        ref32 = ref.astype(np.float32)
        out32 = out.astype(np.float32)
        atol = 2e-3 if ref.dtype == np.float16 else 2e-6
        np.testing.assert_allclose(out32, ref32, rtol=1e-5, atol=atol)


def test_h_then_v_matches_hv(make_clip):
    """H-only then V-only == combined blur (runtime path composition)."""
    clip = make_clip("GRAY16")
    sep = boxblur(
        boxblur(clip, hradius=9, vradius=0, vpasses=0),
        hradius=0, hpasses=0, vradius=9,
    )
    # hr=9,vr=9 single-pass picks the comptime path; force runtime by passes
    both = boxblur(clip, hradius=9, vradius=9, hpasses=1, vpasses=2)
    once_more = boxblur(sep, hradius=0, hpasses=0, vradius=9)
    np.testing.assert_array_equal(
        np.asarray(both.planes[0]), np.asarray(once_more.planes[0])
    )


def test_pass_composition(make_clip):
    """blur(p=2) == blur(p=1) twice (runtime path is per-pass identical)."""
    clip = make_clip("GRAY16")
    two = boxblur(clip, hradius=6, vradius=0, vpasses=0, hpasses=2)
    one_one = boxblur(
        boxblur(clip, hradius=6, vradius=0, vpasses=0),
        hradius=6, vradius=0, vpasses=0,
    )
    np.testing.assert_array_equal(
        np.asarray(two.planes[0]), np.asarray(one_one.planes[0])
    )


def test_plane_passthrough(make_clip):
    clip = make_clip("YUV420P16")
    out = boxblur(clip, planes=[0], hradius=5, vradius=5)
    np.testing.assert_array_equal(np.asarray(out.planes[1]), np.asarray(clip.planes[1]))
    np.testing.assert_array_equal(np.asarray(out.planes[2]), np.asarray(clip.planes[2]))
    assert not np.array_equal(np.asarray(out.planes[0]), np.asarray(clip.planes[0]))


def test_flat_input_invariant(make_clip):
    """A constant plane stays constant under any box blur."""
    from vszip_tpu import Clip, get_format

    clip = Clip.blank(get_format("GRAY16"), 64, 48, value=31337)
    out = boxblur(clip, hradius=7, vradius=7)
    np.testing.assert_array_equal(np.asarray(out.planes[0]), 31337)
    outf = boxblur(Clip.blank(get_format("GRAYS"), 64, 48, value=0.625), hradius=4, vradius=9)
    np.testing.assert_allclose(np.asarray(outf.planes[0]), 0.625, rtol=1e-6)


def test_errors(make_clip):
    clip = make_clip("GRAY8")
    with pytest.raises(VSZipError, match="nothing to be performed"):
        boxblur(clip, hradius=0, vradius=0)
    with pytest.raises(VSZipError, match="hradius too large"):
        boxblur(clip, hradius=400, vradius=1)
    with pytest.raises(VSZipError, match="vradius too large"):
        boxblur(clip, hradius=1, vradius=300)
    with pytest.raises(VSZipError, match="plane index out of range"):
        boxblur(clip, planes=[1], hradius=1, vradius=1)
    with pytest.raises(VSZipError, match="plane specified twice"):
        boxblur(make_clip("YUV420P8"), planes=[0, 0], hradius=1, vradius=1)
    with pytest.raises(VSZipError, match="not supported Int format"):
        boxblur(make_clip("GRAY32"), hradius=1, vradius=1)
