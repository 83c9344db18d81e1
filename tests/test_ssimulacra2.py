"""SSIMULACRA2 tests (golden scores + behavioral contracts mirroring the
reference's test_ssimulacra2.py strategy)."""

import numpy as np
import pytest

from golden import Case
from vszip_tpu import VSZipError
from vszip_tpu.ops.boxblur import boxblur
from vszip_tpu.ops.ssimulacra2 import ssimulacra2

# The reference's exact sweep (reference tests/test_ssimulacra2.py:37-55):
# formats spanning each accepted color family x the three distortion recipes
# + hand-picked format x distortion interactions.  All 15 case ids exist in
# the reference's goldens/ssimulacra2.json, so every comparison below is
# REFERENCE-pinned.
from golden import sweep

CASES = (
    sweep(
        base_fmt="YUV420P16",
        base_args={"dist": "blur1"},
        formats=("YUV420P8", "YUV420P16", "RGB24", "RGBS", "GRAY8", "GRAY16"),
        args=({"dist": "resize"}, {"dist": "blur1"}, {"dist": "blur3"}),
        geometries=("odd", "tiny"),
    )
    + [
        Case("RGBS", args={"dist": "resize"}),
        Case("RGB24", args={"dist": "blur3"}),
        Case("YUV420P8", args={"dist": "resize"}),
        Case("YUV420P16", args={"dist": "blur3"}),
        Case("GRAY16", args={"dist": "resize"}),
        Case("GRAY8", args={"dist": "blur3"}),
    ]
)


def _distort(clip, kind):
    """The reference's distortion recipes (reference
    tests/test_ssimulacra2.py:17-26): VS-core std.BoxBlur (bit-faithful
    NumPy, tests/vsstd.py) and zimg Bicubic 2x up + back down
    (vszip_tpu.resize, zimg-exact Q14 for integer formats)."""
    if kind == "resize":
        from vszip_tpu import resize

        up = resize(clip, clip.width * 2, clip.height * 2)
        return resize(up, clip.width, clip.height)
    r = {"blur1": 1, "blur3": 3}[kind]
    from vsstd import boxblur as std_boxblur

    return std_boxblur(clip, hradius=r, vradius=r)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_golden(golden, make_clip, case):
    """REFERENCE-pinned scores at rel=1e-3 with a documented 0.08 absolute
    floor carried only by the three YUV blur1 (lowest-distortion) cases.
    Round-5 forensic (benchmarks/forensic_ssim2_r05.py) settled WHERE the
    0.031-0.077 residual lives: composing the whole chain in ideal f64
    NumPy (zimg-weights upsample + BT.709 matrix + exact sRGB EOTF +
    literal metric oracle) reproduces THIS REPO's score to 2.5e-5 and
    differs from the reference binary by the same 0.033 — i.e. the repo
    computes the ideal-chain value and the residual is the reference
    stack's own approximation (zimg's approximate-gamma vector
    polynomials, strongest for the dark/out-of-gamut negatives YUV 4:2:0
    produces; coefficients unavailable in this environment).  Eliminated
    this round: upsample staging (Q14 int vs float sequential-FMA,
    <=0.002 apart), f64-exact EOTF (+-1e-5), canonical EOTF constants
    (~0.0008), clamp0/clamp01/mirror out-of-range rules (move scores the
    wrong way by up to 6.2), input LSB noise (a whole-plane +-1 LSB
    perturbation moves the score 0.0002).  Mixed residual signs
    (+0.077/-0.031/-0.033) are the reference's approximation noise."""
    clip = make_clip(case.fmt, case.geometry)
    out = ssimulacra2(clip, _distort(clip, case.args["dist"]))
    golden.check_value(
        "ssimulacra2", case, float(np.asarray(out.props["SSIMULACRA2"])[0]),
        rel=1e-3, abs_=0.08,
    )


@pytest.mark.parametrize("crop", [(96, 64), (13, 7)], ids=["small", "tiny"])
def test_matches_literal_oracle(make_seeded_clip, crop):
    """Metric math pinned independently of the op's own goldens: sequential
    NumPy transcription of reference src/filters/ssimulacra2.zig:46-663
    (tests/oracle/ssimulacra2_ref.py) vs the op on linear RGB input
    (_Transfer=8 skips the sRGB EOTF on both sides)."""
    from oracle.ssimulacra2_ref import ssimulacra2_frame_ref
    from vszip_tpu import Clip, get_format

    cw, ch = crop
    src = make_seeded_clip("RGBS")
    p1 = [np.asarray(p)[:, 100 : 100 + ch, 200 : 200 + cw] for p in src.planes]
    p2 = [np.asarray(p) for p in
          boxblur(Clip.from_planes(tuple(p1), get_format("RGBS")),
                  hradius=2, vradius=2).planes]
    lin = {"_Transfer": 8}
    c1 = Clip.from_planes(tuple(p1), get_format("RGBS"), lin)
    c2 = Clip.from_planes(tuple(p2), get_format("RGBS"), lin)
    got = float(np.asarray(ssimulacra2(c1, c2).props["SSIMULACRA2"])[0])
    want = ssimulacra2_frame_ref([p[0] for p in p1], [p[0] for p in p2])
    assert got == pytest.approx(want, rel=1e-3, abs=0.05)


def test_reference_anchor():
    """The reference's golden recipe — BICUBIC-converted src16, bicubic 2x
    up then back down (reference tests/test_ssimulacra2.py:9-10,74-76) —
    scores 68.62493918303275 there.  With the zimg-exact Q14 conversion and
    resize, this repo lands within 0.011 of that; assert 0.1 to leave
    headroom for compiler-level float drift only."""
    from fixtures import convert, source_rgb24
    from vszip_tpu import resize

    clip = convert(source_rgb24(), "YUV420P16", filt="bicubic")
    dist = resize(resize(clip, 1280, 640), 640, 320)
    s = float(np.asarray(ssimulacra2(clip, dist).props["SSIMULACRA2"])[0])
    assert abs(s - 68.62493918303275) < 0.1


def test_identical_constant_clip():
    """Reference contract: identical constant clips score exactly 100
    (reference tests/test_ssimulacra2.py:66-68)."""
    from vszip_tpu import Clip, get_format

    planes = (
        np.full((1, 64, 64), 30000, np.uint16),
        np.full((1, 32, 32), 20000, np.uint16),
        np.full((1, 32, 32), 40000, np.uint16),
    )
    clip = Clip.from_planes(planes, get_format("YUV420P16"))
    s = float(np.asarray(ssimulacra2(clip, clip).props["SSIMULACRA2"])[0])
    assert s == 100.0


def test_identical_high(make_clip):
    clip = make_clip("YUV420P16")
    s = float(np.asarray(ssimulacra2(clip, clip).props["SSIMULACRA2"])[0])
    assert s > 99.0


def test_monotonic_with_distortion(make_clip):
    clip = make_clip("YUV420P16")
    s1 = float(np.asarray(ssimulacra2(clip, _distort(clip, "blur1")).props["SSIMULACRA2"])[0])
    s2 = float(np.asarray(ssimulacra2(clip, _distort(clip, "blur3")).props["SSIMULACRA2"])[0])
    assert s2 < s1 < 99.0


def test_symmetry_not_required_but_sane(make_clip):
    clip = make_clip("YUV420P16")
    d = _distort(clip, "blur1")
    ab = float(np.asarray(ssimulacra2(clip, d).props["SSIMULACRA2"])[0])
    ba = float(np.asarray(ssimulacra2(d, clip).props["SSIMULACRA2"])[0])
    assert abs(ab - ba) < 20  # asymmetric metric, same ballpark


def test_output_carries_reference_planes(make_clip):
    clip = make_clip("YUV420P16")
    out = ssimulacra2(clip, _distort(clip, "blur1"))
    np.testing.assert_array_equal(np.asarray(out.planes[0]), np.asarray(clip.planes[0]))


def test_errors(make_clip):
    from fixtures import crop_abs

    clip = make_clip("YUV420P16")
    with pytest.raises(VSZipError, match="same dimensions"):
        ssimulacra2(clip, crop_abs(clip, 64, 64))
    with pytest.raises(VSZipError, match="half precision"):
        ssimulacra2(make_clip("YUV444PH"), make_clip("YUV444PH"))
