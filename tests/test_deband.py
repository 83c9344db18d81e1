"""Deband tests: RNG native-vs-oracle cross-check, per-pixel kernel oracle,
golden sweeps over all 7 sample modes."""

import numpy as np
import pytest

from fixtures import crop_abs
from golden import Case, sweep
from vszip_tpu import VSZipError
from vszip_tpu.ops.deband import deband

# The reference's exact case list (reference tests/test_deband.py:11-56).
from golden import grid  # noqa: E402

CASES = (
    sweep(
        base_fmt="GRAY16",
        base_args={"thr": 48, "grain": 16, "seed": 7},
        formats=("GRAY8", "GRAY16", "GRAYS", "YUV420P8", "YUV420P16", "YUV444PS"),
        args=grid(sample_mode=[1, 2, 3, 4, 5, 6, 7])
        + grid(blur_first=[True, False])
        + grid(range=[1, 8, 31])
        + grid(random_algo_ref=[0, 1, 2])
        + grid(random_algo_grain=[0, 1, 2])
        + [
            {"dynamic_grain": True},
            {"dynamic_grain": False},
        ],
        geometries=("odd", "tiny"),
    )
    + [
        Case("YUV422P16", args={"thr": 48, "grain": 16, "seed": 7}),
        Case("YUV422P8", args={"thr": [48, 24], "grain": [16, 8], "seed": 7}),
        Case("RGB48", args={"thr": 48, "grain": 16, "seed": 7}),
        Case("RGBS", args={"thr": 48, "grain": 16, "seed": 7}),
        Case("YUV420P16", args={"thr": 48, "grain": 16, "seed": 7,
                                "keep_tv_range": True}),
        Case("GRAY16", args={"thr": 48, "grain": 16, "seed": 7,
                             "sample_mode": 5, "thr1": 80, "thr2": 20}),
        Case("GRAY16", args={"thr": 48, "grain": 16, "seed": 7,
                             "sample_mode": 6, "thr1": 80, "thr2": 20}),
        Case("GRAY16", args={"thr": 48, "grain": 16, "seed": 7,
                             "sample_mode": 7, "thr1": 80, "thr2": 20}),
        Case("GRAY16", args={"thr": 48, "grain": 16, "seed": 7,
                             "sample_mode": 7, "angle_boost": 4.0}),
        Case("GRAY16", args={"thr": 48, "grain": 16, "seed": 7,
                             "sample_mode": 7, "max_angle": 0.5}),
        Case("YUV420P16", args={"thr": [48, 24], "grain": [16, 8], "seed": 7}),
        Case("YUV444PS", args={"thr": [48, 24, 12], "grain": [16, 8], "seed": 7}),
        Case("GRAY16", args={"thr": 48, "grain": 16, "seed": 7,
                             "random_algo_ref": 2, "random_param_ref": 2.0}),
        Case("GRAY16", args={"thr": 48, "grain": 16, "seed": 7,
                             "random_algo_grain": 2, "random_param_grain": 2.0}),
        Case("GRAY16", args={"thr": 48, "grain": 16, "seed": 99}),
    ]
)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_golden(golden, make_clip, case):
    clip = make_clip(case.fmt, case.geometry)
    out = deband(clip, **case.args)
    golden.check("deband", case, out, n=0, rel=2e-6)


@pytest.mark.parametrize("mode", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("fmt", ["GRAY16", "GRAYS"])
def test_matches_literal_oracle(make_seeded_clip, fmt, mode):
    from oracle.deband_rng_ref import precompute_ref
    from oracle.deband_ref import deband_plane_ref

    clip = crop_abs(make_seeded_clip(fmt), width=48, height=40, left=120, top=80)
    is_int = fmt == "GRAY16"
    out = deband(clip, sample_mode=mode, grain=8, thr=2.0, thr1=1.5, thr2=1.5)
    pre = precompute_ref(
        w=48, h=40, num_frames=1, seed=0, sample_mode=mode, range_=15,
        ssw=0, ssh=0, algo_ref=1, algo_grain=1, param_ref=1.0,
        param_grain=1.0, is_float=not is_int, dynamic=False,
        add_grain_y=True, add_grain_c=False,
        grain_y=int(np.trunc(8 * 65535.0 / 255.0 + 0.5)) if is_int
        else np.float32(8 / 255.0),
        grain_c=0,
    )
    if is_int:
        thr3 = tuple(int(np.trunc(v * 65535.0 / 255.0 + 0.5)) for v in (2.0, 1.5, 1.5))
        rng = (0, 65535)
    else:
        thr3 = tuple(np.float32(v / 255.0) for v in (2.0, 1.5, 1.5))
        rng = (0.0, 1.0)
    vstride = (48 + 15) & ~15 if is_int else (48 + 7) & ~7  # 32-byte VS rows
    ref = deband_plane_ref(
        np.asarray(clip.planes[0][0]), pre, False, mode, True, True,
        thr3, rng, np.float32(1.5), np.float32(0.15), vstride, "grain_y",
    )
    got = np.asarray(out.planes[0][0])
    if is_int:
        diff = np.abs(got.astype(np.int64) - ref.astype(np.int64))
        if mode in (6, 7):
            assert diff.max() <= 1, f"mode {mode}: max {diff.max()}"
            assert (diff > 0).mean() < 0.01
        else:
            np.testing.assert_array_equal(got, ref, err_msg=f"mode {mode}")
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6)


def test_native_rng_matches_python_oracle():
    from oracle.deband_rng_ref import precompute_ref
    from vszip_tpu.runtime.deband_rng import deband_precompute

    kw = dict(w=36, h=20, num_frames=2, seed=99, sample_mode=2, range_=15,
              ssw=1, ssh=1, algo_ref=1, algo_grain=1, param_ref=1.0,
              param_grain=1.0, is_float=False, dynamic=True,
              add_grain_y=True, add_grain_c=True, grain_y=257, grain_c=514)
    got = deband_precompute(**kw)
    want = precompute_ref(**kw)
    for k in ("ref1_dy", "ref1_dx", "ref2_dy", "ref2_dx", "c_ref1_dy",
              "c_ref1_dx", "c_ref2_dy", "c_ref2_dx", "grain_y", "grain_c",
              "grain_offsets"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_seed_determinism(make_clip):
    clip = make_clip("GRAY16")
    a = np.asarray(deband(clip, seed=5, grain=16).planes[0])
    b = np.asarray(deband(clip, seed=5, grain=16).planes[0])
    c = np.asarray(deband(clip, seed=6, grain=16).planes[0])
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_thr_zero_no_deband_but_grain(make_clip):
    clip = make_clip("GRAY16")
    out = deband(clip, thr=0, grain=0)
    np.testing.assert_array_equal(np.asarray(out.planes[0]), np.asarray(clip.planes[0]))


def test_low_depth_roundtrip(make_clip):
    clip = make_clip("YUV420P8")
    out = deband(clip)
    assert out.format.bits_per_sample == 8
    assert out.planes[0].dtype == np.uint8


def test_errors(make_clip):
    with pytest.raises(VSZipError, match="only 32-bit format"):
        deband(make_clip("YUV444PH"))
    with pytest.raises(VSZipError, match="out of range"):
        deband(make_clip("GRAY16"), sample_mode=8)
    with pytest.raises(VSZipError, match="out of range"):
        deband(make_clip("GRAY16"), range=-1)
