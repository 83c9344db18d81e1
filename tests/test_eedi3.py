"""EEDI3 / EEDI3H tests: literal oracle cross-checks + golden sweeps.

CASES / CASES_H are the reference's exact case lists (reference
tests/test_eedi3.py:22-63), so every id resolves against the reference's
own goldens/eedi3.json / eedi3h.json at the reference suite's default
tolerance rel=1e-6 (tightened from 2e-5 in round 4: with the cost build
mirroring the reference's f32 op order, the Viterbi ranking is stable
and the goldens hold at the reference's own bar)."""

import numpy as np
import pytest

from fixtures import crop_abs
from golden import Case, grid, sweep
from vszip_tpu import VSZipError
from vszip_tpu.ops.eedi3 import eedi3, eedi3h

FLOAT_FMTS = ("GRAYS", "YUV420PS", "YUV444PS", "RGBS")

CASES = (
    sweep(
        base_fmt="GRAYS",
        base_args={"field": 1},
        formats=FLOAT_FMTS,
        args=(
            grid(field=[0])
            + grid(dh=[True])
            + grid(nrad=[0, 3], mdis=[40])
            + grid(hp=[True])
            + grid(vcheck=[0, 1, 3])
            + grid(alpha=[0.4], beta=[0.3], gamma=[40.0])
            + grid(gamma=[0.0])
        ),
    )
    + [
        Case("GRAYS", args={"field": 2}),
        Case("YUV420PS", args={"field": 3, "dh": False}),
        Case("GRAYS", args={"field": 1, "alpha": 0.9, "beta": 0.05,
                            "gamma": 2.0, "mdis": 30}),
    ]
)

CASES_H = (
    sweep(
        base_fmt="GRAYS",
        base_args={"field": 1},
        formats=FLOAT_FMTS,
        args=(
            grid(field=[0])
            + grid(dh=[True])
            + grid(nrad=[3], mdis=[40])
            + grid(hp=[True])
            + grid(vcheck=[0, 3])
        ),
    )
    + [Case("GRAYS", args={"field": 2})]
)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_golden(golden, make_clip, case):
    clip = make_clip(case.fmt, case.geometry)
    out = eedi3(clip, **case.args)
    golden.check("eedi3", case, out, rel=1e-6)


@pytest.mark.parametrize("case", CASES_H, ids=str)
def test_golden_h(golden, make_clip, case):
    clip = make_clip(case.fmt, case.geometry)
    out = eedi3h(clip, **case.args)
    golden.check("eedi3h", case, out, rel=1e-6)


@pytest.mark.parametrize(
    "args",
    [
        {"field": 1, "mdis": 4, "nrad": 2},
        {"field": 0, "mdis": 4, "nrad": 2},
        {"field": 1, "mdis": 4, "nrad": 0},
        {"field": 1, "mdis": 2, "nrad": 1, "dh": True},
        {"field": 1, "mdis": 4, "nrad": 2, "hp": True},
        {"field": 1, "mdis": 3, "nrad": 1, "alpha": 0.4, "beta": 0.3,
         "gamma": 10.0},
    ],
    ids=str,
)
def test_matches_literal_oracle(make_seeded_clip, args):
    from oracle.eedi3_ref import eedi3_plane_ref

    clip = crop_abs(make_seeded_clip("GRAYS"), width=40, height=24, left=100, top=60)
    full = dict(alpha=0.2, beta=0.25, gamma=20.0)
    full.update(args)
    out = eedi3(clip, vcheck=0, **args)
    got = np.asarray(out.planes[0][0])
    ref, _ = eedi3_plane_ref(
        np.asarray(clip.planes[0][0]), full["field"], full.get("dh", False),
        full["mdis"], full["nrad"], full["alpha"], full["beta"],
        full["gamma"], hp=full.get("hp", False),
    )
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7,
                               err_msg=str(args))


def test_kept_lines_pass_through(make_clip):
    clip = make_clip("GRAYS")
    src = np.asarray(clip.planes[0])
    for field in (0, 1):
        out = np.asarray(eedi3(clip, field=field).planes[0])
        np.testing.assert_array_equal(out[:, (1 - field)::2], src[:, (1 - field)::2])


def test_dh_doubles_height(make_clip):
    clip = make_clip("GRAYS")
    out = eedi3(clip, field=1, dh=True)
    assert out.height == clip.height * 2
    outh = eedi3h(clip, field=1, dh=True)
    assert outh.width == clip.width * 2


def test_field_2_doubles_rate(make_clip):
    clip = make_clip("GRAYS")
    out = eedi3(clip, field=2)
    assert out.num_frames == 2 * clip.num_frames


def test_mclip_gates_dp(make_clip):
    from vszip_tpu import Clip, get_format

    clip = make_clip("GRAYS")
    zero_mask = Clip.blank(get_format("GRAY8"), clip.width, clip.height,
                           clip.num_frames, value=0)
    out_masked = np.asarray(eedi3(clip, field=1, vcheck=0,
                                  mclip=zero_mask).planes[0])
    # all-zero mask -> pure vertical interpolation everywhere
    out_plain = np.asarray(eedi3(clip, field=1, vcheck=0).planes[0])
    assert not np.array_equal(out_masked, out_plain)
    full_mask = Clip.blank(get_format("GRAY8"), clip.width, clip.height,
                           clip.num_frames, value=255)
    out_full = np.asarray(eedi3(clip, field=1, vcheck=0,
                                mclip=full_mask).planes[0])
    np.testing.assert_array_equal(out_full, out_plain)


def test_errors(make_clip):
    clip = make_clip("GRAYS")
    with pytest.raises(VSZipError, match="only 32-bit float"):
        eedi3(make_clip("GRAY8"), field=1)
    with pytest.raises(VSZipError, match="field must be 0, 1, 2, or 3"):
        eedi3(clip, field=4)
    with pytest.raises(VSZipError, match="alpha \\+ beta"):
        eedi3(clip, field=1, alpha=0.8, beta=0.8)
    with pytest.raises(VSZipError, match="mdis must be"):
        eedi3(clip, field=1, mdis=41)
    with pytest.raises(VSZipError, match="field must be 0 or 1 when dh"):
        eedi3(clip, field=2, dh=True)
    odd_clip = crop_abs(clip, clip.width, clip.height - 1)
    with pytest.raises(VSZipError, match="height must be mod 2"):
        eedi3(odd_clip, field=1)
