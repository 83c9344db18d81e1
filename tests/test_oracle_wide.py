"""Every op's single XLA formulation against the literal oracles in
tests/oracle/, on seeded content, at the shapes where the removed
hand-written band kernels used to take over: planes at least 128 wide,
radii up to 22, multipass in both axes, several frames (an odd count where
frames used to be paired)."""

import numpy as np
import pytest

from fixtures import seeded_plane
from vszip_tpu import Clip, get_format
from vszip_tpu.ops.boxblur import boxblur
from vszip_tpu.ops.checkmate import checkmate
from vszip_tpu.ops.clahe import clahe
from vszip_tpu.ops.comb_mask import comb_mask
from vszip_tpu.ops.compress import compress
from vszip_tpu.ops.deband import deband
from vszip_tpu.ops.eedi3 import eedi3

W = 160


def _clip(fmt_name, shape, seed=1):
    fmt = get_format(fmt_name)
    return Clip.from_planes((seeded_plane(shape, fmt.storage_dtype, seed),),
                            fmt)


@pytest.mark.parametrize("dtype", ["GRAY8", "GRAY16"])
@pytest.mark.parametrize("args", [
    {"hradius": 13, "vradius": 13},                          # comptime
    {"hradius": 22, "vradius": 22},                          # comptime max
    {"hradius": 22, "vradius": 9},                           # runtime asym
    {"hradius": 5, "vradius": 5, "hpasses": 3, "vpasses": 2},
    {"hradius": 4, "vradius": 6, "hpasses": 1, "vpasses": 4},
], ids=str)
def test_boxblur(dtype, args):
    from oracle.boxblur_ref import boxblur_ref

    clip = _clip(dtype, (2, 72, W))
    out = np.asarray(boxblur(clip, **args).planes[0])
    for n in range(2):
        ref = boxblur_ref(np.asarray(clip.planes[0][n]), **args)
        np.testing.assert_array_equal(out[n], ref, err_msg=f"frame {n}")


@pytest.mark.parametrize("mode,blur_first", [
    (1, True), (2, True), (2, False), (3, True), (4, True), (5, True),
    (6, True), (7, True)])
def test_deband(mode, blur_first):
    from oracle.deband_ref import deband_plane_ref
    from oracle.deband_rng_ref import precompute_ref

    n, h = 3, 40
    clip = _clip("GRAY16", (n, h, W), seed=mode)
    thr, thr1, thr2, grain = 2.0, 1.5, 1.5, 8
    out = np.asarray(deband(clip, sample_mode=mode, blur_first=blur_first,
                            grain=grain, thr=thr, thr1=thr1,
                            thr2=thr2).planes[0])

    def scale(v):
        return int(np.trunc(v * 65535.0 / 255.0 + 0.5))

    pre = precompute_ref(
        w=W, h=h, num_frames=n, seed=0, sample_mode=mode, range_=15,
        ssw=0, ssh=0, algo_ref=1, algo_grain=1, param_ref=1.0,
        param_grain=1.0, is_float=False, dynamic=False, add_grain_y=True,
        add_grain_c=False, grain_y=scale(grain), grain_c=0)
    for f in range(n):
        ref = deband_plane_ref(
            np.asarray(clip.planes[0][f]), pre, False, mode, blur_first,
            True, tuple(scale(v) for v in (thr, thr1, thr2)), (0, 65535),
            np.float32(1.5), np.float32(0.15), W, "grain_y")
        diff = np.abs(out[f].astype(np.int64) - ref.astype(np.int64))
        if mode in (6, 7):
            # pow/atan polynomials: XLA may contract a multiply-add the
            # oracle rounds twice (see test_deband.py)
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01, f
        else:
            np.testing.assert_array_equal(out[f], ref, err_msg=f"frame {f}")


@pytest.mark.parametrize("args", [
    {}, {"limit": 2, "tiles": [4, 2]}, {"tiles": [1, 1]}], ids=str)
def test_clahe_8bit(args):
    from oracle.clahe_ref import clahe_ref

    clip = _clip("GRAY8", (2, 96, 192))
    out = np.asarray(clahe(clip, **args).planes[0])
    full = {"limit": 7, "tiles": [3, 3]}
    full.update(args)
    tx, ty = full["tiles"]
    for n in range(2):
        ref = clahe_ref(np.asarray(clip.planes[0][n]), full["limit"], tx, ty)
        np.testing.assert_array_equal(out[n], ref, err_msg=f"frame {n}")


@pytest.mark.parametrize("args", [
    {"codec": 0, "qscale": 8},
    {"codec": 0, "qscale": 1, "dc_prec": 3},    # the i64 quantizer path
    {"codec": 1, "quality": 50},
    {"codec": 1, "quality": 97},
], ids=str)
def test_compress(args):
    from oracle.compress_ref import compress_block_ref

    h = 48
    clip = _clip("GRAY8", (2, h, W))
    out = np.asarray(compress(clip, **args).planes[0])
    codec = "jpeg" if args["codec"] == 1 else "mpeg2"
    for n in range(2):
        src = np.asarray(clip.planes[0][n])
        for by in range(0, h, 8):
            for bx in range(0, W, 8):
                ref = compress_block_ref(
                    src[by:by + 8, bx:bx + 8], codec,
                    qscale=args.get("qscale", 8),
                    dc_prec=args.get("dc_prec", 0),
                    quality=args.get("quality", 50))
                np.testing.assert_array_equal(
                    out[n, by:by + 8, bx:bx + 8], ref,
                    err_msg=f"frame {n} block ({by},{bx})")


@pytest.mark.parametrize("args", [{}, {"metric": True, "cthresh": 80}],
                         ids=str)
def test_comb_mask(args):
    from oracle.pointwise_ref import comb_mask_ref

    clip = _clip("GRAY8", (3, 48, W))
    out = np.asarray(comb_mask(clip, **args).planes[0])
    full = {"cthresh": 6, "mthresh": 9, "expand": True, "metric": False}
    full.update(args)
    frames = np.asarray(clip.planes[0])
    for n in range(3):
        ref = comb_mask_ref(frames[n], frames[max(0, n - 1)],
                            full["cthresh"], full["mthresh"], full["expand"],
                            full["metric"])
        np.testing.assert_array_equal(out[n], ref, err_msg=f"frame {n}")


@pytest.mark.parametrize("args", [{}, {"tthr2": 10}], ids=str)
def test_checkmate(args):
    from oracle.pointwise_ref import checkmate_ref

    clip = _clip("GRAY8", (5, 48, W))
    out = np.asarray(checkmate(clip, **args).planes[0])
    full = {"thr": 12, "tmax": 12, "tthr2": 0}
    full.update(args)
    frames = np.asarray(clip.planes[0])
    for n in range(5):
        ref = checkmate_ref(frames, n, full["thr"], full["tmax"],
                            full["tthr2"])
        np.testing.assert_array_equal(out[n], ref, err_msg=f"frame {n}")


EEDI3_W = 128


@pytest.mark.parametrize("hp", [False, True], ids=["nonhp", "hp"])
@pytest.mark.parametrize("vcheck", [0, 1, 2, 3])
def test_eedi3(hp, vcheck):
    from oracle.eedi3_ref import eedi3_plane_ref, vcheck_ref

    field, mdis, nrad = 1, 4, 2
    clip = _clip("GRAYS", (2, 20, EEDI3_W))
    out = np.asarray(eedi3(clip, field=field, mdis=mdis, nrad=nrad, hp=hp,
                           vcheck=vcheck).planes[0])
    for n in range(2):
        src = np.asarray(clip.planes[0][n])
        ref, dmap = eedi3_plane_ref(src, field, False, mdis, nrad, 0.2,
                                    0.25, 20.0, hp=hp)
        if vcheck:
            ref = vcheck_ref(src, ref, dmap, field, False, hp, vcheck)
        np.testing.assert_allclose(out[n], ref, rtol=2e-6, atol=2e-7,
                                   err_msg=f"frame {n}")


def test_eedi3_dh_vcheck():
    from oracle.eedi3_ref import eedi3_plane_ref, vcheck_ref

    clip = _clip("GRAYS", (1, 12, EEDI3_W))
    out = np.asarray(eedi3(clip, field=0, dh=True, mdis=3, nrad=1,
                           vcheck=2).planes[0][0])
    src = np.asarray(clip.planes[0][0])
    ref, dmap = eedi3_plane_ref(src, 0, True, 3, 1, 0.2, 0.25, 20.0)
    ref = vcheck_ref(src, ref, dmap, 0, True, False, 2)
    np.testing.assert_allclose(out, ref, rtol=2e-6, atol=2e-7)
