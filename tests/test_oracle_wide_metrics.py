"""XPSNR and SSIMULACRA2 against the literal oracles in tests/oracle/ at
the shapes where the removed hand-written band kernels used to take over
(1080p luma blocks of 64 pixels; planes at least 128 wide)."""

import numpy as np
import pytest

from fixtures import seeded_plane
from vszip_tpu import Clip, get_format
from vszip_tpu.ops.boxblur import boxblur

W = 160


@pytest.mark.parametrize("fps", [24, 60])
def test_xpsnr_1080p_blocks(fps):
    """1920x1080 gives the 64-pixel blocks of the common HD case."""
    from oracle.xpsnr_ref import wsse_frame_ref
    from vszip_tpu.ops.xpsnr import _xpsnr_frame_stats

    rng = np.random.default_rng(fps)
    n, (w, h) = 3, (1920, 1080)
    widths, heights = (w, w // 2, w // 2), (h, h // 2, h // 2)
    orgs = [seeded_plane((n, hh, ww), np.uint16, fps) >> 6
            for ww, hh in zip(widths, heights)]
    recs = [np.clip(p.astype(np.int32) + rng.integers(-6, 7, p.shape), 0,
                    1023).astype(np.uint16) for p in orgs]
    got = np.asarray(_xpsnr_frame_stats(tuple(orgs), tuple(recs), 10, fps,
                                        True, (widths, heights)))
    for f in range(n):
        want = wsse_frame_ref(
            [o[f] for o in orgs], [r[f] for r in recs],
            orgs[0][f - 1] if f >= 1 else None,
            orgs[0][f - 2] if f >= 2 else None,
            widths, heights, 10, fps, True)
        np.testing.assert_allclose(got[f], want, rtol=0, atol=1,
                                   err_msg=f"frame {f}")


def test_ssimulacra2_wide():
    from oracle.ssimulacra2_ref import ssimulacra2_frame_ref
    from vszip_tpu.ops.ssimulacra2 import ssimulacra2

    fmt = get_format("RGBS")
    p1 = tuple(seeded_plane((1, 128, W), np.float32, s) for s in (1, 2, 3))
    p2 = tuple(np.asarray(p) for p in boxblur(
        Clip.from_planes(p1, fmt), hradius=2, vradius=2).planes)
    lin = {"_Transfer": 8}
    got = float(np.asarray(ssimulacra2(
        Clip.from_planes(p1, fmt, lin),
        Clip.from_planes(p2, fmt, lin)).props["SSIMULACRA2"])[0])
    want = ssimulacra2_frame_ref([p[0] for p in p1], [p[0] for p in p2])
    assert got == pytest.approx(want, rel=1e-3, abs=0.05)
