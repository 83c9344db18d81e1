"""PlaneMinMax: (thresholded) per-plane min/max + optional diff vs clipb.

Reference: src/filters/planeminmax.zig + src/vapoursynth/planeminmax.zig.
With ``minthr``/``maxthr`` > 0 the reference builds a histogram (floats are
binned at ``u16(v*65535 + 0.5)``, clamped) and walks from each end until the
cumulative count exceeds ``trunc(total*thr)``.  The walk is a monotone
threshold search, so here it is a 17-step vectorized binary search over the
bin range (identical result, no scatter/histogram).  With both thr 0
it's a plain min/max.  Props ``{prop}Min/Max/Diff`` on a copy of clipa.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.clip import Clip
from ..core.format import ColorFamily, SampleType
from ..core.params import VSZipError, compare_clips, parse_planes, require

FILTER_NAME = "PlaneMinMax"


def _bin_index(x, is_int: bool):
    if is_int:
        return x.astype(jnp.int32)
    v = x.astype(jnp.float32) * jnp.float32(65535.0) + jnp.float32(0.5)
    # lossyCast u16: clamp then truncate
    return jnp.clip(v, 0.0, 65535.0).astype(jnp.int32)


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _minmax_thr(x, hist_size: int, minthr: float, maxthr: float, is_int: bool):
    import numpy as np

    bins = _bin_index(x, is_int)
    n = x.shape[0]
    total = float(x.shape[1] * x.shape[2])
    # reference truncates total * f32(thr) (src/filters/planeminmax.zig:40-41)
    totalmin = float(np.trunc(total * np.float64(np.float32(minthr))))
    totalmax = float(np.trunc(total * np.float64(np.float32(maxthr))))

    # smallest u with count(bins <= u) > totalmin, else peak
    lo = jnp.zeros((n,), jnp.int32)
    hi = jnp.full((n,), hist_size, jnp.int32)  # exclusive
    # search span is hist_size+1 states, so (hist_size-1).bit_length() is one
    # step short of convergence (caught by the reference's RGB24 minthr=0.1
    # golden: unconverged lo returned 0 where the walk answer is 1)
    steps = max(1, (hist_size + 1).bit_length())
    for _ in range(steps):
        mid = (lo + hi) // 2
        cnt = jnp.sum(
            (bins <= mid[:, None, None]).astype(jnp.float64), axis=(1, 2)
        )
        ok = cnt > totalmin
        hi = jnp.where(ok, mid, hi)
        lo = jnp.where(ok, lo, mid + 1)
    retmin = jnp.minimum(lo, hist_size - 1)

    # largest u with count(bins >= u) > totalmax, else 0
    lo2 = jnp.full((n,), -1, jnp.int32)  # exclusive lower
    hi2 = jnp.full((n,), hist_size - 1, jnp.int32)
    for _ in range(steps):
        mid = (lo2 + hi2 + 1) // 2
        cnt = jnp.sum(
            (bins >= mid[:, None, None]).astype(jnp.float64), axis=(1, 2)
        )
        ok = cnt > totalmax
        lo2 = jnp.where(ok, mid, lo2)
        hi2 = jnp.where(ok, hi2, mid - 1)
    retmax = jnp.maximum(lo2, 0)
    return retmin, retmax


@jax.jit
def _minmax_plain(x):
    return jnp.min(x, axis=(1, 2)), jnp.max(x, axis=(1, 2))


@partial(jax.jit, static_argnums=(2, 3))
def _diff(x, ref, peakf: float, is_int: bool):
    if is_int:
        d = jnp.abs(
            x.astype(jnp.float64) - ref.astype(jnp.float64)
        )
    else:
        d = jnp.abs(x.astype(jnp.float32) - ref.astype(jnp.float32)).astype(jnp.float64)
    diff = jnp.sum(d, axis=(1, 2)) / float(x.shape[1] * x.shape[2])
    if is_int:
        diff = diff / peakf
    return diff


def plane_minmax(clipa: Clip, minthr: float = 0.0, maxthr: float = 0.0,
                 clipb: Clip | None = None, planes=None,
                 prop: str = "psm") -> Clip:
    fmt = clipa.format
    is_int = fmt.sample_type is SampleType.INTEGER
    require(
        not (is_int and fmt.bits_per_sample == 32),
        FILTER_NAME, "not supported Int format.",
    )
    if clipb is not None:
        compare_clips([clipa, clipb], FILTER_NAME, same_len=False, bigger_than=True)
    process = parse_planes(planes, fmt.num_planes, FILTER_NAME, default_all=False)
    if planes is None:
        process = [True] + [False] * (fmt.num_planes - 1)
    for key, thr in (("maxthr", maxthr), ("minthr", minthr)):
        if thr < 0 or thr > 1:
            raise VSZipError(
                f"{FILTER_NAME}: {key} should be a float between 0.0 and 1.0"
            )
    hist_size = 65536 if not is_int else (1 << fmt.bits_per_sample)
    peakf = float(hist_size - 1)
    no_thr = maxthr == 0 and minthr == 0
    do_chroma = any(process[1:])
    if (do_chroma and not no_thr
            and fmt.color_family is ColorFamily.YUV
            and fmt.sample_type is SampleType.FLOAT):
        raise VSZipError(
            f"{FILTER_NAME}: you can't use maxthr/minthr with float chroma, "
            "use planes=[0] or maxthr/minthr=0"
        )

    mins, maxs, diffs = [], [], []
    n = clipa.num_frames
    for p in range(fmt.num_planes):
        if not process[p]:
            continue
        x = clipa.planes[p]
        if no_thr:
            mi, ma = _minmax_plain(x)
            if fmt.sample_type is SampleType.FLOAT:
                mi, ma = mi.astype(jnp.float32), ma.astype(jnp.float32)
        else:
            mi, ma = _minmax_thr(x, hist_size, float(minthr), float(maxthr), is_int)
            if not is_int:
                mi = mi.astype(jnp.float32) / jnp.float32(65535.0)
                ma = ma.astype(jnp.float32) / jnp.float32(65535.0)
        mins.append(mi)
        maxs.append(ma)
        if clipb is not None:
            diffs.append(_diff(x, clipb.planes[p][:n], peakf, is_int))

    props = {
        f"{prop}Min": jnp.stack(mins, axis=-1),
        f"{prop}Max": jnp.stack(maxs, axis=-1),
    }
    if clipb is not None:
        props[f"{prop}Diff"] = jnp.stack(diffs, axis=-1)
    return clipa.with_props(**props)
