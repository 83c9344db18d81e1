"""CombMask: interlace comb detector with optional motion mask + expansion.

Reference: src/filters/comb_mask.zig + src/vapoursynth/comb_mask.zig.
8-bit only, all planes.  Two metrics (reflect-101 vertical edges):

* metric 0: ``d1 = c - up, d2 = c - down``; candidate when both > cthresh or
  both < -cthresh; confirmed when ``|up2 + 4c + down2 - 3(up+down)| >
  6*cthresh`` (rows +-2 also reflect-101).
* metric 1: ``(up - c) * (down - c) > cthresh``.

``mthresh > 0`` enables the motion mask: ``|src - prev_frame| > mthresh``
dilated vertically by one (zero row above the top, clamped at the bottom)
and ANDed into the mask; the first frame compares with itself (all-zero
mask).  ``expand`` dilates horizontally by one — with the reference quirk
that the last column keeps its pre-expand value; expansion runs after the
motion AND.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.clip import Clip
from ..core.format import SampleType
from ..core.params import VSZipError, require

FILTER_NAME = "CombMask"


def _shift_rows_101(x, off: int):
    """Row-shifted view with reflect-101 (no duplicate) edge mirror."""
    h = x.shape[1]
    if off == 0:
        return x
    if off < 0:
        head = jnp.flip(x[:, 1 : 1 - off, :], axis=1)
        return jnp.concatenate([head, x[:, : h + off, :]], axis=1)
    tail = jnp.flip(x[:, h - off - 1 : h - 1, :], axis=1)
    return jnp.concatenate([x[:, off:, :], tail], axis=1)


def _metric0(xi, cthresh: int, cth6: int):
    up2 = _shift_rows_101(xi, -2)
    up = _shift_rows_101(xi, -1)
    dn = _shift_rows_101(xi, 1)
    dn2 = _shift_rows_101(xi, 2)
    d1 = xi - up
    d2 = xi - dn
    pred = ((d1 > cthresh) & (d2 > cthresh)) | ((d1 < -cthresh) & (d2 < -cthresh))
    val = jnp.abs((up2 + 4 * xi + dn2) - 3 * (up + dn)) > cth6
    return jnp.where(pred & val, jnp.uint8(255), jnp.uint8(0))


def _metric1(xi, cthresh: int):
    up = _shift_rows_101(xi, -1)
    dn = _shift_rows_101(xi, 1)
    return jnp.where((up - xi) * (dn - xi) > cthresh, jnp.uint8(255), jnp.uint8(0))


def _expand(m):
    """3-tap horizontal dilation; the last column keeps its pre-expand value
    (reference expandMask never writes dst[w-1],
    src/filters/comb_mask.zig:180-206)."""
    w = m.shape[2]
    if w < 2:
        return m
    left = jnp.concatenate([m[:, :, :1] * 0, m[:, :, :-1]], axis=2)
    right = jnp.concatenate([m[:, :, 1:], m[:, :, -1:] * 0], axis=2)
    out = left | m | right
    # column 0: buf[0] | buf[1] (no left tap); column w-1: untouched
    out = out.at[:, :, 0].set(m[:, :, 0] | m[:, :, 1])
    return jnp.concatenate([out[:, :, : w - 1], m[:, :, w - 1 :]], axis=2)


def _motion_and(mask, xi, pi, mthresh: int):
    diff = jnp.where(jnp.abs(xi - pi) > mthresh, jnp.uint8(255), jnp.uint8(0))
    up = jnp.concatenate([jnp.zeros_like(diff[:, :1, :]), diff[:, :-1, :]], axis=1)
    dn = jnp.concatenate([diff[:, 1:, :], diff[:, -1:, :]], axis=1)
    return mask & (up | diff | dn)


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _comb_mask_plane(x, prev, cthresh: int, cth6: int, mthresh: int,
                     metric_1: bool, expand: bool):
    xi = x.astype(jnp.int32)
    mask = _metric1(xi, cthresh) if metric_1 else _metric0(xi, cthresh, cth6)
    motion = mthresh > 0
    if expand and not motion:
        mask = _expand(mask)
    if motion:
        mask = _motion_and(mask, xi, prev.astype(jnp.int32), mthresh)
        if expand:
            mask = _expand(mask)
    return mask


def comb_mask(clip: Clip, cthresh: int = 6, mthresh: int = 9,
              expand: bool = True, metric: bool = False) -> Clip:
    fmt = clip.format
    require(
        fmt.sample_type is SampleType.INTEGER and fmt.bits_per_sample == 8,
        FILTER_NAME, "only 8 bit int format supported.",
    )
    cthresh, mthresh = int(cthresh), int(mthresh)
    metric_1 = bool(metric)
    cth_max = 65025 if metric_1 else 255
    if cthresh > cth_max or cthresh < 0:
        raise VSZipError(
            f"{FILTER_NAME}: cthresh must be between 0 and {cth_max} when "
            f"metric = {str(metric_1).lower()}."
        )
    if mthresh > 255 or mthresh < 0:
        raise VSZipError(f"{FILTER_NAME}: mthresh must be between 0 and 255.")
    min_h = clip.height >> fmt.subsampling_h
    if min_h < 3:
        raise VSZipError(
            f"{FILTER_NAME}: clip too small; every plane must be at least 3 rows tall."
        )
    cth6 = 0 if metric_1 else cthresh * 6

    out = []
    for p in clip.planes:
        prev = jnp.concatenate([p[:1], p[:-1]], axis=0)  # frame n-1, clamped
        out.append(
            _comb_mask_plane(p, prev, cthresh, cth6, mthresh, metric_1,
                             bool(expand))
        )
    return clip.with_planes(out)
