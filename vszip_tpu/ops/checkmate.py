"""Checkmate: temporal+spatial dot-crawl / rainbow reducer.

Reference: src/filters/checkmate.zig + src/vapoursynth/checkmate.zig.
8-bit only, all planes.  5-frame window (n-2..n+2, clamped at clip ends)
when ``tthr2 > 0``, else 3 frames.  First/last two rows pass through.  For
interior rows (x-neighbors at +-2 columns, clamped):

* ``tthr2`` branch (per pixel, when the three temporal diffs are all below
  tthr2): temporal smooth ``(p1 + 2*src + n1) >> 2``.
* else: weighted blend of the 1-2-1 vertical column sums of the prev/next
  frames against the current frame's, with fixed-point weights
  ``min(clamp(thr + tmax - |diff|, 0, tmax+1) * (8192 // tmax), 8192)`` and
  spatial term ``trunc(curr_value / 10)`` (truncating division!), summed at
  14-bit scale and shifted down 15, clamped to u8.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.clip import Clip
from ..core.format import SampleType
from ..core.params import VSZipError, require

FILTER_NAME = "Checkmate"


def _col121(xi):
    """src[y-2] + 2*src[y] + src[y+2] for interior rows y in [2, h-3]."""
    return xi[:, :-4, :] + 2 * xi[:, 2:-2, :] + xi[:, 4:, :]


def _shift_cols_clamp(x, off: int):
    w = x.shape[2]
    if off < 0:
        lead = jnp.repeat(x[:, :, :1], -off, axis=2)
        return jnp.concatenate([lead, x[:, :, :off]], axis=2)
    tail = jnp.repeat(x[:, :, -1:], off, axis=2)
    return jnp.concatenate([x[:, :, off:], tail], axis=2)


@partial(jax.jit, static_argnums=(5, 6, 7, 8))
def _checkmate_plane(x, p1, n1, p2, n2, thr: int, tmax: int, tthr2: int,
                     use_tthr2: bool):
    xi = x.astype(jnp.int32)
    p1i = p1.astype(jnp.int32)
    n1i = n1.astype(jnp.int32)

    # interior-row views (rows 2..h-3); all row-indexed terms below are
    # relative to that window
    c = xi[:, 2:-2, :]
    cp1 = p1i[:, 2:-2, :]
    cn1 = n1i[:, 2:-2, :]

    cur_col = _col121(xi)
    # x-neighbor terms, columns clamped like the reference
    # (x_left = max(x-2,0), x_right = min(x+2, w-1))
    cvl = _shift_cols_clamp(xi[:, :-4, :], -2)   # src[y-2, xl]
    cvr = _shift_cols_clamp(xi[:, :-4, :], 2)    # src[y-2, xr]
    sl = _shift_cols_clamp(c, -2)                # src[y, xl]
    sr = _shift_cols_clamp(c, 2)                 # src[y, xr]
    dl = _shift_cols_clamp(xi[:, 4:, :], -2)     # src[y+2, xl]
    dr = _shift_cols_clamp(xi[:, 4:, :], 2)      # src[y+2, xr]
    curr_value = (
        -cvl - cvr + 2 * sl + 2 * sr - dl - dr + 2 * cur_col + 12 * c
    )

    nc = _col121(n1i) - cur_col
    pc = _col121(p1i) - cur_col
    nc = thr + tmax - jnp.abs(nc)
    pc = thr + tmax - jnp.abs(pc)
    tmax_mult = (1 << 13) // tmax
    nw = jnp.minimum(jnp.clip(nc, 0, tmax + 1) * tmax_mult, 8192)
    pw = jnp.minimum(jnp.clip(pc, 0, tmax + 1) * tmax_mult, 8192)
    cw = (1 << 14) - (nw + pw)
    next_value = c + cn1
    prev_value = c + cp1
    # trunc division toward zero (Zig @divTrunc), not floor
    curr_div10 = jnp.sign(curr_value) * (jnp.abs(curr_value) // 10)
    out = (cw * curr_div10 + pw * prev_value + nw * next_value) >> 15
    out = jnp.clip(out, 0, 255)

    if use_tthr2:
        p2i = p2.astype(jnp.int32)
        n2i = n2.astype(jnp.int32)
        cond = (
            (jnp.abs(cp1 - cn1) < tthr2)
            & (jnp.abs(p2i[:, 2:-2, :] - c) < tthr2)
            & (jnp.abs(c - n2i[:, 2:-2, :]) < tthr2)
        )
        smooth = (cp1 + 2 * c + cn1) >> 2
        out = jnp.where(cond, smooth, out)

    mid = out.astype(jnp.uint8)
    return jnp.concatenate([x[:, :2, :], mid, x[:, -2:, :]], axis=1)


def _frame_shift(p, off: int):
    """Frame n+off with clamping at clip ends."""
    if off == 0:
        return p
    if off < 0:
        return jnp.concatenate([jnp.repeat(p[:1], -off, axis=0), p[:off]], axis=0)
    return jnp.concatenate([p[off:], jnp.repeat(p[-1:], off, axis=0)], axis=0)


def checkmate(clip: Clip, thr: int = 12, tmax: int = 12, tthr2: int = 0) -> Clip:
    fmt = clip.format
    require(
        fmt.sample_type is SampleType.INTEGER and fmt.bits_per_sample == 8,
        FILTER_NAME, "only 8 bit int format supported.",
    )
    thr, tmax, tthr2 = int(thr), int(tmax), int(tthr2)
    if tmax < 1 or tmax > 255:
        raise VSZipError(f"{FILTER_NAME}: tmax value should be in range [1;255].")
    if tthr2 < 0:
        raise VSZipError(f"{FILTER_NAME}: tthr2 should be non-negative.")
    if thr < 0 or thr > 255:
        raise VSZipError(f"{FILTER_NAME}: thr value should be in range [0;255].")
    min_w = clip.width >> fmt.subsampling_w
    min_h = clip.height >> fmt.subsampling_h
    if min_w < 3 or min_h < 5:
        raise VSZipError(
            f"{FILTER_NAME}: clip too small; every plane must be at least 3 "
            "wide and 5 tall."
        )
    use_tthr2 = tthr2 > 0

    out = []
    for p in clip.planes:
        p1 = _frame_shift(p, -1)
        n1 = _frame_shift(p, 1)
        p2 = _frame_shift(p, -2) if use_tthr2 else p
        n2 = _frame_shift(p, 2) if use_tthr2 else p
        out.append(
            _checkmate_plane(p, p1, n1, p2, n2, thr, tmax, tthr2, use_tthr2)
        )
    return clip.with_planes(out)
