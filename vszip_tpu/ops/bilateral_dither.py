"""BilateralDither: flat-kernel bilateral smoother for debanding
(Dither_bilateral16 lineage).

Reference: src/filters/bilateral_dither.zig + bilateral_dither_subspl.zig +
src/vapoursynth/bilateral_dither.zig.  Per pixel the weight of a window
neighbor is ``clamp(m - |ref_diff|, 0, wmax)`` and the output is
``center + sum(w * diff) / max(sum_w, sum_w_min)``.  Two paths:

* dense: the full (2r-1)^2 window (offsets 1-r..r-1 both axes), evaluated
  as a `lax.fori_loop` over taps on the mirror-padded f32 cache;
* sub-sampled (active when ``subspl >= 4`` or the 0 default): precomputed
  point lists (see bilateral_dither_points) — per row an LCG picks the
  starting list, each 4-pixel group advances it; realized here as per-tap
  flat gathers with NumPy-precomputed per-pixel indices (bit-matching the
  reference's linear addressing into the padded cache incl. its slack).

Integer outputs round to nearest and clamp to [0, peak].
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.clip import Clip
from ..core.format import SampleType
from ..core.params import VSZipError, get_array, parse_planes, require
from .bilateral_dither_points import NBR_POINT_LISTS, generate, rnd_row_values

FILTER_NAME = "BilateralDither"


def _pad_cache(x, rh: int, rv: int):
    """mirror-padded f32 cache (reflect with edge duplication)."""
    return jnp.pad(
        x.astype(jnp.float32), ((0, 0), (rv, rv), (rh, rh)), mode="symmetric"
    )


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8))
def _dense(x, ref, rh: int, rv: int, m: float, wmax: float, swmin: float,
           peak: float, is_int: bool):
    n, h, w = x.shape
    src_c = _pad_cache(x, rh, rv)
    ref_c = src_c if ref is None else _pad_cache(ref, rh, rv)
    cen = src_c[:, rv : rv + h, rh : rh + w]
    cen_ref = ref_c[:, rv : rv + h, rh : rh + w]

    ndx = 2 * rh - 1
    ndy = 2 * rv - 1

    # statically unrolled taps (same row-major order as the reference, so
    # f32 accumulation is bit-identical); static slices let XLA fuse many
    # taps into one pass over the plane, where a lax.scan would make one
    # pass per tap
    s = jnp.zeros_like(cen)
    sw = jnp.zeros_like(cen)
    for dy in range(1, ndy + 1):
        for dx in range(1, ndx + 1):
            v = jax.lax.slice(src_c, (0, dy, dx), (n, dy + h, dx + w))
            vr = jax.lax.slice(ref_c, (0, dy, dx), (n, dy + h, dx + w))
            wgt = jnp.maximum(
                jnp.minimum(jnp.float32(m) - jnp.abs(vr - cen_ref),
                            jnp.float32(wmax)), 0.0)
            s = s + (v - cen) * wgt
            sw = sw + wgt
    p = cen + s / jnp.maximum(sw, jnp.float32(swmin))
    if is_int:
        # round half away from zero (Zig @round); values are clamped >= 0
        return jnp.floor(jnp.clip(p, 0.0, jnp.float32(peak)) + 0.5).astype(x.dtype)
    return p.astype(x.dtype)


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 7, 8, 9))
def _subspl(x, ref, tap_idx, rh: int, rv: int, m: float, wmax: float,
            swmin: float, peak: float, is_int: bool):
    """tap_idx: (k, H, W) int32 flat indices into the padded cache (with
    slack), precomputed on the host from the point lists."""
    n, h, w = x.shape
    cstride = w + 2 * rh
    cheight = h + 2 * rv
    slack = (2 * rh + 2) * cstride + 4
    src_c = _pad_cache(x, rh, rv).reshape(n, -1)
    src_c = jnp.concatenate(
        [src_c, jnp.zeros((n, slack), jnp.float32)], axis=1
    )
    if ref is None:
        ref_c = src_c
    else:
        ref_c = _pad_cache(ref, rh, rv).reshape(n, -1)
        ref_c = jnp.concatenate(
            [ref_c, jnp.zeros((n, slack), jnp.float32)], axis=1
        )
    base = (
        (jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) + rv) * cstride
        + jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) + rh
    ).reshape(-1)
    cen = jnp.take(src_c, base, axis=1).reshape(n, h, w)
    cen_ref = jnp.take(ref_c, base, axis=1).reshape(n, h, w)

    s = jnp.zeros_like(cen)
    sw = jnp.zeros_like(cen)
    for j in range(tap_idx.shape[0]):
        idx = tap_idx[j].reshape(-1)
        v = jnp.take(src_c, idx, axis=1).reshape(n, h, w)
        vr = jnp.take(ref_c, idx, axis=1).reshape(n, h, w)
        wgt = jnp.maximum(jnp.minimum(jnp.float32(m) - jnp.abs(vr - cen_ref),
                                      jnp.float32(wmax)), 0.0)
        sw = sw + wgt
        s = s + (v - cen) * wgt
    p = cen + s / jnp.maximum(sw, jnp.float32(swmin))
    if is_int:
        return jnp.floor(jnp.clip(p, 0.0, jnp.float32(peak)) + 0.5).astype(x.dtype)
    return p.astype(x.dtype)


def _tap_indices(w: int, h: int, rh: int, rv: int, pts: np.ndarray, k: int):
    """(k, H, W) flat cache indices: per row the LCG picks the start list,
    each 4-pixel group advances it (reference bilateral_dither.zig:124-134)."""
    cstride = w + 2 * rh
    rows = rnd_row_values(h)
    start = ((rows >> 8) % NBR_POINT_LISTS).astype(np.int64)
    groups = (np.arange(w) >> 2).astype(np.int64)
    list_id = (start[:, None] + groups[None, :]) % NBR_POINT_LISTS  # (H, W)
    base = (np.arange(h)[:, None] + rv) * cstride + (np.arange(w)[None, :] + rh)
    # the reference loads 4-wide from the GROUP base; pixels within a group
    # share the group's tap addresses offset by their lane position
    group_base = (np.arange(h)[:, None] + rv) * cstride + (
        (np.arange(w) & ~3)[None, :] + rh
    )
    lane = (np.arange(w) & 3)[None, :]
    dy = pts[:, :, 0]  # (NBR, k)
    dx = pts[:, :, 1]
    idx = np.zeros((k, h, w), np.int32)
    for j in range(k):
        off = dy[list_id, j] * cstride + dx[list_id, j]
        idx[j] = group_base + off + lane
    return idx


def bilateral_dither(clip: Clip, ref: Clip | None = None, radius=None,
                     thr=None, flat=None, wmin=None, subspl=None,
                     planes=None) -> Clip:
    fmt = clip.format
    is_int = fmt.sample_type is SampleType.INTEGER
    if is_int:
        require(8 <= fmt.bits_per_sample <= 16, FILTER_NAME,
                "integer input must be 8..16 bit")
    else:
        require(fmt.bits_per_sample == 32, FILTER_NAME,
                "float input must be 32 bit")
    radius_a = get_array(radius, "radius", 16, 2, 16384, FILTER_NAME)
    thr_a = get_array(thr, "thr", 2.5, 0.0, 65535.0, FILTER_NAME)
    flat_a = get_array(flat, "flat", 0.4, 0.0, 1.0, FILTER_NAME)
    wmin_a = get_array(wmin, "wmin", 0.0, 0.0, 65535.0, FILTER_NAME)
    subspl_a = get_array(subspl, "subspl", 0.0, 0.0, 4096.0, FILTER_NAME)
    require(clip.width >= 16 and clip.height >= 16, FILTER_NAME,
            "input must be 16x16 min")
    process = parse_planes(planes, fmt.num_planes, FILTER_NAME)

    scale = float(1 << (fmt.bits_per_sample - 8)) if is_int else 1.0 / 256.0
    unit = 1.0 if is_int else 1.0 / 65535.0
    peak = float((1 << fmt.bits_per_sample) - 1) if is_int else 0.0

    if ref is not None:
        if (ref.format != fmt or ref.width != clip.width
                or ref.height != clip.height
                or ref.num_frames != clip.num_frames):
            raise VSZipError(
                f'{FILTER_NAME}: "ref" must have the same format and '
                'dimensions as "clip"'
            )

    out = []
    for p, x in enumerate(clip.planes):
        if not process[p]:
            out.append(x)
            continue
        pw, ph = clip.plane_dims(p)
        r = int(radius_a[p])
        if pw < r or ph < r:
            raise VSZipError(
                f'{FILTER_NAME}: picture size must be greater than "radius"'
            )
        m = max(float(np.float32(thr_a[p]) * np.float32(scale)), unit)
        wmax = max(
            float(np.float32(thr_a[p]) * np.float32(1.0 - np.float32(flat_a[p]))
                  * np.float32(scale)),
            unit,
        )
        rp = ref.planes[p] if ref is not None else None
        sub = float(subspl_a[p])
        active = sub >= 4.0 or sub < 1e-3
        if active:
            pts, k = generate(r, r, sub)
            swmin = max(float(np.float32(wmin_a[p]) * np.float32(wmax)
                              * np.float32(k)), unit)
            tap_idx = jnp.asarray(_tap_indices(pw, ph, r, r, pts, k))
            out.append(
                _subspl(x, rp, tap_idx, r, r, m, wmax, swmin, peak, is_int)
            )
        else:
            area = float((2 * r - 1) * (2 * r - 1))
            swmin = max(float(np.float32(wmin_a[p]) * np.float32(wmax)
                              * np.float32(area)), unit)
            out.append(_dense(x, rp, r, r, m, wmax, swmin, peak, is_int))
    return clip.with_planes(out)
