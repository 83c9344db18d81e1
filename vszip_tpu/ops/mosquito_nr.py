"""MosquitoNR: direction-aware mosquito-noise reducer with wavelet detail
restore.

Reference: src/filters/mosquito_nr.zig (+ the f32 variant in
mosquito_nr_float.zig) and src/vapoursynth/mosquito_nr.zig.  Per plane:

1. Work plane: integer inputs are lifted to bits+4 fixed point (<< 4) with a
   2-pixel reflect-101 border; floats are used raw.
2. Direction pass: 8 directional SADs over the radius-1 or radius-2 stencil
   (4 axis/diagonal directions plus 4 half-angle directions built from
   averaged tap pairs); per pixel the smallest SAD picks the direction
   (ties keep the lower index), an exact-zero best SAD means "flat" (copy).
3. Directional blend with integer coefficients derived from `strength`
   (rounded >>6/>>7/>>8 fixed-point for ints, reciprocal multiplies for
   floats).
4. Optional detail restore (`restore` < 128 blends, 0 disables): a CDF-5/3
   style integer lifting wavelet (predict: odd - (even_l+even_r)>>1, update:
   even + (detail_l+detail_r)>>2) applied V then H to both the original and
   the smoothed plane; their LL bands are mixed by restore/128 and the
   inverse transform reconstructs the output from the mixed LL + the
   smoothed plane's detail bands.

All integer arithmetic stays in i32 (the reference's i16 lanes for 8-bit
input cannot overflow for valid pixel ranges, so plain i32 is bit-identical).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.clip import Clip
from ..core.format import ColorFamily, SampleType
from ..core.params import VSZipError, get_array, parse_planes, require

FILTER_NAME = "MosquitoNR"


def _pad2(x):
    """2-pixel reflect-101 border on both axes."""
    top = jnp.flip(x[:, 1:3, :], axis=1)
    bot = jnp.flip(x[:, -3:-1, :], axis=1)
    x = jnp.concatenate([top, x, bot], axis=1)
    left = jnp.flip(x[:, :, 1:3], axis=2)
    right = jnp.flip(x[:, :, -3:-1], axis=2)
    return jnp.concatenate([left, x, right], axis=2)


def _shift(p, dy, dx, h, w):
    """interior view of the padded plane shifted by (dy, dx)"""
    return p[:, 2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w]


def _half(a, is_int):
    return (a >> 1) if is_int else (a * jnp.float32(0.5))


def _sads(t, radius, is_int):
    """Direction pass on a generic tap closure `t(dy, dx)`."""
    c = t(0, 0)
    A = lambda v: jnp.abs(v - c)
    H = lambda a, b: jnp.abs(_half(a + b, is_int) - c)
    if radius == 1:
        sad = [
            A(t(0, -1)) + A(t(0, 1)),
            A(t(-1, -1)) + A(t(1, 1)),
            A(t(-1, 0)) + A(t(1, 0)),
            A(t(-1, 1)) + A(t(1, -1)),
            H(t(0, -1), t(-1, -1)) + H(t(0, 1), t(1, 1)),
            H(t(-1, -1), t(-1, 0)) + H(t(1, 1), t(1, 0)),
            H(t(-1, 0), t(-1, 1)) + H(t(1, 0), t(1, -1)),
            H(t(0, 1), t(-1, 1)) + H(t(0, -1), t(1, -1)),
        ]
    else:
        sad = [
            A(t(0, -1)) + A(t(0, 1)) + A(t(0, -2)) + A(t(0, 2)),
            A(t(-1, -1)) + A(t(1, 1)) + A(t(-2, -2)) + A(t(2, 2)),
            A(t(-1, 0)) + A(t(1, 0)) + A(t(-2, 0)) + A(t(2, 0)),
            A(t(-1, 1)) + A(t(1, -1)) + A(t(-2, 2)) + A(t(2, -2)),
            A(t(-1, -2)) + A(t(1, 2)) + H(t(0, -1), t(-1, -1)) + H(t(0, 1), t(1, 1)),
            A(t(-2, -1)) + A(t(2, 1)) + H(t(-1, -1), t(-1, 0)) + H(t(1, 1), t(1, 0)),
            A(t(-2, 1)) + A(t(2, -1)) + H(t(-1, 0), t(-1, 1)) + H(t(1, 0), t(1, -1)),
            A(t(-1, 2)) + A(t(1, -2)) + H(t(-1, 1), t(0, 1)) + H(t(1, -1), t(0, -1)),
        ]
    best = sad[0]
    idx = jnp.zeros(c.shape, jnp.int32)
    for i in range(1, 8):
        lt = sad[i] < best
        idx = jnp.where(lt, jnp.int32(i), idx)
        best = jnp.where(lt, sad[i], best)
    zero = jnp.int32(0) if is_int else jnp.float32(0.0)
    return jnp.where(best == zero, jnp.int32(8), idx)


def _blend(t, dirs, strength, radius, is_int):
    c = t(0, 0)
    s = strength if is_int else jnp.float32(strength)
    if radius == 1:
        coef0, coef1, coef2 = 64 - 2 * s, 128 - 4 * s, s
        lo_shift, hi_shift = 6, 7
    else:
        coef0, coef1, coef2 = 128 - 4 * s, 256 - 8 * s, s
        coef3 = 2 * s
        lo_shift, hi_shift = 7, 8

    def lo(acc):
        if is_int:
            return (acc + (1 << (lo_shift - 1))) >> lo_shift
        return acc * jnp.float32(1.0 / (1 << lo_shift))

    def hi(acc):
        if is_int:
            return (acc + (1 << (hi_shift - 1))) >> hi_shift
        return acc * jnp.float32(1.0 / (1 << hi_shift))

    if radius == 1:
        arms = [
            lo(coef0 * c + coef2 * (t(0, -1) + t(0, 1))),
            lo(coef0 * c + coef2 * (t(-1, -1) + t(1, 1))),
            lo(coef0 * c + coef2 * (t(-1, 0) + t(1, 0))),
            lo(coef0 * c + coef2 * (t(-1, 1) + t(1, -1))),
            hi(coef1 * c + coef2 * (t(-1, -1) + t(0, -1) + t(0, 1) + t(1, 1))),
            hi(coef1 * c + coef2 * (t(-1, -1) + t(-1, 0) + t(1, 0) + t(1, 1))),
            hi(coef1 * c + coef2 * (t(-1, 1) + t(-1, 0) + t(1, 0) + t(1, -1))),
            hi(coef1 * c + coef2 * (t(-1, 1) + t(0, 1) + t(0, -1) + t(1, -1))),
        ]
    else:
        arms = [
            lo(coef0 * c + coef2 * (t(0, -2) + t(0, -1) + t(0, 1) + t(0, 2))),
            lo(coef0 * c + coef2 * (t(-2, -2) + t(-1, -1) + t(1, 1) + t(2, 2))),
            lo(coef0 * c + coef2 * (t(-2, 0) + t(-1, 0) + t(1, 0) + t(2, 0))),
            lo(coef0 * c + coef2 * (t(-2, 2) + t(-1, 1) + t(1, -1) + t(2, -2))),
            hi(coef1 * c + coef3 * (t(-1, -2) + t(1, 2))
               + coef2 * (t(-1, -1) + t(0, -1) + t(0, 1) + t(1, 1))),
            hi(coef1 * c + coef3 * (t(-2, -1) + t(2, 1))
               + coef2 * (t(-1, -1) + t(-1, 0) + t(1, 0) + t(1, 1))),
            hi(coef1 * c + coef3 * (t(-2, 1) + t(2, -1))
               + coef2 * (t(-1, 1) + t(-1, 0) + t(1, 0) + t(1, -1))),
            hi(coef1 * c + coef3 * (t(-1, 2) + t(1, -2))
               + coef2 * (t(-1, 1) + t(0, 1) + t(0, -1) + t(1, -1))),
        ]
    out = c
    for i, arm in enumerate(arms):
        out = jnp.where(dirs == jnp.int32(i), arm, out)
    return out


def _q2(v, is_int):
    return (v >> 2) if is_int else (v * jnp.float32(0.25))


def _q1(v, is_int):
    return (v >> 1) if is_int else (v * jnp.float32(0.5))


def _fwd_axis(x, axis, is_int):
    """lifting forward along `axis`: returns (approx, detail)."""
    x = jnp.moveaxis(x, axis, 1)
    n = x.shape[1]
    na, nd = (n + 1) // 2, n // 2
    e = x[:, 0::2]
    o = x[:, 1::2]
    # even neighbor below odd j: index 2j+2 if < n else n-2
    if n % 2 == 0:
        e2 = jnp.concatenate([e[:, 1:], e[:, nd - 1 : nd]], axis=1)
    else:
        e2 = e[:, 1 : nd + 1]
    d = o - _q1(e[:, :nd] + e2, is_int)
    dl = jnp.concatenate([d[:, :1], d[:, : na - 1]], axis=1)
    dr = d if na == nd else jnp.concatenate([d, d[:, nd - 1 : nd]], axis=1)
    a = e + _q2(dl + dr, is_int)
    return jnp.moveaxis(a, 1, axis), jnp.moveaxis(d, 1, axis)


def _inv_axis(a, d, axis, n, is_int):
    a = jnp.moveaxis(a, axis, 1)
    d = jnp.moveaxis(d, axis, 1)
    na, nd = (n + 1) // 2, n // 2
    dl = jnp.concatenate([d[:, :1], d[:, : na - 1]], axis=1)
    dr = d if na == nd else jnp.concatenate([d, d[:, nd - 1 : nd]], axis=1)
    e = a - _q2(dl + dr, is_int)
    if n % 2 == 0:
        e2 = jnp.concatenate([e[:, 1:], e[:, nd - 1 : nd]], axis=1)
    else:
        e2 = e[:, 1 : nd + 1]
    o = d + _q1(e[:, :nd] + e2, is_int)
    out = jnp.zeros(a.shape[:1] + (n,) + a.shape[2:], a.dtype)
    out = out.at[:, 0::2].set(e)
    out = out.at[:, 1::2].set(o)
    return jnp.moveaxis(out, 1, axis)


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _mosquito_plane(x, strength: int, restore: int, radius: int, bits: int,
                    is_int: bool, chroma: bool):
    n, h, w = x.shape
    if is_int:
        work = (x.astype(jnp.int32) << 4)
        lo_clamp, hi_clamp = 0, (1 << bits) - 1
    else:
        work = x.astype(jnp.float32)
        lo_clamp = -0.5 if chroma else 0.0
        hi_clamp = 0.5 if chroma else 1.0
    # The direction pass is a plain XLA stencil: XLA fuses the +-2 tap
    # chains into few passes.
    p = _pad2(work)
    tap = lambda dy, dx: _shift(p, dy, dx, h, w)
    dirs = _sads(tap, radius, is_int)
    blur = _blend(tap, dirs, strength, radius, is_int)

    out = blur
    if restore != 0:
        va_o, _ = _fwd_axis(work, 1, is_int)
        ll_o, _ = _fwd_axis(va_o, 2, is_int)
        va_b, vd_b = _fwd_axis(blur, 1, is_int)
        ll_b, hd_b = _fwd_axis(va_b, 2, is_int)
        if restore != 128:
            if is_int:
                ll = (restore * ll_o + (128 - restore) * ll_b + 64) >> 7
            else:
                wo = jnp.float32(restore / 128.0)
                ll = wo * ll_o + (jnp.float32(1.0) - wo) * ll_b
        else:
            ll = ll_o
        va_rec = _inv_axis(ll, hd_b, 2, w, is_int)
        out = _inv_axis(va_rec, vd_b, 1, h, is_int)

    if is_int:
        res = jnp.clip((out + 8) >> 4, lo_clamp, hi_clamp)
        return res.astype(x.dtype)
    return jnp.clip(out, lo_clamp, hi_clamp).astype(x.dtype)


def mosquito_nr(clip: Clip, strength=None, restore=None, radius=None,
                planes=None) -> Clip:
    fmt = clip.format
    ok_int = fmt.sample_type is SampleType.INTEGER and 8 <= fmt.bits_per_sample <= 16
    ok_float = fmt.sample_type is SampleType.FLOAT and fmt.bits_per_sample == 32
    require(
        ok_int or ok_float, FILTER_NAME,
        "only constant-format 8..16 bit integer or 32 bit float input is supported.",
    )
    require(
        fmt.color_family is not ColorFamily.RGB,
        FILTER_NAME, "input must be YUV or Gray.",
    )
    # default = luma only (reference src/vapoursynth/mosquito_nr.zig:114:
    # planes preset {true, false, false} before mapGetPlanes override)
    if planes is None:
        selected = [True] + [False] * (fmt.num_planes - 1)
    else:
        selected = parse_planes(planes, fmt.num_planes, FILTER_NAME)
    strength_a = get_array(strength, "strength", 16, 0, 32, FILTER_NAME)
    restore_a = get_array(restore, "restore", 128, 0, 128, FILTER_NAME)
    radius_a = get_array(radius, "radius", 2, 1, 2, FILTER_NAME)
    for p in range(fmt.num_planes):
        if not selected[p]:
            continue
        pw, ph = clip.plane_dims(p)
        if pw < 4 or ph < 4:
            raise VSZipError(
                f"{FILTER_NAME}: input is too small (need at least 4x4 per "
                "processed plane)."
            )
    is_int = fmt.sample_type is SampleType.INTEGER
    out = []
    for p, x in enumerate(clip.planes):
        if not selected[p] or strength_a[p] == 0:
            out.append(x)
            continue
        out.append(
            _mosquito_plane(
                x, int(strength_a[p]), int(restore_a[p]), int(radius_a[p]),
                fmt.bits_per_sample, is_int,
                p > 0 and fmt.color_family is ColorFamily.YUV,
            )
        )
    return clip.with_planes(out)
