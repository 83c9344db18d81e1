"""BoxBlur: separable box blur with the reference's exact dual-path semantics.

Reference behavior being reproduced (NOT translated — the reference runs
sequential per-row running sums on CPU SIMD; here the identical arithmetic is
restated in closed form over prefix sums so every pixel is independent):

* Runtime path (reference src/filters/boxblur_runtime.zig): H passes then V
  passes; every 1-D pass is a fixed-point running box sum for ints
  (``inv = (2^32+r)//ksize``, init ``(W0*inv + 2^31) >> 16``, per-step
  ``+/- pixel*inv2`` with ``inv2 = inv >> 16``, output ``sum >> 16``) and an
  f32 running mean for floats.  Edges mirror with duplication (numpy
  'symmetric').  The running state is affine in the window sum W(x):
  ``out(x) = (C0 + inv2*(W(x) - W(0))) >> 16`` with
  ``C0 = (W(0)*inv + 2^31) >> 16`` — bit-exact and fully parallel.
* Comptime path (reference src/filters/boxblur_comptime.zig, selected when
  hradius==vradius<=22 and 1 pass each): vertical FIRST as a raw column sum
  quantized via ``(col*inv + 2^31) >> 32``, then the horizontal fixed-point
  running pass.  Vertical edges use the reference's hybrid mirror
  (top: reflect-101 clamped to h-1; bottom: tap offset ``o`` reads absolute
  row ``max(h-1-o, 0)``); horizontal edges mirror with duplication.
  Float: direct FIR in both axes with the hybrid mirror on BOTH axes.

Float accumulation policy: the reference chains f32 adds sequentially in a
running sum; we evaluate each window directly as an f32 tap ladder (no
prefix rounding drift — a documented deviation that is slightly *more*
accurate and stays inside the reference test tolerances).  The comptime
float path reproduces the reference's exact f32 add ordering, so f32
outputs are bit-exact there.

Dispatch rule replicated from reference src/vapoursynth/boxblur.zig:188:
``use_rt = hradius != vradius or hradius > 22 or hpasses > 1 or vpasses > 1``
(including the quirk that the comptime path ignores pass counts, so e.g.
hpasses=0 with hradius==vradius still blurs both axes).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.clip import Clip
from ..core.format import SampleType
from ..core.params import VSZipError, parse_planes, require

FILTER_NAME = "BoxBlur"


# ---------------------------------------------------------------------------
# mirror index tables (host-side, static per (n, radius))
# ---------------------------------------------------------------------------

def _hybrid_idx(n: int, off: int) -> np.ndarray:
    """The comptime path's mirror (reference mirrorRows,
    src/filters/boxblur_comptime.zig:50-70, and hBlurFloat edges):
    j<0 -> min(-j, n-1); j>n-1 -> max(n-1-off, 0)."""
    idx = np.arange(n) + off
    idx = np.where(idx < 0, np.minimum(-idx, n - 1), idx)
    idx = np.where(idx > n - 1, max(n - 1 - off, 0), idx)
    return idx


def _slice(x, start: int, size: int, axis: int):
    return jax.lax.slice_in_dim(x, start, start + size, axis=axis)


def _tap_symmetric(x, off: int, axis: int):
    """Shifted view with duplicate-edge mirror, built from slices/flips only
    (no gathers): m(-j)=j-1, m(n-1+j)=n-j."""
    n = x.shape[axis]
    if off == 0:
        return x
    if off < 0:
        head = jnp.flip(_slice(x, 0, -off, axis), axis=axis)
        return jnp.concatenate([head, _slice(x, 0, n + off, axis)], axis=axis)
    tail = jnp.flip(_slice(x, n - off, off, axis), axis=axis)
    return jnp.concatenate([_slice(x, off, n - off, axis), tail], axis=axis)


def _tap_hybrid(x, off: int, axis: int):
    """Shifted view with the comptime hybrid mirror, slices/flips/broadcast
    only.  Valid for |off| < n (guaranteed by the radius validation)."""
    n = x.shape[axis]
    if off == 0:
        return x
    if off < 0:
        # out-of-top positions i < -off read row -(i+off): flip(x[1 : 1-off])
        head = jnp.flip(_slice(x, 1, -off, axis), axis=axis)
        return jnp.concatenate([head, _slice(x, 0, n + off, axis)], axis=axis)
    # out-of-bottom positions read the constant row n-1-off
    fill = _slice(x, n - 1 - off, 1, axis)
    reps = [1] * x.ndim
    reps[axis] = off
    return jnp.concatenate(
        [_slice(x, off, n - off, axis), jnp.tile(fill, reps)], axis=axis
    )


def _window_sums_i32(x, radius: int, axis: int):
    """Sliding window sums of width 2r+1 with duplicate-edge mirror, via an
    exclusive prefix sum over the padded axis.  i32 is exact up to plane
    extents of ~32768 at 16-bit (guarded in the op)."""
    n = x.shape[axis]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (radius, radius)
    xp = jnp.pad(x.astype(jnp.int32), pad, mode="symmetric")
    cs = jnp.cumsum(xp, axis=axis)
    ksize = 2 * radius + 1
    hi = jax.lax.slice_in_dim(cs, ksize - 1, ksize - 1 + n, axis=axis)
    lo = jax.lax.slice_in_dim(cs, 0, n, axis=axis) - jax.lax.slice_in_dim(
        xp, 0, n, axis=axis
    )
    return hi - lo


# ---------------------------------------------------------------------------
# runtime-path 1-D passes (closed form of the running sums)
# ---------------------------------------------------------------------------

def _fixed_point_output(w, w0, radius: int, dtype):
    """Exact 32-bit evaluation of the reference running-sum output
    ``out(x) = (C0 + inv2*(W(x)-W(0))) >> 16`` with
    ``C0 = (W(0)*inv + 2^31) >> 16``.  The 38-bit product ``inv2*D`` is
    split into i32-safe limbs (D>>9 / D&511); the per-line constant C0
    (up to 2^32) is computed in int64 on the tiny W0 slice only, then split
    into 16-bit halves.  Bit-identical to the int64 closed form."""
    ksize = 2 * radius + 1
    inv = ((1 << 32) + radius) // ksize
    inv2 = np.int32(inv >> 16)
    c0 = (w0.astype(jnp.int64) * inv + (1 << 31)) >> 16
    c0h = (c0 >> 16).astype(jnp.int32)
    c0l = (c0 & 0xFFFF).astype(jnp.int32)
    d = w - w0
    a = inv2 * (d >> 9)
    b = inv2 * (d & 511)
    out = c0h + (a >> 7) + ((c0l + ((a & 127) << 9) + b) >> 16)
    return out.astype(dtype)


def _blur_int_rt_1d(x, radius: int, axis: int):
    """One integer running-sum pass, bit-exact, i32 hot path."""
    n = x.shape[axis]
    if (n + 2 * radius) * int(np.iinfo(x.dtype).max) < 2**31:
        w = _window_sums_i32(x, radius, axis)
    else:  # giant planes: prefix sums overflow i32; fall back to i64
        w = None
        for tap in _taps_symmetric(x.astype(jnp.int64), radius, axis):
            w = tap if w is None else w + tap
        w = w.astype(jnp.int64)
    w0 = jax.lax.slice_in_dim(w, 0, 1, axis=axis)
    return _fixed_point_output(w, w0, radius, x.dtype)


def _taps_symmetric(x, radius: int, axis: int):
    """Stack of 2r+1 tap views with the duplicate-edge mirror."""
    for off in range(-radius, radius + 1):
        yield _tap_symmetric(x, off, axis)


def _blur_float_rt_1d(x, radius: int, axis: int):
    """One float box-mean pass.  The reference chains f32 adds in a running
    sum; we evaluate each window directly as an f32 tap ladder (no prefix
    rounding drift — documented deviation, within test tolerances).  Only
    used for SINGLE-pass float blurs; multipass chains amplify the ulp
    difference past the golden tolerance, so they take the bit-exact
    sliding accumulator below."""
    div = jnp.float32(1.0 / (2 * radius + 1))
    acc = None
    for tap in _taps_symmetric(x.astype(jnp.float32), radius, axis):
        term = div * tap
        acc = term if acc is None else acc + term
    return acc.astype(x.dtype)


def _blur_float_exact_1d(x, radius: int, axis: int):
    """One float box-mean pass replicating the reference's sliding f32
    accumulator bit for bit (src/filters/boxblur_runtime.zig blurFloat):
    ``sum = (src[r] + 2*src[0] + ... + 2*src[r-1]) * div`` then for every x
    ``sum += (s1[x] - s2[x]) * div`` with the three-phase mirror tap
    schedule.  The x-sequential dependence is a lax.scan whose carry is the
    whole batch of rows — all parallelism rides the batch axes.  f16
    accumulates in f32 and narrows per output, like the reference."""
    length = x.shape[axis]
    div = jnp.float32(1.0 / (2 * radius + 1))
    xm = jnp.moveaxis(x.astype(jnp.float32), axis, 0)  # (len, ...)

    init = xm[radius]
    for i in range(radius):  # ascending adds, matching the scalar loop
        init = init + xm[i] * jnp.float32(2.0)
    init = init * div

    s1_idx = np.empty(length, np.int64)
    s2_idx = np.empty(length, np.int64)
    for xx in range(length):
        if xx <= radius:
            s1_idx[xx], s2_idx[xx] = radius + xx, radius - xx
        elif xx < length - radius:
            s1_idx[xx], s2_idx[xx] = radius + xx, xx - radius - 1
        else:
            s1_idx[xx] = 2 * length - radius - xx - 1
            s2_idx[xx] = xx - radius - 1
    deltas = (jnp.take(xm, jnp.asarray(s1_idx), axis=0)
              - jnp.take(xm, jnp.asarray(s2_idx), axis=0)) * div

    def step(sum_, d):
        s = sum_ + d
        return s, s

    _, out = jax.lax.scan(step, init, deltas)
    return jnp.moveaxis(out, 0, axis).astype(x.dtype)


def _rt_blur(x, hradius: int, hpasses: int, vradius: int, vpasses: int,
             is_int: bool):
    if not is_int and (hpasses > 1 or vpasses > 1):
        # float multipass: the reference's sliding-accumulator rounding
        # compounds per pass, so the tap ladder drifts past the golden
        # tolerance (~5e-6 rel after 2-3 passes); run EVERY pass of both
        # axes with the bit-exact accumulator so the whole chain matches
        # the reference's blurFloat composition exactly
        blur1d = _blur_float_exact_1d
    else:
        blur1d = _blur_int_rt_1d if is_int else _blur_float_rt_1d
    if hradius > 0 and hpasses > 0:
        for _ in range(hpasses):
            x = blur1d(x, hradius, axis=2)
    if vradius > 0 and vpasses > 0:
        for _ in range(vpasses):
            x = blur1d(x, vradius, axis=1)
    return x


# ---------------------------------------------------------------------------
# comptime path (hradius == vradius <= 22, single pass)
# ---------------------------------------------------------------------------

def _taps_hybrid(x, radius: int, axis: int):
    """Stack of 2r+1 tap views with the comptime path's hybrid mirror."""
    for off in range(-radius, radius + 1):
        yield _tap_hybrid(x, off, axis)


def _hybrid_window_sums_i32(x, radius: int, axis: int):
    """Window sums with the hybrid mirror: interior via one prefix sum, the
    2*radius edge lines recomputed from small tap slices."""
    n = x.shape[axis]
    ksize = 2 * radius + 1
    xi = x.astype(jnp.int32)
    cs = jnp.cumsum(xi, axis=axis)
    # interior centers i in [radius, n-1-radius]: W = cs[i+r] - cs[i-r] + x[i-r]
    interior = (
        _slice(cs, ksize - 1, n - 2 * radius, axis)
        - _slice(cs, 0, n - 2 * radius, axis)
        + _slice(xi, 0, n - 2 * radius, axis)
    )
    # edge strips: explicit mirrored tap sums over static index tables
    idx = np.stack([_hybrid_idx(n, off) for off in range(-radius, radius + 1)])
    top = None
    bot = None
    for k in range(ksize):
        t = jnp.take(xi, jnp.asarray(idx[k, :radius]), axis=axis)
        b = jnp.take(xi, jnp.asarray(idx[k, n - radius:]), axis=axis)
        top = t if top is None else top + t
        bot = b if bot is None else bot + b
    return jnp.concatenate([top, interior, bot], axis=axis)


def _ct_blur_int(x, radius: int):
    # vertical: raw column sums (hybrid mirror), quantized at 32-bit shift.
    # ``(col*inv + 2^31) >> 32`` equals round-half-up division
    # ``(2*col + ksize) // (2*ksize)`` exactly for every odd ksize <= 45 and
    # col <= ksize*65535 (the truncation term |col*(r-e)|/(ksize*2^32) is
    # < 1/(2*ksize), the closest an odd-numerator half-integer quotient can
    # sit to an integer), so the 48-bit product never materializes.
    ksize = 2 * radius + 1
    col = _hybrid_window_sums_i32(x, radius, axis=1)
    tmp = ((2 * col + ksize) // (2 * ksize)).astype(x.dtype)
    # horizontal: the same running fixed-point pass as the runtime path
    return _blur_int_rt_1d(tmp, radius, axis=2)


def _ct_blur_float(x, radius: int):
    # Reference accumulates acc += div * tap in f32, tap order k=0..ksize-1,
    # in BOTH axes (vBlurFloat then hBlurFloat) — replicate the exact ladder.
    div = jnp.float32(1.0 / (2 * radius + 1))
    xf = x.astype(jnp.float32)
    acc = None
    for tap in _taps_hybrid(xf, radius, axis=1):
        term = div * tap
        acc = term if acc is None else acc + term
    tmp = acc.astype(x.dtype).astype(jnp.float32)  # f16 narrows between axes
    acc = None
    for tap in _taps_hybrid(tmp, radius, axis=2):
        term = div * tap
        acc = term if acc is None else acc + term
    return acc.astype(x.dtype)


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _boxblur_plane(x, use_rt: bool, hradius: int, hpasses: int, vradius: int,
                   vpasses: int, is_int: bool):
    if use_rt:
        return _rt_blur(x, hradius, hpasses, vradius, vpasses, is_int)
    if is_int:
        return _ct_blur_int(x, hradius)
    return _ct_blur_float(x, hradius)


def boxblur(clip: Clip, planes=None, hradius: int = 1, hpasses: int = 1,
            vradius: int = 1, vpasses: int = 1) -> Clip:
    """vszip.BoxBlur equivalent (reference src/vapoursynth/boxblur.zig:131)."""
    fmt = clip.format
    require(
        not (fmt.sample_type is SampleType.INTEGER and fmt.bits_per_sample == 32),
        FILTER_NAME, "not supported Int format.",
    )
    process = parse_planes(planes, fmt.num_planes, FILTER_NAME)
    hradius, vradius = int(hradius), int(vradius)
    hpasses, vpasses = int(hpasses), int(vpasses)
    require(hradius >= 0 and vradius >= 0, FILTER_NAME, "radius must be >= 0")

    vb = vradius > 0 and vpasses > 0
    hb = hradius > 0 and hpasses > 0
    require(vb or hb, FILTER_NAME, "nothing to be performed")

    for p in range(fmt.num_planes):
        if not process[p]:
            continue
        pw, ph = clip.plane_dims(p)
        if hb and 2 * hradius >= pw:
            raise VSZipError(
                f"{FILTER_NAME}: hradius too large; 2*hradius must be < the "
                "(smallest processed) plane width."
            )
        if vb and 2 * vradius >= ph:
            raise VSZipError(
                f"{FILTER_NAME}: vradius too large; 2*vradius must be < the "
                "(smallest processed) plane height."
            )

    use_rt = (hradius != vradius) or (hradius > 22) or (hpasses > 1) or (vpasses > 1)
    is_int = fmt.sample_type is SampleType.INTEGER

    out = []
    for p, x in enumerate(clip.planes):
        if not process[p]:
            out.append(x)
            continue
        out.append(
            _boxblur_plane(x, use_rt, hradius, hpasses, vradius, vpasses, is_int)
        )
    return clip.with_planes(out)
