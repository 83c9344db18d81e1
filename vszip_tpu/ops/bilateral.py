"""Bilateral: edge-preserving smoothing, two algorithms.

Reference: src/filters/bilateral.zig + src/vapoursynth/bilateral.zig.

* alg2 ("truncated"): spatial window of sub-sampled taps — offsets
  ``(+-xx, +-yy)`` for xx, yy in {1, 1+step, ...} < radius+1 (axes excluded,
  center weighted ``gs[0]*gr[0]``), replicate edge padding, spatial weights
  from a precomputed Gaussian LUT and range weights from a per-|diff| LUT
  (floats index at ``trunc(min(1,|d|)*65535 + 0.5)``).  Accumulation follows
  the reference's (yy, xx) loop order so f32 sums match bit-for-bit.
* alg1 (PBFIC, "Real-Time O(1) Bilateral Filtering", Yang et al.): `num`
  luminance levels; per level a range-weight plane Wk and product Jk are
  smoothed with the van Vliet / Young-van Vliet recursive Gaussian (forward+
  backward IIR in both axes, clamped warm-up history exactly as the
  reference) and the output linearly interpolates Jk/Wk between the two
  bracketing levels.  The IIR scans are `lax.scan`s vectorized over the
  orthogonal axis and the level axis.

Create-time parameter derivation (sigmaS chroma scaling, PBFICnum auto,
radius/step/samples, algorithm auto-select, plane disable on zero sigmas,
LUT generation incl. the range-LUT tail fill) reproduces
src/vapoursynth/bilateral.zig:104-231 in host NumPy.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.clip import Clip
from ..core.format import ColorFamily, SampleType
from ..core.params import VSZipError, compare_clips, get_array, parse_planes

FILTER_NAME = "Bilateral"


# ---------------------------------------------------------------------------
# create-time derivations (host numpy)
# ---------------------------------------------------------------------------

def _gs_lut(radius: int, sigma_s: float) -> np.ndarray:
    upper = radius + 1
    y, x = np.mgrid[0:upper, 0:upper].astype(np.float64)
    return np.exp((x * x + y * y) / (sigma_s * sigma_s * -2.0)).astype(np.float32)


def _gr_lut(hist_len: int, sigma_r: float) -> np.ndarray:
    rng = float(hist_len - 1)
    upper = int(np.trunc(min(rng, sigma_r * 8.0 * rng + 0.5)))
    i = np.arange(hist_len, dtype=np.float64)
    j = np.minimum(i, upper) / rng
    x = j / sigma_r
    lut = np.exp(x * x / -2.0) / (math.sqrt(2.0 * math.pi) * sigma_r)
    return lut.astype(np.float32)


def _recursive_gaussian_params(sigma: float):
    q = (
        3.97156 - 4.14554 * math.sqrt(1 - 0.26891 * sigma)
        if sigma < 2.5
        else 0.98711 * sigma - 0.96330
    )
    den = 1.57825 + 2.44413 * q + 1.4281 * q * q + 0.422205 * q**3
    n1 = 2.44413 * q + 2.85619 * q * q + 1.26661 * q**3
    n2 = -(1.4281 * q * q + 1.26661 * q**3)
    n3 = 0.422205 * q**3
    b = np.float32(1 - (n1 + n2 + n3) / den)
    return b, np.float32(n1 / den), np.float32(n2 / den), np.float32(n3 / den)


# ---------------------------------------------------------------------------
# alg2: truncated spatial window
# ---------------------------------------------------------------------------

def _shift2d_clamp(x, dy: int, dx: int):
    """x shifted by (dy, dx) with replicate (clamp) padding; (N,H,W)."""
    h, w = x.shape[1], x.shape[2]
    if dy:
        if dy > 0:
            x = jnp.concatenate(
                [x[:, dy:, :], jnp.repeat(x[:, -1:, :], dy, axis=1)], axis=1
            )
        else:
            x = jnp.concatenate(
                [jnp.repeat(x[:, :1, :], -dy, axis=1), x[:, :dy, :]], axis=1
            )
    if dx:
        if dx > 0:
            x = jnp.concatenate(
                [x[:, :, dx:], jnp.repeat(x[:, :, -1:], dx, axis=2)], axis=2
            )
        else:
            x = jnp.concatenate(
                [jnp.repeat(x[:, :, :1], -dx, axis=2), x[:, :, :dx]], axis=2
            )
    return x


def _range_weight(grf, cx, nb, is_int: bool):
    if is_int:
        idx = jnp.abs(cx.astype(jnp.int32) - nb.astype(jnp.int32))
    else:
        # subtract in the storage dtype, then widen (matches the reference's
        # f16 semantics: |a-b| computed in T before the f32 index math)
        ad = jnp.abs(cx - nb).astype(jnp.float32)
        idx = jnp.trunc(
            jnp.minimum(jnp.float32(1.0), ad) * jnp.float32(65535.0)
            + jnp.float32(0.5)
        ).astype(jnp.int32)
    return grf(idx)


def _gr_direct(hist_len: int, sigma_r: float):
    """Direct evaluation of the range-weight function (the reference bakes
    it into a hist_len LUT, src/filters/bilateral.zig:306-348; per-pixel
    table gathers are avoided, so the same expression is
    evaluated vectorized instead — identical formula, f32 exp)."""
    rng = float(hist_len - 1)
    upper = float(np.trunc(min(rng, sigma_r * 8.0 * rng + 0.5)))
    # the reference LUT builder divides twice in f64 ((idx/rng)/sigma);
    # fold both into one f64-precomputed scalar and run the per-pixel math
    # entirely in f32 (idx <= 65535 is f32-exact; the folded constant is
    # within 1 ulp, so the weight deviates by ~1e-7 relative — far inside
    # the filter's <=1-LSB output contract, and ~10x cheaper than the
    # emulated-f64 vector ops it replaces)
    scale = np.float32(1.0 / (rng * float(sigma_r)))

    def weight(idx):
        m = jnp.minimum(idx.astype(jnp.float32), np.float32(upper))
        t = m * scale
        a = t * t * np.float32(-0.5)
        return jnp.exp(a) * np.float32(
            1.0 / (math.sqrt(2.0 * math.pi) * sigma_r)
        )

    return weight


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 7, 8))
def _truncated(src, ref, gs, sigma_r: float, hist_len: int, radius: int,
               step: int, peak: float, is_int: bool):
    grf = _gr_direct(hist_len, sigma_r)
    n, h, w = src.shape
    # pad once with replicate edges; every tap is then a pure slice, which
    # XLA fuses into the arithmetic as offset reads (no per-tap copies)
    rpad = ((0, 0), (radius, radius), (radius, radius))
    srcp = jnp.pad(src, rpad, mode="edge")
    refp = srcp if src is ref else jnp.pad(ref, rpad, mode="edge")

    def tap(a, dy, dx):
        return jax.lax.slice(
            a, (0, radius + dy, radius + dx), (n, radius + dy + h, radius + dx + w)
        )

    sf = src.astype(jnp.float32)
    cx = ref
    w0 = gs[0] * grf(jnp.zeros((), jnp.int32))
    wsum = jnp.broadcast_to(w0, src.shape).astype(jnp.float32)
    s = sf * w0
    radius2 = radius + 1
    for yy in range(1, radius2, step):
        for xx in range(1, radius2, step):
            swei = gs[yy * radius2 + xx]
            offs = [(-yy, xx), (yy, xx), (-yy, -xx), (yy, -xx)]
            rws = [
                _range_weight(grf, cx, tap(refp, dy, dx), is_int)
                for dy, dx in offs
            ]
            wsum = wsum + swei * (rws[0] + rws[1] + rws[2] + rws[3])
            s = s + swei * sum(
                tap(srcp, dy, dx).astype(jnp.float32) * rw
                for (dy, dx), rw in zip(offs, rws)
            )
    r = s / wsum
    if is_int:
        return jnp.trunc(
            jnp.clip(r + jnp.float32(0.5), 0.0, jnp.float32(peak))
        ).astype(src.dtype)
    return r.astype(src.dtype)


# ---------------------------------------------------------------------------
# alg1: PBFIC with recursive Gaussian
# ---------------------------------------------------------------------------

def _iir_scan(x, b, b1, b2, b3, axis: int, compute_ends: bool):
    """Forward+backward van Vliet IIR along `axis` with the reference's
    warm-up semantics.  compute_ends=True (vertical pass): the first forward
    element and last backward element are *computed* from history seeded
    with their own value (the reference's aliased clamped reads); False
    (horizontal pass): they pass through unchanged."""
    x = jnp.moveaxis(x, axis, 0)  # (L, ...)

    def stepf(carry, v):
        o1, o2, o3 = carry
        o = b * v + b1 * o1 + b2 * o2 + b3 * o3
        return (o, o1, o2), o

    first_in = x[0]
    if compute_ends:
        o0 = b * first_in + b1 * first_in + b2 * first_in + b3 * first_in
    else:
        o0 = first_in
    _, rest = jax.lax.scan(stepf, (o0, o0, o0), x[1:])
    y = jnp.concatenate([o0[None], rest], axis=0)

    last = y[-1]
    if compute_ends:
        ol = b * last + b1 * last + b2 * last + b3 * last
    else:
        ol = last
    _, restb = jax.lax.scan(stepf, (ol, ol, ol), y[:-1], reverse=True)
    z = jnp.concatenate([restb, ol[None]], axis=0)
    return jnp.moveaxis(z, 0, axis)


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7))
def _pbfic(src, ref, num: int, sigma_s: float, peak: float, is_int: bool,
           sigma_r: float = 0.02, hist_len: int = 65536):
    n, h, w = src.shape
    b, b1, b2, b3 = _recursive_gaussian_params(sigma_s)
    if is_int:
        ks = np.arange(num, dtype=np.float32)
        pbfick = np.clip(
            np.trunc(peak * ks / np.float32(num - 1) + 0.5), 0, peak
        ).astype(np.float32)
    else:
        pbfick = (np.arange(num) / np.float64(num - 1)).astype(np.float32)

    reff = ref.astype(jnp.float32)
    srcf = src.astype(jnp.float32)

    grf = _gr_direct(hist_len, sigma_r)

    def level(pk):
        wk = _range_weight(grf, jnp.full_like(ref, pk.astype(ref.dtype)), ref,
                           is_int).astype(jnp.float32)
        jk = wk * srcf
        wk = _iir_scan(wk, b, b1, b2, b3, 2, False)
        wk = _iir_scan(wk, b, b1, b2, b3, 1, True)
        jk = _iir_scan(jk, b, b1, b2, b3, 2, False)
        jk = _iir_scan(jk, b, b1, b2, b3, 1, True)
        return jnp.where(wk == 0, 0.0, jk / wk)

    planes = jax.vmap(level)(jnp.asarray(pbfick))  # (num, N, H, W)

    # bracketing level k per pixel (reference loop semantics, first match,
    # default num-2 when no bracket matches)
    pb = jnp.asarray(pbfick)
    k_sel = jnp.full(src.shape, num - 2, jnp.int32)
    for k in range(num - 3, -1, -1):
        cond = (reff < pb[k + 1]) & (reff >= pb[k])
        k_sel = jnp.where(cond, k, k_sel)
    # per-pixel bracket select without gathers (num is small and static)
    p0 = jnp.zeros(src.shape, jnp.float32)
    p1 = jnp.zeros(src.shape, jnp.float32)
    lo = jnp.zeros(src.shape, jnp.float32)
    hi = jnp.zeros(src.shape, jnp.float32)
    for k in range(num - 1):
        m = k_sel == k
        p0 = jnp.where(m, pb[k], p0)
        p1 = jnp.where(m, pb[k + 1], p1)
        lo = jnp.where(m, planes[k], lo)
        hi = jnp.where(m, planes[k + 1], hi)
    vf = ((p1 - reff) * lo + (reff - p0) * hi) / (p1 - p0)
    if is_int:
        return jnp.trunc(
            jnp.clip(vf + jnp.float32(0.5), 0.0, jnp.float32(peak))
        ).astype(src.dtype)
    return vf.astype(src.dtype)


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------

def bilateral(clip: Clip, ref: Clip | None = None, sigmaS=None, sigmaR=None,
              planes=None, algorithm=None, PBFICnum=None) -> Clip:
    fmt = clip.format
    if fmt.sample_type is SampleType.INTEGER and fmt.bits_per_sample == 32:
        raise VSZipError(f"{FILTER_NAME}: not supported Int format.")
    yuv = fmt.color_family is ColorFamily.YUV
    hist_len = fmt.hist_len()
    peak = float(hist_len - 1)
    is_int = fmt.sample_type is SampleType.INTEGER

    # sigmaS defaulting incl. chroma subsampling scaling (reference :104-125)
    if sigmaS is None:
        sigmaS = []
    elif not isinstance(sigmaS, (list, tuple)):
        sigmaS = [sigmaS]
    s_s = [0.0] * 3
    for i in range(3):
        if i < len(sigmaS):
            s_s[i] = float(sigmaS[i])
        elif i == 0:
            s_s[0] = 3.0
        elif i == 1 and yuv and fmt.subsampling_h and fmt.subsampling_w:
            factor = float((1 << fmt.subsampling_h) * (1 << fmt.subsampling_w))
            s_s[1] = s_s[0] / math.sqrt(factor)
        else:
            s_s[i] = s_s[i - 1]
        if s_s[i] < 0:
            raise VSZipError(
                'Bilateral: Invalid "sigmaS" assigned, must be non-negative '
                "float number"
            )

    s_r = get_array(sigmaR, "sigmaR", 0.02, 0.0, float("inf"), FILTER_NAME)
    alg = get_array(algorithm, "algorithm", 0, 0, 2, FILTER_NAME)
    pbficnum = get_array(PBFICnum, "PBFICnum", 0, 0, 256, FILTER_NAME)
    process = parse_planes(planes, fmt.num_planes, FILTER_NAME)
    process += [False] * (3 - len(process))

    for i in range(3):
        if s_s[i] == 0 or s_r[i] == 0:
            process[i] = False
    for num in pbficnum:
        if num == 1:
            raise VSZipError(
                'Bilateral: Invalid "PBFICnum" assigned, must be integer '
                "ranges in [0,256] except 1"
            )

    pbficnum = [int(v) for v in pbficnum]
    for i in range(3):
        if process[i] and pbficnum[i] == 0:
            if s_r[i] >= 0.08:
                pbficnum[i] = 4
            elif s_r[i] >= 0.015:
                pbficnum[i] = min(16, int(4 * 0.08 / s_r[i] + 0.5))
            else:
                pbficnum[i] = min(32, int(16 * 0.015 / s_r[i] + 0.5))
            if i > 0 and yuv and pbficnum[i] % 2 == 0 and pbficnum[i] < 256:
                pbficnum[i] += 1

    radius = [0] * 3
    step = [0] * 3
    samples = [0] * 3
    for i in range(3):
        if not process[i]:
            continue
        orad = max(int(s_s[i] * 2 + 0.5), 1)
        step[i] = 1 if orad < 4 else (2 if orad < 8 else 3)
        samples[i] = 1
        radius[i] = 1 + (samples[i] - 1) * step[i]
        while orad * 2 > radius[i] * 3:
            samples[i] += 1
            radius[i] = 1 + (samples[i] - 1) * step[i]
            if radius[i] >= orad and samples[i] > 2:
                samples[i] -= 1
                radius[i] = 1 + (samples[i] - 1) * step[i]
                break

    alg = [int(a) for a in alg]
    for i in range(3):
        if process[i] and alg[i] <= 0:
            if step[i] == 1:
                alg[i] = 2
            elif s_r[i] < 0.08 and samples[i] < 5:
                alg[i] = 2
            elif 4 * samples[i] * samples[i] <= 15 * pbficnum[i]:
                alg[i] = 2
            else:
                alg[i] = 1

    for i in range(fmt.num_planes):
        if process[i] and alg[i] == 2:
            pw, ph = clip.plane_dims(i)
            if pw <= 2 * radius[i] or ph <= 2 * radius[i]:
                raise VSZipError(
                    "Bilateral: plane too small for the spatial radius derived "
                    "from sigmaS; lower sigmaS or use a larger clip."
                )

    if ref is not None:
        compare_clips([clip, ref], FILTER_NAME, same_len=False, bigger_than=True)
    rclip = ref if ref is not None else clip

    out = []
    nf = clip.num_frames
    for p in range(fmt.num_planes):
        x = clip.planes[p]
        if not process[p]:
            out.append(x)
            continue
        rp = rclip.planes[p][:nf]
        if alg[p] == 1:
            out.append(
                _pbfic(x, rp, pbficnum[p], float(s_s[p]), peak, is_int,
                       sigma_r=float(s_r[p]), hist_len=hist_len)
            )
        else:
            gs = jnp.asarray(_gs_lut(radius[p], s_s[p]).reshape(-1))
            out.append(
                _truncated(x, rp, gs, float(s_r[p]), hist_len, radius[p],
                           step[p], peak, is_int)
            )
    return clip.with_planes(out)
