"""SSIMULACRA2: Cloudinary's perceptual image-quality metric (version 2.1).

Reference: src/filters/ssimulacra2.zig + src/vapoursynth/ssimulacra2.zig.
Inputs are converted to linear RGBS (reference: toRGBS then an sRGB->linear
Resize; here core.resample).  Per frame and per scale s in 0..5 (each scale
a clamped 2x2 box downscale of the previous):

* XYB opsin transform (absorbance matrix, cbrt, per-channel affine),
* per channel: 9-tap separable Gaussian blur of mu1, mu2, (im1*im2), and
  (im1-im2)^2 (the reference's hybrid edge mirror), then
* SSIM map ``1 - num_m*num_s/denom_s`` (f64, 1-norm and 4-norm averages) and
  the asymmetric artifact / detail-loss ratio maps,
* the 108-weight fold + cubic polynomial + power nonlinearity -> score.

Zero-weight (plane, scale) pairs are pruned exactly like the reference's
comptime skip table.  XLA's cbrt/pow replace the VCL polynomial ports
(documented deviation inside the metric's own tolerance; the reference
pins its golden score at rel=1e-3).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.clip import Clip
from ..core.format import SampleType
from ..core.params import VSZipError, require
from ..core.resample import srgb_to_linear, to_rgbs

FILTER_NAME = "SSIMULACRA2"

_KERNEL = np.array([
    0.0076144188642501831054687500, 0.0360749699175357818603515625,
    0.1095860823988914489746093750, 0.2134445458650588989257812500,
    0.2665599882602691650390625000, 0.2134445458650588989257812500,
    0.1095860823988914489746093750, 0.0360749699175357818603515625,
    0.0076144188642501831054687500,
], np.float32)
_RADIUS = 4

# ssimulacra2 v2.1 fitted weights (public metric constants)
WEIGHT = np.array([
    0.0, 0.0007376606707406586, 0.0, 0.0, 0.0007793481682867309, 0.0,
    0.0, 0.0004371155730107379, 0.0, 1.1041726426657346, 0.00066284834129271,
    0.00015231632783718752, 0.0, 0.0016406437456599754, 0.0,
    1.8422455520539298, 11.441172603757666, 0.0, 0.0007989109436015163,
    0.000176816438078653, 0.0, 1.8787594979546387, 10.94906990605142, 0.0,
    0.0007289346991508072, 0.9677937080626833, 0.0, 0.00014003424285435884,
    0.9981766977854967, 0.00031949755934435053, 0.0004550992113792063, 0.0,
    0.0, 0.0013648766163243398, 0.0, 0.0, 0.0, 0.0, 0.0, 7.466890328078848,
    0.0, 17.445833984131262, 0.0006235601634041466, 0.0, 0.0,
    6.683678146179332, 0.00037724407979611296, 1.027889937768264,
    225.20515300849274, 0.0, 0.0, 19.213238186143016, 0.0011401524586618361,
    0.001237755635509985, 176.39317598450694, 0.0, 0.0, 24.43300999870476,
    0.28520802612117757, 0.0004485436923833408, 0.0, 0.0, 0.0,
    34.77906344483772, 44.835625328877896, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0008680556573291698, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0005313191874358747, 0.0, 0.00016533814161379112, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0004179171803251336, 0.0017290828234722833, 0.0,
    0.0020827005846636437, 0.0, 0.0, 8.826982764996862, 23.19243343998926,
    0.0, 95.1080498811086, 0.9863978034400682, 0.9834382792465353,
    0.0012286405048278493, 171.2667255897307, 0.9807858872435379, 0.0, 0.0,
    0.0, 0.0005130064588990679, 0.0, 0.00010854057858411537,
], np.float64)
assert WEIGHT.shape == (108,)

_PRUNE = 0.01


def _skip(plane: int, scale: int):
    base = plane * 36 + scale * 6
    return dict(
        ssim=WEIGHT[base] <= _PRUNE and WEIGHT[base + 3] <= _PRUNE,
        artifact=WEIGHT[base + 1] <= _PRUNE and WEIGHT[base + 4] <= _PRUNE,
        detailloss=WEIGHT[base + 2] <= _PRUNE and WEIGHT[base + 5] <= _PRUNE,
    )


def _downscale2(x):
    """clamped 2x2 box downscale, (N,H,W) -> (N,ceil(H/2),ceil(W/2)).

    reduce_window instead of four strided views (the window sum associates (a+b)+(c+d) instead of ((a+b)+c)+d — a 1-ulp
    shift, inside the metric's 1e-3 score contract)."""
    n, h, w = x.shape
    xp = jnp.pad(x, ((0, 0), (0, h % 2), (0, w % 2)), mode="edge")
    return jax.lax.reduce_window(
        xp, np.float32(0.0), jax.lax.add, (1, 2, 2), (1, 2, 2), "VALID"
    ) * jnp.float32(0.25)


_K_M = np.array([
    [0.30, 1.0 - 0.078 - 0.30, 0.078],
    [0.23, 1.0 - 0.078 - 0.23, 0.078],
    [0.24342269, 0.20476745, 1.0 - 0.24342269 - 0.20476745],
], np.float32)
_K_BIAS = np.float32(0.0037930734)
_K_D1 = np.float32(np.cbrt(0.0037930734))


# Bit-faithful port of the reference's VCL2 cbrt (src/vcl.zig:40-81);
# shared with the Deband m6/m7 pow/atan ports in ops/vcl.py.  Replaces
# XLA's own cbrt so the XYB nonlinearity rounds like the reference's
# SIMD build (the largest contributor to the round-3 score residual).
from .vcl import cbrt as _vcl_cbrt


def _to_xyb(r, g, b):
    mix = []
    for row in _K_M:
        # right-associated like the reference's fma chain
        # (ssimulacra2.zig:428-430 mulAdd(m0, r, mulAdd(m1, g,
        # mulAdd(m2, b, bias))))
        m = row[0] * r + (row[1] * g + (row[2] * b + _K_BIAS))
        mix.append(_vcl_cbrt(jnp.maximum(m, 0.0)) - _K_D1)
    cx, cy, cz = mix
    xv = 0.5 * (cx - cy)
    yv = 0.5 * (cx + cy)
    return (
        xv * jnp.float32(14.0) + jnp.float32(0.42),
        yv + jnp.float32(0.01),
        (cz - yv) + jnp.float32(0.55),
    )


def _tap_hybrid(x, off: int, axis: int):
    """The reference blur's edge rule (ssimulacra2.zig blurH :247-309):
    leading taps reflect-101 clamped to n-1, trailing taps read the fixed
    index n-1-off (clamped at 0 by the min(.., j) term)."""
    n = x.shape[axis]
    sl = lambda s, e: jax.lax.slice_in_dim(x, s, e, axis=axis)
    if off == 0:
        return x
    if n <= _RADIUS:
        # degenerate dims (deep pyramid levels of tiny inputs): build the
        # tap from single-row slices by the literal index formula
        idx = []
        for j in range(n):
            if off < 0:
                idx.append(min(-off - j, n - 1) if j < -off else j + off)
            else:
                dist = n - 1 - j
                idx.append(j - min(off - dist, j) if dist < off else j + off)
        return jnp.concatenate([sl(i, i + 1) for i in idx], axis=axis)
    if off < 0:
        head = jnp.flip(sl(1, 1 - off), axis=axis)
        return jnp.concatenate([head, sl(0, n + off)], axis=axis)
    fill = sl(max(n - 1 - off, 0), max(n - 1 - off, 0) + 1)
    reps = [1, 1, 1]
    reps[axis] = off
    return jnp.concatenate([sl(off, n), jnp.tile(fill, reps)], axis=axis)


def _blur_1d(x, axis: int):
    """One 9-tap pass along `axis` with the hybrid edge rule, bit-identical
    to the per-tap ladder.  The leading (reflect-101) taps come from ONE
    shared padded array whose slices fuse into the add ladder (the per-tap
    concatenate form materialized every tap: 9 full-plane copies per pass);
    only the last RADIUS positions follow the non-mirrorlike trailing rule
    and are recomputed exactly."""
    n = x.shape[axis]
    if n < 2 * _RADIUS + 1:
        acc = None
        for k in range(9):
            t = _KERNEL[k] * _tap_hybrid(x, k - _RADIUS, axis)
            acc = t if acc is None else acc + t
        return acc
    sl = lambda s, e: jax.lax.slice_in_dim(x, s, e, axis=axis)
    head = jnp.flip(sl(1, 1 + _RADIUS), axis=axis)
    tail = jnp.concatenate([sl(n - 1, n)] * _RADIUS, axis=axis)  # fixed below
    pad = jnp.concatenate([head, x, tail], axis=axis)
    acc = None
    for k in range(9):
        t = _KERNEL[k] * jax.lax.slice_in_dim(pad, k, k + n, axis=axis)
        acc = t if acc is None else acc + t
    rows = []
    for j in range(n - _RADIUS, n):
        a = None
        for k in range(9):
            off = k - _RADIUS
            dist = n - 1 - j
            i = j + off if (off <= 0 or dist >= off) else n - 1 - off
            t = _KERNEL[k] * sl(i, i + 1)
            a = t if a is None else a + t
        rows.append(a)
    return jnp.concatenate(
        [jax.lax.slice_in_dim(acc, 0, n - _RADIUS, axis=axis)] + rows,
        axis=axis)


def _blur(x):
    """9-tap separable Gaussian, V then H, hybrid edge mirror, f32 ladder."""
    return _blur_1d(_blur_1d(x, 1), 2)


def _norms_raw(m):
    # full-resolution math stays f32 (f64 runs at a fraction of its rate);
    # XLA's tree reduction keeps the f32 sum error ~1e-7 relative, far
    # inside the metric's 1e-3 score tolerance.  The scalar tail widens
    # to f64 to match the reference's final fold.
    s1 = jnp.sum(m, axis=(1, 2)).astype(jnp.float64)
    m4 = (m * m) * (m * m)
    s4 = jnp.sum(m4, axis=(1, 2)).astype(jnp.float64)
    return s1, s4


def _plane_sums(im1, im2, need_ssim: bool, need_err: bool):
    """Raw map sums [ssim_1, ssim_4, art_1, art_4, det_1, det_4], each (N,)
    f64 (4-norm entries are pre-root sums of m^4)."""
    n = im1.shape[0]
    zero = jnp.zeros((n,), jnp.float64)
    mu1 = _blur(im1)
    mu2 = _blur(im2)
    if need_ssim:
        s12 = _blur(im1 * im2)
        # The reference builds the SSIM denominator from blur((im1+im2)^2)
        # minus 2*s12 (ssimulacra2.zig:228-246, :522).  Algebraically
        # s11 + s22 - m11 - m22 == 2*(s12 - m12) + [blur((im1-im2)^2)
        # - (mu1-mu2)^2]; this form is used here because the bracketed
        # correction is EXACTLY zero when im1 == im2 (blur of an exact-zero
        # plane), so den_s == num_s bit-for-bit and identical inputs score
        # exactly 100 (the reference pins == 100.0 in its tests) no matter
        # what FMA contractions the compiler forms -- the reference's form
        # only cancels when the products happen to round the same way.
        sd = _blur((im1 - im2) ** 2)
        md = mu1 - mu2
        num_m = 1.0 - md * md
        s12c = s12 - mu1 * mu2
        core = s12c + s12c
        num_s = core + jnp.float32(0.0009)
        den_s = (core + (sd - md * md)) + jnp.float32(0.0009)
        d1 = jnp.maximum(1.0 - (num_m * num_s) / den_s, jnp.float32(0.0))
        ssim1, ssim4 = _norms_raw(d1)
    else:
        ssim1 = ssim4 = zero
    if need_err:
        n1 = jnp.abs(im1 - mu1)
        n2 = jnp.abs(im2 - mu2)
        d1e = (1.0 + n2) / (1.0 + n1) - 1.0
        art1, art4 = _norms_raw(jnp.maximum(d1e, jnp.float32(0.0)))
        det1, det4 = _norms_raw(jnp.maximum(-d1e, jnp.float32(0.0)))
    else:
        art1 = art4 = det1 = det4 = zero
    return ssim1, ssim4, art1, art4, det1, det4


@jax.jit
def _ssimulacra2_frames(planes1, planes2):
    """planes: 3-tuples of (N,H,W) f32 linear RGB.  Returns (N,) scores."""
    n = planes1[0].shape[0]
    score = jnp.zeros((n,), jnp.float64)
    wi = 0  # weight cursor mirrors the reference's fold order
    terms = {}

    src1, src2 = planes1, planes2
    for scale in range(6):
        if scale > 0:
            src1 = tuple(_downscale2(p) for p in src1)
            src2 = tuple(_downscale2(p) for p in src2)
        npix = 1.0 / float(src1[0].shape[1] * src1[0].shape[2])
        xyb1 = _to_xyb(*src1)
        xyb2 = _to_xyb(*src2)
        for plane in range(3):
            sk = _skip(plane, scale)
            im1, im2 = xyb1[plane], xyb2[plane]
            need_ssim = not sk["ssim"]
            need_err = not (sk["artifact"] and sk["detailloss"])
            if not (need_ssim or need_err):
                terms[(scale, plane)] = (0.0,) * 6
                continue
            raw = _plane_sums(im1, im2, need_ssim, need_err)
            ssim1 = raw[0] * npix
            ssim4 = jnp.sqrt(jnp.sqrt(raw[1] * npix))
            art1 = raw[2] * npix
            art4 = jnp.sqrt(jnp.sqrt(raw[3] * npix))
            det1 = raw[4] * npix
            det4 = jnp.sqrt(jnp.sqrt(raw[5] * npix))
            terms[(scale, plane)] = (ssim1, ssim4, art1, art4, det1, det4)

    # fold in the reference's weight order
    # (plane-major, scale, then [ssim, artifact, detailloss] x [1-norm, 4-norm])
    i = 0
    for plane in range(3):
        for scale in range(6):
            ssim1, ssim4, art1, art4, det1, det4 = terms[(scale, plane)]
            for vals in ((ssim1, art1, det1), (ssim4, art4, det4)):
                for v in vals:
                    if np.ndim(v) == 0 and v == 0.0:
                        i += 1
                        continue
                    score = score + WEIGHT[i] * jnp.abs(v)
                    i += 1

    ssim = score * 0.9562382616834844
    ssim = (
        6.248496625763138e-5 * ssim * ssim * ssim
        + 2.326765642916932 * ssim
        - 0.020884521182843837 * ssim * ssim
    )
    return jnp.where(
        ssim > 0.0,
        jnp.power(ssim, 0.6276336467831387) * -10.0 + 100.0,
        100.0,
    )


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _chunk_scores(c1: Clip, c2: Clip, lin1: bool, lin2: bool,
                  mat1: int = 6, mat2: int = 6):
    """Whole chunk pipeline (toRGBS + EOTF + metric) under ONE jit, so the
    conversion chain does not dispatch one program per op.  c1/c2 carry
    no props (the _Transfer/_Matrix checks are hoisted to static flags)."""
    r1 = to_rgbs(c1, matrix=mat1)
    r2 = to_rgbs(c2, matrix=mat2)
    if not lin1:
        r1 = srgb_to_linear(r1)
    if not lin2:
        r2 = srgb_to_linear(r2)
    return _ssimulacra2_frames(tuple(r1.planes), tuple(r2.planes))


def ssimulacra2(reference: Clip, distorted: Clip) -> Clip:
    """Returns a copy of `reference` carrying the per-frame prop
    SSIMULACRA2 (the reference props a copy of src1)."""
    if (reference.width, reference.height) != (distorted.width, distorted.height):
        raise VSZipError(f"{FILTER_NAME}: clips must have the same dimensions.")
    if reference.num_frames != distorted.num_frames:
        raise VSZipError(f"{FILTER_NAME}: clips must have the same length.")
    for c in (reference, distorted):
        if (c.format.sample_type is SampleType.FLOAT
                and c.format.bits_per_sample == 16):
            raise VSZipError(f"{FILTER_NAME}: half precision input is not supported.")
    from ..core.resample import pick_matrix

    lin1 = reference.props.get("_Transfer") == 8
    lin2 = distorted.props.get("_Transfer") == 8
    mat1 = pick_matrix(reference)
    mat2 = pick_matrix(distorted)
    # the pyramid holds a few dozen full-frame f32 intermediates (sources,
    # XYB, blurs and maps); chunk the frame batch so they stay well under
    # device memory (~16 x 1080p frames per chunk)
    budget = 16 * 1080 * 1920
    chunk = max(1, budget // max(reference.width * reference.height, 1))
    n = reference.num_frames

    def sub(clip, i):
        return Clip(tuple(p[i : i + chunk] for p in clip.planes),
                    clip.format, {})

    if n <= chunk:
        scores = _chunk_scores(Clip(reference.planes, reference.format, {}),
                               Clip(distorted.planes, distorted.format, {}),
                               lin1, lin2, mat1, mat2)
    else:
        parts = [_chunk_scores(sub(reference, i), sub(distorted, i),
                               lin1, lin2, mat1, mat2)
                 for i in range(0, n, chunk)]
        scores = jnp.concatenate(parts)
    return reference.with_props(SSIMULACRA2=scores)
