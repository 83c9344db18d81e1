"""Compress: MPEG-2 / JPEG intra-block compression-artifact simulator.

Reference: src/filters/compress.zig + src/vapoursynth/compress.zig — an
8-bit 8x8 pipeline of forward integer DCT (the classic JPEG "islow" fixed
point transform, CONST_BITS=13/PASS1_BITS=4), intra quantize/dequantize
(MPEG-2 deadzone or JPEG symmetric rounding), and the FFmpeg-style integer
inverse DCT (ROW_SHIFT=11/COL_SHIFT=20 with the DC-only row fast path).
All arithmetic is wrapping i32 (i64 for the quantizer products) with i16
truncation between stages, so results are bit-exact to the reference.

Layout: the plane never leaves its natural (N, H, W) layout.  A
(blocks, 8, 8) batch would put 8 on the minor axis, where every
materialization pays a strided transpose.  Instead, each
1-D transform stage is (linear combination -> single rounding shift) per
output lane, so a whole pass is 15 shifted multiply-adds with period-8
coefficient vectors: out[w] = sum_s M[w%8, w%8+s] * x[w+s].  Wrapping i32
accumulation is bit-identical to the reference's butterfly order (mod-2^32
arithmetic is order-independent), quantization constants tile to (H, W)
planes, and the data-dependent DC-only row path becomes a masked select
driven by a group-of-8 OR (also shift-composed).  Everything fuses into a
handful of elementwise XLA kernels with the minor axis at full width.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.clip import Clip
from ..core.format import ColorFamily, SampleType
from ..core.params import VSZipError, get_value, require

FILTER_NAME = "Compress"

# standard tables (MPEG-1/2 default intra matrix; JPEG Annex K quant tables)
MPEG_INTRA = np.array([
    8, 16, 19, 22, 26, 27, 29, 34,
    16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38,
    22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48,
    26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69,
    27, 29, 35, 38, 46, 56, 69, 83,
], np.int64)

JPEG_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)

JPEG_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], np.int64)

# islow FDCT constants
_F = dict(
    F0_298631336=2446, F0_390180644=3196, F0_541196100=4433,
    F0_765366865=6270, F0_899976223=7373, F1_175875602=9633,
    F1_501321110=12299, F1_847759065=15137, F1_961570560=16069,
    F2_053119869=16819, F2_562915447=20995, F3_072711026=25172,
)
CONST_BITS, PASS1_BITS = 13, 4
QMAT_SHIFT = 21
INTRA_QUANT_BIAS = 3 << (8 - 3)
MPEG_BIAS = INTRA_QUANT_BIAS * (1 << (QMAT_SHIFT - 8))
MPEG_THRESH1 = (1 << QMAT_SHIFT) - MPEG_BIAS - 1
MPEG_THRESH2 = MPEG_THRESH1 << 1
JPEG_BIAS = 1 << (QMAT_SHIFT - 1)
W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520
ROW_SHIFT, COL_SHIFT = 11, 20
COL_DC_BIAS = (1 << (COL_SHIFT - 1)) // W4


def _i16(x):
    """wrapping truncation to i16, kept in i32 lanes"""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _unit_rows():
    return [np.eye(8, dtype=np.int64)[i] for i in range(8)]


def _fdct_mat() -> np.ndarray:
    """(8, 8) integer matrix M with raw_fdct[j] = sum_c M[j,c] * in[c].

    Each islow FDCT output is an exact integer linear combination followed
    by a single rounding shift (reference src/filters/compress.zig fdct:
    every o[k] gets exactly one descale / one << PASS1_BITS), so tracing
    the butterfly over unit vectors recovers the per-lane row."""
    t = _unit_rows()
    tmp0, tmp7 = t[0] + t[7], t[0] - t[7]
    tmp1, tmp6 = t[1] + t[6], t[1] - t[6]
    tmp2, tmp5 = t[2] + t[5], t[2] - t[5]
    tmp3, tmp4 = t[3] + t[4], t[3] - t[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    o = [None] * 8
    o[0] = tmp10 + tmp11
    o[4] = tmp10 - tmp11
    z1 = (tmp12 + tmp13) * _F["F0_541196100"]
    o[2] = z1 + tmp13 * _F["F0_765366865"]
    o[6] = z1 + tmp12 * (-_F["F1_847759065"])
    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * _F["F1_175875602"]
    o4 = tmp4 * _F["F0_298631336"]
    o5 = tmp5 * _F["F2_053119869"]
    o6 = tmp6 * _F["F3_072711026"]
    o7 = tmp7 * _F["F1_501321110"]
    z1 = z1 * (-_F["F0_899976223"])
    z2 = z2 * (-_F["F2_562915447"])
    z3 = z3 * (-_F["F1_961570560"]) + z5
    z4 = z4 * (-_F["F0_390180644"]) + z5
    o[7] = o4 + z1 + z3
    o[5] = o5 + z2 + z4
    o[3] = o6 + z2 + z3
    o[1] = o7 + z1 + z4
    return np.stack(o)


def _idct_mat() -> np.ndarray:
    """(8, 8) matrix for the FFmpeg simple-IDCT butterfly (both passes use
    the same linear form; the row/column biases are uniform additive
    constants applied by the caller before the shift)."""
    c = _unit_rows()
    a0 = W4 * c[0]
    a1, a2, a3 = a0.copy(), a0.copy(), a0.copy()
    a0 = a0 + W2 * c[2]
    a1 = a1 + W6 * c[2]
    a2 = a2 - W6 * c[2]
    a3 = a3 - W2 * c[2]
    b0 = W1 * c[1] + W3 * c[3]
    b1 = W3 * c[1] - W7 * c[3]
    b2 = W5 * c[1] - W1 * c[3]
    b3 = W7 * c[1] - W5 * c[3]
    a0 = a0 + W4 * c[4] + W6 * c[6]
    a1 = a1 - W4 * c[4] - W2 * c[6]
    a2 = a2 - W4 * c[4] + W2 * c[6]
    a3 = a3 + W4 * c[4] - W6 * c[6]
    b0 = b0 + W5 * c[5] + W7 * c[7]
    b1 = b1 - W1 * c[5] - W5 * c[7]
    b2 = b2 + W7 * c[5] + W3 * c[7]
    b3 = b3 + W3 * c[5] - W1 * c[7]
    return np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                     a3 - b3, a2 - b2, a1 - b1, a0 - b0])


@lru_cache(maxsize=None)
def _shift_coefs(kind: str, n: int):
    """Period-8 coefficient vectors: out[w] = sum_s coef_s[w] * x[w+s].

    coef_s[w] = M[w%8, w%8+s] when the source lane stays inside the group,
    else 0 — the group-of-8 all-to-all becomes 15 shifted multiply-adds on
    full-width lanes.  Wrapping i32 accumulation commutes mod 2^32, so the
    result is bit-identical to the reference's butterfly evaluation."""
    mat = _fdct_mat() if kind == "fdct" else _idct_mat()
    lanes = np.arange(n) % 8
    out = []
    for s in range(-7, 8):
        src = lanes + s
        valid = (src >= 0) & (src < 8)
        coef = np.where(valid, mat[lanes, np.clip(src, 0, 7)], 0)
        if np.any(coef):
            out.append((s, coef.astype(np.int32)))
    return tuple(out)


def _group_linear(x, kind: str, axis: int):
    """Apply the 8-point butterfly matrix along `axis` of an (N, H, W) i32
    plane via shifted multiply-adds (shifts are slices of a once-padded
    array, fusing into the accumulation)."""
    n = x.shape[axis]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (8, 8)
    xp = jnp.pad(x, pad)
    shape = [1] * x.ndim
    shape[axis] = n
    acc = None
    for s, coef in _shift_coefs(kind, n):
        sl = jax.lax.slice_in_dim(xp, 8 + s, 8 + s + n, axis=axis)
        term = sl * jnp.asarray(coef).reshape(shape)
        acc = term if acc is None else acc + term
    return acc


@lru_cache(maxsize=None)
def _lane04(n: int) -> np.ndarray:
    """bool vector: lane % 8 in {0, 4} (the even-part fast outputs)."""
    return (np.arange(n) % 8) % 4 == 0


def _fdct_plane(x):
    """x: (N, H, W) i32 level-shifted pixels -> i16-range coefficients in
    plane layout (coefficient (j, i) of each block lives at (h%8==j,
    w%8==i))."""
    _, h, w = x.shape
    m04w = jnp.asarray(_lane04(w))[None, None, :]
    raw = _group_linear(x, "fdct", 2)
    p1 = _i16(jnp.where(m04w, raw * (1 << PASS1_BITS),
                        _descale(raw, CONST_BITS - PASS1_BITS)))
    m04h = jnp.asarray(_lane04(h))[None, :, None]
    raw2 = _group_linear(p1, "fdct", 1)
    return _i16(jnp.where(m04h, _descale(raw2, PASS1_BITS),
                          _descale(raw2, CONST_BITS + PASS1_BITS)))


def _idct_plane(q):
    """q: (N, H, W) i32 dequantized coefficients (i16-range) in plane
    layout -> i32 pixel values before the +level offset."""
    _, h, w = q.shape
    lanes_w = np.arange(w) % 8

    raw = _group_linear(q, "idct", 2)
    rows = _i16((raw + (1 << (ROW_SHIFT - 1))) >> ROW_SHIFT)

    # DC-only row fast path: group-of-8 OR over the AC lanes, then the DC
    # value broadcast across its group — both composed from masked shifts.
    ac = jnp.where(jnp.asarray(lanes_w != 0)[None, None, :], q, 0)
    acp = jnp.pad(ac, ((0, 0), (0, 0), (8, 8)))
    gor = None
    for s in range(-7, 8):
        mask = (lanes_w + s >= 0) & (lanes_w + s < 8)
        if not mask.any():
            continue
        sl = jax.lax.slice_in_dim(acp, 8 + s, 8 + s + w, axis=2)
        t = jnp.where(jnp.asarray(mask)[None, None, :], sl, 0)
        gor = t if gor is None else gor | t
    dcv = jnp.where(jnp.asarray(lanes_w == 0)[None, None, :], q, 0)
    dcp = jnp.pad(dcv, ((0, 0), (0, 0), (8, 8)))
    dcb = None
    for j in range(8):
        sl = jax.lax.slice_in_dim(dcp, 8 - j, 8 - j + w, axis=2)
        t = jnp.where(jnp.asarray(lanes_w == j)[None, None, :], sl, 0)
        dcb = t if dcb is None else dcb + t
    rows = jnp.where(gor == 0, _i16(dcb * 8), rows)

    raw2 = _group_linear(rows, "idct", 1)
    return (raw2 + W4 * COL_DC_BIAS) >> COL_SHIFT


def _tile_plane(tab64, h: int, w: int, dtype) -> np.ndarray:
    """(64,) per-coefficient table -> (1, H, W) plane-layout constant."""
    return np.tile(tab64.reshape(8, 8), (h // 8, w // 8)).astype(dtype)[None]


def _quant_setup(codec: str, qscale: int, dc_prec: int, quality: int,
                 is_chroma: bool):
    """Host-side quantizer tables + the i64-wide determination.  Returns
    (qa, qb, wide) with qa/qb the per-coefficient (64,) quant/dequant
    tables."""
    if codec == "mpeg2":
        qscale2 = qscale << 1
        qmat = (2 << QMAT_SHIFT) // (qscale2 * MPEG_INTRA)
        # DCT coefs fit i16 (FFmpeg stores them in int16_t blocks), so the
        # quant product is bounded by 32767*max(qmat); stay in i32 when that
        # fits (every qscale >= 2 does) — i64 vector math is emulated-slow
        wide = (32767 * int(qmat[1:].max())
                + max(MPEG_BIAS, MPEG_THRESH1) >= 2**31)
        return qmat, qscale2 * MPEG_INTRA, wide
    base = JPEG_CHROMA if is_chroma else JPEG_LUMA
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    qtab = np.clip((base * scale + 50) // 100, 1, 255)
    jqmat = (1 << QMAT_SHIFT) // (8 * qtab)
    wide = 32767 * int(jqmat.max()) + JPEG_BIAS >= 2**31
    return jqmat, qtab, wide


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _compress_plane(x, codec: str, qscale: int, dc_prec: int, quality_chroma):
    """x: (N, H, W) uint8 padded to 8-multiples."""
    quality, is_chroma = quality_chroma
    _, h, w = x.shape
    level = 128 if codec == "jpeg" else 0
    coeff = _fdct_plane(x.astype(jnp.int32) - level)

    dcm = (jnp.asarray((np.arange(h) % 8 == 0))[None, :, None]
           & jnp.asarray((np.arange(w) % 8 == 0))[None, None, :])
    qa64, qb64, wide = _quant_setup(codec, qscale, dc_prec, quality,
                                       is_chroma)
    acc = jnp.int64 if wide else jnp.int32
    npacc = np.int64 if wide else np.int32
    if codec == "mpeg2":
        uacc = jnp.uint64 if wide else jnp.uint32
        cw = coeff.astype(acc)
        dc_scale = 8 >> dc_prec
        dc_q = dc_scale << 3
        # DC (the AC formulas read qmat[0] at DC positions; masked out below)
        dc_lv = coeff + (dc_q >> 1)
        dc_out = jnp.sign(dc_lv) * (jnp.abs(dc_lv) // dc_q)  # trunc division
        # FFmpeg assumes positive DC; divTrunc matches for both signs
        lv = cw * jnp.asarray(_tile_plane(qa64, h, w, npacc))
        # unsigned deadzone window test (wraparound safe: |lv|+T1 < 2^31)
        inrange = (lv + acc(MPEG_THRESH1)).astype(uacc) > uacc(MPEG_THRESH2)
        q = jnp.where(
            lv > 0,
            (MPEG_BIAS + lv) >> QMAT_SHIFT,
            -((MPEG_BIAS - lv) >> QMAT_SHIFT),
        )
        ac = jnp.where(inrange, q, 0).astype(jnp.int32)
        # dequantize
        deq = _tile_plane(qb64, h, w, np.int32)
        deq_ac = _i16(jnp.sign(ac) * ((jnp.abs(ac) * jnp.asarray(deq)) >> 4))
        out = jnp.where(dcm, _i16(dc_out * dc_scale), deq_ac)
    else:
        lv = coeff.astype(acc) * jnp.asarray(_tile_plane(qa64, h, w, npacc))
        q = jnp.where(
            lv > 0,
            (JPEG_BIAS + lv) >> QMAT_SHIFT,
            jnp.where(lv < 0, -((JPEG_BIAS - lv) >> QMAT_SHIFT), 0),
        ).astype(jnp.int32)
        out = _i16(q * jnp.asarray(_tile_plane(qb64, h, w, np.int32)))

    pix = _idct_plane(out) + level
    return jnp.clip(pix, 0, 255).astype(jnp.uint8)


def compress(clip: Clip, codec: int = 0, quality: int = 50, qscale: int = 8,
             dc_prec: int = 0, chroma: bool = True) -> Clip:
    """vszip.Compress (reference src/vapoursynth/compress.zig): codec 0 =
    MPEG-2 intra (qscale 1..31, dc_prec 0..3), codec 1 = JPEG (quality
    1..100); chroma=False passes chroma planes through.  8-bit Gray/YUV."""
    fmt = clip.format
    require(
        fmt.sample_type is SampleType.INTEGER and fmt.bits_per_sample == 8
        and fmt.color_family is not ColorFamily.RGB,
        FILTER_NAME, "only 8-bit integer Gray or YUV formats are supported.",
    )
    if codec not in (0, 1):
        raise VSZipError(f"{FILTER_NAME}: codec must be 0 (mpeg2) or 1 (jpeg).")
    if codec == 0:
        if not (1 <= int(qscale) <= 31):
            raise VSZipError(f"{FILTER_NAME}: qscale must be between 1 and 31.")
        if not (0 <= int(dc_prec) <= 3):
            raise VSZipError(f"{FILTER_NAME}: dc_prec must be between 0 and 3.")
    else:
        if not (1 <= int(quality) <= 100):
            raise VSZipError(f"{FILTER_NAME}: quality must be between 1 and 100.")
    codec_name = "jpeg" if codec == 1 else "mpeg2"
    process = [True, bool(chroma), bool(chroma)]

    out = []
    for p, x in enumerate(clip.planes):
        if not process[p]:
            out.append(x)
            continue
        h, w = x.shape[1], x.shape[2]
        xp = jnp.pad(x, ((0, 0), (0, -h % 8), (0, -w % 8)), mode="edge")
        y = _compress_plane(xp, codec_name, int(qscale), int(dc_prec),
                            (int(quality), p > 0))
        out.append(y[:, :h, :w])
    return clip.with_planes(out)
