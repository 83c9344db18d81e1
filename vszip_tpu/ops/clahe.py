"""CLAHE: contrast-limited adaptive histogram equalization (OpenCV-style).

Reference: src/filters/clahe.zig + src/vapoursynth/clahe.zig.  8/16-bit int,
all planes.  Per tile (tile_w = width // tiles_x, tile_h = height // tiles_y;
remainder pixels contribute to no histogram but are still interpolated):

1. histogram, clipped at ``clip_limit = max(limit*tile_area//hist_size, 1)``;
   the clipped excess is redistributed: ``excess // hist_size`` to every bin,
   the residual to bins ``{k*step}`` with ``step = max(hist_size//residual,1)``;
2. LUT = ``trunc(cumsum * peak/tile_area + 0.5)``;
3. output = bilinear interpolation of the 4 neighboring tile LUTs at the
   source value (tile coords ``x/tile_w - 0.5``, clamped), rounded half-up.

Sets ``_ColorRange`` FULL.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.clip import Clip
from ..core.format import SampleType
from ..core.params import VSZipError, require

FILTER_NAME = "CLAHE"


def _r(v):
    """Round an f64 value to the nearest f32 value, kept in f64: with f32
    operands, f64 products and sums are exact, so chaining _r reproduces
    strict (uncontracted) f32 arithmetic on every backend — XLA is
    otherwise free to contract mul+add into FMA, which flips ties at a
    trunc(x + 0.5) rounding boundary.  reduce_precision is one explicit op,
    which no simplifier folds the way it may fold a f64->f32->f64 convert
    pair."""
    return jax.lax.reduce_precision(v, exponent_bits=8, mantissa_bits=23)


def _blend_bilinear_f32_exact(l0, l1, l2, l3, xa, ya):
    """The reference's bilinear blend (clahe.zig:265-268) in strict f32
    (see _r), identical on every backend."""
    r = _r

    l0, l1, l2, l3 = (v.astype(jnp.float64) for v in (l0, l1, l2, l3))
    xa = xa.astype(jnp.float64)
    ya = ya.astype(jnp.float64)
    oxa = r(1.0 - xa)
    oya = r(1.0 - ya)
    t1 = r(r(l0 * oxa) + r(l1 * xa))
    t2 = r(r(l2 * oxa) + r(l3 * xa))
    res = r(r(t1 * oya) + r(t2 * ya))
    return jnp.trunc(r(res + 0.5))


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _clahe_plane(x, limit: int, tiles_x: int, tiles_y: int, bits: int):
    n, height, width = x.shape
    hist_size = 1 << bits
    peak = float(hist_size - 1)
    tile_w = width // tiles_x
    tile_h = height // tiles_y
    tile_area = tile_w * tile_h
    lut_scale = np.float32(peak / tile_area)
    clip_limit = max(limit * tile_area // hist_size, 1)

    # --- per-tile histograms over the covered region ---
    xi = x[:, : tiles_y * tile_h, : tiles_x * tile_w].astype(jnp.int32)
    txy = xi.reshape(n, tiles_y, tile_h, tiles_x, tile_w)
    vals = txy.transpose(0, 1, 3, 2, 4).reshape(n * tiles_y * tiles_x, tile_area)
    if bits <= 8:
        # nibble-decomposed histogram: hist[t, h*16+l] counts pixels with
        # high nibble h and low nibble l, i.e. an outer-product contraction
        # hi_onehot^T @ lo_onehot over the tile's pixels.  The one-hots cost
        # 32 compares/pixel (vs 256 for a direct compare-reduce) and the
        # 256-bin accumulation is a matrix product.  It is exact under any
        # matmul precision: the operands are 0/1 and every partial count
        # stays below 2^24 in the f32 accumulator.
        #
        # The contraction is CHUNKED over the pixel axis with a lax.scan
        # once the (t, p, 16) bf16 one-hots XLA materializes as dot
        # operands (~64 B/pixel combined) would pass 1 GiB.  Chunking bounds
        # the operands to ~t*0.5 MB per step, and since each partial
        # histogram is accumulated in int32, counts are exact for ANY
        # tile_area (the un-chunked f32 accumulator is only exact below
        # 2^24 pixels).
        i16 = jnp.arange(16, dtype=jnp.int32)
        t_cnt = vals.shape[0]
        onehot_bytes = 2 * t_cnt * tile_area * 16 * 2
        if onehot_bytes <= (1 << 30) and tile_area < (1 << 24):
            # operands fit comfortably; single contraction (counts < 2^24
            # are exact in the f32 accumulator)
            hi = (vals[:, :, None] >> 4) == i16[None, None, :]
            lo = (vals[:, :, None] & 15) == i16[None, None, :]
            hist = jnp.einsum(
                "tph,tpl->thl",
                hi.astype(jnp.bfloat16),
                lo.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            ).astype(jnp.int32)
        else:
            # chunk the pixel axis with a scan: bounds the materialized
            # one-hots AND makes counts exact for any tile_area (partials
            # <= chunk < 2^24 each, accumulated in int32).
            chunk = 32768
            pad = (-tile_area) % chunk
            # pad value -1: its high nibble matches no one-hot lane, so
            # padded pixels contribute nothing to the outer product.
            valsp = jnp.pad(vals, ((0, 0), (0, pad)), constant_values=-1)
            valsc = valsp.reshape(t_cnt, -1, chunk).transpose(1, 0, 2)

            def body(acc, vc):
                hi = (vc[:, :, None] >> 4) == i16[None, None, :]
                lo = (vc[:, :, None] & 15) == i16[None, None, :]
                part = jnp.einsum(
                    "tph,tpl->thl",
                    hi.astype(jnp.bfloat16),
                    lo.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32,
                ).astype(jnp.int32)
                return acc + part, None

            hist0 = jnp.zeros((t_cnt, 16, 16), jnp.int32)
            hist, _ = jax.lax.scan(body, hist0, valsc)
        hist = hist.reshape(n, tiles_y * tiles_x, hist_size)
    else:
        offs = (
            jax.lax.broadcasted_iota(jnp.int32, (n * tiles_y * tiles_x, 1), 0)
            * hist_size
        )
        flat_idx = (vals + offs).reshape(-1)
        hist = (
            jnp.zeros((n * tiles_y * tiles_x * hist_size,), jnp.int32)
            .at[flat_idx]
            .add(1)
            .reshape(n, tiles_y * tiles_x, hist_size)
        )

    # --- clip + redistribute ---
    excess = jnp.sum(jnp.maximum(hist - clip_limit, 0), axis=-1, keepdims=True)
    hist = jnp.minimum(hist, clip_limit)
    batch = excess // hist_size
    residual = excess - batch * hist_size
    hist = hist + batch
    step = jnp.maximum(hist_size // jnp.maximum(residual, 1), 1)
    j = jax.lax.broadcasted_iota(jnp.int32, hist.shape, 2)
    bump = ((j % step) == 0) & ((j // step) < residual)
    hist = hist + bump.astype(jnp.int32)

    # --- cumulative sum -> LUT ---
    cdf = jnp.cumsum(hist, axis=-1)
    # strict f32 trunc(cdf * scale + 0.5), as the reference rounds it
    lut = jnp.trunc(
        _r(_r(cdf.astype(jnp.float64) * np.float64(lut_scale)) + 0.5)
    ).astype(jnp.int32)  # values <= peak, fits the storage type

    if bits <= 8:
        # --- gather-free bilinear LUT interpolation ---
        # Pad so rows/cols split into half-tile-shifted cells; inside a cell
        # the four neighbor-tile indices are constant, so the per-pixel
        # lookup becomes one fused compare-select over the 256 bins against
        # a per-cell blended weight table.
        thh, twh = tile_h // 2, tile_w // 2
        ry_n = -((thh + height) // -tile_h)
        rx_n = -((twh + width) // -tile_w)
        hp, wp = ry_n * tile_h, rx_n * tile_w
        xp2 = jnp.pad(
            x.astype(jnp.int32),
            ((0, 0), (thh, hp - thh - height), (twh, wp - twh - width)),
        )
        cells = xp2.reshape(n, ry_n, tile_h, rx_n, tile_w)
        ty1r = np.clip(np.arange(ry_n) - 1, 0, tiles_y - 1)
        ty2r = np.minimum(np.arange(ry_n), tiles_y - 1)
        tx1r = np.clip(np.arange(rx_n) - 1, 0, tiles_x - 1)
        tx2r = np.minimum(np.arange(rx_n), tiles_x - 1)

        # blend fractions on the padded grid (pad rows are sliced away, and
        # in clamped cells both tiles agree so the fraction is irrelevant);
        # the f32 reciprocal multiply matches the reference's per-pixel math
        ysp = (np.arange(hp) - thh).astype(np.float32)
        tyf = ysp * np.float32(1.0 / tile_h) - np.float32(0.5)
        ya_p = jnp.asarray(
            (tyf - np.floor(tyf)).astype(np.float32).reshape(1, ry_n, tile_h, 1, 1)
        )
        xsp = (np.arange(wp) - twh).astype(np.float32)
        txf = xsp * np.float32(1.0 / tile_w) - np.float32(0.5)
        xa_p = jnp.asarray(
            (txf - np.floor(txf)).astype(np.float32).reshape(1, 1, 1, rx_n, tile_w)
        )
        # per-pixel 4-table lookup via a scalar select-chain: the four
        # neighbor LUTs (values <= 255) pack into one i32 per bin, so the
        # chain is 256 compares + 256 selects of per-cell broadcasts — a
        # single fused elementwise kernel with no (..., B, ...) operand for
        # XLA to materialize (a broadcast compare-reduce would hold a
        # 256x copy of the plane)
        luti = lut.reshape(n, tiles_y, tiles_x, hist_size)

        def seli(tyr, txr):  # (n, RY, RX, B) i32 table per cell
            return luti[:, tyr][:, :, txr]

        tab32 = (
            seli(ty1r, tx1r)
            | (seli(ty1r, tx2r) << 8)
            | (seli(ty2r, tx1r) << 16)
            | (seli(ty2r, tx2r) << 24)
        )  # (n, RY, RX, B)

        acc = jnp.broadcast_to(
            tab32[:, :, None, :, None, 0], cells.shape
        )
        for i in range(1, hist_size):
            acc = jnp.where(cells == i, tab32[:, :, None, :, None, i], acc)
        l0 = (acc & 255).astype(jnp.float32)
        l1 = ((acc >> 8) & 255).astype(jnp.float32)
        l2 = ((acc >> 16) & 255).astype(jnp.float32)
        l3 = ((acc >> 24) & 255).astype(jnp.float32)
        res = _blend_bilinear_f32_exact(l0, l1, l2, l3, xa_p, ya_p)
        res = res.reshape(n, hp, wp)[:, thh : thh + height, twh : twh + width]
        return res.astype(x.dtype)

    # --- bilinear interpolation of 4 tile LUTs per pixel ---
    xs = np.arange(width, dtype=np.float32)
    txf = xs * np.float32(1.0 / tile_w) - np.float32(0.5)
    tx1u = np.floor(txf)
    xa = jnp.asarray(txf - tx1u, jnp.float32)[None, None, :]
    tx1 = jnp.asarray(np.clip(tx1u, 0, tiles_x - 1).astype(np.int32))
    tx2 = jnp.asarray(np.minimum(tx1u + 1, tiles_x - 1).astype(np.int32))

    ys = np.arange(height, dtype=np.float32)
    tyf = ys * np.float32(1.0 / tile_h) - np.float32(0.5)
    ty1u = np.floor(tyf)
    ya = jnp.asarray(tyf - ty1u, jnp.float32)[None, :, None]
    ty1 = jnp.asarray(np.clip(ty1u, 0, tiles_y - 1).astype(np.int32))
    ty2 = jnp.asarray(np.minimum(ty1u + 1, tiles_y - 1).astype(np.int32))

    v = x.astype(jnp.int32)
    frame_base = (
        jax.lax.broadcasted_iota(jnp.int32, (n, 1, 1), 0)
        * (tiles_y * tiles_x * hist_size)
    )
    lut_flat = lut.reshape(-1)

    def look(tyv, txv):
        tile = tyv[None, :, None] * tiles_x + txv[None, None, :]
        idx = frame_base + tile * hist_size + v
        return lut_flat[idx].astype(jnp.float32)

    l0 = look(ty1, tx1)
    l1 = look(ty1, tx2)
    l2 = look(ty2, tx1)
    l3 = look(ty2, tx2)
    return _blend_bilinear_f32_exact(l0, l1, l2, l3, xa, ya).astype(x.dtype)


def clahe(clip: Clip, limit: int = 7, tiles=None) -> Clip:
    fmt = clip.format
    require(
        fmt.sample_type is SampleType.INTEGER and fmt.bits_per_sample in (8, 16),
        FILTER_NAME, "only 8 or 16 bit int formats supported.",
    )
    limit = int(limit)
    if tiles is None:
        tiles = [3, 3]
    elif not isinstance(tiles, (list, tuple)):
        tiles = [tiles]
    if len(tiles) < 1 or len(tiles) > 2:
        raise VSZipError(f"{FILTER_NAME} : tiles array can't have more than 2 values.")
    for t in tiles:
        if t < 1:
            raise VSZipError(f"{FILTER_NAME}: tiles values must be >= 1.")
    tiles_x = int(tiles[0])
    tiles_y = int(tiles[1]) if len(tiles) == 2 else tiles_x
    min_w = clip.width >> (fmt.subsampling_w if fmt.num_planes > 1 else 0)
    min_h = clip.height >> (fmt.subsampling_h if fmt.num_planes > 1 else 0)
    if tiles_x > min_w or tiles_y > min_h:
        raise VSZipError(
            f"{FILTER_NAME}: tiles must not exceed the (chroma) plane width/height."
        )
    hist_size = 1 << fmt.bits_per_sample
    cl = limit * (clip.width // tiles_x) * (clip.height // tiles_y) // hist_size
    if cl > 2**31 - 1:
        raise VSZipError(
            f"{FILTER_NAME}: limit too large for this frame size; reduce limit "
            "or increase tiles."
        )
    out = [
        _clahe_plane(p, limit, tiles_x, tiles_y, fmt.bits_per_sample)
        for p in clip.planes
    ]
    return clip.with_planes(out).with_props(_ColorRange=0)
