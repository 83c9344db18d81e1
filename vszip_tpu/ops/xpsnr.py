"""XPSNR: Fraunhofer's perceptually weighted PSNR.

Reference: src/filters/xpsnr.zig + src/vapoursynth/xpsnr.zig.  Per frame,
the luma plane is cut into B x B blocks (``B = trunc(32*sqrt(w*h/8294400)
+ 0.5) * 4``; B < 4 degenerates to plain per-plane SSE).  Each block's
visual-activity weight is ``1/sqrt(ms_act^2)`` where ``ms_act`` combines

* spatial activity: mean |3x3 Laplacian| over the block's intersection with
  the picture interior (pictures > 2048x1152 use a 2x-downsampled high-pass
  on the even grid instead, skipped for blocks narrower than 13), and
* temporal activity (optional): gamma=2 times the mean |first-order| frame
  difference (2x2-aggregated on large pictures), second-order when fps>=32;
  missing previous frames contribute zero (frames 0/1),

floored at ``2^(depth-6)`` then squared.  Small pictures (<= 640x480)
run the reference's sequential neighbor-clamping pass over the raster of
block weights.  Chroma SSE reuses the luma block weights.  Outputs are the
frame props XPSNR_Y/U/V plus clip-level averages (the reference prints the
same aggregate to stdout when the filter is freed).

Layout: activity/SSE maps are computed full-plane in i32 and reduced
with zero-padded block reshapes (two-stage: i32 within-block rows, then f64
over the block-level partials — sums stay exact integers end to end);
the temporal terms use zero-filled frame shifts of the batch axis, which
reproduces the missing-frame semantics; the small-frame smoothing is a
`lax.fori_loop` over the (tiny) block raster, vmapped over frames.
"""

from __future__ import annotations

import math
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.clip import Clip
from ..core.format import ColorFamily, SampleType
from ..core.params import VSZipError, compare_clips, require

FILTER_NAME = "XPSNR"
GAMMA = 2


def _block_sum(m, b: int, by: int | None = None):
    """Exact per-block sums of a non-negative i32 map as f64, without any
    full-resolution f64 math (f64 runs at a fraction of the i32 rate):
    stage 1 sums the `by` rows of each block in i32 (safe: every
    map value is < 2^28/by), stage 2 widens the by-fold-smaller partials to
    f64.  Values stay exact integers throughout, matching the reference's
    u64 accumulation."""
    if by is None:
        by = b
    n, h, w = m.shape
    hb, wb = -h % by, -w % b
    mp = jnp.pad(m, ((0, 0), (0, hb), (0, wb)))
    nb_h, nb_w = (h + hb) // by, (w + wb) // b
    s1 = mp.reshape(n, nb_h, by, nb_w, b).sum(axis=2, dtype=jnp.int32)
    return s1.astype(jnp.float64).sum(axis=3)


def _lap_map(x):
    """|12c - 2(l+r+u+d) - (ul+ur+dl+dr)| over the interior, 0 on borders."""
    xi = x.astype(jnp.int32)
    c = xi[:, 1:-1, 1:-1]
    l = xi[:, 1:-1, :-2]
    r = xi[:, 1:-1, 2:]
    u = xi[:, :-2, 1:-1]
    d = xi[:, 2:, 1:-1]
    ul = xi[:, :-2, :-2]
    ur = xi[:, :-2, 2:]
    dl = xi[:, 2:, :-2]
    dr = xi[:, 2:, 2:]
    f = jnp.abs(12 * c - 2 * (l + r + u + d) - (ul + ur + dl + dr))
    return jnp.pad(f, ((0, 0), (1, 1), (1, 1)))


def _highds_map(x):
    """The >HD downsampled high-pass |f| at even coordinates (zero
    elsewhere).  Taps reach (-2..+3) around each 2x2 cell."""
    xi = jnp.pad(x.astype(jnp.int32), ((0, 0), (3, 4), (3, 4)))

    def t(dy, dx):
        return xi[:, 3 + dy : 3 + dy + x.shape[1], 3 + dx : 3 + dx + x.shape[2]]

    f = (
        12 * (t(0, 0) + t(0, 1) + t(1, 0) + t(1, 1))
        - 3 * (t(-1, 0) + t(-1, 1) + t(2, 0) + t(2, 1))
        - 3 * (t(0, -1) + t(0, 2) + t(1, -1) + t(1, 2))
        - 2 * (t(-1, -1) + t(-1, 2) + t(2, -1) + t(2, 2))
        - (t(-2, -1) + t(-2, 0) + t(-2, 1) + t(-2, 2)
           + t(3, -1) + t(3, 0) + t(3, 1) + t(3, 2)
           + t(-1, -2) + t(0, -2) + t(1, -2) + t(2, -2)
           + t(-1, 3) + t(0, 3) + t(1, 3) + t(2, 3))
    )
    n, h, w = x.shape
    even = (
        (jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) % 2 == 0)
        & (jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) % 2 == 0)
    )
    return jnp.where(even[None], jnp.abs(f), 0)


def _cell2_sums(x, p1, p2, order: int):
    """2x2-cell |t| map at even coords; t = cur - p1 (order 1) or
    cur - 2*p1 + p2 (order 2).  p1/p2 are zero-filled shifted frames."""
    t = x.astype(jnp.int32)
    if order == 1:
        t = t - p1.astype(jnp.int32)
    else:
        t = t - 2 * p1.astype(jnp.int32) + p2.astype(jnp.int32)
    cell = t[:, 0::2, 0::2] + t[:, 0::2, 1::2] + t[:, 1::2, 0::2] + t[:, 1::2, 1::2]
    m = jnp.zeros(x.shape, jnp.int32)
    return m.at[:, 0::2, 0::2].set(jnp.abs(cell))


def _tempdiff_map(x, p1, p2, order: int):
    t = x.astype(jnp.int32)
    if order == 1:
        t = t - p1.astype(jnp.int32)
    else:
        t = t - 2 * p1.astype(jnp.int32) + p2.astype(jnp.int32)
    return jnp.abs(t)


def _smooth_weights(wts, nb_w: int, nb_h: int, b: int, w: int, h: int):
    """The reference's sequential small-picture weight clamping
    (src/filters/xpsnr.zig:450-468), one frame; wts (nb,) f64."""
    nb = nb_w * nb_h

    def body(idx, wv):
        col = idx % nb_w
        x = col * b
        prev2 = jnp.where(idx > 1, wv[jnp.maximum(idx - 2, 0)], 0.0)
        at_left = col == 0
        map_prev = jnp.where(
            at_left,
            jnp.where(idx > 1, prev2, 0.0),
            jnp.where(x > b, jnp.maximum(prev2, wv[idx]), wv[idx]),
        )
        above_prev = wv[jnp.maximum(idx - 1 - nb_w, 0)]
        map_prev = jnp.where(idx > nb_w, jnp.maximum(map_prev, above_prev), map_prev)
        prev1 = wv[jnp.maximum(idx - 1, 0)]
        new_prev1 = jnp.where((idx > 0) & (prev1 > map_prev), map_prev, prev1)
        wv = wv.at[jnp.maximum(idx - 1, 0)].set(
            jnp.where(idx > 0, new_prev1, wv[jnp.maximum(idx - 1, 0)])
        )
        # final-block clamp
        is_last = idx == nb - 1
        last_ok = (x + b >= w) & ((nb_h - 1) * b + b >= h) & (idx > nb_w)
        mp2 = jnp.maximum(wv[jnp.maximum(idx - 1, 0)], wv[jnp.maximum(idx - nb_w, 0)])
        cur = wv[idx]
        wv = wv.at[idx].set(
            jnp.where(is_last & last_ok & (cur > mp2), mp2, cur)
        )
        return wv

    return jax.lax.fori_loop(0, nb, body, wts)


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _xpsnr_frame_stats(org, rec, depth: int, frame_rate: int,
                       temporal: bool, dims):
    """Returns wsse64 per component, (N, num_comps) f64."""
    widths, heights = dims
    w, h = widths[0], heights[0]
    n = org[0].shape[0]
    wh = w * h
    r = wh / (3840.0 * 2160.0)
    b = int(32.0 * math.sqrt(r) + 0.5) * 4  # trunc, like lossyCast
    sft = 1 << (2 * depth - 9)
    avg_act = math.sqrt(16.0 * sft / math.sqrt(max(1e-5, r)))
    num_comps = len(org)

    if b < 4:
        out = []
        for c in range(num_comps):
            d = org[c].astype(jnp.int64) - rec[c].astype(jnp.int64)
            out.append(jnp.sum((d * d).astype(jnp.float64), axis=(1, 2)))
        return jnp.stack(out, axis=1)

    b_val = 2 if wh > 2048 * 1152 else 1
    nb_w, nb_h = -(-w // b), -(-h // b)

    order = 2 if frame_rate >= 32 else 1
    # --- luma block SSE ---
    diff = org[0].astype(jnp.int32) - rec[0].astype(jnp.int32)
    sse_blk = _block_sum(diff * diff, b)

    # --- spatial activity ---
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    active = (
        (xs >= b_val) & (xs < w - b_val) & (ys >= b_val)
        & (ys < h - b_val)
    )[None]
    sa_map = _highds_map(org[0]) if b_val == 2 else _lap_map(org[0])
    sa_blk = _block_sum(jnp.where(active, sa_map, 0), b)

    # per-block active-extent denominators
    bx0 = np.arange(nb_w) * b
    by0 = np.arange(nb_h) * b
    wax = np.minimum(bx0 + b, w)
    way = np.minimum(by0 + b, h)
    x_lo = np.maximum(bx0, b_val)
    x_hi = np.where(bx0 + b < w, wax, wax - b_val)
    y_lo = np.maximum(by0, b_val)
    y_hi = np.where(by0 + b < h, way, way - b_val)
    nx = np.maximum(x_hi - x_lo, 0).astype(np.float64)
    ny = np.maximum(y_hi - y_lo, 0).astype(np.float64)
    denom_sa = ny[:, None] * nx[None, :]
    empty = denom_sa <= 0
    if b_val == 2:
        # highds skipped for narrow blocks (w_act <= 12)
        wact_ext = np.where(bx0 + b < w, wax - bx0, wax - bx0 - b_val)
        sa_blk = jnp.where(jnp.asarray(wact_ext > 12)[None, None, :], sa_blk, 0.0)

    ms = sa_blk / jnp.asarray(np.where(empty, 1.0, denom_sa))[None]

    # --- temporal activity ---
    if temporal:
        p1 = jnp.concatenate(
            [jnp.zeros_like(org[0][:1]), org[0][:-1]], axis=0)
        p2 = jnp.concatenate(
            [jnp.zeros_like(org[0][:2]), org[0][:-2]], axis=0)
        # frame 1 has p1 but no p2; frame 0 has neither — zero fills
        if b_val == 2:
            ta_map = _cell2_sums(org[0], p1, p2, order)
        else:
            ta_map = _tempdiff_map(org[0], p1, p2, order)
        ta_blk = _block_sum(ta_map, b) * GAMMA
        bw_ext = (wax - bx0).astype(np.float64)
        bh_ext = (way - by0).astype(np.float64)
        denom_ta = jnp.asarray(bh_ext[:, None] * bw_ext[None, :])
        ms = ms + ta_blk / denom_ta[None]

    floor = float(1 << (depth - 6))
    ms = jnp.maximum(ms, floor)
    ms2 = ms * ms
    weights = 1.0 / jnp.sqrt(ms2)
    # empty active region -> ms_act stays 1.0 unsquared (reference early out)
    weights = jnp.where(jnp.asarray(empty)[None], 1.0, weights)

    if wh <= 640 * 480:
        flat = weights.reshape(n, -1)
        flat = jax.vmap(lambda v: _smooth_weights(v, nb_w, nb_h, b, w, h))(flat)
        weights = flat.reshape(n, nb_h, nb_w)

    wsse = [jnp.trunc(jnp.maximum(jnp.sum(sse_blk * weights, axis=(1, 2)), 0.0)
                      * avg_act + 0.5)]
    wsse[0] = jnp.where(jnp.sum(sse_blk * weights, axis=(1, 2)) <= 0.0, 0.0, wsse[0])

    for c in range(1, num_comps):
        bx = (b * widths[c]) // w
        by = (b * heights[c]) // h
        # chroma blocks may be rectangular (bx != by for 422/440)
        dc = org[c].astype(jnp.int32) - rec[c].astype(jnp.int32)
        blk = _block_sum(dc * dc, bx, by)
        s = jnp.sum(blk * weights, axis=(1, 2))
        wsse.append(jnp.where(s <= 0.0, 0.0, jnp.trunc(s * avg_act + 0.5)))

    return jnp.stack(wsse, axis=1)


def xpsnr(reference: Clip, distorted: Clip, temporal: bool = True,
          verbose: bool = False, fps: float | None = None) -> Clip:
    """``verbose=True`` prints the reference's end-of-run summary line
    (src/vapoursynth/xpsnr.zig:110-128 prints it on filter free; here the
    whole clip is processed in one call, so it prints before returning).
    ``fps`` overrides the _FpsNum/_FpsDen frame props (the reference reads
    the clip's fps; Clip carries it as props).

    The output also carries ``_XPSNR_WSSE`` / ``_XPSNR_Num64`` props:
    INTERNAL streaming-support state (runtime.stream recomputes the global
    XPSNR_AVG from them and strips them before handing chunks to sinks);
    they are not part of the reference's public prop surface."""
    fmt = reference.format
    if fmt.color_family is not ColorFamily.YUV:
        raise VSZipError(f"{FILTER_NAME} : only supports YUV format clips")
    if fmt.bits_per_sample not in (8, 10):
        raise VSZipError(f"{FILTER_NAME} : only supports 8 or 10 bit clips")
    if reference.width % 2 or reference.height % 2:
        raise VSZipError(f"{FILTER_NAME} : only supports even width and height")

    ref, dist = reference, distorted
    b1, b2 = ref.format.bits_per_sample, dist.format.bits_per_sample
    if b1 < b2:
        ref = _promote(ref, b2)
    elif b1 > b2:
        dist = _promote(dist, b1)
    compare_clips([ref, dist], FILTER_NAME, same_len=True)

    depth = ref.format.bits_per_sample
    if fps is None:
        num = ref.props.get("_FpsNum", dist.props.get("_FpsNum", 0))
        den = ref.props.get("_FpsDen", dist.props.get("_FpsDen", 1))
        frame_rate = int(num) // int(den) if den else 0
    else:
        frame_rate = int(fps)

    widths = tuple(ref.plane_dims(p)[0] for p in range(ref.format.num_planes))
    heights = tuple(ref.plane_dims(p)[1] for p in range(ref.format.num_planes))
    wsse = _xpsnr_frame_stats(
        tuple(ref.planes), tuple(dist.planes), depth, frame_rate,
        bool(temporal), (widths, heights),
    )
    num64 = _num64_const(widths, heights, depth, wsse.shape[1])
    cur, avg = _prop_math(wsse, num64)
    names = ["XPSNR_Y", "XPSNR_U", "XPSNR_V"]
    props = {names[c]: cur[:, c] for c in range(wsse.shape[1])}
    props["XPSNR_AVG"] = avg
    # streaming support: the end-of-run average accumulates across ALL
    # frames in the reference (src/vapoursynth/xpsnr.zig:89-96,114-128 sums
    # sqrt(wsse) under a mutex and prints the aggregate on free), so a
    # chunked executor cannot combine per-chunk XPSNR_AVG scalars.  Expose
    # the raw per-frame wsse plus the per-component normalizer so
    # runtime.stream can recompute the global average from totals with the
    # SAME jitted _prop_math (bit-equal to a resident run).
    props["_XPSNR_WSSE"] = wsse  # (N, C) f64, per-frame
    props["_XPSNR_Num64"] = num64  # (C,) f64, constant across chunks
    if verbose:
        av = np.asarray(avg)
        n = int(wsse.shape[0])
        comps = "".join(
            f"{c}: {float(av[i]):.4f}  "
            for i, c in enumerate("yuv"[: wsse.shape[1]]))
        print(f"XPSNR average, {n} frames  {comps}", flush=True)
    return distorted.with_props(**props)


@lru_cache(maxsize=64)
def _num64_const(widths, heights, depth: int, ncomp: int):
    """(C,) per-component width*height*max_err normalizer, cached.  A host
    array, so that a call traced under an outer jit (process_stream) caches
    no tracer for the next trace to trip over."""
    max_err = float(((1 << depth) - 1) ** 2)
    return np.asarray(
        [float(widths[c]) * heights[c] * max_err for c in range(ncomp)],
        np.float64)


@jax.jit
def _prop_math(wsse, num64):
    # prop math stays on device (f64 but tiny) and under ONE jit: a
    # np.asarray would block on a device round trip per call, and eager
    # per-op dispatch would launch one tiny program per op.  num64: (C,) per-component
    # width*height*max_err normalizer (passed as data so the streaming
    # finalizer can re-run this exact function on concatenated wsse).
    n = wsse.shape[0]
    sq = jnp.sqrt(wsse)  # (N, C)
    sum_wdist = jnp.sum(sq, axis=0)
    cur = jnp.where(
        sq < 1.0, jnp.inf,
        10.0 * jnp.log10(num64[None, :] / jnp.maximum(sq, 1.0) ** 2))
    # end-of-run aggregate (the reference prints this on free)
    ad = jnp.maximum(sum_wdist / n, 1e-300)
    avg = jnp.where(
        sum_wdist >= n,
        10.0 * jnp.log10(num64 / (ad * ad)),
        jnp.sum(cur, axis=0) / n,
    )
    return cur, avg


def _promote(clip: Clip, bits: int) -> Clip:
    # depth matching via the shared bitDepth analogue (reference
    # src/vapoursynth/xpsnr.zig:165-169 invokes helper.zig bitDepth)
    from ..core.resample import bit_depth

    return bit_depth(clip, bits)
