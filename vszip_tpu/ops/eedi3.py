"""EEDI3 / EEDI3H: edge-directed interpolation via a per-line Viterbi DP.

Reference: src/filters/eedi3.zig + src/vapoursynth/eedi3.zig (an eedi3m
float-mode port).  For every missing line (field interpolation or dh
doubling): build 4 mirror-reflected neighbor rows (offsets -3,-1,+1,+3),
compute a connection-cost matrix over directions u in [-mdis, mdis]
(2*mdis per side half-pel with hp=True), run a dynamic program across x
with +-1 (+-2 for hp) transitions penalized by gamma, backtrack the optimal
direction path, and interpolate along the chosen direction with a 4-tap
(0.5625/-0.0625) kernel.  Optional `mclip` gates the DP to masked regions
(buildBmask look-ahead of mdis); optional `vcheck` runs the sequential
reliability post-pass blending back toward a vertical interpolation (or
`sclip`).  EEDI3H is the same pipeline on transposed planes.

Layout: all lines of all frames batch into one (B, L, W) tensor; the
cost matrix is built with static padded-index gathers (multi-bounce mirror
tables precomputed on host); the x-sequential DP is a `lax.scan` over W
with a (B, L, tpitch) carry — the batch dimensions hold the parallelism
(540 lines/frame at 1080p).  Backtrack is a reverse scan over the stored
i8 argmin deltas; vcheck is a scan over lines with the previously-updated
line as carry.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.clip import Clip
from ..core.format import SampleType
from ..core.params import VSZipError, require

FILTER_NAME = "EEDI3"

MDIS_MAX = 40
NRAD_MAX = 3
# padded margin per side (reference pad_h: align(2*mdis_max + nrad_max + n_vec))
PAD = 96
FLT_MAX_09 = np.float32(np.finfo(np.float32).max * 0.9)


@lru_cache(maxsize=64)
def _pad_idx(w: int) -> np.ndarray:
    """index table for the reference's mirrorPad cascade: position p in the
    padded buffer [0, w + 2*PAD) -> source column in [0, w)."""
    n = w + 2 * PAD
    idx = np.zeros(n, np.int64)
    idx[PAD : PAD + w] = np.arange(w)
    for i in range(PAD):  # right: buf[PAD+w+i] = buf[PAD+w-2-i]
        idx[PAD + w + i] = idx[PAD + w - 2 - i]
    for i in range(PAD):  # left: buf[i] = buf[2*PAD - i]
        idx[i] = idx[2 * PAD - i]
    return idx


def _reflect_row(y: int, h: int) -> int:
    if h == 1:
        return 0
    while y < 0 or y >= h:
        if y < 0:
            y = -y
        if y >= h:
            y = 2 * (h - 1) - y
    return y


def _src_col(dh: bool, off: int, n_src: int) -> int:
    return _reflect_row(off, 2 * n_src) // 2 if dh else _reflect_row(off, n_src)


def _take_pad(row, off: int):
    """row: (..., w + 2*PAD) padded row; returns the w-wide view at data
    offset `off` (i.e. padded position PAD + off .. PAD + off + w)."""
    w = row.shape[-1] - 2 * PAD
    return jax.lax.slice_in_dim(row, PAD + off, PAD + off + w, axis=row.ndim - 1)


def _pad_rows(rows):
    """(B, L, w) -> (B, L, w + 2*PAD) via the mirror cascade.  For w > PAD+1
    the cascade is a single reflection each side, expressible as reversed
    slices, which fuse into their consumers where a gather would not;
    smaller widths wrap multiple times and keep the index-table gather."""
    w = rows.shape[-1]
    if w > PAD + 1:
        left = jnp.flip(rows[..., 1 : PAD + 1], axis=-1)
        right = jnp.flip(rows[..., w - 1 - PAD : w - 1], axis=-1)
        return jnp.concatenate([left, rows, right], axis=-1)
    return jnp.take(rows, jnp.asarray(_pad_idx(w)), axis=-1)


def _shifted(x2, t: int, ext: int):
    """roll(x, t) replacement: a pure slice of the `ext`-zero-extended row.
    The circular wrap of a true roll never reaches any used position
    (|offsets| stay < PAD), so at every read lane the slice is
    bit-identical — and unlike roll (concat of two slices, materialized per
    direction) slices fuse into the consuming arithmetic, which is where
    the cost build's HBM traffic went."""
    n = x2.shape[-1] - 2 * ext
    return jax.lax.slice_in_dim(x2, ext - t, ext - t + n, axis=x2.ndim - 1)


def _ext_rows(rows, ext: int):
    return [
        jnp.pad(r, ((0, 0),) * (r.ndim - 1) + ((ext, ext),)) for r in rows
    ]


def _costs_nonhp(r3p, r1p, r1n, r3n, mdis, nrad, alpha, beta, one_minus_ab):
    """list of tpitch (B, L, w) connection-cost arrays (one per direction
    u); inputs are padded rows."""
    w = r3p.shape[-1] - 2 * PAD
    ext = 2 * mdis
    r1p2, r1n2, r3n2 = _ext_rows((r1p, r1n, r3n), ext)
    costs = []
    for u in range(-mdis, mdis + 1):
        tu = 2 * u
        tb_parts = (
            jnp.abs(r3p - _shifted(r1p2, tu, ext)),
            jnp.abs(r1p - _shifted(r1n2, tu, ext)),
            jnp.abs(r1n - _shifted(r3n2, tu, ext)),
        )
        # padded-space t_base: value at padded pos j is |a(j) - b(j - 2u)|
        tb = tb_parts[0] + tb_parts[1] + tb_parts[2]
        # Three separate window sums exactly like the reference's
        # costBlockDirect (src/filters/eedi3.zig:326-333 sw0/sw1/sw2): the
        # box sum B(j) = sum_k tb(j+k) is one shifted ladder shared by all
        # three (elementwise shifts don't change the k-ascending f32
        # accumulation), then s = (B(x+u) + B(x)) + B(x+2u).
        wp = tb.shape[-1]
        tb_e = jnp.pad(tb, ((0, 0),) * (tb.ndim - 1) + ((nrad, nrad),))
        bx = None
        for k in range(-nrad, nrad + 1):
            sh = jax.lax.slice_in_dim(tb_e, nrad + k, nrad + k + wp,
                                      axis=tb.ndim - 1)
            bx = sh if bx is None else bx + sh
        s = (_take_pad(bx, u) + _take_pad(bx, 0)) + _take_pad(bx, tu)
        ip = (_take_pad(r1p, u) + _take_pad(r1n, -u)) * jnp.float32(0.5)
        v = jnp.abs(_take_pad(r1p, 0) - ip) + jnp.abs(_take_pad(r1n, 0) - ip)
        costs.append(
            jnp.float32(alpha) * s + jnp.float32(beta * abs(u))
            + jnp.float32(one_minus_ab) * v
        )
    return costs


def _hp_row(a):
    """half-pel row (computeHpRow): out[j] = .5625*(a[j]+a[j+1]) -
    .0625*(a[j-1]+a[j+2]) for j in [1, n-2); ends passthrough-undefined in
    the reference (never read in range)."""
    out = (
        jnp.float32(0.5625) * (a + jnp.roll(a, -1, axis=-1))
        - jnp.float32(0.0625) * (jnp.roll(a, 1, axis=-1) + jnp.roll(a, -2, axis=-1))
    )
    return out


def _costs_hp(r3p, r1p, r1n, r3n, mdis, nrad, alpha3, beta255, one_minus_ab):
    hp = [_hp_row(r) for r in (r3p, r1p, r1n, r3n)]
    cen = 2 * mdis
    ext = cen
    r1p2, r1n2, r3n2 = _ext_rows((r1p, r1n, r3n), ext)
    hpB2, hpC2, hpD2 = _ext_rows(hp[1:], ext)
    costs = []
    for u in range(-cen, cen + 1):
        uh = u >> 1
        odd = (u & 1) != 0
        lo0 = (-uh - 1) if odd else -uh
        A0, B0, C0, D0 = hp if odd else (r3p, r1p, r1n, r3n)
        base_m = (
            jnp.abs(r3p - _shifted(r1p2, u, ext))
            + jnp.abs(r1p - _shifted(r1n2, u, ext))
            + jnp.abs(r1n - _shifted(r3n2, u, ext))
        )
        if odd:
            base0 = (
                jnp.abs(A0 - _shifted(hpB2, u, ext))
                + jnp.abs(B0 - _shifted(hpC2, u, ext))
                + jnp.abs(C0 - _shifted(hpD2, u, ext))
            )
        else:
            base0 = base_m
        # separate k-ascending window sums (reference interpLineHP); the
        # shared box ladder produces bit-identical accumulations
        wp = base_m.shape[-1]

        def box(b):
            b_e = jnp.pad(b, ((0, 0),) * (b.ndim - 1) + ((nrad, nrad),))
            acc = None
            for k in range(-nrad, nrad + 1):
                sh = jax.lax.slice_in_dim(b_e, nrad + k, nrad + k + wp,
                                          axis=b.ndim - 1)
                acc = sh if acc is None else acc + sh
            return acc

        bm_box = box(base_m)
        b0_box = bm_box if not odd else box(base0)
        s1 = _take_pad(bm_box, 0)
        s2 = _take_pad(bm_box, u)
        s0 = _take_pad(b0_box, uh)
        ip = (_take_pad(B0, uh) + _take_pad(C0, lo0)) * jnp.float32(0.5)
        v = jnp.abs(_take_pad(r1p, 0) - ip) + jnp.abs(_take_pad(r1n, 0) - ip)
        costs.append(
            jnp.float32(alpha3) * (s0 + s1 + s2)
            + jnp.float32(beta255 * abs(u) * 0.5)
            + jnp.float32(one_minus_ab) * v
        )
    return costs


def _dp(tcosts, bmask, gamma: float, hp: bool):
    """Viterbi DP across x.  tcosts (tpitch, B, L, W) — tpitch LEADS so the
    per-step state keeps the wide (B, L) axes minor.  bmask (B, L, W)
    bool or None.  Returns fpath (B, L, W) i32."""
    tpitch, b, l, w = tcosts.shape
    big = jnp.float32(FLT_MAX_09)

    pcost0 = tcosts[:, :, :, 0]
    piT0 = jnp.zeros((tpitch, b, l), jnp.int8)

    if hp:
        gammas = [(2, gamma), (1, gamma * 0.5)]
    else:
        gammas = [(1, gamma)]

    def step(carry, xs):
        pcost, prev_piT = carry
        (tcx, is_x1), bm = xs  # tcx (tpitch, B, L); bm (B, L)
        # candidate chain in the reference's strict-less order; the +-1/2
        # transition shifts are slices along the leading tpitch axis
        if hp:
            pad = jnp.pad(pcost, ((2, 2), (0, 0), (0, 0)), constant_values=big)
            cands = [
                (pad[0:tpitch] + jnp.float32(gamma), -2),
                (pad[1 : tpitch + 1] + jnp.float32(gamma * 0.5), -1),
                (pad[2 : tpitch + 2], 0),
                (pad[3 : tpitch + 3] + jnp.float32(gamma * 0.5), 1),
                (pad[4 : tpitch + 4] + jnp.float32(gamma), 2),
            ]
            bval, bd = cands[0][0], jnp.full((tpitch, b, l), -2, jnp.int8)
            for cv, dv in cands[1:]:
                m = cv < bval
                bval = jnp.where(m, cv, bval)
                bd = jnp.where(m, jnp.int8(dv), bd)
        else:
            pad = jnp.pad(pcost, ((1, 1), (0, 0), (0, 0)), constant_values=big)
            left = pad[0:tpitch] + jnp.float32(gamma)
            cent = pad[1 : tpitch + 1]
            right = pad[2 : tpitch + 2] + jnp.float32(gamma)
            lw = left < cent
            bval = jnp.where(lw, left, cent)
            bd = jnp.where(lw, jnp.int8(-1), jnp.int8(0))
            rw = right < bval
            bval = jnp.where(rw, right, bval)
            bd = jnp.where(rw, jnp.int8(1), bd)

        new_pcost = jnp.minimum(bval + tcx, big)
        new_piT = bd
        if bmask is not None:
            inactive = ~bm[None]
            # inactive x: carry costs through; at x==1 reset to tcosts[x]
            reset = jnp.where(is_x1, tcx, pcost)
            new_pcost = jnp.where(inactive, reset, new_pcost)
            new_piT = jnp.where(inactive,
                                jnp.where(is_x1, jnp.int8(0), prev_piT),
                                new_piT)
        return (new_pcost, new_piT), new_piT

    # K consecutive x-updates per scan iteration amortize per-iteration
    # overhead; the remainder steps run unrolled outside the scan (padding
    # the multi-GB cost sequence to a K-multiple doubled peak HBM).
    K = 4
    steps = w - 1
    ns = steps // K
    rem = steps - ns * K

    tc_seq = jnp.moveaxis(tcosts[:, :, :, 1:], 3, 0)  # (W-1, tpitch, B, L)
    xs_idx = jnp.arange(1, w, dtype=jnp.int32)
    is_x1 = (xs_idx == 1)[:, None, None, None]
    bm_seq = (
        jnp.moveaxis(bmask[:, :, 1:], 2, 0)
        if bmask is not None
        else jnp.ones((steps, b, l), bool)
    )

    def stepK(carry, xs):
        (tcs, isx), bms = xs  # leading K axis
        outs = []
        for k in range(K):
            carry, piT = step(carry, ((tcs[k], isx[k]), bms[k]))
            outs.append(piT)
        return carry, jnp.stack(outs)

    def grp(a, n):
        return a[: n * K].reshape((n, K) + a.shape[1:])

    carry = (pcost0, piT0)
    carry, piTs = jax.lax.scan(
        stepK, carry, ((grp(tc_seq, ns), grp(is_x1, ns)), grp(bm_seq, ns))
    )
    piTs = piTs.reshape((ns * K,) + piTs.shape[2:])
    tail = []
    for i in range(rem):
        carry, piT = step(
            carry,
            ((tc_seq[ns * K + i], is_x1[ns * K + i]), bm_seq[ns * K + i]),
        )
        tail.append(piT)
    if tail:
        piTs = jnp.concatenate([piTs, jnp.stack(tail)], axis=0)
    # piTs[x-1] = backtrack deltas for position x-1 .. i.e. piTs[i] is pbackt[i]

    mdis_center = (tpitch - 1) // 2

    def back(carry, piT):
        f = carry  # (B, L) i32
        idx = mdis_center + f
        # per-pixel tpitch lookup as a select chain
        piTi = piT.astype(jnp.int32)
        delta = piTi[0]
        for t in range(1, tpitch):
            delta = jnp.where(idx == t, piTi[t], delta)
        f2 = f + delta
        return f2, f2

    def backK(carry, piTk):
        outs = []
        for k in reversed(range(K)):
            carry, f2 = back(carry, piTk[k])
            outs.append(f2)
        return carry, jnp.stack(outs[::-1])

    # the trailing remainder steps are consumed first by the reverse pass
    f_last = jnp.zeros((b, l), jnp.int32)
    tail_f = []
    for i in reversed(range(rem)):
        f_last, f2 = back(f_last, piTs[ns * K + i])
        tail_f.append(f2)
    _, fpaths = jax.lax.scan(backK, f_last, grp(piTs, ns), reverse=True)
    fpaths = fpaths.reshape((ns * K,) + fpaths.shape[2:])
    if tail_f:
        fpaths = jnp.concatenate([fpaths, jnp.stack(tail_f[::-1])], axis=0)
    # fpaths[i] = fpath at position i (for i in 0..w-2); position w-1 is 0
    fpath = jnp.concatenate(
        [jnp.moveaxis(fpaths, 0, 2), jnp.zeros((b, l, 1), jnp.int32)], axis=2
    )
    if bmask is not None:
        fpath = jnp.where(bmask, fpath, 0)
    return fpath


def _select_multi(fpath, fmin: int, fmax: int, taps):
    """Directional lookups without per-pixel gathers:
    for each candidate direction value fv the needed positions are STATIC
    lane slices of the padded rows, chained with selects on ``fpath == fv``
    (one shared compare per fv).  `taps` is a list of (row, off_fn) with
    ``off_fn(fv)`` the data-column offset; returns one array per tap giving
    the value at padded position ``PAD + x + off_fn(fpath[pixel])``.

    Slice offsets beyond the mirror pad are clamped; that only affects
    lanes whose guarded four-tap branch is unused (the reference never
    evaluates those positions — src/filters/eedi3.zig interpLine guards
    with ``x >= 3*|d|``)."""
    w = taps[0][0].shape[-1] - 2 * PAD
    maxoff = max(
        abs(off_fn(fv)) for _, off_fn in taps for fv in (fmin, fmax)
    )
    ext = max(0, maxoff - PAD)
    rows = {}

    def slice_at(row, off):
        r = rows.get(id(row))
        if r is None:
            r = (jnp.pad(row, ((0, 0),) * (row.ndim - 1) + ((ext, ext),),
                         mode="edge") if ext else row)
            rows[id(row)] = r
        return jax.lax.slice_in_dim(
            r, ext + PAD + off, ext + PAD + off + w, axis=row.ndim - 1)

    accs = [slice_at(r, off_fn(fmin)) for r, off_fn in taps]
    for fv in range(fmin + 1, fmax + 1):
        m = fpath == fv
        accs = [
            jnp.where(m, slice_at(r, off_fn(fv)), acc)
            for (r, off_fn), acc in zip(taps, accs)
        ]
    return accs


def _output_nonhp(r3p, r1p, r1n, r3n, fpath, w, mdis: int):
    d = fpath
    ad = jnp.abs(d)
    xs = jax.lax.broadcasted_iota(jnp.int32, d.shape, d.ndim - 1)
    g1p, g1n, g3p, g3n = _select_multi(
        d, -mdis, mdis,
        [(r1p, lambda f: f), (r1n, lambda f: -f),
         (r3p, lambda f: 3 * f), (r3n, lambda f: -3 * f)],
    )
    four_tap = (jnp.float32(0.5625) * (g1p + g1n)
                - jnp.float32(0.0625) * (g3p + g3n))
    two_tap = (g1p + g1n) * jnp.float32(0.5)
    ok = (xs >= ad * 3) & (xs + ad * 3 <= w - 1)
    return jnp.where(ok, four_tap, two_tap)


def _output_hp(r3p, r1p, r1n, r3n, fpath, w, bmask, mdis: int):
    d = fpath
    xs = jax.lax.broadcasted_iota(jnp.int32, d.shape, d.ndim - 1)
    even = (d & 1) == 0
    d2 = d >> 1
    ad_e = jnp.abs(d2)
    # half-pel fpath spans [-2*mdis, 2*mdis]; all derived offsets become
    # static per candidate value (Python int arithmetic mirrors the
    # reference's shift expressions exactly, including negative >> 1)
    taps = [
        (r1p, lambda f: f >> 1), (r1n, lambda f: -(f >> 1)),
        (r3p, lambda f: (3 * f) >> 1), (r3n, lambda f: -((3 * f) >> 1)),
        (r3p, lambda f: (3 * f + 1) >> 1),
        (r1p, lambda f: (f + 1) >> 1),
        (r1n, lambda f: -((f + 1) >> 1)),
        (r3n, lambda f: -((3 * f + 1) >> 1)),
    ]
    (g1p_e, g1n_e, g3p_e, g3n_e, g3p_o, g1p_o, g1n_o, g3n_o) = _select_multi(
        d, -2 * mdis, 2 * mdis, taps)
    four_e = (jnp.float32(0.5625) * (g1p_e + g1n_e)
              - jnp.float32(0.0625) * (g3p_e + g3n_e))
    two_e = (g1p_e + g1n_e) * jnp.float32(0.5)
    ok_e = (xs >= ad_e * 3) & (xs + ad_e * 3 <= w - 1)
    out_e = jnp.where(ok_e, four_e, two_e)

    d30 = (3 * d) >> 1
    d31 = (3 * d + 1) >> 1
    ad_o = jnp.maximum(jnp.abs(d30), jnp.abs(d31))
    c0 = g3p_e + g3p_o
    c1 = g1p_e + g1p_o
    c2 = g1n_e + g1n_o
    c3 = g3n_e + g3n_o
    four_o = jnp.float32(0.28125) * (c1 + c2) - jnp.float32(0.03125) * (c0 + c3)
    two_o = (c1 + c2) * jnp.float32(0.25)
    ok_o = (xs >= ad_o) & (xs + ad_o <= w - 1)
    out_o = jnp.where(ok_o, four_o, two_o)

    out = jnp.where(even, out_e, out_o)
    if bmask is not None:
        vert = (
            jnp.float32(0.5625) * (_take_pad(r1p, 0) + _take_pad(r1n, 0))
            - jnp.float32(0.0625) * (_take_pad(r3p, 0) + _take_pad(r3n, 0))
        )
        out = jnp.where(bmask, out, vert)
    return out


def _build_bmask(maskp, mdis: int):
    """(B, L, W) u8 mask -> bool gate (reference buildBmask)."""
    b, l, w = maskp.shape
    minmdis = min(w, mdis)
    xs = jnp.arange(w, dtype=jnp.int64)
    nz = maskp != 0
    # init: last = max over x < minmdis with mask[x]!=0 of (x + mdis)
    head = jnp.where(nz[:, :, :minmdis], xs[:minmdis] + mdis, -666999)
    last0 = jnp.max(head, axis=2) if minmdis > 0 else jnp.full((b, l), -666999)
    # main: cummax over x'' of (x'' + 2*mdis) where mask[x''+mdis]!=0
    nmain = w - minmdis
    if nmain > 0:
        cand = jnp.where(nz[:, :, mdis : mdis + nmain],
                         xs[:nmain] + 2 * mdis, -666999)
        run = jax.lax.cummax(cand, axis=2)
        last_main = jnp.maximum(run, last0[:, :, None])
        bm_main = xs[:nmain] <= last_main
        last_end = last_main[:, :, -1]
    else:
        bm_main = jnp.zeros((b, l, 0), bool)
        last_end = last0
    bm_tail = xs[nmain:] <= last_end[:, :, None]
    return jnp.concatenate([bm_main, bm_tail], axis=2)


@partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _interp_all(rows4, mask, scp_dummy, params, hp: bool, w: int, use_mask: bool):
    (mdis, nrad, alpha, beta, gamma, one_minus_ab) = params
    r3p, r1p, r1n, r3n = [_pad_rows(r) for r in rows4]
    bm = _build_bmask(mask, mdis) if use_mask else None
    if hp:
        clist = _costs_hp(r3p, r1p, r1n, r3n, mdis, nrad, alpha, beta,
                          one_minus_ab)
    else:
        clist = _costs_nonhp(r3p, r1p, r1n, r3n, mdis, nrad, alpha, beta,
                             one_minus_ab)
    tc = jnp.stack(clist, axis=0)
    fpath = _dp(tc, bm, gamma, hp)
    if hp:
        out = _output_hp(r3p, r1p, r1n, r3n, fpath, w, bm, mdis)
    else:
        out = _output_nonhp(r3p, r1p, r1n, r3n, fpath, w, mdis)
        if bm is not None:
            # all-inactive lines fall back to vertical 4-tap with dmap 0;
            # handled per pixel by fpath==0 two/four tap?  The reference
            # uses the vertical kernel only for fully-inactive lines; for
            # masked-out pixels fpath is 0 and the normal x-range select
            # applies, which matches the reference's interpolation at dir 0.
            pass
    return out, fpath


def _vcheck(src_lines, dst_lines, scp, dmap, field, n_interp, n_dst, n_src,
            dh, hp, vcheck, vthresh0, vthresh1, vthresh2, w, mdis):
    """Sequential reliability pass over interpolated lines (reference
    vcheckLine).  dst_lines (B, n_dst, W) already containing the interp.

    Line ``off`` reads the line the previous iteration updated (pd-2), so
    the pass is a `lax.scan` carrying that one row; every per-pixel
    direction lookup decomposes into a select over the <= 2*mdis+1 possible
    shifts."""
    rcp0 = np.float32(1.0 / (vthresh0 / 255.0))
    rcp1 = np.float32(1.0 / (vthresh1 / 255.0))
    rcp2 = np.float32(1.0 / vthresh2)
    vt2 = np.float32(vthresh2)

    offs = np.arange(1, n_interp - 1)
    pds = field + 2 * offs
    # drop loop iterations the reference skips outright (only possible for
    # degenerate line counts)
    ok = (pds >= 2) & (pds + 2 < n_dst)
    offs, pds = offs[ok], pds[ok]
    if offs.size == 0:
        return dst_lines
    if not (np.all(np.diff(offs) == 1)):  # contiguous by construction
        raise AssertionError("non-contiguous vcheck line range")

    def dcol(delta):  # (n_off, B, W) strided view of dst rows pd+delta
        sl = dst_lines[:, pds[0] + delta : pds[-1] + delta + 1 : 2]
        return jnp.moveaxis(sl, 1, 0)

    dl_a, d1p_a, d1n_a, d2n_a = dcol(0), dcol(-1), dcol(1), dcol(2)
    dm_c_a = jnp.moveaxis(dmap[:, offs[0] : offs[-1] + 1], 1, 0)
    dm_p_a = jnp.moveaxis(dmap[:, offs[0] - 1 : offs[-1]], 1, 0)
    dm_n_a = jnp.moveaxis(dmap[:, offs[0] + 1 : offs[-1] + 2], 1, 0)
    if scp is not None:
        cint_a = jnp.moveaxis(scp[:, pds[0] : pds[-1] + 1 : 2], 1, 0)
    else:
        c3p = np.asarray([_src_col(dh, int(p) - 3, n_src) for p in pds])
        c3n = np.asarray([_src_col(dh, int(p) + 3, n_src) for p in pds])
        s3p_a = jnp.moveaxis(src_lines[:, c3p], 1, 0)
        s3n_a = jnp.moveaxis(src_lines[:, c3n], 1, 0)
        cint_a = (jnp.float32(0.5625) * (d1p_a + d1n_a)
                  - jnp.float32(0.0625) * (s3p_a + s3n_a))

    col_i = jax.lax.broadcasted_iota(jnp.int32, dl_a.shape[1:], dl_a.ndim - 2)

    def gsel(stack, o):
        """stack (S, B, W); o (B, W) int in [-mdis, mdis].  Returns
        stack[s, b, clip(x + o[b,x], 0, w-1)] via edge-padded shifts."""
        rp = jnp.pad(stack, ((0, 0), (0, 0), (mdis, mdis)), mode="edge")
        acc = jnp.zeros_like(stack)
        for s in range(-mdis, mdis + 1):
            seg = jax.lax.slice_in_dim(rp, mdis + s, mdis + s + w, axis=2)
            acc = acc + jnp.where(o == s, seg, jnp.float32(0.0))
        return acc

    def body(d2p, xs):
        dl, d1p, d1n, d2n, cint, dm_c, dm_p, dm_n = xs
        keep = (dm_c == 0)
        keep |= (jnp.maximum(dm_c * dm_p, dm_c * dm_n) < 0) | (
            (dm_p == dm_n) & (dm_p == 0))

        if hp:
            even = (dm_c & 1) == 0
            maxoff = jnp.where(
                even, jnp.abs(dm_c >> 1),
                jnp.maximum(jnp.abs(dm_c >> 1), jnp.abs((dm_c + 1) >> 1)),
            )
        else:
            maxoff = jnp.abs(dm_c)
        keep |= (col_i + maxoff >= w) | (col_i - maxoff < 0)

        up = jnp.stack([d2p, d1p, dl])
        dn = jnp.stack([dl, d1n, d2n])
        if hp:
            d20 = dm_c >> 1
            d21 = (dm_c + 1) >> 1
            a20, a21 = gsel(up, d20), gsel(up, d21)
            b20, b21 = gsel(dn, -d20), gsel(dn, -d21)
            s2ps, s1ps, pa0 = a20[0] + a21[0], a20[1] + a21[1], a20[2] + a21[2]
            ps0, s1ns, s2ns = b20[0] + b21[0], b20[1] + b21[1], b20[2] + b21[2]
            it_o = (s2ps + ps0) * jnp.float32(0.25)
            vt_o = (jnp.abs(s2ps - s1ps) + jnp.abs(pa0 - s1ps)) * jnp.float32(0.5)
            ib_o = (pa0 + s2ns) * jnp.float32(0.25)
            vb_o = (jnp.abs(s2ns - s1ns) + jnp.abs(ps0 - s1ns)) * jnp.float32(0.5)
            # even directions: offh = dm >> 1 = d20, so reuse a20/b20
            it_e = (a20[0] + b20[0]) * jnp.float32(0.5)
            ib_e = (a20[2] + b20[2]) * jnp.float32(0.5)
            vt_e = jnp.abs(a20[0] - a20[1]) + jnp.abs(a20[2] - a20[1])
            vb_e = jnp.abs(b20[2] - b20[1]) + jnp.abs(b20[0] - b20[1])
            it = jnp.where(even, it_e, it_o)
            ib = jnp.where(even, ib_e, ib_o)
            vt = jnp.where(even, vt_e, vt_o)
            vb = jnp.where(even, vb_e, vb_o)
            dabs = jnp.abs(dm_c) >> 1
        else:
            gu = gsel(up, dm_c)
            gd = gsel(dn, -dm_c)
            it = (gu[0] + gd[0]) * jnp.float32(0.5)
            ib = (gu[2] + gd[2]) * jnp.float32(0.5)
            vt = jnp.abs(gu[0] - gu[1]) + jnp.abs(gu[2] - gu[1])
            vb = jnp.abs(gd[2] - gd[1]) + jnp.abs(gd[0] - gd[1])
            dabs = jnp.abs(dm_c)

        vc = jnp.abs(dl - d1p) + jnp.abs(dl - d1n)
        d0 = jnp.abs(it - d1p)
        d1_ = jnp.abs(ib - d1n)
        d2_ = jnp.abs(vt - vc)
        d3_ = jnp.abs(vb - vc)
        if vcheck == 1:
            m0, m1 = jnp.minimum(d0, d1_), jnp.minimum(d2_, d3_)
        elif vcheck == 2:
            m0 = (d0 + d1_) * jnp.float32(0.5)
            m1 = (d2_ + d3_) * jnp.float32(0.5)
        else:
            m0, m1 = jnp.maximum(d0, d1_), jnp.maximum(d2_, d3_)
        a0 = m0 * rcp0
        a1 = m1 * rcp1
        a2 = jnp.maximum((vt2 - dabs.astype(jnp.float32)) * rcp2, 0.0)
        a = jnp.minimum(jnp.maximum(a0, jnp.maximum(a1, a2)), 1.0)
        tl = (jnp.float32(1.0) - a) * dl + a * cint
        tl = jnp.where(keep, cint, tl)
        return tl, tl

    init = dst_lines[:, pds[0] - 2]
    _, ys = jax.lax.scan(
        body, init,
        (dl_a, d1p_a, d1n_a, d2n_a, cint_a, dm_c_a, dm_p_a, dm_n_a),
    )
    return dst_lines.at[:, pds[0] : pds[-1] + 1 : 2].set(
        jnp.moveaxis(ys, 0, 1)
    )


@partial(jax.jit, static_argnums=tuple(range(3, 13)))
def _eedi3_plane(x, mask_plane, scp_plane, field: int, dh: bool, hp: bool,
                 mdis: int, nrad: int, alpha: float, beta: float, gamma: float,
                 vcheck: int, vthresh: tuple):
    """x: (B, n_src, W) f32; returns (B, n_dst, W).  Jitted end-to-end —
    run eagerly, the several-hundred-op graph (plus the DP and vcheck
    scans) dispatches per op through the device transport."""
    b, n_src, w = x.shape
    n_interp = n_src if dh else n_src // 2
    n_dst = n_src * 2 if dh else n_src

    one_minus_ab = np.float32(1.0) - np.float32(alpha) - np.float32(beta)
    a_s, b_s, g_s = alpha / 3.0, beta / 255.0, gamma / 255.0

    lines = np.asarray([field + 2 * k for k in range(n_interp)])
    rows = []
    for off in (-3, -1, 1, 3):
        idx = np.asarray([_src_col(dh, int(li) + off, n_src) for li in lines])
        rows.append(x[:, jnp.asarray(idx), :])
    if mask_plane is not None:
        # mask rows are picked at interp_off for dh, at the dst line otherwise
        midx = np.arange(n_interp) if dh else lines
        mask_l = mask_plane[:, jnp.asarray(midx), :]
    else:
        mask_l = jnp.zeros((1,), jnp.uint8)

    params = (mdis, nrad, float(np.float32(a_s)), float(np.float32(b_s)),
              float(np.float32(g_s)), float(one_minus_ab))
    interp, fpath = _interp_all(tuple(rows), mask_l, None, params, hp, w,
                                mask_plane is not None)

    # assemble: kept lines + interpolated lines
    out = jnp.zeros((b, n_dst, w), jnp.float32)
    if dh:
        out = out.at[:, (1 - field)::2].set(x.astype(jnp.float32))
    else:
        out = out.at[:, (1 - field)::2].set(
            x[:, (1 - field)::2].astype(jnp.float32)
        )
    out = out.at[:, field::2].set(interp)

    if vcheck > 0:
        out = _vcheck(x.astype(jnp.float32), out, scp_plane, fpath, field,
                      n_interp, n_dst, n_src, dh, hp, vcheck,
                      vthresh[0], vthresh[1], vthresh[2], w, mdis)
    return out


def _eedi3_impl(horizontal: bool, clip: Clip, field: int, dh=False, alpha=0.2,
                beta=0.25, gamma=20.0, nrad=2, mdis=20, hp=False, vcheck=2,
                vthresh0=32.0, vthresh1=64.0, vthresh2=4.0,
                sclip: Clip | None = None, mclip: Clip | None = None) -> Clip:
    name = "EEDI3H" if horizontal else "EEDI3"
    axis_name = "width" if horizontal else "height"
    fmt = clip.format
    if fmt.sample_type is not SampleType.FLOAT or fmt.bits_per_sample != 32:
        raise VSZipError(f"{name}: only 32-bit float input is supported.")
    if field < 0 or field > 3:
        raise VSZipError(f"{name}: field must be 0, 1, 2, or 3.")
    if dh and field > 1:
        raise VSZipError(f"{name}: field must be 0 or 1 when dh=True.")
    interp_axis = clip.width if horizontal else clip.height
    if not dh and interp_axis % 2:
        raise VSZipError(f"{name}: {axis_name} must be mod 2 when dh=False.")
    if not (0.0 <= alpha <= 1.0):
        raise VSZipError(f"{name}: alpha must be between 0.0 and 1.0 (inclusive).")
    if not (0.0 <= beta <= 1.0):
        raise VSZipError(f"{name}: beta must be between 0.0 and 1.0 (inclusive).")
    if alpha + beta > 1.0:
        raise VSZipError(f"{name}: alpha + beta must be less than or equal to 1.0.")
    if gamma < 0.0:
        raise VSZipError(f"{name}: gamma must be greater than or equal to 0.0.")
    if not (0 <= nrad <= 3):
        raise VSZipError(f"{name}: nrad must be between 0 and 3 (inclusive).")
    if not (1 <= mdis <= 40):
        raise VSZipError(f"{name}: mdis must be between 1 and 40 (inclusive).")
    if not (0 <= vcheck <= 3):
        raise VSZipError(f"{name}: vcheck must be 0, 1, 2, or 3.")
    if vcheck > 0 and (vthresh0 <= 0 or vthresh1 <= 0 or vthresh2 <= 0):
        raise VSZipError(
            f"{name}: vthresh0, vthresh1 and vthresh2 must be greater than 0.0."
        )
    if mclip is not None:
        from ..core.format import ColorFamily

        if mclip.format.color_family is not ColorFamily.GRAY:
            raise VSZipError(f"{name}: mclip must be Gray.")
        if (mclip.width, mclip.height) != (clip.width, clip.height):
            raise VSZipError(f"{name}: mclip's dimensions don't match.")
        if mclip.num_frames != clip.num_frames:
            raise VSZipError(f"{name}: mclip's number of frames doesn't match.")
        # the reference converts non-Gray8 masks to Gray8 (Resize.Point);
        # the gate only tests mask != 0, which is dtype-independent here
    double_rate = field > 1

    out_planes = []
    nf = clip.num_frames
    vthresh = (float(vthresh0), float(vthresh1), float(vthresh2))
    for p in range(fmt.num_planes):
        xp = jnp.asarray(clip.planes[p], jnp.float32)
        ssw = fmt.subsampling_w if p else 0
        ssh = fmt.subsampling_h if p else 0
        mp = None
        if mclip is not None:
            # the single luma-sized Gray mask drives every plane; subsampled
            # planes read the first chroma-width pixels of the luma-indexed
            # mask rows (reference quirk: no scaling, plain row indexing)
            m = jnp.asarray(mclip.planes[0])
            pw_, _ = clip.plane_dims(p)
            mp = m[:, :, :pw_]
        if horizontal:
            xp = jnp.swapaxes(xp, 1, 2)
            mp = jnp.swapaxes(mp, 1, 2) if mp is not None else None

        def run(fld, scp_p):
            return _eedi3_plane(
                xp, mp, scp_p, fld, bool(dh), bool(hp), int(mdis), int(nrad),
                float(alpha), float(beta), float(gamma), int(vcheck), vthresh,
            )

        base_field = field & 1
        if double_rate:
            scp_even = scp_odd = None
            if sclip is not None and vcheck > 0:
                sp = jnp.asarray(sclip.planes[p], jnp.float32)
                if horizontal:
                    sp = jnp.swapaxes(sp, 1, 2)
                scp_even = sp[0::2]
                scp_odd = sp[1::2]
            out0 = run(0 ^ base_field, scp_even)
            out1 = run(1 ^ base_field, scp_odd)
            n_dst = out0.shape[1]
            merged = jnp.zeros((2 * nf, n_dst, out0.shape[2]), jnp.float32)
            merged = merged.at[0::2].set(out0)
            merged = merged.at[1::2].set(out1)
            res = merged
        else:
            scp_p = None
            if sclip is not None and vcheck > 0:
                scp_p = jnp.asarray(sclip.planes[p], jnp.float32)
                if horizontal:
                    scp_p = jnp.swapaxes(scp_p, 1, 2)
            res = run(base_field, scp_p)
        if horizontal:
            res = jnp.swapaxes(res, 1, 2)
        out_planes.append(res)

    props = dict(clip.props)
    props["_FieldBased"] = 0
    return Clip(tuple(out_planes), fmt, props)


def eedi3(clip: Clip, field: int, **kw) -> Clip:
    """vszip.EEDI3 (vertical interpolation)."""
    return _eedi3_impl(False, clip, field, **kw)


def eedi3h(clip: Clip, field: int, **kw) -> Clip:
    """vszip.EEDI3H (the same pipeline across the width)."""
    return _eedi3_impl(True, clip, field, **kw)
