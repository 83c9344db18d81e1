"""Literal NumPy oracle for EEDI3 (reference src/filters/eedi3.zig scalar
paths): per-line cost matrix, sequential DP, backtrack, interpolation, and
the vcheck post-pass.  Non-hp and hp variants."""

from __future__ import annotations

import numpy as np

PAD = 96
FLT_MAX_09 = np.float32(np.finfo(np.float32).max * 0.9)


def reflect(y, h):
    if h == 1:
        return 0
    while y < 0 or y >= h:
        if y < 0:
            y = -y
        if y >= h:
            y = 2 * (h - 1) - y
    return y


def src_col(dh, off, n_src):
    return reflect(off, 2 * n_src) // 2 if dh else reflect(off, n_src)


def pad_row(row):
    w = len(row)
    buf = np.zeros(w + 2 * PAD, np.float32)
    buf[PAD : PAD + w] = row
    for i in range(PAD):
        buf[PAD + w + i] = buf[PAD + w - 2 - i]
    for i in range(PAD):
        buf[i] = buf[2 * PAD - i]
    return buf


def _f32(x):
    return np.float32(x)


def interp_line_ref(r3p, r1p, r1n, r3n, w, mdis, nrad, alpha, beta, gamma,
                    one_minus_ab, hp=False):
    """returns (dst_row, dmap_row); inputs are padded rows."""
    if hp:
        return _interp_line_hp(r3p, r1p, r1n, r3n, w, mdis, nrad, alpha, beta,
                               gamma, one_minus_ab)
    tpitch = 2 * mdis + 1
    P = PAD
    tcosts = np.zeros((tpitch, w), np.float32)
    for ui, u in enumerate(range(-mdis, mdis + 1)):
        tu = 2 * u
        tb = {}

        def t_base(j):
            if j not in tb:
                tb[j] = _f32(
                    abs(_f32(r3p[P + j] - r1p[P + j - tu]))
                    + abs(_f32(r1p[P + j] - r1n[P + j - tu]))
                    + abs(_f32(r1n[P + j] - r3n[P + j - tu]))
                )
            return tb[j]

        for x in range(w):
            sw0 = sw1 = sw2 = _f32(0)
            for k in range(-nrad, nrad + 1):
                sw1 = _f32(sw1 + t_base(x + k))
                sw0 = _f32(sw0 + t_base(x + u + k))
                sw2 = _f32(sw2 + t_base(x + tu + k))
            ip = _f32((r1p[P + x + u] + r1n[P + x - u]) * _f32(0.5))
            v = _f32(abs(_f32(r1p[P + x] - ip)) + abs(_f32(r1n[P + x] - ip)))
            tcosts[ui, x] = _f32(
                _f32(alpha) * _f32(_f32(sw0 + sw1) + sw2)
                + _f32(_f32(beta) * abs(u))
                + _f32(one_minus_ab) * v
            )

    pbackt = np.zeros((w, tpitch), np.int8)
    pc = np.full(tpitch + 2, FLT_MAX_09, np.float32)
    pc[1 : tpitch + 1] = tcosts[:, 0]
    for x in range(1, w):
        nxt = np.full(tpitch + 2, FLT_MAX_09, np.float32)
        for ui in range(tpitch):
            left = _f32(pc[ui] + _f32(gamma))
            cent = pc[ui + 1]
            right = _f32(pc[ui + 2] + _f32(gamma))
            bval, bd = cent, 0
            if left < bval:
                bval, bd = left, -1
            if right < bval:
                bval, bd = right, 1
            nxt[ui + 1] = min(_f32(bval + tcosts[ui, x]), FLT_MAX_09)
            pbackt[x - 1, ui] = bd
        pc = nxt

    fpath = np.zeros(w, np.int32)
    for bx in range(w - 2, -1, -1):
        fpath[bx] = fpath[bx + 1] + pbackt[bx, mdis + fpath[bx + 1]]

    dst = np.zeros(w, np.float32)
    for x in range(w):
        d = int(fpath[x])
        ad = abs(d)
        if x >= ad * 3 and x + ad * 3 <= w - 1:
            dst[x] = _f32(
                _f32(0.5625) * _f32(r1p[P + x + d] + r1n[P + x - d])
                - _f32(0.0625) * _f32(r3p[P + x + 3 * d] + r3n[P + x - 3 * d])
            )
        else:
            dst[x] = _f32(_f32(r1p[P + x + d] + r1n[P + x - d]) * _f32(0.5))
    return dst, fpath


def _hp_row(a):
    out = np.zeros_like(a)
    n = len(a)
    for j in range(1, n - 2):
        out[j] = _f32(
            _f32(0.5625) * _f32(a[j] + a[j + 1])
            - _f32(0.0625) * _f32(a[j - 1] + a[j + 2])
        )
    return out


def _interp_line_hp(r3p, r1p, r1n, r3n, w, mdis, nrad, alpha3, beta255,
                    gamma255, one_minus_ab):
    P = PAD
    cen = 2 * mdis
    tpitch = 4 * mdis + 1
    hp3p, hp1p, hp1n, hp3n = (_hp_row(r) for r in (r3p, r1p, r1n, r3n))
    tcosts = np.zeros((tpitch, w), np.float32)
    for ui, u in enumerate(range(-cen, cen + 1)):
        uh = u >> 1
        odd = (u & 1) != 0
        lo0 = (-uh - 1) if odd else -uh
        A0, B0, C0, D0 = (hp3p, hp1p, hp1n, hp3n) if odd else (r3p, r1p, r1n, r3n)

        def base_m(j):
            return _f32(
                abs(_f32(r3p[P + j] - r1p[P + j - u]))
                + abs(_f32(r1p[P + j] - r1n[P + j - u]))
                + abs(_f32(r1n[P + j] - r3n[P + j - u]))
            )

        def base_0(j):
            if not odd:
                return base_m(j)
            return _f32(
                abs(_f32(A0[P + j] - B0[P + j - u]))
                + abs(_f32(B0[P + j] - C0[P + j - u]))
                + abs(_f32(C0[P + j] - D0[P + j - u]))
            )

        for x in range(w):
            s0 = s1 = s2 = _f32(0)
            for k in range(-nrad, nrad + 1):
                s1 = _f32(s1 + base_m(x + k))
                s2 = _f32(s2 + base_m(x + u + k))
                s0 = _f32(s0 + base_0(x + uh + k))
            ip = _f32((B0[P + x + uh] + C0[P + x + lo0]) * _f32(0.5))
            v = _f32(abs(_f32(r1p[P + x] - ip)) + abs(_f32(r1n[P + x] - ip)))
            tcosts[ui, x] = _f32(
                _f32(alpha3) * _f32(_f32(s0 + s1) + s2)
                + _f32(_f32(beta255) * abs(u) * _f32(0.5))
                + _f32(one_minus_ab) * v
            )

    pbackt = np.zeros((w, tpitch), np.int8)
    pc = np.full(tpitch + 4, FLT_MAX_09, np.float32)
    pc[2 : tpitch + 2] = tcosts[:, 0]
    for x in range(1, w):
        nxt = np.full(tpitch + 4, FLT_MAX_09, np.float32)
        for ui in range(tpitch):
            bval, bd = FLT_MAX_09, 0
            for dv in range(-2, 3):
                gv = _f32(_f32(gamma255) * abs(dv) * _f32(0.5))
                cc = _f32(pc[ui + 2 + dv] + gv)
                if cc < bval:
                    bval, bd = cc, dv
            nxt[ui + 2] = min(_f32(bval + tcosts[ui, x]), FLT_MAX_09)
            pbackt[x - 1, ui] = bd
        pc = nxt

    fpath = np.zeros(w, np.int32)
    for bx in range(w - 2, -1, -1):
        fpath[bx] = fpath[bx + 1] + pbackt[bx, cen + fpath[bx + 1]]

    dst = np.zeros(w, np.float32)
    for x in range(w):
        d = int(fpath[x])
        if (d & 1) == 0:
            d2 = d >> 1
            ad = abs(d2)
            if x >= ad * 3 and x + ad * 3 <= w - 1:
                dst[x] = _f32(
                    _f32(0.5625) * _f32(r1p[P + x + d2] + r1n[P + x - d2])
                    - _f32(0.0625) * _f32(r3p[P + x + 3 * d2] + r3n[P + x - 3 * d2])
                )
            else:
                dst[x] = _f32(_f32(r1p[P + x + d2] + r1n[P + x - d2]) * _f32(0.5))
        else:
            d20, d21 = d >> 1, (d + 1) >> 1
            d30, d31 = (3 * d) >> 1, (3 * d + 1) >> 1
            ad = max(abs(d30), abs(d31))
            c1 = _f32(r1p[P + x + d20] + r1p[P + x + d21])
            c2 = _f32(r1n[P + x - d20] + r1n[P + x - d21])
            if x >= ad and x + ad <= w - 1:
                c0 = _f32(r3p[P + x + d30] + r3p[P + x + d31])
                c3 = _f32(r3n[P + x - d30] + r3n[P + x - d31])
                dst[x] = _f32(
                    _f32(0.28125) * _f32(c1 + c2) - _f32(0.03125) * _f32(c0 + c3)
                )
            else:
                dst[x] = _f32(_f32(c1 + c2) * _f32(0.25))
    return dst, fpath


def eedi3_plane_ref(src, field, dh, mdis, nrad, alpha, beta, gamma, hp=False):
    """src (n_src, W) f32 -> (n_dst, W) without vcheck; also returns dmap."""
    n_src, w = src.shape
    n_interp = n_src if dh else n_src // 2
    n_dst = n_src * 2 if dh else n_src
    out = np.zeros((n_dst, w), np.float32)
    dmap = np.zeros((n_interp, w), np.int32)
    if dh:
        for k in range(n_src):
            out[2 * k + (1 - field)] = src[k]
    else:
        for k in range(1 - field, n_src, 2):
            out[k] = src[k]
    a_s = _f32(alpha) / _f32(3.0)
    b_s = _f32(beta) / _f32(255.0)
    g_s = _f32(gamma) / _f32(255.0)
    omab = _f32(1.0) - _f32(alpha) - _f32(beta)
    for i, line in enumerate(range(field, n_dst, 2)):
        rows = [
            pad_row(src[src_col(dh, line + off, n_src)])
            for off in (-3, -1, 1, 3)
        ]
        dst, fp = interp_line_ref(rows[0], rows[1], rows[2], rows[3], w,
                                  mdis, nrad, a_s, b_s, g_s, omab, hp=hp)
        out[line] = dst
        dmap[i] = fp
    return out, dmap


def vcheck_ref(src, dst, dmap, field, dh, hp, vcheck, vthresh0=32.0,
               vthresh1=64.0, vthresh2=4.0):
    """vcheckLine (reference src/filters/eedi3.zig), one pixel at a time:
    every interpolated line pd (except the first and last) is blended
    toward its vertical 4-tap interpolation by a reliability weight built
    from the direction map; line pd reads line pd-2 as already updated.
    src (n_src, W) f32, dst (n_dst, W) the interpolated frame, dmap
    (n_interp, W) the chosen directions."""
    n_src, w = src.shape
    n_dst = dst.shape[0]
    n_interp = dmap.shape[0]
    out = dst.copy()
    rcp0 = _f32(1.0 / (vthresh0 / 255.0))
    rcp1 = _f32(1.0 / (vthresh1 / 255.0))
    rcp2 = _f32(1.0 / vthresh2)
    vt2 = _f32(vthresh2)
    half, quarter = _f32(0.5), _f32(0.25)
    for off in range(1, n_interp - 1):
        pd = field + 2 * off
        if pd < 2 or pd + 2 >= n_dst:
            continue
        d2p, d1p, dl = out[pd - 2], dst[pd - 1], dst[pd]
        d1n, d2n = dst[pd + 1], dst[pd + 2]
        s3p = src[src_col(dh, pd - 3, n_src)]
        s3n = src[src_col(dh, pd + 3, n_src)]
        for x in range(w):
            dm, dmp, dmn = (int(dmap[off, x]), int(dmap[off - 1, x]),
                            int(dmap[off + 1, x]))
            cint = _f32(_f32(0.5625) * _f32(d1p[x] + d1n[x])
                        - _f32(0.0625) * _f32(s3p[x] + s3n[x]))
            keep = (dm == 0 or max(dm * dmp, dm * dmn) < 0
                    or (dmp == 0 and dmn == 0))
            if hp:
                maxoff = (abs(dm >> 1) if dm % 2 == 0
                          else max(abs(dm >> 1), abs((dm + 1) >> 1)))
            else:
                maxoff = abs(dm)
            if keep or x + maxoff >= w or x - maxoff < 0:
                out[pd, x] = cint
                continue
            if hp:
                d20, d21 = dm >> 1, (dm + 1) >> 1
                up0, up1, up2 = (d2p[x + d20], d1p[x + d20], dl[x + d20])
                dn0, dn1, dn2 = (dl[x - d20], d1n[x - d20], d2n[x - d20])
                if dm % 2 == 0:
                    it = _f32(_f32(up0 + dn0) * half)
                    ib = _f32(_f32(up2 + dn2) * half)
                    vt = _f32(abs(_f32(up0 - up1)) + abs(_f32(up2 - up1)))
                    vb = _f32(abs(_f32(dn2 - dn1)) + abs(_f32(dn0 - dn1)))
                else:
                    s2ps = _f32(up0 + d2p[x + d21])
                    s1ps = _f32(up1 + d1p[x + d21])
                    pa0 = _f32(up2 + dl[x + d21])
                    ps0 = _f32(dn0 + dl[x - d21])
                    s1ns = _f32(dn1 + d1n[x - d21])
                    s2ns = _f32(dn2 + d2n[x - d21])
                    it = _f32(_f32(s2ps + ps0) * quarter)
                    vt = _f32(_f32(abs(_f32(s2ps - s1ps))
                                   + abs(_f32(pa0 - s1ps))) * half)
                    ib = _f32(_f32(pa0 + s2ns) * quarter)
                    vb = _f32(_f32(abs(_f32(s2ns - s1ns))
                                   + abs(_f32(ps0 - s1ns))) * half)
                dabs = abs(dm) >> 1
            else:
                up0, up1, up2 = d2p[x + dm], d1p[x + dm], dl[x + dm]
                dn0, dn1, dn2 = dl[x - dm], d1n[x - dm], d2n[x - dm]
                it = _f32(_f32(up0 + dn0) * half)
                ib = _f32(_f32(up2 + dn2) * half)
                vt = _f32(abs(_f32(up0 - up1)) + abs(_f32(up2 - up1)))
                vb = _f32(abs(_f32(dn2 - dn1)) + abs(_f32(dn0 - dn1)))
                dabs = abs(dm)
            vc = _f32(abs(_f32(dl[x] - d1p[x])) + abs(_f32(dl[x] - d1n[x])))
            d0 = abs(_f32(it - d1p[x]))
            d1 = abs(_f32(ib - d1n[x]))
            d2 = abs(_f32(vt - vc))
            d3 = abs(_f32(vb - vc))
            if vcheck == 1:
                m0, m1 = min(d0, d1), min(d2, d3)
            elif vcheck == 2:
                m0, m1 = _f32(_f32(d0 + d1) * half), _f32(_f32(d2 + d3) * half)
            else:
                m0, m1 = max(d0, d1), max(d2, d3)
            a0 = _f32(m0 * rcp0)
            a1 = _f32(m1 * rcp1)
            a2 = max(_f32(_f32(vt2 - _f32(dabs)) * rcp2), _f32(0.0))
            a = min(max(a0, max(a1, a2)), _f32(1.0))
            out[pd, x] = _f32(_f32(_f32(1.0) - a) * dl[x] + _f32(a * cint))
    return out
