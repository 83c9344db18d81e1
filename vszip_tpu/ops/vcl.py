"""Bit-faithful JAX ports of the reference's VCL2 transcendentals
(src/vcl.zig, itself Agner Fog's vectorclass vectormath_{exp,trig}.h).

The reference routes three hot transcendentals through hand-vectorized
polynomial kernels instead of libm: ``cbrt`` (SSIMULACRA2's XYB
nonlinearity, src/vcl.zig:40-81), ``pow`` (Deband m6/m7's soft-blend
factor ``pow(product, 0.1)``, src/vcl.zig:85-180 /
src/filters/deband_int.zig:325), and ``atan`` (Deband m7's gradient
angle, src/vcl.zig:3-38 / deband_int.zig:411).  Porting the exact
polynomials (same coefficients, same association order, same bit-level
exponent manipulation) makes the repo's outputs round like the
reference's SIMD build instead of like XLA's own transcendental
lowering.

Deviation note: the Zig kernels use ``@mulAdd`` (true fused
multiply-add, one rounding).  XLA decides contraction itself;
``a * b + c`` below may round twice.  The reference-pinned goldens
(rel 1e-6 on Deband m6/m7, rel 1e-3 on SSIMULACRA2) bound the
residual from that difference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_U32 = jnp.uint32
_I32 = jnp.int32
_F32 = jnp.float32


def _bits(x):
    return jax.lax.bitcast_convert_type(x, _U32)


def _float(u):
    return jax.lax.bitcast_convert_type(u, _F32)


def _round_half_away(x):
    """Zig ``@round``: round half away from zero (the Zig port's rule;
    ties in the pow exponent splits land only on exact .5 products)."""
    return jnp.trunc(x + jnp.where(x >= 0, _F32(0.5), _F32(-0.5)))


def _copysign(mag, sign_src):
    return _float((_bits(mag) & _U32(0x7FFFFFFF))
                  | (_bits(sign_src) & _U32(0x80000000)))


def _poly3(x, c0, c1, c2, c3):
    # vcl.zig polynomial_3: (c3*x + c2)*x2 + (c1*x + c0)
    x2 = x * x
    return (_F32(c3) * x + _F32(c2)) * x2 + (_F32(c1) * x + _F32(c0))


def _poly5(x, c0, c1, c2, c3, c4, c5):
    # vcl.zig polynomial_5: (c3*x+c2)*x2 + ((c5*x+c4)*x4 + (c1*x+c0))
    x2 = x * x
    x4 = x2 * x2
    return ((_F32(c3) * x + _F32(c2)) * x2
            + ((_F32(c5) * x + _F32(c4)) * x4 + (_F32(c1) * x + _F32(c0))))


def _poly8(x, c0, c1, c2, c3, c4, c5, c6, c7, c8):
    # vcl.zig polynomial_8 association order
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    hi = (_F32(c7) * x + _F32(c6)) * x2 + (_F32(c5) * x + _F32(c4))
    lo = ((_F32(c3) * x + _F32(c2)) * x2
          + ((_F32(c1) * x + _F32(c0)) + _F32(c8) * x8))
    return hi * x4 + lo


def _fraction_2(a):
    """Mantissa with exponent forced to -1: bits -> (mant | 0x3F000000)."""
    return _float((_bits(a) & _U32(0x007FFFFF)) | _U32(0x3F000000))


def _exponent_f(a):
    """Unbiased exponent as f32."""
    e = ((_bits(a) >> _U32(23)) & _U32(0xFF)).astype(_I32) - _I32(127)
    return e.astype(_F32)


def atan(x):
    """VCL2 atan_f (src/vcl.zig:3-38): octant reduction around
    tan(pi/8)=sqrt2-1 / tan(3pi/8)=sqrt2+1, degree-3 odd polynomial in
    z^2, copysign restore."""
    import math

    t = jnp.abs(x)
    notsmal = t >= _F32(math.sqrt(2.0) - 1.0)
    notbig = t <= _F32(math.sqrt(2.0) + 1.0)

    s = jnp.where(notbig, _F32(math.pi * 0.25), _F32(math.pi * 0.5))
    s = jnp.where(notsmal, s, _F32(0.0))

    a = jnp.where(notbig, t, _F32(0.0))
    a = a + jnp.where(notsmal, _F32(-1.0), _F32(0.0))
    b = jnp.where(notbig, _F32(1.0), _F32(0.0))
    b = b + jnp.where(notsmal, t, _F32(0.0))

    z = a / b
    zz = z * z
    re = _poly3(zz, -3.33329491539e-1, 1.99777106478e-1,
                -1.38776856032e-1, 8.05374449538e-2)
    re = re * (zz * z) + z + s
    return _copysign(re, x)


def cbrt(x):
    """VCL2 cbrt_f (src/vcl.zig:40-81): exponent-hacked seed
    ``bitcast(0x54800000 - exp_bits*0x002AAAAA)``, 3 Newton iterations,
    one refined step, ``a^2 * x``; |x| <= 2^-126 underflows to 0."""
    one_third = _F32(1.0 / 3.0)
    four_third = _F32(4.0 / 3.0)
    xa = jnp.abs(x)
    xa3 = one_third * xa
    m1 = _bits(xa)
    m2 = _U32(0x54800000) - ((m1 >> _U32(23)) * _U32(0x002AAAAA))
    a = _float(m2)
    underflow = m1 <= _U32(0x00800000)
    for _ in range(3):
        a2 = a * a
        a = (four_third * a) - (xa3 * (a2 * a2))
    a2 = a * a
    a = a + (one_third * (a - (xa * (a2 * a2))))
    a = (a * a) * x
    return jnp.where(underflow, _F32(0.0), a)


def pow_(x0, y):
    """VCL2 pow_template_f (src/vcl.zig:85-180): log via degree-8
    polynomial on the mantissa with hi/lo ln2 split and error
    compensation, three-way exponent accumulation (e1+e2+e3), exp via
    degree-5 Taylor, exponent injected by wrapping bit arithmetic.
    Handles the x==+-0 cases like the reference (y>0 -> 0, y==0 -> 1,
    y<0 -> inf); negative non-zero x follows |x| (the reference's
    deband call sites only pass x in [0,1])."""
    y = jnp.asarray(y, _F32)

    x1 = jnp.abs(x0)
    x = _fraction_2(x1)
    blend = x > _F32(0.7071067811865476)
    x = jnp.where(blend, x, x + x)
    x = x - _F32(1.0)

    x2 = x * x
    lg1 = _poly8(x, 3.3333331174e-1, -2.4999993993e-1, 2.0000714765e-1,
                 -1.6668057665e-1, 1.4249322787e-1, -1.2420140846e-1,
                 1.1676998740e-1, -1.1514610310e-1, 7.0376836292e-2)
    lg1 = lg1 * (x2 * x)

    ef = _exponent_f(x1)
    ef = jnp.where(blend, ef + _F32(1.0), ef)

    e1 = _round_half_away(ef * y)
    yr = ef * y - e1

    half = _F32(0.5)
    lg = (half * (-x2) + x) + lg1
    x2err = (half * x) * x + half * (-x2)
    lgerr = half * x2 + (lg - x) - lg1

    log2e = _F32(1.4426950408889634)
    ln2f_hi = _F32(0.693359375)
    ln2f_lo = _F32(-2.12194440e-4)
    ln2 = _F32(0.6931471805599453)

    e2 = _round_half_away(lg * y * log2e)
    v = lg * y + (-e2) * ln2f_hi
    v = (-e2) * ln2f_lo + v

    correction = (lgerr + x2err) * y + (-yr) * ln2
    v = v - correction

    x = v
    e3 = _round_half_away(x * log2e)
    x = (-e3) * ln2 + x

    x2e = x * x
    z = _poly5(x, 1.0 / 2.0, 1.0 / 6.0, 1.0 / 24.0, 1.0 / 120.0,
               1.0 / 720.0, 1.0 / 5040.0)
    z = z * x2e + x + _F32(1.0)

    ee = e1 + e2 + e3
    ei = _round_half_away(ee).astype(_I32)
    z_bits = _bits(z) + (ei.astype(_U32) << _U32(23))  # wrapping add
    z = _float(z_bits)

    x0_bits = _bits(jnp.broadcast_to(jnp.asarray(x0, _F32), z.shape))
    xzero = (x0_bits & _U32(0x7F800000)) == _U32(0)
    inf = _float(jnp.broadcast_to(_U32(0x7F800000), z.shape))
    yb = jnp.broadcast_to(y, z.shape)
    zero_case = jnp.where(yb < _F32(0.0), inf,
                          jnp.where(yb == _F32(0.0), _F32(1.0), _F32(0.0)))
    return jnp.where(xzero, zero_case, z)
