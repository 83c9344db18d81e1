"""ColorMap: Gray8 -> RGB24 pseudo-color via the 22 OpenCV colormaps.

Reference: src/filters/color_map.zig + src/vapoursynth/color_map.zig.  The
anchor tables (public OpenCV colormap data, 9..510 f32 anchors per channel)
live in colormap_data.npz; create-time they are resampled to a 256-entry u8
LUT with linear interpolation and ``trunc(v*255 + 0.5)`` rounding, then the
frame op is a triple LUT take.  Output carries RGB24 full-range props
(_Matrix RGB, _Transfer sRGB, _Primaries BT709, _ColorRange FULL).
"""

from __future__ import annotations

from functools import lru_cache, partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ..core.clip import Clip
from ..core.format import get_format
from ..core.params import VSZipError

FILTER_NAME = "ColorMap"

COLOR_NAMES = [
    "autumn", "bone", "jet", "winter", "rainbow", "ocean", "summer",
    "spring", "cool", "hsv", "pink", "hot", "parula", "magma", "inferno",
    "plasma", "viridis", "cividis", "twilight", "twilight_shifted", "turbo",
    "deepgreen",
]


@lru_cache(maxsize=1)
def _tables():
    return dict(np.load(Path(__file__).with_name("colormap_data.npz")))


@lru_cache(maxsize=32)
def _lut(color: int) -> tuple:
    anchors = _tables()[COLOR_NAMES[color]]
    n = anchors.shape[1]
    lut = np.zeros((3, 256), np.uint8)
    for i in range(256):
        p = np.float32(i) * np.float32(n - 1) / np.float32(255.0)
        lo = int(np.floor(p))
        hi = min(lo + 1, n - 1)
        frac = np.float32(p - lo)
        for c in range(3):
            v = anchors[c, lo] + (anchors[c, hi] - anchors[c, lo]) * frac
            lut[c, i] = np.trunc(v * np.float32(255.0) + np.float32(0.5))
    return tuple(lut)


@partial(jax.jit, static_argnums=(1,))
def _apply(x, color: int):
    # per-pixel LUT via a bit-keyed mux tree instead of gathers or a
    # broadcast compare-reduce (whose (N,H,256,W) operand XLA materializes
    # in device memory at production batch sizes).  The three channel
    # LUTs pack into one i32 constant per bin; a 256-way mux costs 255
    # two-way selects however it is shaped, but keying each tree level off
    # one BIT of the pixel value drops the per-bin compares of a linear
    # select chain (255 sel + 8 bit tests vs 256 cmp + 256 sel), all fused
    # as one elementwise kernel.
    r, g, b = _lut(color)
    packed = (r.astype(np.int32) | (g.astype(np.int32) << 8)
              | (b.astype(np.int32) << 16))
    v = x.astype(jnp.int32)
    bits = [((v >> k) & jnp.int32(1)) == 1 for k in range(8)]

    def node(base, span):
        if span == 1:
            return np.int32(packed[base])
        half = span // 2
        return jnp.where(bits[half.bit_length() - 1],
                         node(base + half, half), node(base, half))

    acc = node(0, 256)
    ru = (acc & 255).astype(jnp.uint8)
    gu = ((acc >> 8) & 255).astype(jnp.uint8)
    bu = ((acc >> 16) & 255).astype(jnp.uint8)
    return ru, gu, bu


def colormap(clip: Clip, color: int = 20) -> Clip:
    if clip.format.name != "GRAY8":
        raise VSZipError(f"{FILTER_NAME}: only Gray8 format is supported.")
    if color < 0 or color > 21:
        raise VSZipError(f'{FILTER_NAME}: "color" should be between 0 and 21.')
    r, g, b = _apply(clip.planes[0], int(color))
    props = dict(clip.props)
    props.update(_Matrix=0, _Transfer=13, _Primaries=1, _ColorRange=0)
    return Clip((r, g, b), get_format("RGB24"), props)
