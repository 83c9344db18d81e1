"""Deterministic test fixtures.

The reference suite derives all inputs from one 1920x1080 photo
(reference tests/conftest.py:73-135): a 640x320 RGB24 crop of
tests/image.png, plus a 3-frame vertically-shifted temporal variant
(reference tests/conftest.py:138-167).  This suite anchors to the SAME
content: the photo is decoded with the in-repo PNG decoder and cropped with
the reference's exact geometry (left = width-640, bottom = height-320), so
content-level comparisons against reference numbers (e.g. the SSIMULACRA2
68.625 anchor) are meaningful.  Set VSZIP_TEST_IMAGE to point elsewhere.

Format conversions are zimg-exact (tests/zimg_exact.py): u8 -> f32 by
reciprocal multiply, BT.709 matrix as an f32 FMA chain, chroma resampled
through the reference's `resize.Bilinear(format=..., matrix=1)` semantics
(Point for the temporal clip, matching reference tests/conftest.py:161), and
limited-range FMA quantization.  This makes the converted planes match the
reference fixture pipeline to round-to-nearest ties (validated bit-exactly on
the YUV444P16/YUV420PS pins in test_zimg_convert.py), so the reference's own
golden JSONs are directly comparable.
Geometry variants reproduce the reference's full/odd/tiny scheme
(reference tests/conftest.py:108-121).

Tests that pin an op against an in-repo literal oracle (tests/oracle/) do
not need the photo: they take `seeded_rgb24()` / `seeded_temporal_rgb24()`,
a procedural image of the same size generated from a fixed seed, with
gradients, hard edges, fine texture, noise and a clean banded ramp, so
every filter has work to do.
"""

from __future__ import annotations

import os
from functools import lru_cache
from pathlib import Path

import numpy as np

import zimg_exact
from vszip_tpu import Clip, get_format

W, H = 640, 320

IMAGE = Path(
    os.environ.get("VSZIP_TEST_IMAGE", "/root/reference/tests/image.png")
)


@lru_cache(maxsize=1)
def _photo_planes() -> tuple:
    """(3, Himg, Wimg) uint8 planes of the full reference photo."""
    from vszip_tpu.io.image_read import image_read

    clip = image_read(str(IMAGE))
    assert clip.format.name == "RGB24", clip.format.name
    return tuple(np.asarray(p)[0] for p in clip.planes)


def _crop(top: int = 0) -> np.ndarray:
    """(H, W, 3) uint8: the reference crop (right-top corner region), rows
    shifted down by `top` (reference tests/conftest.py:142-147)."""
    planes = _photo_planes()
    ih, iw = planes[0].shape
    return np.stack(
        [p[top : top + H, iw - W : iw] for p in planes], axis=-1
    )


def source_rgb24() -> Clip:
    """Single-frame 640x320 RGB24 crop of the reference photo."""
    u8 = _crop(0)
    planes = tuple(u8[None, :, :, c] for c in range(3))
    return Clip.from_planes(planes, get_format("RGB24"))


def temporal_rgb24() -> Clip:
    """3-frame clip; frame n is the crop shifted down n rows."""
    u8 = np.stack([_crop(n) for n in range(3)])
    planes = tuple(u8[:, :, :, c] for c in range(3))
    return Clip.from_planes(planes, get_format("RGB24"))


SEED = 20260416


@lru_cache(maxsize=1)
def _seeded_canvas() -> np.ndarray:
    """(H + 2, W, 3) uint8 procedural image from SEED: smooth colour
    gradients, hard-edged rectangles and discs, a fine sinusoidal texture,
    Gaussian noise, and a noise-free quantized ramp (the banding Deband and
    CLAHE act on) in the left quarter."""
    rng = np.random.default_rng(SEED)
    hh = H + 2
    yy, xx = np.mgrid[0:hh, 0:W].astype(np.float64)
    img = np.stack([
        40.0 + 170.0 * xx / W,
        40.0 + 170.0 * yy / hh,
        125.0 + 80.0 * np.sin(xx / 37.0 + yy / 23.0),
    ], axis=-1)
    for _ in range(10):
        x0, y0 = rng.integers(0, W - 40), rng.integers(0, hh - 30)
        w, h = rng.integers(20, 160), rng.integers(15, 120)
        img[y0 : y0 + h, x0 : x0 + w] = rng.integers(0, 256, 3)
    for _ in range(8):
        cx, cy, r = rng.integers(0, W), rng.integers(0, hh), rng.integers(8, 60)
        img[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = rng.integers(0, 256, 3)
    img += (20.0 * np.sin(xx * 1.7) * np.sin(yy * 1.3))[..., None]
    img += rng.normal(0.0, 6.0, img.shape)
    ramp = np.floor(60.0 + 24.0 * yy[:, : W // 4] / hh + 8.0 * xx[:, : W // 4] / W)
    img[:, : W // 4] = ramp[..., None] + np.array([0.0, 20.0, 40.0])
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def seeded_rgb24() -> Clip:
    """Single-frame 640x320 RGB24 crop of the seeded canvas."""
    u8 = _seeded_canvas()[:H]
    return Clip.from_planes(tuple(u8[None, :, :, c] for c in range(3)),
                            get_format("RGB24"))


def seeded_temporal_rgb24() -> Clip:
    """3-frame seeded clip; frame n is the canvas shifted down n rows."""
    u8 = np.stack([_seeded_canvas()[n : n + H] for n in range(3)])
    return Clip.from_planes(tuple(u8[:, :, :, c] for c in range(3)),
                            get_format("RGB24"))


def seeded_plane(shape, dtype, seed: int = SEED) -> np.ndarray:
    """(N, H, W) plane of the given dtype with gradients, edges, texture
    and noise, from `seed` (integer dtypes span their full range, float
    dtypes [0, 1])."""
    rng = np.random.default_rng(seed)
    n, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    v = 0.2 + 0.5 * (xx / w) * (yy / h)
    v = v + 0.15 * np.sin(xx * 1.3 + yy * 0.7) * (xx > w / 3)
    v = np.where((xx - w / 2) ** 2 + (yy - h / 2) ** 2 < (min(h, w) / 4) ** 2,
                 0.85, v)
    v = v[None] + rng.normal(0.0, 0.03, (n, h, w))
    v = np.clip(v, 0.0, 1.0)
    if np.issubdtype(dtype, np.integer):
        return np.rint(v * np.iinfo(dtype).max).astype(dtype)
    return v.astype(dtype)


# ---------------------------------------------------------------------------
# conversions (zimg-exact; see tests/zimg_exact.py)
# ---------------------------------------------------------------------------


def _convert_props(src_props: dict, fmt) -> dict:
    """Props the reference fixtures carry after conversion (reference
    tests/conftest.py:99-105): YUV keeps the _Matrix=1 the resize stamps;
    GRAY runs std.RemoveFrameProps("_Matrix") so toRGBS falls back to its
    height>650 ? 709 : 601 rule; RGB targets get _Matrix=0."""
    from vszip_tpu.core.format import ColorFamily

    props = dict(src_props)
    if fmt.color_family is ColorFamily.GRAY:
        props.pop("_Matrix", None)
    else:
        props["_Matrix"] = 0 if fmt.color_family is ColorFamily.RGB else 1
    return props


def convert(clip: Clip, fmt_name: str, filt: str = "bilinear") -> Clip:
    """Convert an RGB24 source clip to the named format, reproducing the
    reference fixtures' `resize.Bilinear(format=fmt, matrix=1)`
    (reference tests/conftest.py:99-105; filt="point" reproduces the temporal
    fixture's resize.Point, reference tests/conftest.py:161)."""
    fmt = get_format(fmt_name)
    src = clip.numpy()
    if fmt.name == clip.format.name:
        return Clip.from_planes([np.asarray(p) for p in src.planes], fmt, src.props)
    out = zimg_exact.convert_rgb24(tuple(np.asarray(p) for p in src.planes), fmt, filt)
    return Clip.from_planes(out, fmt, _convert_props(src.props, fmt))


def convert_sized(clip: Clip, fmt_name: str, width: int, height: int) -> Clip:
    """`rgb.resize.Bilinear(width=, height=, format=fmt, matrix=1)` — used by
    the XPSNR extended cases (reference tests/test_xpsnr.py:36-39)."""
    fmt = get_format(fmt_name)
    src = clip.numpy()
    out = zimg_exact.convert_rgb24(
        tuple(np.asarray(p) for p in src.planes), fmt, "bilinear", width, height
    )
    return Clip.from_planes(out, fmt, _convert_props(src.props, fmt))


def geometry_variant(clip: Clip, geometry: str) -> Clip:
    """full / odd / tiny geometry variants
    (reference tests/conftest.py:108-121): `odd` shaves the subsampling-mod
    minimum off right/bottom so dims stop being tile multiples; `tiny` is a
    13x7-ish interior crop forcing scalar-tail / masked-edge paths."""
    fmt = clip.format
    wmod, hmod = 1 << fmt.subsampling_w, 1 << fmt.subsampling_h
    if geometry == "full":
        return clip
    if geometry == "odd":
        return crop(clip, right=wmod, bottom=hmod)
    if geometry == "tiny":
        tw, th = 13 - 13 % wmod, 7 - 7 % hmod
        return crop_abs(clip, width=tw, height=th, left=200, top=100)
    raise ValueError(f"unknown geometry {geometry!r}")


def crop(clip: Clip, left=0, right=0, top=0, bottom=0) -> Clip:
    w, h = clip.width - left - right, clip.height - top - bottom
    return crop_abs(clip, w, h, left, top)


def crop_abs(clip: Clip, width: int, height: int, left: int = 0, top: int = 0) -> Clip:
    fmt = clip.format
    planes = []
    for p, arr in enumerate(clip.planes):
        sw = fmt.subsampling_w if p else 0
        sh = fmt.subsampling_h if p else 0
        l, t = left >> sw, top >> sh
        pw, ph = width >> sw, height >> sh
        planes.append(arr[:, t : t + ph, l : l + pw])
    return Clip.from_planes(planes, fmt, clip.props)
