#!/usr/bin/env python
"""Smoke test of vszip_tpu on one NVIDIA GPU, through the library's entry
points, at the shapes bench.py times.

    python chip_smoke.py               # one card: main path + every op
    python chip_smoke.py --four-cards  # the frames-mesh path on four cards

Runs in one process.  The CPU results every phase is compared with come
from the CPU backend of this same process (``jax.devices("cpu")``), so no
second process ever opens the card.  Phases:

1. device check: exit non-zero without a GPU; print the device kind,
   count, and ``nvidia-smi``'s name and power limit of the card;
2. main path: BoxBlur r13 on 256 frames of 1920x1080 YUV420P16 streamed
   host to host through ``process_stream`` (batch 64, host sink); the
   first and last chunks are compared bit-exactly with the same call on
   the CPU backend, one full luma frame bit-exactly with the literal
   oracle (tests/oracle/boxblur_ref.py);
3. one phase per op bench.py times, at its shapes, each compared with the
   CPU backend on 2 frames and timed (median of 5 calls after warm-up,
   each ended by ``block_until_ready``).

The last stdout line is one JSON object ``{"ok": ..., "device": {...}}``.
Any phase that raises or misses its tolerance makes ``ok`` false and the
exit code 1.

Tolerances (GPU vs the CPU backend):
* BoxBlur, Deband P16/P10 and CLAHE are bit-exact: they compute in
  integer arithmetic, or round a float result in strict f32 (CLAHE);
* Bilateral P16 may differ by at most 1 LSB: its range weight is an f32
  exp and its weighted sums are float, so each backend's exp and XLA's
  multiply-add contraction move the value before rounding by an ulp, which
  flips a .5 rounding boundary (1 LSB is the op's documented contract
  against the reference);
* EEDI3 (GRAYS) lets at most 5% of pixels flip: float cost sums that XLA
  orders differently per backend can flip a Viterbi tie-break, and a
  flipped direction changes the interpolated pixel (the same
  cross-backend contract the CPU suite documents).  A pixel counts as
  flipped when it differs by more than 1e-5, above the ulp-level rounding
  that contracted multiply-adds leave on every pixel;
* SSIMULACRA2 score within rel 1e-3, the metric's score contract;
* XPSNR per-frame scores within rel 1e-6: its block sums are exact
  integers widened to f64, so only the final f64 log/sqrt may differ.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from typing import Callable, NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# XPSNR's streamed four-card run: two chunks of batch + overlap = 32 frames
# each, so every chunk divides over four devices (a chunk that does not
# falls back to one device and compiles a second program).
XPSNR_OVERLAP = 2
XPSNR_BATCH = 30
XPSNR_FRAMES = 60


class PhaseFailed(Exception):
    pass


def _import_library():
    """Import the checkout's vszip_tpu (never an installed copy) and the
    literal oracles beside it; raise ImportError when they are absent."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import vszip_tpu

    if not os.path.abspath(vszip_tpu.__file__).startswith(ROOT + os.sep):
        raise ImportError(f"vszip_tpu found at {vszip_tpu.__file__}, not in "
                          f"{ROOT}")
    from oracle.boxblur_ref import boxblur_ref  # noqa: F401

    return vszip_tpu


def card_info() -> str:
    """nvidia-smi's name and power limit of every visible card."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip()


def timed(fn, arg, reps: int = 5):
    """(median seconds, output): one warm-up call, then `reps` calls each
    ended by block_until_ready."""
    import jax

    out = jax.block_until_ready(fn(arg))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(arg))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), out


def put(clip, device):
    """The clip's planes and array props committed to `device`."""
    import jax

    return jax.device_put(clip, device)


def on(device, fn, clip):
    """fn(clip) with the clip and every constant the op creates on
    `device`."""
    import jax

    with jax.default_device(device):
        return fn(put(clip, device))


def content(rng, n: int, h: int, w: int, dtype, peak: float) -> np.ndarray:
    """(n, h, w) frames with gradients, a hard-edged disc, fine texture
    and noise; frame i is the base picture shifted i pixels right."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.2 + 0.5 * (xx / w) * (yy / h)
    base += 0.15 * np.sin(xx * 0.9 + yy * 0.4) * (xx > w / 3)
    disc = (xx - w / 2) ** 2 + (yy - h / 2) ** 2 < (min(h, w) / 4) ** 2
    base = np.where(disc, 0.85, base)
    frames = np.stack([np.roll(base, i, axis=1) for i in range(n)])
    frames += rng.normal(0.0, 0.02, frames.shape).astype(np.float32)
    frames = np.clip(frames, 0.0, 1.0) * np.float32(peak)
    if np.issubdtype(dtype, np.integer):
        return np.rint(frames).astype(dtype)
    return frames.astype(dtype)


def make_clip(vz, rng, fmt_name: str, n: int, w: int = 1920, h: int = 1080):
    fmt = vz.get_format(fmt_name)
    int_fmt = fmt.sample_type.name == "INTEGER"
    peak = float((1 << fmt.bits_per_sample) - 1) if int_fmt else 1.0
    planes = []
    for p in range(fmt.num_planes):
        pw, ph = fmt.plane_dims(w, h, p)
        planes.append(content(rng, n, ph, pw, fmt.storage_dtype, peak))
    return vz.Clip.from_planes(tuple(planes), fmt)


def vz_clip(like, planes):
    return type(like)(tuple(planes), like.format, {})


# ---------------------------------------------------------------------------
# comparisons: each returns (ok, text)
# ---------------------------------------------------------------------------

def exact(got, want):
    n_diff = sum(int(np.count_nonzero(np.asarray(a) != np.asarray(b)))
                 for a, b in zip(got.planes, want.planes))
    n_px = sum(int(np.asarray(a).size) for a in want.planes)
    shapes_ok = all(np.asarray(a).shape == np.asarray(b).shape
                    and np.asarray(a).dtype == np.asarray(b).dtype
                    for a, b in zip(got.planes, want.planes))
    return (shapes_ok and n_diff == 0,
            f"bit-exact check: {n_diff} of {n_px} samples differ")


def within_one(got, want):
    diffs = [np.abs(np.asarray(a).astype(np.int64) - np.asarray(b))
             for a, b in zip(got.planes, want.planes)]
    worst = max(int(d.max()) for d in diffs)
    n_diff = sum(int(np.count_nonzero(d)) for d in diffs)
    n_px = sum(d.size for d in diffs)
    return worst <= 1, (f"{n_diff} of {n_px} samples differ, max |diff| "
                        f"{worst} LSB (limit 1)")


def flips(got, want, limit: float, noise: float = 1e-5):
    a, b = np.asarray(got.planes[0]), np.asarray(want.planes[0])
    d = np.abs(a - b)
    share = float(np.mean(d > noise))
    ok = (a.shape == b.shape and bool(np.all(np.isfinite(a)))
          and share <= limit)
    return ok, (f"{share:.4%} of pixels flipped (differ by > {noise:g}; "
                f"limit {limit:.0%}), {float(np.mean(d > 0)):.4%} differ at "
                f"all, max |diff| {float(d.max()):.3g}")


def prop_rel(got, want, keys, limit: float):
    worst = 0.0
    for k in keys:
        a = np.asarray(got.props[k], np.float64)
        b = np.asarray(want.props[k], np.float64)
        if a.shape != b.shape or not np.all(np.isfinite(a)):
            return False, f"{k}: shape {a.shape} vs {b.shape} or not finite"
        worst = max(worst, float(np.max(np.abs(a - b) / np.abs(b))))
    return worst <= limit, (f"max rel diff of {'/'.join(keys)} {worst:.3g} "
                            f"(limit {limit:g})")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def boxblur_r13(vz, c):
    return vz.boxblur(c, hradius=13, vradius=13)


def main_path(vz, dev, n_frames=256, batch=64, w=1920, h=1080, mesh=None,
              keep_all=False):
    """Stream BoxBlur r13 over `n_frames` of YUV420P16 host to host.
    Returns (first chunk, last chunk, all frames or None, seconds,
    source)."""
    import jax

    fmt = vz.get_format("YUV420P16")
    rng = np.random.default_rng(0)
    tmpl = make_clip(vz, rng, "YUV420P16", 16, w, h)
    period = tmpl.num_frames

    def frames(start, stop):
        idx = np.arange(start, stop)
        bump = ((idx // period) * 4099 % 65536).astype(np.uint16)
        return tuple(p[idx % period] + bump[:, None, None]
                     for p in tmpl.planes)

    source = vz.SyntheticSource(frames, fmt, n_frames)
    last_start = (n_frames - 1) // batch * batch
    got = {}
    store = ([np.empty((n_frames,) + p.shape[1:], p.dtype)
              for p in tmpl.planes] if keep_all else None)

    def sink(start, chunk):
        if start == 0:
            got["first"] = chunk
        if start == last_start:
            got["last"] = chunk
        got["frames"] = got.get("frames", 0) + chunk.num_frames
        if store is not None:
            for s, p in zip(store, chunk.planes):
                s[start:start + p.shape[0]] = p

    with jax.default_device(dev):
        t0 = time.perf_counter()
        vz.process_stream(source, lambda c: boxblur_r13(vz, c),
                          batch=batch, sink=sink, mesh=mesh)
        secs = time.perf_counter() - t0
    if got.get("frames") != n_frames:
        raise PhaseFailed(f"sink saw {got.get('frames')} of {n_frames} "
                          "frames")
    return got["first"], got["last"], store, secs, (frames, fmt, last_start)


def phase_main(vz, dev, cpu, report, n=256, batch=64, w=1920, h=1080):
    from oracle.boxblur_ref import boxblur_ref

    first_c, last_c, _, secs, (frames, fmt, last_start) = main_path(
        vz, dev, n, batch, w, h)
    frame_mb = sum(p[0].nbytes for p in first_c.planes) / 1e6
    report.info(f"streamed {n} frames of {w}x{h} YUV420P16 "
                f"({frame_mb:.2f} MB/frame) host to host in {secs:.3f} s "
                f"(first call, compile included): {n / secs:.2f} fps")
    oks = []
    for name, start, chunk in (("first", 0, first_c),
                               ("last", last_start, last_c)):
        src = vz.Clip.from_planes(frames(start, min(n, start + batch)), fmt)
        want = on(cpu, lambda c: boxblur_r13(vz, c), src)
        ok, text = exact(chunk, want)
        oks.append(ok)
        report.info(f"{name} chunk vs CPU backend: {text}")
    src0 = np.asarray(frames(0, 1)[0][0])
    ref = boxblur_ref(src0, hradius=13, vradius=13)
    n_diff = int(np.count_nonzero(np.asarray(first_c.planes[0][0]) != ref))
    oks.append(n_diff == 0)
    report.info(f"luma frame 0 vs literal oracle: {n_diff} of {ref.size} "
                "samples differ")
    report.info("64-bit values in the BoxBlur r13 program: "
                + i64_values(vz, dev, vz.Clip.from_planes(
                    frames(0, batch), fmt)))
    return all(oks), "streamed BoxBlur r13 bit-exact vs CPU and oracle"


def i64_values(vz, dev, clip) -> str:
    """The shapes of the 64-bit tensors in the lowered BoxBlur r13 step."""
    import re

    import jax

    txt = jax.jit(lambda c: boxblur_r13(vz, c)).lower(put(clip, dev)).as_text()
    shapes = sorted(set(re.findall(r"tensor<([0-9x]*)xi64>", txt)))
    return ", ".join(s or "scalar" for s in shapes) or "none"


class Phase(NamedTuple):
    """One op at bench.py's shape.  `paired`: the clip holds a reference
    and a distorted half (metrics).  `rerun`: the op's output depends on
    the clip length, so the 2-frame check runs the op on 2 frames on the
    device too instead of slicing the timed output."""
    name: str
    make: Callable
    op: Callable
    compare: Callable
    paired: bool = False
    rerun: bool = False


def op_phases(vz, w=1920, h=1080, frames=None):
    """A Phase for every op bench.py times, at its shapes.  `frames`
    replaces every phase's frame count (for a small rehearsal)."""
    rng = np.random.default_rng(1)

    def clip(fmt_name, n, height=h):
        return make_clip(vz, rng, fmt_name, frames or n, w, height)

    def y16(n):
        return clip("YUV420P16", n)

    def pair(fmt_name, n, noise):
        a = clip(fmt_name, n)
        fmt = a.format
        if fmt.sample_type.name == "INTEGER":
            peak = (1 << fmt.bits_per_sample) - 1
            b = tuple(np.clip(p.astype(np.int32) + rng.integers(
                -noise, noise + 1, p.shape), 0, peak).astype(p.dtype)
                for p in a.planes)
        else:
            b = tuple(np.clip(p + np.float32(0.01), 0, 1) for p in a.planes)
        return vz.Clip.from_planes(tuple(np.concatenate([x, y]) for x, y in
                                         zip(a.planes, b)), fmt)

    def halves(c):
        n = c.num_frames // 2
        return (vz_clip(c, tuple(p[:n] for p in c.planes)),
                vz_clip(c, tuple(p[n:] for p in c.planes)))

    def xpsnr(c):
        a, b = halves(c)
        return vz.xpsnr(a, b, fps=24)

    def ssim2(c):
        a, b = halves(c)
        return vz.ssimulacra2(a, b)

    xp_keys = ("XPSNR_Y", "XPSNR_U", "XPSNR_V")
    # Deband's RNG is seeded with the clip length (rerun=True).
    return [
        Phase("boxblur_5pass_1080p_yuv420p16", lambda: y16(64),
              lambda c: vz.boxblur(c, hradius=13, hpasses=5, vradius=13,
                                   vpasses=5), exact),
        Phase("bilateral_s2r2_1080p_yuv420p16", lambda: y16(64),
              lambda c: vz.bilateral(c, sigmaS=2.0, sigmaR=2.0,
                                     planes=[0, 1, 2]), within_one),
        Phase("deband_m1_1080p_yuv420p16", lambda: y16(64),
              lambda c: vz.deband(c, sample_mode=1), exact, rerun=True),
        Phase("deband_m2_1080p_yuv420p16", lambda: y16(64),
              lambda c: vz.deband(c), exact, rerun=True),
        Phase("deband_m2_1080p_yuv420p10", lambda: clip("YUV420P10", 16),
              lambda c: vz.deband(c), exact, rerun=True),
        Phase("clahe_8bit_1080p", lambda: clip("GRAY8", 64),
              lambda c: vz.clahe(c), exact),
        Phase("eedi3_dh_540to1080_w1920", lambda: clip("GRAYS", 8, h // 2),
              lambda c: vz.eedi3(c, field=1, dh=True),
              lambda a, b: flips(a, b, 0.05)),
        Phase("eedi3_dh_hp_540to1080_w1920",
              lambda: clip("GRAYS", 8, h // 2),
              lambda c: vz.eedi3(c, field=1, dh=True, hp=True),
              lambda a, b: flips(a, b, 0.05)),
        Phase("xpsnr_1080p_yuv420p10", lambda: pair("YUV420P10", 32, 8),
              xpsnr, lambda a, b: prop_rel(a, b, xp_keys, 1e-6),
              paired=True),
        Phase("ssimulacra2_1080p_rgbs", lambda: pair("RGBS", 8, 0), ssim2,
              lambda a, b: prop_rel(a, b, ("SSIMULACRA2",), 1e-3),
              paired=True),
    ]


def leading(c, n: int, paired: bool):
    """The first n frames of a clip, or of each half of a paired clip."""
    if not paired:
        return vz_clip(c, tuple(np.asarray(p)[:n] for p in c.planes))
    half = c.num_frames // 2
    return vz_clip(c, tuple(np.concatenate([np.asarray(p)[:n],
                                            np.asarray(p)[half:half + n]])
                            for p in c.planes))


def slice_out(out, n: int):
    """The first n frames of an op's output, props included."""
    planes = tuple(p[:n] for p in out.planes)
    props = {k: (v[:n] if getattr(v, "ndim", 0) >= 1
                 and v.shape[0] == out.planes[0].shape[0] else v)
             for k, v in out.props.items()}
    return type(out)(planes, out.format, props)


def eedi3_scan_share(dev, hp: bool, op_secs: float, shape) -> str:
    """Device time of the Viterbi DP (forward scan + backtrack scan) alone
    at the phase's (frames, lines, width), beside the whole op's."""
    import jax
    import jax.numpy as jnp

    from vszip_tpu.ops.eedi3 import _dp

    tpitch = 4 * 20 + 1 if hp else 2 * 20 + 1
    gamma = float(np.float32(20.0 / 255.0))
    with jax.default_device(dev):
        tc = jax.random.uniform(jax.random.key(0), (tpitch,) + shape,
                                jnp.float32)
        dp = jax.jit(lambda t: _dp(t, None, gamma, hp))
        secs, _ = timed(dp, tc)
    return (f"DP scans {secs * 1e3:.2f} ms of the op's {op_secs * 1e3:.2f} "
            f"ms ({secs / op_secs:.1%})")


def run_op_phase(vz, dev, cpu, report, phase: Phase):
    import jax

    name = phase.name
    clip = phase.make()
    n_frames = clip.num_frames // (2 if phase.paired else 1)
    secs, out = timed(phase.op, put(clip, dev))
    small = leading(clip, 2, phase.paired)
    want = on(cpu, phase.op, small)
    got = on(dev, phase.op, small) if phase.rerun else slice_out(out, 2)
    ok, text = phase.compare(jax.device_get(got), jax.device_get(want))
    report.info(f"{name}: {text}")
    report.timing(name, secs, n_frames)
    if name.startswith("eedi3"):
        shape = (clip.num_frames, clip.height, clip.width)
        report.info(f"{name}: " + eedi3_scan_share(dev, "hp" in name, secs,
                                                   shape))
    return ok, text


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_four_cards(vz, devs, report, n_frames=256, batch=64, w=1920,
                     h=1080, xp_w=1920, xp_h=1080):
    """The frames-mesh path: streamed BoxBlur r13 and streamed XPSNR
    (overlap 2) over four devices, each compared bit-exactly with the same
    stream on one device."""
    from vszip_tpu.parallel import frames_mesh

    mesh = frames_mesh(4, devices=devs[:4])
    oks = []
    _, _, one, t1, _ = main_path(vz, devs[0], n_frames, batch, w, h,
                                 keep_all=True)
    _, _, four, t4, _ = main_path(vz, devs[0], n_frames, batch, w, h,
                                  mesh=mesh, keep_all=True)
    n_diff = sum(int(np.count_nonzero(a != b)) for a, b in zip(one, four))
    oks.append(n_diff == 0)
    report.info(f"streamed BoxBlur r13, {n_frames} frames {w}x{h} "
                f"YUV420P16: four devices vs one: {n_diff} samples differ "
                f"(first calls, compile included: one {t1:.3f} s, four "
                f"{t4:.3f} s)")

    rng = np.random.default_rng(2)
    ref = make_clip(vz, rng, "YUV420P10", XPSNR_FRAMES, xp_w, xp_h)
    dist = tuple(np.clip(p.astype(np.int32) + rng.integers(-8, 9, p.shape),
                         0, 1023).astype(np.uint16) for p in ref.planes)
    both = vz.ArraySource(tuple(np.concatenate([a, b], axis=2)
                                for a, b in zip(ref.planes, dist)),
                          ref.format)
    ncol = [p.shape[2] for p in ref.planes]

    def xp(c):
        a = vz_clip(c, tuple(p[:, :, :k] for p, k in zip(c.planes, ncol)))
        b = vz_clip(c, tuple(p[:, :, k:] for p, k in zip(c.planes, ncol)))
        return vz.xpsnr(a, b, fps=24)

    import jax

    with jax.default_device(devs[0]):
        p1 = vz.process_stream(both, xp, batch=XPSNR_BATCH,
                               overlap=XPSNR_OVERLAP)
        p4 = vz.process_stream(both, xp, batch=XPSNR_BATCH,
                               overlap=XPSNR_OVERLAP, mesh=mesh)
    keys = ("XPSNR_Y", "XPSNR_U", "XPSNR_V", "XPSNR_AVG")
    same = all(np.array_equal(np.asarray(p1[k]), np.asarray(p4[k]))
               for k in keys)
    oks.append(same)
    report.info(f"streamed XPSNR overlap={XPSNR_OVERLAP}, {XPSNR_FRAMES} "
                f"frames {xp_w}x{xp_h} YUV420P10: four devices vs one: "
                f"{'identical' if same else 'DIFFERENT'} XPSNR_AVG "
                f"{np.asarray(p4['XPSNR_AVG']).tolist()} and per-frame props")
    return all(oks), "four-device streams bit-exact vs one device"


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

class Report:
    def __init__(self, card: str):
        self.card = card.replace("\n", "; ")
        self.failed = []

    def info(self, text: str):
        print(text, flush=True)

    def timing(self, name: str, secs: float, frames: int):
        print(f"{name}: time {secs * 1e3:.3f} ms per call of {frames} "
              f"frames ({frames / secs:.2f} fps), median of 5 after "
              f"warm-up | {self.card}", flush=True)

    def phase(self, name: str, body):
        t0 = time.perf_counter()
        try:
            ok, text = body()
        except Exception:  # noqa: BLE001 - reported, then fails the run
            traceback.print_exc()
            ok, text = False, "raised"
        status = "PASS" if ok else "FAIL"
        print(f"[{status}] {name}: {text} ({time.perf_counter() - t0:.1f} s "
              "wall)", flush=True)
        if not ok:
            self.failed.append(name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the frames-mesh path over four GPUs")
    args = ap.parse_args(argv)
    # the CPU comparisons need the CPU backend beside the GPU one
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    try:
        vz = _import_library()
    except ImportError as e:
        print(f"chip_smoke: the vszip_tpu checkout is not beside this "
              f"script ({e})", file=sys.stderr)
        return 1
    from vszip_tpu.runtime.compile_cache import enable_compile_cache

    cache = enable_compile_cache(ROOT)
    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform} "
              f"({dev.device_kind})", file=sys.stderr)
        return 1
    need = 4 if args.four_cards else 1
    if len(devs) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 1
    card = card_info()
    print(f"device: {dev.platform} {dev.device_kind} x{len(devs)}; "
          f"compile cache {cache}", flush=True)
    print(card, flush=True)
    report = Report(card)

    if args.four_cards:
        report.phase("four_cards", lambda: phase_four_cards(vz, devs,
                                                            report))
    else:
        cpu = jax.devices("cpu")[0]
        report.phase("main_path_streamed_boxblur_r13",
                     lambda: phase_main(vz, dev, cpu, report))
        for phase in op_phases(vz):
            report.phase(phase.name, lambda: run_op_phase(
                vz, dev, cpu, report, phase))

    ok = not report.failed
    if not ok:
        print(f"failed phases: {', '.join(report.failed)}", flush=True)
    print(json.dumps({"ok": ok, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
