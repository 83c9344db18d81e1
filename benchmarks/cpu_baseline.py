#!/usr/bin/env python
"""Same-formulation CPU baselines.

Runs the identical vszip_tpu library calls on the XLA-CPU backend — the
same algorithm, the same monomorphized graphs — and prints fps per
workload.  This is not the reference's hand-SIMD Zig build (only its three
README workloads have published numbers), but the same formulation XLA can
compile for a CPU, which is the like-for-like ratio a GPU claim can be
checked against.  Run on an idle machine:

    JAX_PLATFORMS=cpu python benchmarks/cpu_baseline.py [filter ...]

Prints one JSON line per workload: {"metric", "cpu_fps_per_core",
"frames", "seconds"}.  Keep iteration counts tiny — EEDI3 at 1080p runs
seconds per frame on a core.
"""

import json
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = __file__.rsplit("/", 2)[0]
sys.path.insert(0, ROOT)

import vszip_tpu as vz  # noqa: E402


def mk(fmtname, batch, h=1080, w=1920, seed=0):
    rng = np.random.default_rng(seed)
    fmt = vz.get_format(fmtname)
    bits = fmt.bits_per_sample
    planes = []
    for p in range(fmt.num_planes):
        ph = h >> (fmt.subsampling_h if p else 0)
        pw = w >> (fmt.subsampling_w if p else 0)
        if fmt.sample_type.name == "INTEGER":
            dt = np.uint8 if bits <= 8 else np.uint16
            planes.append(rng.integers(0, 1 << bits, (batch, ph, pw), dtype=dt))
        else:
            planes.append(rng.random((batch, ph, pw), dtype=np.float32))
    return vz.Clip.from_planes(tuple(planes), fmt)


def measure(name, fn, clip, frames, min_iters=2):
    out = fn(clip)
    jax.block_until_ready([np.asarray(out.planes[0][0, 0, :1])])  # compile
    t0 = time.perf_counter()
    iters = 0
    while iters < min_iters or time.perf_counter() - t0 < 1.0:
        out = fn(clip)
        np.asarray(out.planes[0][0, 0, :1])
        iters += 1
    dt = time.perf_counter() - t0
    fps = frames * iters / dt
    print(json.dumps({"metric": name, "cpu_fps_per_core": round(fps, 2),
                      "frames": frames * iters, "seconds": round(dt, 2)}),
          flush=True)


def measure_metric(name, fn, read, frames, min_iters=2):
    np.asarray(read(fn()))
    t0 = time.perf_counter()
    iters = 0
    while iters < min_iters or time.perf_counter() - t0 < 1.0:
        np.asarray(read(fn()))
        iters += 1
    dt = time.perf_counter() - t0
    fps = frames * iters / dt
    print(json.dumps({"metric": name, "cpu_fps_per_core": round(fps, 2),
                      "frames": frames * iters, "seconds": round(dt, 2)}),
          flush=True)


def main():
    only = set(sys.argv[1:])

    def want(k):
        return not only or any(k.startswith(o) for o in only)

    y16 = mk("YUV420P16", 4)
    g8 = mk("GRAY8", 4)
    g16 = mk("GRAY16", 4)

    if want("boxblur"):
        measure("boxblur_r13", lambda c: vz.boxblur(c, hradius=13,
                                                    vradius=13), y16, 4)
    if want("bilateral"):
        measure("bilateral_s2r2", lambda c: vz.bilateral(
            c, sigmaS=2.0, sigmaR=2.0, planes=[0, 1, 2]), y16, 4)
    if want("clahe"):
        measure("clahe_8bit", lambda c: vz.clahe(c), g8, 4)
    if want("compress"):
        measure("compress", lambda c: vz.compress(mk("YUV420P8", 4)), y16, 4)
    if want("mosquito"):
        measure("mosquito_nr", lambda c: vz.mosquito_nr(g16), y16, 4)
    if want("deband"):
        for m in (1, 2, 4, 6, 7):
            measure(f"deband_m{m}", lambda c, m=m: vz.deband(
                c, sample_mode=m), y16, 4)
    if want("eedi3"):
        e_in = vz.Clip.from_planes(
            (np.random.default_rng(1).random((1, 540, 1920),
                                             dtype=np.float32),),
            vz.get_format("GRAYS"))
        measure("eedi3_dh", lambda c: vz.eedi3(c, field=1, dh=True),
                e_in, 1)
        measure("eedi3_hp", lambda c: vz.eedi3(c, field=1, dh=True,
                                               hp=True), e_in, 1)
        measure("eedi3_vcheck", lambda c: vz.eedi3(c, field=1, dh=True,
                                                   vcheck=2), e_in, 1)
        measure("eedi3h_dh", lambda c: vz.eedi3h(c, field=1, dh=True),
                e_in, 1)
    if want("xpsnr"):
        c1 = mk("YUV420P10", 4)
        c2 = mk("YUV420P10", 4, seed=9)
        measure_metric("xpsnr", lambda: vz.xpsnr(c1, c2, fps=24),
                       lambda o: o.props["XPSNR_Y"], 4)
    if want("ssimulacra2"):
        r1 = mk("RGBS", 2)
        r2 = vz.Clip.from_planes(
            tuple(np.clip(np.asarray(p) + 0.01, 0, 1) for p in r1.planes),
            vz.get_format("RGBS"))
        measure_metric("ssimulacra2", lambda: vz.ssimulacra2(r1, r2),
                       lambda o: o.props["SSIMULACRA2"], 2)
    if want("bdither"):
        measure("bdither_dense_r16", lambda c: vz.bilateral_dither(
            mk("GRAY16", 1), radius=16), g16, 1, min_iters=1)


if __name__ == "__main__":
    main()
