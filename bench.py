#!/usr/bin/env python
"""Benchmark harness: the reference README's headline workloads on one GPU.

Reference baselines (reference README.md:31-50, the only published numbers,
desktop CPU): BoxBlur r13 1-pass 1046.11 fps, BoxBlur r13 5-pass 367.01 fps,
Bilateral s2/r2 141.36 fps — 1920x1080 YUV420P16.

Prints one JSON line per headline metric, each naming the device it ran on.
``*_streamed`` runs the same workload through the chunked double-buffered
streaming runtime (vszip_tpu/runtime/stream.py).  Refuses to run without a
GPU: a CPU number is not a device metric.  Correctness on the GPU is
chip_smoke.py's job.

    python bench.py
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

BASELINES = {  # reference README.md:31-50
    "boxblur_r13_1080p_yuv420p16_fps": 1046.11,
    "boxblur_r13_5pass_1080p_yuv420p16_fps": 367.01,
    "bilateral_s2r2_1080p_yuv420p16_fps": 141.36,
}


def _mk(vz, rng, fmtname, batch, h=1080, w=1920):
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
    return vz.Clip.from_planes(tuple(planes), fmt).device()


def main():
    from vszip_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache(ROOT)
    import jax
    import vszip_tpu as vz

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    rng = np.random.default_rng(0)
    batch = 64
    lines = []

    def bench(metric, step, clip, iters, b, chain=True):
        """fps over a chained-dispatch loop ended by block_until_ready."""
        jstep = jax.jit(step)
        # compile + warm both the input and the chained signature
        out = jax.block_until_ready(jstep(clip))
        jax.block_until_ready(jstep(out if chain else clip))
        t0 = time.perf_counter()
        out = clip
        for _ in range(iters):
            out = jstep(out if chain else clip)
        jax.block_until_ready(out)
        fps = b * iters / (time.perf_counter() - t0)
        base = BASELINES.get(metric)
        lines.append({
            "metric": metric, "value": round(fps, 2), "unit": "frames/sec",
            "vs_baseline": round(fps / base, 3) if base else None,
            "device": device,
        })
        return fps

    y16 = _mk(vz, rng, "YUV420P16", batch)
    bench("boxblur_r13_1080p_yuv420p16_fps",
          lambda c: vz.boxblur(c, hradius=13, vradius=13), y16, 150, batch)
    bench("boxblur_r13_5pass_1080p_yuv420p16_fps",
          lambda c: vz.boxblur(c, hradius=13, hpasses=5, vradius=13,
                               vpasses=5), y16, 40, batch)
    bench("bilateral_s2r2_1080p_yuv420p16_fps",
          lambda c: vz.bilateral(c, sigmaS=2.0, sigmaR=2.0,
                                 planes=[0, 1, 2]), y16, 25, batch)
    # Deband output differs per grain stream; chain=False replays the input.
    bench("deband_m1_1080p_yuv420p16_fps",
          lambda c: vz.deband(c, sample_mode=1), y16, 15, batch, chain=False)
    bench("deband_m2_1080p_yuv420p16_fps",
          lambda c: vz.deband(c), y16, 8, batch, chain=False)

    g8 = _mk(vz, rng, "GRAY8", batch)
    bench("clahe_8bit_1080p_fps", lambda c: vz.clahe(c), g8, 25, batch)

    e_in = vz.Clip.from_planes(
        (rng.random((8, 540, 1920), dtype=np.float32),),
        vz.get_format("GRAYS")).device()
    bench("eedi3_dh_540to1080_w1920_fps",
          lambda c: vz.eedi3(c, field=1, dh=True), e_in, 8, 8, chain=False)

    # metrics: the HEADLINE value is the MEDIAN of repeated timed loops;
    # best-of-N is kept as a secondary field, with the observed spread.
    def bench_metric(metric, fn, iters, b, repeats=5):
        jax.block_until_ready(fn())
        dts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn()
            jax.block_until_ready(out)
            dts.append((time.perf_counter() - t0) / iters)
        med = sorted(dts)[len(dts) // 2]
        lines.append({"metric": metric, "value": round(b / med, 2),
                      "unit": "frames/sec", "vs_baseline": None,
                      "best_fps": round(b / min(dts), 2),
                      "spread_fps": [round(b / max(dts), 2),
                                     round(b / min(dts), 2)],
                      "note": f"median of {repeats} loops of {iters}",
                      "device": device})

    c1 = _mk(vz, rng, "YUV420P10", 32)
    c2 = vz.Clip.from_planes(
        tuple(np.clip(np.asarray(a).astype(np.int32)
                      + rng.integers(-8, 8, a.shape), 0, 1023).astype(np.uint16)
              for a in c1.planes), vz.get_format("YUV420P10")).device()
    bench_metric("xpsnr_1080p_yuv420p10_fps",
                 lambda: vz.xpsnr(c1, c2, fps=24), 8, 32)

    r1 = vz.Clip.from_planes(
        tuple(rng.random((8, 1080, 1920), dtype=np.float32) for _ in range(3)),
        vz.get_format("RGBS")).device()
    r2 = vz.Clip.from_planes(
        tuple(np.clip(np.asarray(p) + 0.01, 0, 1) for p in r1.planes),
        vz.get_format("RGBS")).device()
    bench_metric("ssimulacra2_1080p_rgbs_fps",
                 lambda: vz.ssimulacra2(r1, r2), 4, 8)

    # streamed: the README's workload shape through the double-buffered
    # streaming runtime (vszip_tpu/runtime/stream.py); no sink, so this
    # times upload plus compute only.
    n_stream = 192
    template = tuple(np.asarray(p) for p in y16.planes)

    def make(start, stop):
        n = stop - start
        return tuple(p[:n] for p in template)

    source = vz.SyntheticSource(make, vz.get_format("YUV420P16"), n_stream)
    vz.process_stream(source, lambda c: vz.boxblur(c, hradius=13,
                                                   vradius=13), batch=batch)
    t0 = time.perf_counter()
    vz.process_stream(source,
                      lambda c: vz.boxblur(c, hradius=13, vradius=13),
                      batch=batch)
    dt = time.perf_counter() - t0
    fps = n_stream / dt
    frame_mb = sum(p[0].nbytes for p in template) / 1e6
    lines.append({"metric": "boxblur_r13_streamed_fps",
                  "value": round(fps, 2), "unit": "frames/sec",
                  "vs_baseline": round(fps / 1046.11, 3),
                  "note": f"{n_stream} frames, {frame_mb:.2f} MB/frame, "
                          "host to device only (no sink)",
                  "device": device})

    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
