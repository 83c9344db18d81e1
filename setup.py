"""Build hook: precompile the native runtime libraries into the wheel.

The reference ships per-ISA prebuilt shared libraries in its wheels
(reference hatch_build.py:99-125 cross-compiles the Zig plugin per target
and packs a manifest for load-time selection).  This rebuild's native
surface is much smaller — three host-side helper libraries (Deband RNG
precompute, Deband's error-diffusion demote, PNG scanline unfilter) that
are sequential/byte-oriented and therefore live in C++ rather than JAX —
but the packaging story is the same: wheels built here include the
compiled ``.so`` next to the sources, and ``runtime/deband_rng.py`` /
``runtime/dither.py`` / ``runtime/png_native.py`` use the prebuilt copy
without needing a compiler at import time.  Source installs on a
machine with ``g++`` still work via the lazy first-use build; without any
compiler, PNG decode falls back to pure Python and Deband raises a clear
error (the RNG parity contract cannot be met in pure Python at usable
speed).
"""

import subprocess
from pathlib import Path

from setuptools import setup
from setuptools.command.build_py import build_py


NATIVE = Path(__file__).parent / "vszip_tpu" / "runtime" / "native"
LIBS = {
    "deband_rng.cpp": "libvszip_deband_rng.so",
    "dither.cpp": "libvszip_dither.so",
    "png_unfilter.cpp": "libvszip_png_unfilter.so",
}


class BuildPyWithNative(build_py):
    def run(self):
        for src, lib in LIBS.items():
            src_p, lib_p = NATIVE / src, NATIVE / lib
            if lib_p.is_file() and lib_p.stat().st_mtime >= src_p.stat().st_mtime:
                continue
            try:
                subprocess.run(
                    ["g++", "-O2", "-fPIC", "-shared", "-o", str(lib_p),
                     str(src_p)],
                    check=True,
                )
            except (FileNotFoundError, subprocess.CalledProcessError) as e:
                # Source-only wheel: importers rebuild lazily or fall back.
                print(f"vszip-tpu: skipping native prebuild of {lib}: {e}")
        super().run()


setup(cmdclass={"build_py": BuildPyWithNative})
