"""chip_smoke.py on the CPU: it refuses to run without a GPU or outside a
checkout, the compile-cache helper's choice of directory, and every phase
rehearsed at a tiny size with the CPU standing in for the GPU (the
comparisons then run CPU against CPU; what they check here is the control
flow, shapes and bookkeeping of each phase)."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import vszip_tpu as vz
from vszip_tpu.runtime.compile_cache import (compile_cache_dir,
                                             enable_compile_cache)

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "chip_smoke.py"


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load()


def _run(script, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(res):
    lines = res.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


def test_exits_nonzero_without_gpu(tmp_path):
    res = _run(SCRIPT, tmp_path,
               {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cache")})
    assert res.returncode != 0
    assert _no_result(res)
    assert "needs a GPU" in res.stderr


def test_exits_nonzero_alone(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, lone)
    res = _run(lone, tmp_path)
    assert res.returncode != 0
    assert _no_result(res)
    assert "checkout is not beside this script" in res.stderr


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache_dir("/some/checkout") == str(tmp_path / "c")
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache("/some/checkout") == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache_dir(str(tmp_path)) == str(tmp_path / ".jax_cache")
    assert compile_cache_dir(str(ROOT)) == str(ROOT / ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compile_cache(str(tmp_path)) == str(
            tmp_path / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(
            tmp_path / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_is_ignored_by_git():
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


@pytest.fixture
def report(capsys):
    return smoke.Report("cpu stand-in, 0 W")


def test_main_path_rehearsal(report):
    cpu = jax.devices("cpu")[0]
    ok, _ = smoke.phase_main(vz, cpu, cpu, report, n=10, batch=4, w=64,
                             h=64)
    assert ok


_PHASES = [p.name for p in smoke.op_phases(vz, w=64, h=32, frames=2)]


@pytest.mark.parametrize("name", _PHASES)
def test_op_phase_rehearsal(report, name):
    cpu = jax.devices("cpu")[0]
    (phase,) = [p for p in smoke.op_phases(vz, w=96, h=64, frames=3)
                if p.name == name]
    ok, text = smoke.run_op_phase(vz, cpu, cpu, report, phase)
    assert ok, text


def test_four_card_rehearsal(report, monkeypatch):
    monkeypatch.setattr(smoke, "XPSNR_FRAMES", 12)
    monkeypatch.setattr(smoke, "XPSNR_BATCH", 6)
    ok, text = smoke.phase_four_cards(vz, jax.devices()[:4], report,
                                      n_frames=16, batch=8, w=64, h=64,
                                      xp_w=64, xp_h=32)
    assert ok, text


def test_contract_line(capsys, monkeypatch):
    """With every phase stubbed to pass, the last line is the contract's
    JSON object and the exit code is 0."""
    dev = jax.devices()[0]

    class FakeDev:
        platform = "gpu"
        device_kind = "stand-in"

    monkeypatch.setattr(jax, "devices",
                        lambda *a: [dev] if a else [FakeDev()])
    monkeypatch.setattr(smoke, "card_info", lambda: "stand-in, 700.00 W")
    monkeypatch.setattr(smoke, "phase_main", lambda *a, **k: (True, "ok"))
    monkeypatch.setattr(smoke, "run_op_phase", lambda *a, **k: (True, "ok"))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent-cache")
    assert smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "stand-in", "count": 1}}


def test_failed_phase_fails_the_run(capsys, monkeypatch):
    dev = jax.devices()[0]

    class FakeDev:
        platform = "gpu"
        device_kind = "stand-in"

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(jax, "devices",
                        lambda *a: [dev] if a else [FakeDev()])
    monkeypatch.setattr(smoke, "card_info", lambda: "stand-in, 700.00 W")
    monkeypatch.setattr(smoke, "phase_main", boom)
    monkeypatch.setattr(smoke, "run_op_phase", lambda *a, **k: (True, "ok"))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent-cache")
    assert smoke.main([]) == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert "[FAIL] main_path_streamed_boxblur_r13" in "\n".join(out)
    assert json.loads(out[-1])["ok"] is False
