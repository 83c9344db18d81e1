"""Test configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding
(vszip_tpu.parallel) is exercised without a GPU; chip_smoke.py and
bench.py run the same ops on the GPU.  Must set flags before JAX
initializes.
"""

import os
import sys
from pathlib import Path

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Force the platform through jax.config as well as the environment, before
# any backend initializes, so the suite runs on the 8-device CPU mesh even
# on a machine whose JAX has a GPU plugin.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


def pytest_sessionstart(session):
    n = len(jax.devices())
    if n < 8 or jax.devices()[0].platform != "cpu":
        raise RuntimeError(
            f"test suite requires the 8-virtual-device CPU mesh, got "
            f"{n} {jax.devices()[0].platform} device(s); check XLA_FLAGS "
            f"and jax_platforms forcing in conftest.py"
        )

sys.path.insert(0, str(Path(__file__).resolve().parent))

from golden import GoldenStore  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--update-goldens",
        action="store_true",
        default=False,
        help="regenerate tests/goldens/*.json from the current build",
    )


def pytest_configure(config):
    config._golden_store = GoldenStore(config.getoption("--update-goldens"))


def pytest_sessionfinish(session, exitstatus):
    store = getattr(session.config, "_golden_store", None)
    if store is not None:
        store.save()


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    store = getattr(config, "_golden_store", None)
    if store is not None and (store.ref_checked or store.self_checked):
        terminalreporter.write_line(
            f"goldens: {store.ref_checked} REFERENCE-pinned comparisons, "
            f"{store.self_checked} self-pinned"
        )


@pytest.fixture(scope="session")
def golden(request):
    return request.config._golden_store


def _clip_factory(base, filt: str = "bilinear"):
    """Factory over one RGB24 source: any format/geometry, cached."""
    from fixtures import convert, geometry_variant

    cache = {}

    def make(fmt_name: str, geometry: str = "full"):
        key = (fmt_name, geometry)
        if key not in cache:
            cache[key] = geometry_variant(convert(base, fmt_name, filt),
                                          geometry)
        return cache[key]

    return make


@pytest.fixture(scope="session")
def src_rgb():
    """Single-frame 640x320 RGB24 crop of the reference photo."""
    from fixtures import source_rgb24

    return source_rgb24()


@pytest.fixture(scope="session")
def make_clip(src_rgb):
    """Factory: the source image in any format/geometry, cached per session."""
    return _clip_factory(src_rgb)


@pytest.fixture(scope="session")
def make_temporal_clip():
    """Factory: 3-frame vertically-shifted clip for temporal filters.
    Converted with Point resize like the reference (tests/conftest.py:161):
    Point preserves the dot-crawl-like detail temporal filters react to."""
    from fixtures import temporal_rgb24

    return _clip_factory(temporal_rgb24(), "point")


@pytest.fixture(scope="session")
def make_seeded_clip():
    """`make_clip` over the seeded procedural image (no photo needed)."""
    from fixtures import seeded_rgb24

    return _clip_factory(seeded_rgb24())


@pytest.fixture(scope="session")
def make_seeded_temporal_clip():
    """`make_temporal_clip` over the seeded procedural image."""
    from fixtures import seeded_temporal_rgb24

    return _clip_factory(seeded_temporal_rgb24(), "point")
