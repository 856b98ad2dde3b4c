"""Test harness: the CPU backend with 8 virtual devices, so the sharding paths
run without a multi-card machine (``JAX_PLATFORMS=cpu`` unless the caller
sets another platform).

Tests marked ``gpu`` need a card: the ``gpu`` fixture skips them elsewhere,
deciding at run time. ``python chip_smoke.py`` runs them on the GPU.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

from burn_raymarching.utils.compile_cache import (  # noqa: E402
    configure_compile_cache,
)

configure_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

REFERENCE = "/root/reference"


@pytest.fixture(scope="session")
def reference_dir():
    """The Rust reference checkout, for the tests that compare against its
    own rendered PNGs and files."""
    if not os.path.isdir(REFERENCE):
        pytest.skip("reference repo not mounted")
    return REFERENCE


@pytest.fixture(scope="session")
def scene_root(tmp_path_factory):
    """A directory laid out like the reference checkout's data: the bundled
    10-view 256x256 dango scene at ``data/`` (cameras.json with relative
    ``data/target_i.png`` paths), rendered by tools/generate.py — whose rig
    equals the reference's cameras.json (tests/test_tools.py)."""
    from burn_raymarching.tools import generate

    root = tmp_path_factory.mktemp("scene_root")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        generate.main(["--out", "data"])
    finally:
        os.chdir(cwd)
    return str(root)


@pytest.fixture
def gpu():
    """Skips unless JAX runs on a GPU (decided at run time, per test)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
