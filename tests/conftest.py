"""Test harness: run everything on a virtual 8-device CPU mesh, so the
sharding paths are exercised without accelerators and the suite's results
do not depend on which accelerator the machine has. The platform is set in
the JAX config, which wins over any default chosen elsewhere. Tests that
can only run on a GPU carry the `gpu` marker and skip on the CPU; to run
them on a card, ask for it explicitly: `JAX_PLATFORMS=cuda pytest -m gpu`.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

_requested = os.environ.get("JAX_PLATFORMS", "")
jax.config.update("jax_platforms", _requested if "cuda" in _requested else "cpu")

import pytest  # noqa: E402

# Persistent compilation cache: the suite is compile-dominated (XLA:CPU
# builds of the backend/registration programs take minutes); warm-cache
# reruns skip all of it. Keyed by HLO hash, so stale entries are inert.
from rolo_tpu.runtime.platform import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none (decided
    here, at run time, never while test modules are imported)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda pytest -m gpu on the card")
    return devs[0]
