"""Test configuration: run on a virtual 8-device CPU mesh unless
``JAX_PLATFORMS`` names another platform.

Multi-device sharding logic is tested without several cards the standard
way: force the host platform and split it into 8 virtual devices.  Tests
that need a GPU are marked ``gpu`` and take the ``gpu`` fixture, which
skips them when JAX finds no GPU; run them on the card with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu -n 0 tests/

(the CPU backend stays on beside the card for the GPU-vs-CPU references).
"""
import os

_platforms = os.environ.get("JAX_PLATFORMS", "")
CPU_PINNED = _platforms in ("", "cpu")
if CPU_PINNED:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if CPU_PINNED:
    jax.config.update("jax_platforms", "cpu")
# Persistent compile cache: the suite's CPU compiles dominate its runtime;
# caching them makes re-runs far cheaper (keyed on HLO hash, so code
# changes invalidate safely).  REVO_NO_COMPILE_CACHE=1 disables it (cache
# on/off is the first bisection step for interpreter-level crashes).
if not os.environ.get("REVO_NO_COMPILE_CACHE"):
    from revo_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first GPU; skips the test when JAX finds none (decided here, at
    run time, never at import or collection)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            f"needs a GPU (JAX platform is {dev.platform!r}); run with "
            "JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu -n 0 tests/"
        )
    return dev


@pytest.fixture
def cpu():
    """The CPU backend's device, for references beside a GPU run; skips
    when JAX_PLATFORMS leaves the CPU out (use JAX_PLATFORMS=cuda,cpu)."""
    try:
        return jax.devices("cpu")[0]
    except RuntimeError:
        pytest.skip("the CPU backend is off; run with JAX_PLATFORMS=cuda,cpu")


@pytest.fixture(autouse=True, scope="module")
def _bound_inprocess_jax_state():
    """Clear jit/executable caches after each test module.

    The full suite deterministically segfaulted ~130 tests in (inside an
    XLA:CPU execution; same spot with the persistent cache disabled and
    with an exclusive machine, while the crashing test passes in
    isolation) — in-process executable accumulation is the trigger.
    Clearing per module bounds it; the persistent on-disk cache keeps the
    re-compiles cheap."""
    yield
    jax.clear_caches()
