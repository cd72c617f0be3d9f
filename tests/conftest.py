"""Test configuration: CPU backend with 8 virtual devices by default.

Mirrors the reference's "emulation as the fake backend" test pattern
(reference: OpenCL/Makefile:121-130 — Intel FPGA emulator targets): the
suite runs on the CPU backend with an 8-device virtual mesh so sharding
paths are exercised without a GPU, and the Triton replay kernel runs in
interpret mode. Tests marked ``gpu`` need the card: they skip here and run
on a GPU machine with ``LDPC_TEST_GPU=1 python -m pytest tests/ -m gpu``
(README "Tests"). Must run before the first `import jax`.
"""

import os
import sys

ON_GPU_RUN = os.environ.get("LDPC_TEST_GPU") == "1"
if not ON_GPU_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not ON_GPU_RUN:
    jax.config.update("jax_platforms", "cpu")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

# NO persistent compilation cache for the CPU test backend: XLA:CPU
# executable (de)serialization segfaulted in this suite, both reading
# entries produced on a different-CPU machine and writing large CPU
# executables (utils/cache.py).

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules(request):
    """Free compiled executables after each test module (--slow runs).

    The --slow suite accumulates hundreds of XLA:CPU executables in one
    process; past ~75% of the suite the NEXT big compile segfaults inside
    LLVM (backend_compile_and_load) or fails with 'LLVM compilation
    error: Cannot allocate memory' — with 120+ GB of system RAM free, so
    it is JIT code-memory pressure, not heap. Dropping the jit caches at
    module boundaries keeps the live-executable count bounded; modules
    recompile their own shared fixtures, which the full suite absorbs
    (245 green in 17:12). The fast path never reached the pressure point
    and keeps its caches (clearing cost it ~3 extra minutes).
    """
    yield
    if request.config.getoption("--slow", default=False):
        import jax

        jax.clear_caches()


REFERENCE_DIR = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_DIR)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: research-schedule / multi-process legs excluded from the "
        "default run (enable with --slow or -m slow)",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU; skips elsewhere (use the ``gpu`` fixture)",
    )


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU. Decided when the test
    runs, never at import or collection time."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with LDPC_TEST_GPU=1 -m gpu on the card)")


def pytest_addoption(parser):
    parser.addoption(
        "--slow",
        action="store_true",
        default=False,
        help="also run tests marked slow (the full pre-commit suite)",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--slow") or config.getoption("-m"):
        return
    import pytest

    skip = pytest.mark.skip(reason="slow leg; run with --slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
