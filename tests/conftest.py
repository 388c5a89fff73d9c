"""Test configuration.

Default lane: tests run on CPU with 8 virtual XLA devices so distributed
(mesh) paths are exercised without accelerator hardware — the analog of
the reference's ``mpiexec -n 6`` single-machine MPI testing
(``cmake/DLAF_AddTest.cmake``). x64 is enabled so float64/complex128
coverage matches the reference's ``{s,d,c,z}`` dtype matrix.

GPU lane: ``DLAF_JAX_GPU_LANE=1 python -m pytest tests -m gpu`` keeps the
default (GPU) backend and runs the ``gpu``-marked tests in one process on
one card. Whether a card is present is decided per test by the
``_lane_gate`` fixture below.
"""
import os
import resource

# XLA's executable (de)serializer and some big compiled CPU programs
# recurse/allocate deeply; with the default 8 MiB stacks the
# persistent-compile-cache path and long full-suite runs segfault
# (observed in put/get_executable_and_time and _pjit_call_impl_python).
# A FINITE rlimit is deliberate: glibc uses the soft RLIMIT_STACK as the
# default pthread stack size only when it is finite, so this also covers
# XLA's worker threads (RLIM_INFINITY would leave them at the 8 MiB glibc
# default).
try:
    _hard = resource.getrlimit(resource.RLIMIT_STACK)[1]
    _want = 512 << 20
    if _hard != resource.RLIM_INFINITY:
        _want = min(_want, _hard)
    resource.setrlimit(resource.RLIMIT_STACK, (_want, _hard))
except (ValueError, OSError):
    pass

GPU_LANE = os.environ.get("DLAF_JAX_GPU_LANE") == "1"

if not GPU_LANE:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not GPU_LANE:
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)  # both lanes: the reference tests
# {s,d,c,z} on every backend (cmake/DLAF_AddTest.cmake:60-118)

# persistent compile cache (dlaf_jax/cache.py): repeat suite runs skip
# recompilation. The CPU lane uses a MACHINE-KEYED directory: XLA:CPU AOT
# executables are machine-specific (the loader warns "Target machine
# feature ... could lead to execution errors such as SIGILL" when entries
# from another host are loaded). The helper also bounds the cache size,
# which puts JAX's cache behind a file lock (concurrent xdist workers).
from dlaf_jax.cache import configure_compilation_cache  # noqa: E402

configure_compilation_cache(cpu=not GPU_LANE, min_compile_secs=2.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_xdist_auto_num_workers(config):
    """``-n auto`` resolution (see pytest.ini): 2 CPU-lane workers, 0 (no
    xdist) on the GPU lane where a single process must own the card."""
    return 0 if GPU_LANE else 2


# Files whose tests compile the JUMBO eigensolver programs. They run FIRST:
# the XLA:CPU client segfaults loading one of these multi-hundred-MB
# executables into a process that has already accumulated ~300 tests' worth
# of compiled programs (observed repeatedly at tests/test_eigh_large.py via
# compilation_cache get_executable_and_time, passing solo against the same
# cache entries). Fresh workers take these
# files first under --dist loadfile, so the jumbo loads happen at minimal
# accumulation.
_JUMBO_FIRST = ("test_eigh_large.py", "test_eigensolver.py",
                "test_dist_eigensolver.py", "test_tridiag_dc_dist.py")

# Fast-gate dtype policy (keeps the default gate to a few minutes on a
# small CPU box): in these files the fast lane runs the single-precision
# dtypes (float32 / complex64); their float64 / complex128 rows run in the
# slow lane (`-m "slow or not slow"` restores the full {s,d,c,z} matrix, the
# reference's CI dtype coverage, DLAF_AddTest.cmake:60-118). Files NOT
# listed keep all dtypes fast.
_FAST_GATE_SINGLE_PRECISION = (
    "test_blas_local.py", "test_dist_cholesky.py", "test_dist_matrix.py",
    "test_dist_multiplication.py", "test_dist_trsm.py",
    "test_dist_trsm_right.py", "test_eigensolver.py", "test_aux.py",
    "test_tridiag_dc_dist.py", "test_band_strips.py", "test_eigh_large.py",
    "test_dist_eigensolver.py")


def pytest_collection_modifyitems(config, items):
    slow = pytest.mark.slow

    def _fname(it):
        return it.path.name if getattr(it, "path", None) else \
            it.fspath.basename

    for item in items:
        if (_fname(item) in _FAST_GATE_SINGLE_PRECISION
                and ("float64" in item.name or "complex128" in item.name)):
            item.add_marker(slow)
    items.sort(key=lambda it: 0 if _fname(it) in _JUMBO_FIRST else 1)


@pytest.fixture(autouse=True)
def _lane_gate(request):
    """``gpu``-marked tests need a GPU backend; every other test belongs to
    the CPU lane. Decided when the test runs, from the live backend."""
    wants_gpu = request.node.get_closest_marker("gpu") is not None
    if wants_gpu and jax.default_backend() != "gpu":
        pytest.skip("gpu-marked test; the backend is not a GPU")
    if not wants_gpu and GPU_LANE:
        pytest.skip("CPU-lane test; running the GPU lane")


@pytest.fixture(params=["float32", "float64", "complex64", "complex128"])
def dtype(request):
    return np.dtype(request.param)


@pytest.fixture(params=["float32", "float64"])
def real_dtype_p(request):
    return np.dtype(request.param)


def tol(dtype, n, factor=10.0):
    """eps-scaled residual bound (reference CHECK_MATRIX_NEAR style,
    test/include/dlaf_test/matrix/util_matrix.h:218-283)."""
    import dlaf_jax.types as t
    return factor * n * t.eps(dtype)
