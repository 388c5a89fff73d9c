"""C API smoke: compile tests/c_api_main.c against libdlaf_jax_c.so and run
it in a fresh process (reference test/unit/c_api analog — a real C caller
through include-header + shared-library linkage, not ctypes)."""
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(ROOT, "dlaf_jax", "native")


@pytest.mark.skipif(shutil.which("gcc") is None, reason="no C compiler")
def test_c_api_roundtrip(tmp_path):
    # always invoke make: its dependency tracking rebuilds the library when
    # dlaf_c_api.cpp / dlaf_jax_c.h changed (a stale committed .so must
    # never be what gets tested)
    r = subprocess.run(["make", "-C", NATIVE, "libdlaf_jax_c.so"],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-2000:]
    exe = str(tmp_path / "c_api_main")
    r = subprocess.run(
        ["gcc", "-O2", os.path.join(ROOT, "tests", "c_api_main.c"),
         "-I", NATIVE, "-L", NATIVE, "-ldlaf_jax_c",
         f"-Wl,-rpath,{NATIVE}", "-lm", "-o", exe],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    # the embedded interpreter picks its compile cache through
    # dlaf_jax.cache (machine-keyed CPU directory inside the checkout)
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_NUM_CPU_DEVICES="8",
               JAX_ENABLE_X64="1")
    # cold-cache budget: the generalized-eigensolver entries add two big
    # eigh_gen_dist compiles on the 1-core host
    r = subprocess.run([exe], capture_output=True, text=True, timeout=1200,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, (r.returncode, r.stdout[-500:], r.stderr[-2000:])
    assert "OK" in r.stdout
