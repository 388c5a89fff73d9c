"""Per-stage wall times of ``dlaf_jax.eigh``'s pipeline on one device.

    python scripts/eigh_stages.py [-n 10240] [--dtype d|s] [--band 128]

Jits each of the five stages of ``algos/eigensolver/driver.eigh``
separately (reduction to band, band to tridiagonal, tridiagonal D&C, the
two back-transformations), runs each once to compile and once timed, and
prints one line per stage with its compile time, warm time and share of
the warm total. (``eigh_large(timers=True)`` gives the same split for the
strip-storage pipeline.)
"""
import argparse
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dlaf_jax.algos.eigensolver import driver  # noqa: E402
from dlaf_jax.algos.eigensolver.band2tridiag import \
    band_to_tridiag_auto  # noqa: E402
from dlaf_jax.algos.eigensolver.bt import (bt_band_to_tridiag,  # noqa: E402
                                           bt_reduction_to_band)
from dlaf_jax.algos.eigensolver.red2band import (extract_band,  # noqa: E402
                                                 reduction_to_band)
from dlaf_jax.algos.eigensolver.tridiag_dc import tridiag_eigh  # noqa: E402
from dlaf_jax.cache import configure_compilation_cache  # noqa: E402
from dlaf_jax.matrix import generators as gen  # noqa: E402
from dlaf_jax.tune import get_tune_parameters  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-n", type=int, default=10240)
    p.add_argument("--dtype", choices=["s", "d"], default="d")
    p.add_argument("--band", type=int, default=None)
    args = p.parse_args(argv)
    jax.config.update("jax_enable_x64", True)
    configure_compilation_cache()
    tune = get_tune_parameters()
    dtype = jnp.float64 if args.dtype == "d" else jnp.float32
    b = args.band or driver.get_band_size(tune.default_block_size)
    gsz = tune.bt_band_to_tridiag_hh_apply_group_size
    a = gen.random_hermitian(jax.random.PRNGKey(3), args.n, dtype)

    stages = [
        ("stage1_red2band", lambda a: reduction_to_band(a, b)),
        ("stage2_band2tridiag",
         lambda p: band_to_tridiag_auto(extract_band(p[0], b), b)),
        ("stage3_tridiag_dc",
         lambda t: tridiag_eigh(jnp.real(t[0]), jnp.real(t[1]),
                                tune.laed4_max_iter)),
        ("stage4_bt_band2tridiag",
         lambda x: bt_band_to_tridiag(x[1][1].astype(dtype), x[0][2],
                                      x[0][3], b, group_size=gsz)),
        ("stage5_bt_red2band",
         lambda x: bt_reduction_to_band(x[1], x[0][0], x[0][1], b)),
    ]
    # each stage's input is built from the previous stages' outputs
    inputs = [lambda: a, lambda: out[0], lambda: out[1],
              lambda: (out[1], out[2]), lambda: (out[0], out[3])]
    out, rows = [], []
    for (name, fn), make in zip(stages, inputs):
        x = make()
        jf = jax.jit(fn)
        t0 = time.perf_counter()
        jax.block_until_ready(jf(x))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        y = jax.block_until_ready(jf(x))
        warm = time.perf_counter() - t0
        out.append(y)
        rows.append((name, first - warm, warm))
    total = sum(w for _, _, w in rows)
    dev = jax.devices()[0]
    print(f"eigh stages n={args.n} {jnp.dtype(dtype).name} band={b} on "
          f"{dev.device_kind}: warm total {total:.3f}s")
    for name, comp, warm in rows:
        print(f"  {name:24s} compile {comp:7.2f}s  warm {warm:8.4f}s  "
              f"{warm / total:6.1%}")


if __name__ == "__main__":
    main()
