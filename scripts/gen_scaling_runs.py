"""Generate strong/weak scaling miniapp command lists.

Analog of the reference's job-script generators
(``scripts/gen_dlaf_strong-gpu.py:20-80``, ``gen_dlaf_weak-gpu.py:25-41``,
``scripts/miniapps.py:199-708``): emits one miniapp command per
(algorithm, size, mesh) point using the same sweep structure — strong scaling
holds n fixed across mesh sizes, weak scaling grows n ∝ sqrt(devices)
rounded to a block-size multiple.
"""
from __future__ import annotations

import argparse

ALGS = {
    "chol": "miniapp_cholesky",
    "trsm": "miniapp_triangular_solver",
    "trmm": "miniapp_triangular_multiplication",
    "gen2std": "miniapp_gen_to_std",
    "red2band": "miniapp_reduction_to_band",
    "band2trid": "miniapp_band_to_tridiag",
    "trid_evp": "miniapp_tridiag_solver",
    "bt_band2trid": "miniapp_bt_band_to_tridiag",
    "bt_red2band": "miniapp_bt_reduction_to_band",
    "evp": "miniapp_eigensolver",
    "gevp": "miniapp_gen_eigensolver",
}

MESHES = [(1, 1), (2, 2), (2, 4), (4, 4), (4, 8), (8, 8)]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["strong", "weak"], default="strong")
    p.add_argument("--algs", default="chol,evp,gevp")
    p.add_argument("--sizes", default="10240,20480,30097,40960")
    p.add_argument("--block-size", type=int, default=512)
    p.add_argument("--nruns", type=int, default=5)
    p.add_argument("--nwarmups", type=int, default=1)
    p.add_argument("--type", default="s")
    args = p.parse_args()

    sizes = [int(s) for s in args.sizes.split(",")]
    for alg in args.algs.split(","):
        mod = ALGS[alg]
        for base_n in sizes:
            for (pr, pc) in MESHES:
                if args.mode == "weak":
                    import math
                    # scale n by sqrt(devices) so memory/device is constant
                    # (reference gen_dlaf_weak-gpu.py:25-41), rounded to the
                    # block size; isqrt would floor sqrt(8) to 2
                    n = base_n * math.sqrt(pr * pc)
                    n = int((n + args.block_size - 1) // args.block_size) * args.block_size
                else:
                    n = base_n
                print(f"python -m dlaf_jax.miniapps.{mod} -n {n} "
                      f"-b {args.block_size} --grid-rows {pr} --grid-cols {pc} "
                      f"--nruns {args.nruns} --nwarmups {args.nwarmups} "
                      f"--type {args.type}")


if __name__ == "__main__":
    main()
