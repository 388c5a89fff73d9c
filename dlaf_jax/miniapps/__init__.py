"""Miniapp benchmark CLIs (reference ``miniapp/``: 12 executables).

Run as modules, e.g.::

    python -m dlaf_jax.miniapps.miniapp_cholesky -n 4096 -b 256 --check
"""
MINIAPPS = [
    "miniapp_cholesky",
    "miniapp_triangular_solver",
    "miniapp_triangular_multiplication",
    "miniapp_gen_to_std",
    "miniapp_eigensolver",
    "miniapp_gen_eigensolver",
    "miniapp_reduction_to_band",
    "miniapp_band_to_tridiag",
    "miniapp_tridiag_solver",
    "miniapp_bt_band_to_tridiag",
    "miniapp_bt_reduction_to_band",
    "miniapp_communication",
]
