"""Infrastructure coverage: tune env chain, init, collectives, printing,
scaling-run generator, CSV postprocess, native pack/unpack."""
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dlaf_jax
from dlaf_jax import tune

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_tune_env_override(monkeypatch):
    monkeypatch.setenv("DLAF_JAX_EIGENSOLVER_MIN_BAND", "17")
    monkeypatch.setenv("DLAF_JAX_DEBUG_DUMP_CHOLESKY_DATA", "true")
    tune.reset_tune_parameters()
    tp = tune.get_tune_parameters()
    assert tp.eigensolver_min_band == 17
    assert tp.debug_dump_cholesky_data is True
    # explicit overrides beat env
    tp = tune.set_tune_parameters(eigensolver_min_band=9)
    assert tp.eigensolver_min_band == 9
    with pytest.raises(ValueError):
        tune.set_tune_parameters(not_a_knob=1)
    tune.reset_tune_parameters()


@pytest.mark.parametrize("knob,value", [
    ("band_to_tridiag_kernel", "pallas"),     # the removed chaser kernel
    ("band_to_tridiag_kernel", "auto"),       # now spelled "pipelined"
    ("matmul_precision", "high"),             # TF32 on the GPU
    ("potrf_trailing_kernel", "pallas"),      # removed knob
    ("bt_apply_fuse_groups", 8),              # removed knob
    ("potrf_panel_size", 8),                  # removed knob
])
def test_tune_rejects_removed_values(knob, value):
    before = tune.get_tune_parameters()
    with pytest.raises(ValueError):
        tune.set_tune_parameters(**{knob: value})
    assert tune.get_tune_parameters() == before


def test_init_print_config(capsys):
    from dlaf_jax import init
    init.finalize()
    init.initialize(print_config=True)
    out = capsys.readouterr().out
    assert "dlaf_jax configuration" in out
    assert "eigensolver_min_band" in out
    init.finalize()
    with init.ScopedInitializer():
        pass


def test_collectives_on_mesh():
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from dlaf_jax.comm import collectives as coll
    from dlaf_jax.comm.mesh import Grid

    grid = Grid((2, 4))
    x = jnp.arange(8.0).reshape(8, 1, 1)
    x = jax.device_put(x, jax.sharding.NamedSharding(
        grid.mesh, P(("r", "c"), None, None)))

    def f(v):
        b = coll.bcast(v, 1, "c")
        s = coll.allreduce_sum(v, "r")
        r = coll.ring_shift(v, "c", 1)
        return b, s, r

    b, s, r = jax.jit(jax.shard_map(
        f, mesh=grid.mesh,
        in_specs=P(("r", "c"), None, None),
        out_specs=P(("r", "c"), None, None)))(x)
    bn = np.asarray(b).ravel()
    # grid is row-major 2x4: device (p,q) holds value p*4+q; bcast from q=1
    assert list(bn) == [1, 1, 1, 1, 5, 5, 5, 5]
    sn = np.asarray(s).ravel()
    assert list(sn) == [4, 6, 8, 10, 4, 6, 8, 10]
    rn = np.asarray(r).ravel()
    assert list(rn) == [3, 0, 1, 2, 7, 4, 5, 6]


def test_printing(capsys):
    from dlaf_jax.matrix.printing import print_csv, print_numpy
    a = np.arange(4.0).reshape(2, 2)
    print_numpy(a, "m")
    out = capsys.readouterr().out
    assert out.startswith("m = np.array(")
    ns = {"np": np}
    exec(out, ns)
    np.testing.assert_array_equal(ns["m"], a)
    print_csv(a)
    out = capsys.readouterr().out
    assert len(out.strip().splitlines()) == 2


def test_scaling_scripts(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "scripts/gen_scaling_runs.py", "--mode", "weak",
         "--algs", "chol", "--sizes", "1024"],
        capture_output=True, text=True, cwd=ROOT, env=env)
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 6 and all("miniapp_cholesky" in ln for ln in lines)
    csv = ("CSVData-2, 0, 0.5, 100.0, s, L, 1024, 256, 2, 2, 1, cpu\n"
           "CSVData-2, 1, 0.4, 120.0, s, L, 1024, 256, 2, 2, 1, cpu\n")
    f = tmp_path / "runs.txt"
    f.write_text(csv)
    r = subprocess.run([sys.executable, "scripts/postprocess.py", str(f)],
                       capture_output=True, text=True, cwd=ROOT, env=env)
    assert "120.0" in r.stdout


def test_native_pack_matches_scalapack_layout():
    from dlaf_jax import native
    from dlaf_jax.api import scalapack as sl
    a = np.arange(31 * 18, dtype=np.float64).reshape(31, 18)
    desc = sl.DLAF_descriptor(m=31, n=18, mb=4, nb=4)
    ref = sl.to_scalapack_locals(a, desc, (2, 3))
    for p in range(2):
        for q in range(3):
            got = native.pack_local(a, 4, 4, (2, 3), (p, q))
            np.testing.assert_array_equal(got, ref[p][q])


def test_io_read_dist(tmp_path):
    from dlaf_jax.comm.mesh import Grid
    from dlaf_jax.matrix.io import MatrixFile
    a = np.random.default_rng(0).standard_normal((24, 24))
    f = MatrixFile(str(tmp_path / "ckpt"))
    f.write(input=a)
    dm = f.read_dist("input", 8, Grid((2, 2)))
    np.testing.assert_allclose(np.asarray(dm.to_global()), a)


def test_grid_order_column_major():
    """Grid order="C" assigns devices column-major (reference
    dlaf_create_grid order argument, include/dlaf_c/grid.h:31): device k
    sits at (k % P, k // P), and algorithms still run correctly since all
    index math is in mesh coordinates."""
    from dlaf_jax.algos.cholesky import cholesky
    from dlaf_jax.comm.mesh import Grid
    from dlaf_jax.matrix.dist_matrix import DistMatrix
    from dlaf_jax.matrix import generators as gen

    devs = jax.devices()[:8]
    gr = Grid((2, 4), order="R")
    gc = Grid((2, 4), order="C")
    mr = np.asarray(gr.mesh.devices)
    mc = np.asarray(gc.mesh.devices)
    assert mr[0, 1] == devs[1] and mr[1, 0] == devs[4]
    assert mc[0, 1] == devs[2] and mc[1, 0] == devs[1]

    with pytest.raises(ValueError):
        Grid((2, 4), order="X")

    a = gen.random_hermitian_positive_definite(jax.random.PRNGKey(0), 64,
                                               jnp.float32)
    dm = DistMatrix.from_global(a, 16, gc, pad_identity=True)
    out = np.tril(np.asarray(cholesky(dm).to_global()))
    res = np.max(np.abs(out @ out.T - np.asarray(a)))
    assert res < 1e-3

    # the ScaLAPACK registry passes the order through
    from dlaf_jax.api import scalapack as s
    ctx = s.dlaf_create_grid(2, 4, "C")
    try:
        g2 = s.dlaf_get_grid(ctx)
        assert np.asarray(g2.mesh.devices)[0, 1] == devs[2]
    finally:
        s.dlaf_free_grid(ctx)


def test_c_entry_ppotrf_offset_info():
    """c_ppotrf info must inspect the SUBMATRIX diagonal (ia-1+t, ja-1+t):
    with ia != ja the main diagonal lies outside the factored block, so a
    non-SPD sub-block must still yield info > 0 (regression: np.diagonal
    read finite untouched entries and returned info = 0)."""
    from dlaf_jax.native import c_entry

    m, nb, n = 8, 4, 4
    a = np.zeros((m, m), dtype=np.float32, order="F")
    np.fill_diagonal(a, 5.0)                      # finite main diagonal
    a[4:8, 0:4] = -np.eye(4, dtype=np.float32)    # non-SPD target block
    ctx = c_entry.c_create_grid(1, 1)
    try:
        desca = [1, ctx, m, m, nb, nb, 0, 0, m]
        info = c_entry.c_ppotrf("L", n, a.ctypes.data, 5, 1, desca, ctx,
                                "float32")
    finally:
        c_entry.c_free_grid(ctx)
    assert info > 0
