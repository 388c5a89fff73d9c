"""Smoke tests: every miniapp runs end-to-end with --check on tiny sizes
(the analog of the reference's miniapp CTest entries)."""
import importlib

import pytest

import dlaf_jax

CASES = [
    ("miniapp_cholesky", ["-n", "96", "-b", "32", "--check", "--nruns", "1"]),
    ("miniapp_cholesky", ["-n", "64", "-b", "16", "--grid-rows", "2",
                          "--grid-cols", "2", "--check", "--nruns", "1"]),
    ("miniapp_triangular_solver", ["-n", "96", "-b", "32", "--check", "--nruns", "1"]),
    ("miniapp_triangular_multiplication", ["-n", "96", "-b", "32", "--check",
                                           "--nruns", "1"]),
    ("miniapp_gen_to_std", ["-n", "96", "-b", "32", "--check", "--nruns", "1"]),
    ("miniapp_eigensolver", ["-n", "64", "--band-size", "16", "--check",
                             "--nruns", "1"]),
    ("miniapp_gen_eigensolver", ["-n", "64", "--check", "--nruns", "1",
                                 "--type", "d"]),
    ("miniapp_reduction_to_band", ["-n", "64", "--band-size", "16", "--check",
                                   "--nruns", "1"]),
    ("miniapp_band_to_tridiag", ["-n", "64", "--band-size", "8", "--check",
                                 "--nruns", "1"]),
    ("miniapp_tridiag_solver", ["-n", "70", "--check", "--nruns", "1"]),
    ("miniapp_bt_band_to_tridiag", ["-n", "64", "--band-size", "8", "--nruns", "1"]),
    ("miniapp_bt_reduction_to_band", ["-n", "64", "--band-size", "16",
                                      "--nruns", "1"]),
    ("miniapp_communication", ["-n", "32", "--grid-rows", "2", "--grid-cols", "4",
                               "--nruns", "1"]),
    ("kernel_runner", ["--kernel", "potrf", "-b", "64", "--count", "4",
                       "--nruns", "1"]),
    ("kernel_runner", ["--kernel", "trsm", "-b", "64", "--count", "4",
                       "--nruns", "1"]),
]


@pytest.fixture(autouse=True)
def small_tune():
    dlaf_jax.set_tune_parameters(eigensolver_min_band=8, default_block_size=16)
    yield
    dlaf_jax.tune.reset_tune_parameters()


@pytest.mark.parametrize("mod,argv", CASES, ids=[f"{m}-{i}" for i, (m, _) in enumerate(CASES)])
def test_miniapp(mod, argv, capsys):
    m = importlib.import_module(f"dlaf_jax.miniapps.{mod}")
    m.main(argv)
    out = capsys.readouterr().out
    if "--check" in argv:
        assert "PASSED" in out
    if mod not in ("miniapp_communication", "kernel_runner"):
        assert "CSVData-2" in out
    if mod == "kernel_runner":
        assert "us/tile" in out


def test_hdf5_reference_layout_roundtrip(tmp_path):
    """MatrixFile .h5 files use the reference's on-disk layout
    (matrix/hdf5.h:200-219): 3-D datasets (cols, rows, c) with c=1 real /
    c=2 (re, im) complex — checked at the raw h5py level, plus roundtrip."""
    import h5py
    import numpy as np

    from dlaf_jax.matrix.io import MatrixFile

    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 4)).astype(np.float32)
    z = (rng.standard_normal((3, 5)) +
         1j * rng.standard_normal((3, 5))).astype(np.complex64)
    w = rng.standard_normal(7).astype(np.float64)
    path = str(tmp_path / "mat.h5")
    f = MatrixFile(path)
    f.write(**{"/input": a, "/z": z, "/evals": w})
    with h5py.File(path, "r") as h:
        assert h["/input"].shape == (4, 6, 1)      # (cols, rows, 1)
        assert h["/z"].shape == (5, 3, 2)          # (cols, rows, re/im)
        assert h["/evals"].shape == (1, 7, 1)      # (n, 1) matrix convention
        assert h["/input"].dtype == np.float32
        np.testing.assert_array_equal(h["/input"][..., 0].T, a)
    np.testing.assert_array_equal(f.read("/input"), a)
    np.testing.assert_array_equal(f.read("/z"), z)
    np.testing.assert_array_equal(f.read("/evals"), w)
    assert set(f.read_all()) == {"input", "z", "evals"}
    # overwrite merge keeps other datasets
    f.write(**{"/input": a + 1})
    np.testing.assert_array_equal(f.read("/input"), a + 1)
    np.testing.assert_array_equal(f.read("/z"), z)


def test_miniapp_eigensolver_io_files(tmp_path, capsys):
    """--output-file writes input + /evals + /evecs (reference contract);
    --input-file reproduces the run from the written file."""
    import numpy as np

    from dlaf_jax.matrix.io import MatrixFile

    out = str(tmp_path / "evp.h5")
    from dlaf_jax.miniapps import miniapp_eigensolver as m
    m.main(["-n", "64", "--band-size", "16", "--check", "--nruns", "1",
            "--nwarmups", "0", "--output-file", out])
    assert "PASSED" in capsys.readouterr().out
    data = MatrixFile(out).read_all()
    assert set(data) == {"input", "evals", "evecs"}
    assert data["input"].shape == (64, 64)
    assert data["evals"].shape == (64,)
    m.main(["--check", "--nruns", "1", "--nwarmups", "0", "--band-size",
            "16", "--input-file", out])
    assert "PASSED" in capsys.readouterr().out
    assert np.all(np.isfinite(data["evals"]))


def test_miniapp_tridiag_input_file(tmp_path, capsys):
    """Reference /tridiag input layout: (n, 2) real matrix, col 0 diag,
    col 1 off-diag."""
    import numpy as np

    from dlaf_jax.matrix.io import MatrixFile

    rng = np.random.default_rng(1)
    n = 48
    td = np.zeros((n, 2), np.float32)
    td[:, 0] = rng.standard_normal(n)
    td[:n - 1, 1] = rng.standard_normal(n - 1)
    path = str(tmp_path / "t.h5")
    MatrixFile(path).write(**{"/tridiag": td})
    from dlaf_jax.miniapps import miniapp_tridiag_solver as m
    m.main(["--check", "--nruns", "1", "--nwarmups", "0",
            "--input-file", path])
    assert "PASSED" in capsys.readouterr().out
