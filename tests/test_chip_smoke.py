"""chip_smoke.py on the CPU: every phase at a tiny size, and main()'s
refusal to run (non-zero exit, no ``"ok": true``) without a GPU."""
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PHASES = {
    "potrf": lambda: cs.phase_potrf(64, 16),
    "trsm": lambda: cs.phase_trsm(64, 32, 16),
    "heev": lambda: cs.phase_heev(64, band=16),
    "hegv": lambda: cs.phase_hegv(48, band=16),
    "f32": lambda: cs.phase_f32(64, 16, 64, band=16),
    "miniapp": lambda: cs.phase_miniapp(64),
    "dist_cholesky": lambda: cs.phase_dist_cholesky(64, 8),
    "dist_eigh": lambda: cs.phase_dist_eigh(64, 8),
}


@pytest.mark.parametrize("name", sorted(PHASES))
def test_phase_tiny(name):
    results = PHASES[name]()
    assert results
    for r in results:
        line = r.line()
        assert r.ok, line
        assert line.startswith("phase ") and line.endswith("PASS")
        assert all(f"<= {g.bound:.3e}" in line for g in r.gates)


def test_gate_fails_on_nan_and_excess():
    assert not cs.Gate("x", float("nan"), 1.0, "r").ok
    assert not cs.Gate("x", 2.0, 1.0, "r").ok
    assert not cs.Result("p", [cs.Gate("x", 0.0, 1.0, "r"),
                               cs.Gate("y", 3.0, 1.0, "r")]).ok
    assert not cs.Result("p", []).ok      # a phase with no gate never passes


def test_raising_phase_fails_the_run(capsys):
    def boom():
        raise RuntimeError("boom")
    assert not cs.run_phases([lambda: cs.phase_potrf(32, 16, uplos=("L",)),
                              boom])
    assert "raised | FAIL" in capsys.readouterr().out


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=300)


@pytest.mark.parametrize("args", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--four"]])
def test_main_refuses_cpu(args):
    r = _run(args, ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_alone_without_the_repo_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_f32_phase_restores_precision():
    from dlaf_jax import tune
    tune.set_tune_parameters(matmul_precision="highest")
    try:
        cs.phase_f32(32, 16, 32, band=16)
        assert tune.get_tune_parameters().matmul_precision == "highest"
    finally:
        tune.reset_tune_parameters()


def test_precision_tag():
    assert cs._precision_tag(jnp.float64) == "f64"
    assert cs._precision_tag(jnp.float32).startswith(
        "f32 matmul_precision=")
