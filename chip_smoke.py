"""Smoke run of the solver pipeline on one GPU through the public API.

    python chip_smoke.py          # one GPU: every local phase, full size
    python chip_smoke.py --four   # four GPUs: distributed Cholesky and
                                  # eigensolver on a 2x2 grid, nothing else

Each phase compiles one public entry point, runs it, times one warm run,
and checks eps-scaled residual gates computed on the device. Each phase
prints one line: compile seconds, the warm wall time labelled with the
card, every residual beside its bound, the device's peak memory and the
compiled program's memory analysis. The last line is the JSON contract
``{"ok": true, "device": {...}}``.

The script exits non-zero, and never prints ``"ok": true``, when no GPU is
found, a phase raises, or a gate fails. Each phase is a function of its
size, so the CPU tests run them at tiny sizes; only :func:`main` insists on
a GPU.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp

import dlaf_jax as dt
from dlaf_jax.cache import configure_compilation_cache
from dlaf_jax.matrix import generators as gen

HIGHEST = jax.lax.Precision.HIGHEST
# eigensolver gate constant c of the reference's correctness test
# (test_eigensolver_correctness.h:71-96: ||E^H E - I|| <= m eps c,
# ||A E - E L|| <= 2 m eps c ||A||)
EIG_C = 10.0

# card label for wall times; main() sets it from nvidia-smi
CARD = "cpu"


@dataclasses.dataclass
class Gate:
    name: str
    value: float
    bound: float
    rule: str

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.bound

    def __str__(self):
        return (f"{self.name} {self.value:.3e} <= {self.bound:.3e} "
                f"[{self.rule}] {'ok' if self.ok else 'FAIL'}")


@dataclasses.dataclass
class Result:
    phase: str
    gates: list
    compile_s: float | None = None
    warm_s: float | None = None
    note: str = ""
    memory: str = "n/a"

    @property
    def ok(self) -> bool:
        return bool(self.gates) and all(g.ok for g in self.gates)

    def line(self) -> str:
        comp = "n/a" if self.compile_s is None else f"{self.compile_s:.2f}s"
        warm = "n/a" if self.warm_s is None else f"{self.warm_s:.4f}s"
        parts = [f"phase {self.phase}", f"compile {comp}",
                 f"warm wall {warm} on {CARD}",
                 *map(str, self.gates),
                 f"peak_bytes_in_use {_peak_bytes()}",
                 f"memory_analysis {self.memory}"]
        if self.note:
            parts.append(self.note)
        parts.append("PASS" if self.ok else "FAIL")
        return " | ".join(parts)


def _eps(dtype) -> float:
    return float(jnp.finfo(jnp.dtype(dtype)).eps)


def _gib(nbytes) -> str:
    return f"{nbytes / 2**30:.2f}GiB"


def _peak_bytes() -> str:
    stats = jax.devices()[0].memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return "n/a"
    return _gib(stats["peak_bytes_in_use"])


def _memory(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "n/a"
    return (f"arg {_gib(m.argument_size_in_bytes)} "
            f"out {_gib(m.output_size_in_bytes)} "
            f"temp {_gib(m.temp_size_in_bytes)} "
            f"alias {_gib(m.alias_size_in_bytes)}")


def _compile_and_time(jitted, *args, **static):
    """(output, compile_s, warm_s, memory) of ``jitted`` at ``args``: one
    compile, one first run, one timed warm run."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **static).compile()
    tc = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    return out, tc, time.perf_counter() - t0, _memory(compiled)


def _first_and_warm(fn):
    """(output, compile_s, warm_s) for a staged entry point that is not one
    jitted program: compile time is the first call less the warm call."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    warm = time.perf_counter() - t0
    return out, max(first - warm, 0.0), warm


def _dtag(dtype) -> str:
    return {"float32": "f32", "float64": "f64", "complex64": "c64",
            "complex128": "c128"}[jnp.dtype(dtype).name]


def _precision_tag(dtype) -> str:
    if jnp.dtype(dtype) in (jnp.float32, jnp.complex64):
        return f"{_dtag(dtype)} matmul_precision=" \
            f"{dt.get_tune_parameters().matmul_precision}"
    return _dtag(dtype)


# ---------------------------------------------------------------------------
# on-device residuals


@jax.jit
def _chol_residual_l(a, f):
    rec = jnp.matmul(f, jnp.conj(f.T), precision=HIGHEST)
    return jnp.max(jnp.abs(rec - a)) / jnp.max(jnp.abs(a))


@jax.jit
def _chol_residual_u(a, f):
    rec = jnp.matmul(jnp.conj(f.T), f, precision=HIGHEST)
    return jnp.max(jnp.abs(rec - a)) / jnp.max(jnp.abs(a))


@jax.jit
def _trsm_residual(l, x, b):
    r = jnp.max(jnp.abs(jnp.matmul(l, x, precision=HIGHEST) - b))
    return r / (jnp.max(jnp.abs(l)) * jnp.maximum(jnp.max(jnp.abs(x)), 1.0))


@jax.jit
def _eig_residuals(a, w, v):
    n = a.shape[0]
    vh = jnp.conj(v.T)
    orth = jnp.max(jnp.abs(jnp.matmul(vh, v, precision=HIGHEST)
                           - jnp.eye(n, dtype=v.dtype)))
    av = jnp.matmul(a, v, precision=HIGHEST)
    res = jnp.max(jnp.abs(av - v * w[None, :].astype(v.dtype)))
    return orth, res / jnp.maximum(jnp.max(jnp.abs(a)), 1.0)


@jax.jit
def _gen_eig_residual(a, b, w, x):
    ax = jnp.matmul(a, x, precision=HIGHEST)
    bx = jnp.matmul(b, x, precision=HIGHEST)
    res = jnp.max(jnp.abs(ax - bx * w[None, :].astype(x.dtype)))
    return res / jnp.maximum(jnp.max(jnp.abs(a)), 1.0)


def chol_gates(a, f, uplo, label="|A-LL^H|/|A|"):
    """Reference miniapp_cholesky.cpp:192-199: max|A - L L^H| / max|A|
    errors above 100 n eps."""
    n = a.shape[0]
    fn = _chol_residual_l if uplo == "L" else _chol_residual_u
    r = float(fn(a, f))
    return [Gate(label, r, 100 * n * _eps(a.dtype), "100*n*eps")]


def eig_gates(a, w, v):
    """Reference test_eigensolver_correctness.h:71-96."""
    m = a.shape[0]
    e = _eps(a.dtype)
    orth, res = (float(x) for x in _eig_residuals(a, w, v))
    return [Gate("|E^HE-I|", orth, m * e * EIG_C, f"m*eps*{EIG_C:g}"),
            Gate("|AE-EL|/|A|", res, 2 * m * e * EIG_C, f"2*m*eps*{EIG_C:g}")]


# ---------------------------------------------------------------------------
# phases (local)


def phase_potrf(n=20480, nb=512, dtype=jnp.float64, uplos=("L", "U"),
                name="potrf_d", canary=False):
    """dt.potrf, lower and upper; gate max|A - LL^H| / max|A|. With
    ``canary`` the residual also gets the tighter sqrt(n) eps bound that a
    product run in TF32 would exceed."""
    a = gen.random_hermitian_positive_definite(jax.random.PRNGKey(1), n,
                                               dtype)
    out = []
    for uplo in uplos:
        f, tc, tw, mem = _compile_and_time(dt.potrf, a, uplo=uplo, nb=nb)
        gates = chol_gates(a, f, uplo)
        if canary:
            gates.append(Gate("TF32 canary", gates[0].value,
                              math.sqrt(n) * _eps(dtype), "sqrt(n)*eps"))
        del f
        out.append(Result(f"{name}[{uplo}] {_precision_tag(dtype)} n={n} "
                          f"nb={nb}", gates, tc, tw, memory=mem))
    return out


def phase_trsm(n=20480, nrhs=2048, nb=512, dtype=jnp.float64):
    """dt.trsm L/L/N on the Cholesky factor; gate max|L X - B|."""
    a = gen.random_hermitian_positive_definite(jax.random.PRNGKey(1), n,
                                               dtype)
    l = dt.potrf(a, uplo="L", nb=nb)
    del a
    b = gen.random_general(jax.random.PRNGKey(2), (n, nrhs), dtype)
    x, tc, tw, mem = _compile_and_time(dt.trsm, l, b, side="L", uplo="L",
                                       trans="N", nb=nb)
    r = float(_trsm_residual(l, x, b))
    gate = Gate("|LX-B|/(|L||X|)", r, 100 * n * _eps(dtype), "100*n*eps")
    return [Result(f"trsm_d {_precision_tag(dtype)} m={n} nrhs={nrhs} "
                   f"nb={nb}", [gate], tc, tw, memory=mem)]


def phase_heev(n=10240, dtype=jnp.float64, band=None, large=True,
               name="heev_d"):
    """dt.eigh (one jitted program, the miniapp's path) and, with
    ``large``, the stage-split dt.eigh_large with its stage times."""
    a = gen.random_hermitian(jax.random.PRNGKey(3), n, dtype)
    eigh = jax.jit(dt.eigh, static_argnames=("band",))
    (w, v), tc, tw, mem = _compile_and_time(eigh, a, band=band)
    out = [Result(f"{name}[eigh] {_precision_tag(dtype)} n={n}",
                  eig_gates(a, w, v), tc, tw, memory=mem)]
    del w, v
    if large:
        stages = {}

        def run():
            w, v, st = dt.eigh_large(jnp.array(a, copy=True), band=band,
                                     timers=True)
            stages.clear()
            stages.update(st)
            return w, v

        (w, v), tc, tw = _first_and_warm(run)
        # shares of the warm wall time (stage4a/4b are parts of stage4)
        split = " ".join(f"{k} {s:.3f}s ({s / tw:.1%})"
                         for k, s in stages.items())
        out.append(Result(f"{name}[eigh_large] {_precision_tag(dtype)} "
                          f"n={n}", eig_gates(a, w, v), tc, tw,
                          note=f"stages: {split}"))
    return out


def phase_hegv(n=4096, dtype=jnp.float64, band=None):
    """dt.eigh_gen; gate max|A X - B X L| as in __graft_entry__."""
    a = gen.random_hermitian(jax.random.PRNGKey(4), n, dtype)
    b = gen.random_hermitian_positive_definite(jax.random.PRNGKey(5), n,
                                               dtype)
    eigh_gen = jax.jit(dt.eigh_gen, static_argnames=("band",))
    (w, x), tc, tw, mem = _compile_and_time(eigh_gen, a, b, band=band)
    r = float(_gen_eig_residual(a, b, w, x))
    gate = Gate("|AX-BXL|/|A|", r, 2000 * n * _eps(dtype), "2000*n*eps")
    return [Result(f"hegv_d {_precision_tag(dtype)} n={n}", [gate], tc, tw,
                   memory=mem)]


def phase_f32(n_potrf=20480, nb=512, n_eigh=8192, band=None):
    """Single precision at matmul_precision="float32": a product that runs
    in TF32 on the tensor cores shows here as residuals ~1e3x larger. The
    Cholesky residual gets a second, tighter gate (sqrt(n) eps) for that."""
    old = dt.get_tune_parameters().matmul_precision
    dt.set_tune_parameters(matmul_precision="float32")
    try:
        out = phase_potrf(n_potrf, nb, jnp.float32, uplos=("L",),
                          name="f32_potrf", canary=True)
        out += phase_heev(n_eigh, jnp.float32, band=band, large=False,
                          name="f32_heev")
    finally:
        dt.set_tune_parameters(matmul_precision=old)
    return out


def phase_miniapp(n=4096, extra=()):
    """miniapp_eigensolver.main in-process with --check (the CLI users
    run); the gate is its own ``check: PASSED`` line."""
    from dlaf_jax.miniapps import miniapp_eigensolver
    argv = ["-n", str(n), "--type", "d", "--check", "--nruns", "1",
            "--nwarmups", "0", *extra]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        miniapp_eigensolver.main(argv)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    print(text, end="", flush=True)
    passed = "check: PASSED" in text
    check = next((ln for ln in text.splitlines()
                  if ln.startswith("check:")), "no check line")
    gate = Gate("miniapp check", 0.0 if passed else 1.0, 0.0,
                "check: PASSED")
    return [Result(f"miniapp_eigensolver -n {n} --type d", [gate],
                   note=f"{check}; cold run incl. compile {wall:.2f}s")]


# ---------------------------------------------------------------------------
# phases (four cards)


def _grid(shape=(2, 2)):
    from dlaf_jax.comm.mesh import Grid
    count = shape[0] * shape[1]
    return Grid(shape, devices=jax.devices()[:count])


def _shard_devices(dm) -> int:
    return len({s.device for s in dm.data.addressable_shards})


def phase_dist_cholesky(n=20480, nb=512, dtype=jnp.float64, shape=(2, 2)):
    """algos.cholesky.cholesky on a 2x2 grid; same gate as potrf_d."""
    from dlaf_jax.algos.cholesky import cholesky
    from dlaf_jax.matrix.dist_matrix import DistMatrix
    grid = _grid(shape)
    a = gen.random_hermitian_positive_definite(jax.random.PRNGKey(1), n,
                                               dtype)
    dm = DistMatrix.from_global(a, nb, grid, pad_identity=True)
    held = {}

    def run():
        held["l"] = cholesky(dm)
        return held["l"].data

    _, tc, tw = _first_and_warm(run)
    ndev = _shard_devices(held["l"])
    f = jnp.tril(held["l"].to_global())
    gates = chol_gates(a, f, "L")
    want = shape[0] * shape[1]
    gates.append(Gate("distinct devices short of grid", want - ndev, 0,
                      f"{want} shards on {want} devices"))
    return [Result(f"dist_cholesky {_precision_tag(dtype)} n={n} nb={nb} "
                   f"grid={shape}", gates, tc, tw,
                   note=f"shards on {ndev} devices")]


def phase_dist_eigh(n=10240, nb=512, dtype=jnp.float64, shape=(2, 2)):
    """dist_driver.eigh_dist on a 2x2 grid; same gates as heev_d."""
    from dlaf_jax.algos.eigensolver.dist_driver import eigh_dist
    from dlaf_jax.matrix.dist_matrix import DistMatrix
    grid = _grid(shape)
    a = gen.random_hermitian(jax.random.PRNGKey(3), n, dtype)
    dm = DistMatrix.from_global(a, nb, grid)
    held = {}

    def run():
        held["w"], held["v"] = eigh_dist(dm)
        return held["w"], held["v"].data

    _, tc, tw = _first_and_warm(run)
    ndev = _shard_devices(held["v"])
    gates = eig_gates(a, held["w"], held["v"].to_global())
    want = shape[0] * shape[1]
    gates.append(Gate("distinct devices short of grid", want - ndev, 0,
                      f"{want} shards on {want} devices"))
    return [Result(f"dist_eigh {_precision_tag(dtype)} n={n} nb={nb} "
                   f"grid={shape}", gates, tc, tw,
                   note=f"shards on {ndev} devices")]


LOCAL_PHASES = (phase_potrf, phase_trsm, phase_heev, phase_hegv, phase_f32,
                phase_miniapp)
FOUR_PHASES = (phase_dist_cholesky, phase_dist_eigh)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them (a
    child process that does not touch JAX)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable ({err})"
    lines = r.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi gave nothing (rc {r.returncode})"


def run_phases(phases) -> bool:
    ok = True
    for phase in phases:
        try:
            for res in phase():
                print(res.line(), flush=True)
                ok &= res.ok
        except Exception:  # noqa: BLE001 - reported, and the run fails
            traceback.print_exc()
            print(f"phase {phase.__name__} | raised | FAIL", flush=True)
            ok = False
    return ok


def main(argv=None) -> int:
    global CARD
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="only the distributed paths on a 2x2 grid of four "
                        "GPUs")
    args = p.parse_args(argv)
    count = 4 if args.four else 1

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devices[0].platform!r}); nothing run", file=sys.stderr)
        return 2
    if len(devices) < count:
        print(f"chip_smoke: needs {count} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    configure_compilation_cache()

    CARD = card_line()
    print(f"jax {jax.__version__}", flush=True)
    print(f"device_kind {devices[0].device_kind} count {len(devices)}",
          flush=True)
    print(CARD, flush=True)

    ok = run_phases(FOUR_PHASES if args.four else LOCAL_PHASES)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
