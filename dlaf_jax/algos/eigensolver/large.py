"""Memory-planned local eigensolver for contract-scale problems.

``eigh_large`` runs the same five-stage pipeline as :func:`driver.eigh`
(reference ``Eigensolver<B,D,T>::call``, ``eigensolver/eigensolver/impl.h:38-95``)
but as SEPARATE jitted stages with an explicit device-memory plan: the
single-jit pipeline needs ~5-6 n^2 live buffers, this one ~3 n^2.

  1. reduction_to_band, donating the input:       peak ~2 n^2
  2. strips from the packed band (O(n b)); one chase pass recording
     NOTHING produces (d, e):                     peak n^2 + O(n b)
  3. tridiagonal D&C with the j-chunked top merge (see
     tridiag_dc._merge_vectors): peak qt + qnewT = 2 n^2, pinned extras
     only ``packed`` (n^2) + strips
  4. stage-2 back-transform in ``rec_chunks`` sweep chunks (default 1):
     each chunk RE-CHASES the O(n b) band recording its reflector slice,
     then applies it with the grouped compact-WY kernel on the padded
     eigenvector buffer. Peak during chunk ci:
     E(n^2) + record(n^2/rec_chunks) + packed(n^2).
     The re-chase is O(n^2 b) flops — cheap next to the O(n^3) it
     unblocks; re-deriving (d, e) rather than pinning the record through
     stage 3 is the same storage-vs-recompute decision the reference
     makes by keeping stage 2 on the O(n b) 1-D band layout
     (``band_to_tridiag/mc.h:438-662``, ``get_1d_block_size.h:19-21``).
  5. stage-1 back-transform (donating the eigenvector matrix).

Every buffer is created and consumed on the device; the host never holds
an n^2 array.
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from ...tune import get_tune_parameters
from .band_strips import band_to_tridiag_strips, packed_to_strips
from .driver import get_band_size
from .red2band import reduction_to_band
from .tridiag_dc import tridiag_eigh


# stage wrappers are memoized at module scope: a fresh jax.jit per
# eigh_large call would re-trace and re-load the executable every run
# (measured 20s warm vs 2s at n=8192 before memoization)
import functools


@functools.lru_cache(maxsize=None)
def _s1_fn(b: int):
    return jax.jit(lambda x: reduction_to_band(x, b), donate_argnums=0)


@functools.lru_cache(maxsize=None)
def _strips_fn(b: int):
    return jax.jit(lambda p: packed_to_strips(p, b))


@functools.lru_cache(maxsize=None)
def _s3_fn(laed4: int):
    return jax.jit(lambda dd, ee: tridiag_eigh(dd, ee, laed4))


@functools.lru_cache(maxsize=None)
def _s4_fn(b: int, gsz: int):
    from .bt import bt_band_to_tridiag
    return jax.jit(
        lambda qq, vv, tt, lo_: bt_band_to_tridiag(
            qq, vv, tt, b, group_size=gsz, sweep_lo=lo_, prepadded=True),
        donate_argnums=0)


@functools.lru_cache(maxsize=None)
def _phase_fn(dtname: str):
    """(d, e complex) -> (|e|, phases) for the real-subdiagonal transform
    (driver._phase_normalize): T = diag(phi) T_real diag(phi)^H."""
    from .driver import _phase_normalize
    dt = jnp.dtype(dtname)
    return jax.jit(lambda e: _phase_normalize(e, dt))


@functools.lru_cache(maxsize=None)
def _pad_phase_fn():
    """Complex stage-4 entry: write phases * q_real into the pre-zeroed
    COMPLEX workspace buffer (buf donated; the separate to-complex +
    pad would hold one more n^2 complex buffer at the peak)."""
    return jax.jit(
        lambda buf, qq, ph: jax.lax.dynamic_update_slice(
            buf, ph[:, None] * qq.astype(buf.dtype), (0, 0)),
        donate_argnums=(0,))


@functools.lru_cache(maxsize=None)
def _pad_fn():
    """Write q into the pre-zeroed workspace buffer ONCE (BOTH donated):
    the padded buffer is threaded through every chunk apply, so no apply
    ever holds a second n^2 copy (the rec_chunks=1 peak-HBM enabler).
    dynamic-update-slice aliases ``buf`` to the output; a concatenate
    CANNOT donate (its output shape differs from every input), which held
    q twice at the peak."""
    return jax.jit(
        lambda buf, qq: jax.lax.dynamic_update_slice(buf, qq, (0, 0)),
        donate_argnums=(0, 1))


@functools.lru_cache(maxsize=None)
def _unpad_fn(n: int):
    """Copy the live rows back into an exactly-(n, n) buffer (BOTH
    donated; see _pad_fn for why this is a DUS and not a slice)."""
    return jax.jit(
        lambda buf, qq: jax.lax.dynamic_update_slice(buf, qq[:n], (0, 0)),
        donate_argnums=(0, 1))


@functools.lru_cache(maxsize=None)
def _zeros_fn(shape, dtype=jnp.float32):
    """On-device zero fill, memoized per shape."""
    return jax.jit(lambda: jnp.zeros(shape, dtype))


@functools.lru_cache(maxsize=None)
def _s5_fn(b: int):
    from .bt import bt_reduction_to_band
    return jax.jit(lambda qq, pp, tt: bt_reduction_to_band(qq, pp, tt, b),
                   donate_argnums=0)


def _chase(strips, n: int, b: int, sweep_lo, sweep_chunk):
    """One full bulge-chase pass over strip storage, recording only sweeps
    [sweep_lo, sweep_lo + sweep_chunk). Returns (d, e, vs, taus)."""
    return band_to_tridiag_strips(strips, n, b, sweep_lo=sweep_lo,
                                  sweep_chunk=sweep_chunk)


def eigh_large(a, band: int | None = None, rec_chunks: int = 1,
               timers: bool = False):
    """Eigendecomposition of hermitian ``a`` (lower triangle referenced),
    staged for minimal peak device memory. CONSUMES (donates) ``a``.

    Returns (w, v) — or (w, v, stage_seconds) with ``timers`` — matching
    :func:`driver.eigh` (eigenvalues ascending, eigenvectors in columns).
    Requires n divisible by the band size and n > band (the contract-scale
    bench shapes; general shapes go through ``driver.eigh``).
    """
    tune = get_tune_parameters()
    n = a.shape[0]
    b = band or get_band_size(tune.default_block_size)
    gsz = tune.bt_band_to_tridiag_hh_apply_group_size
    if n % b or n <= b:
        raise ValueError(f"eigh_large needs n % band == 0 and n > band "
                         f"(n={n}, band={b}); use driver.eigh")
    cplx = bool(jnp.issubdtype(a.dtype, jnp.complexfloating))
    in_dtype = a.dtype
    nsweeps = n - 2
    # chunk length: multiple of the WY group size so chunked application
    # is an exact reproduction of the unchunked descending order
    per_chunk = -(-nsweeps // rec_chunks)            # ceil split
    chunk = -(-per_chunk // gsz) * gsz               # round up to gsz
    nchunks = -(-nsweeps // chunk)

    stage_s: dict[str, float] = {}

    def tick(name, t0, out):
        if timers:
            jax.block_until_ready(out)
            stage_s[name] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    # ---- stage 1: reduction to band (donates a) -------------------------
    packed, taus1 = _s1_fn(b)(a)
    del a
    t0 = tick("stage1_red2band", t0, packed)

    # ---- stage 2: strips + one recording-nothing chase -> (d, e) --------
    strips = _strips_fn(b)(packed)
    d, e, _vs0, _t0 = _chase(strips, n, b, sweep_lo=nsweeps + 1,
                             sweep_chunk=gsz)
    del _vs0, _t0
    t0 = tick("stage2_band2tridiag", t0, e)

    # ---- stage 3: tridiagonal D&C (j-chunked top merge) ------------------
    # complex input: make the subdiagonal real first (phase similarity,
    # reference: band->tridiag yields real T for hermitian input; see
    # driver._phase_normalize), solve the REAL tridiagonal problem, then
    # map eigenvectors back with the phases below
    if cplx:
        e, phases = _phase_fn(str(jnp.dtype(in_dtype)))(e)
    w, q = _s3_fn(tune.laed4_max_iter)(d, e)
    t0 = tick("stage3_tridiag_dc", t0, q)

    # ---- stage 4: stage-2 back-transform, chunked re-chase + apply ------
    # q is padded ONCE and the buffer is donated through every chunk apply
    # (a per-apply pad would hold two n^2 buffers at the concat peak)
    buf = _zeros_fn((n + b + gsz - 1, n), in_dtype if cplx else q.dtype)()
    if cplx:
        q = _pad_phase_fn()(buf, q, phases)
        del phases
    else:
        q = _pad_fn()(buf, q)
    del buf
    for ci in range(nchunks - 1, -1, -1):    # descending sweep order
        lo = ci * chunk
        tc = time.perf_counter()
        _, _, vs_c, taus_c = _chase(strips, n, b, sweep_lo=lo,
                                    sweep_chunk=chunk)
        if timers:
            jax.block_until_ready(vs_c)
            stage_s["stage4a_rechase"] = \
                stage_s.get("stage4a_rechase", 0.0) + time.perf_counter() - tc
            tc = time.perf_counter()
        q = _s4_fn(b, gsz)(q, vs_c, taus_c, lo)
        if timers:
            jax.block_until_ready(q)
            stage_s["stage4b_apply"] = \
                stage_s.get("stage4b_apply", 0.0) + time.perf_counter() - tc
        del vs_c, taus_c
    del strips
    out = _zeros_fn((n, n), q.dtype)()
    q = _unpad_fn(n)(out, q)
    del out
    t0 = tick("stage4_bt_band2tridiag", t0, q)

    # ---- stage 5: stage-1 back-transform (donates q) ---------------------
    q = _s5_fn(b)(q, packed, taus1)
    del packed, taus1
    tick("stage5_bt_red2band", t0, q)

    if timers:
        return w, q, stage_s
    return w, q


def eigvalsh_large(a, band: int | None = None):
    """Eigenvalues only at contract scale: stages 1-3 of the memory plan
    (no reflector record at all — the no-record chase); CONSUMES ``a``."""
    tune = get_tune_parameters()
    n = a.shape[0]
    b = band or get_band_size(tune.default_block_size)
    if n % b or n <= b:
        raise ValueError(f"eigvalsh_large needs n % band == 0 and n > band "
                         f"(n={n}, band={b})")
    gsz = tune.bt_band_to_tridiag_hh_apply_group_size
    packed, _ = _s1_fn(b)(a)
    del a
    strips = _strips_fn(b)(packed)
    del packed
    d, e, _vs, _t = _chase(strips, n, b, sweep_lo=n - 1, sweep_chunk=gsz)
    del strips, _vs, _t
    if jnp.issubdtype(e.dtype, jnp.complexfloating):
        # eigenvalues of T equal those of the phase-similar real tridiagonal
        e, _ = _phase_fn(str(jnp.dtype(e.dtype)))(e)
    w, _ = _s3_fn(tune.laed4_max_iter)(d, e)
    return w
