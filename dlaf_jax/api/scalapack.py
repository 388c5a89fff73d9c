"""ScaLAPACK-flavored descriptor API.

Analog of the reference's C/ScaLAPACK layer (``include/dlaf_c/``,
``src/c_api/``): an integer grid-context registry
(``src/c_api/grid.cpp:1-93``), the ``DLAF_descriptor`` struct
(``include/dlaf_c/desc.h:16``) and typed entry points named after the
ScaLAPACK drop-ins (``dlaf_pspotrf``/``dlaf_pdpotrf``, ``dlaf_pssyevd``/...,
``include/dlaf_c/factorization/cholesky.h:74-86``).

Instead of wrapping per-rank local pointers (there is one Python process for
the whole mesh), the entry points accept the matrix either as a global
(m, n) array or as the ScaLAPACK block-cyclic local layout for a given rank
set — :func:`from_scalapack_locals` / :func:`to_scalapack_locals` convert, so
a ScaLAPACK user's data layout round-trips exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import jax.numpy as jnp
import numpy as np

from ..comm.mesh import Grid
from ..dist import index as ix


# ---------------------------------------------------------------------------
# grid registry (reference src/c_api/grid.cpp)

_GRIDS: Dict[int, Grid] = {}
_NEXT_CTX = [1]


def dlaf_create_grid(grid_rows: int, grid_cols: int, order: str = "R") -> int:
    """Create a device grid, return an integer context handle. ``order``
    is the device->(p, q) rank ordering, "R"ow or "C"olumn major
    (reference ``dlaf_create_grid``, ``include/dlaf_c/grid.h:31``)."""
    assert order in ("R", "C")
    g = Grid((grid_rows, grid_cols), order=order)
    ctx = _NEXT_CTX[0]
    _NEXT_CTX[0] += 1
    _GRIDS[ctx] = g
    return ctx


def dlaf_get_grid(ctx: int) -> Grid:
    return _GRIDS[ctx]


def dlaf_free_grid(ctx: int) -> None:
    _GRIDS.pop(ctx, None)


def dlaf_free_all_grids() -> None:
    _GRIDS.clear()


# ---------------------------------------------------------------------------
# descriptor (reference include/dlaf_c/desc.h:16)


@dataclasses.dataclass
class DLAF_descriptor:
    m: int
    n: int
    mb: int
    nb: int
    isrc: int = 0
    jsrc: int = 0
    i: int = 0
    j: int = 0
    ld: int = 0

    @classmethod
    def from_scalapack(cls, desc) -> "DLAF_descriptor":
        """From a ScaLAPACK desc[9] integer array (DTYPE_, CTXT_, M_, N_,
        MB_, NB_, RSRC_, CSRC_, LLD_) — reference include/dlaf_c/utils.h:35-44."""
        return cls(m=int(desc[2]), n=int(desc[3]), mb=int(desc[4]),
                   nb=int(desc[5]), isrc=int(desc[6]), jsrc=int(desc[7]),
                   ld=int(desc[8]))


# ---------------------------------------------------------------------------
# ScaLAPACK local-layout conversion


def to_scalapack_locals(a, desc: DLAF_descriptor, grid_size) -> List[List[np.ndarray]]:
    """Global (m, n) array -> per-rank column-major local arrays
    (ScaLAPACK block-cyclic layout, numroc-sized)."""
    a = np.asarray(a)
    P, Q = grid_size
    out = []
    for p in range(P):
        row = []
        for q in range(Q):
            lm = int(ix.local_size(desc.m, desc.mb, P, p, desc.isrc))
            ln = int(ix.local_size(desc.n, desc.nb, Q, q, desc.jsrc))
            loc = np.zeros((lm, ln), a.dtype, order="F")
            for lt in range(ix.ceil_div(lm, desc.mb)):
                gi = ix.global_tile_from_local_tile(lt, P, p, desc.isrc)
                r0, r1 = gi * desc.mb, min((gi + 1) * desc.mb, desc.m)
                if r0 >= desc.m:
                    continue
                for ltc in range(ix.ceil_div(ln, desc.nb)):
                    gj = ix.global_tile_from_local_tile(ltc, Q, q, desc.jsrc)
                    c0, c1 = gj * desc.nb, min((gj + 1) * desc.nb, desc.n)
                    if c0 >= desc.n:
                        continue
                    loc[lt * desc.mb: lt * desc.mb + (r1 - r0),
                        ltc * desc.nb: ltc * desc.nb + (c1 - c0)] = a[r0:r1, c0:c1]
            row.append(loc)
        out.append(row)
    return out


def from_scalapack_locals(locals_, desc: DLAF_descriptor, grid_size, dtype=None):
    """Per-rank local arrays -> global (m, n) array (inverse of
    :func:`to_scalapack_locals`)."""
    P, Q = grid_size
    dtype = dtype or locals_[0][0].dtype
    a = np.zeros((desc.m, desc.n), dtype)
    for p in range(P):
        for q in range(Q):
            loc = np.asarray(locals_[p][q])
            lm, ln = loc.shape
            for lt in range(ix.ceil_div(lm, desc.mb) if desc.mb else 0):
                gi = ix.global_tile_from_local_tile(lt, P, p, desc.isrc)
                r0, r1 = gi * desc.mb, min((gi + 1) * desc.mb, desc.m)
                if r0 >= desc.m:
                    continue
                for ltc in range(ix.ceil_div(ln, desc.nb) if desc.nb else 0):
                    gj = ix.global_tile_from_local_tile(ltc, Q, q, desc.jsrc)
                    c0, c1 = gj * desc.nb, min((gj + 1) * desc.nb, desc.n)
                    if c0 >= desc.n:
                        continue
                    a[r0:r1, c0:c1] = loc[lt * desc.mb: lt * desc.mb + (r1 - r0),
                                          ltc * desc.nb: ltc * desc.nb + (c1 - c0)]
    return a


# ---------------------------------------------------------------------------
# typed entry points (reference include/dlaf_c/factorization/cholesky.h:32-86,
# eigensolver/eigensolver.h:36-55, eigensolver/gen_eigensolver.h)


def _run_cholesky(ctx, uplo, a, desc):
    from ..algos.cholesky import cholesky
    from ..matrix.dist_matrix import DistMatrix
    grid = dlaf_get_grid(ctx)
    dm = DistMatrix.from_global(jnp.asarray(a), desc.mb, grid, pad_identity=True)
    out = cholesky(dm, uplo=uplo)
    g = np.asarray(out.to_global())
    full = np.asarray(a).copy()
    idx = np.triu_indices(desc.m) if uplo == "U" else np.tril_indices(desc.m)
    keep = np.triu(g) if uplo == "U" else np.tril(g)
    full[idx] = keep[idx]
    return full


def dlaf_cholesky_factorization(ctx: int, uplo: str, a, desc: DLAF_descriptor):
    """reference ``dlaf_cholesky_factorization_{s,d,c,z}``; both uplos run
    the native distributed factorization (U: ``algos/cholesky.py``
    row-panel path, reference ``factorization/cholesky/impl.h:351``)."""
    return _run_cholesky(ctx, uplo, a, desc)


def _as_lower(a, uplo: str):
    """Stored-``uplo`` hermitian -> full matrix whose lower triangle is valid
    (the distributed drivers read the lower triangle)."""
    a = np.asarray(a)
    if uplo == "U":
        return np.triu(a).conj().T + np.triu(a, 1)
    return a


def dlaf_symmetric_eigensolver(ctx: int, uplo: str, a, desc: DLAF_descriptor):
    """reference ``dlaf_symmetric_eigensolver_{s,d}``: returns (w, z).

    Routes through the registered grid context and the DISTRIBUTED driver
    (reference ``src/c_api/eigensolver/eigensolver.cpp`` always builds the
    Matrix on the ctx grid).
    """
    from ..algos.eigensolver.dist_driver import eigh_dist
    from ..matrix.dist_matrix import DistMatrix
    grid = dlaf_get_grid(ctx)
    dm = DistMatrix.from_global(jnp.asarray(_as_lower(a, uplo)), desc.mb, grid)
    w, v = eigh_dist(dm)
    return np.asarray(w), np.asarray(v.to_global())


def dlaf_hermitian_eigensolver(ctx, uplo, a, desc):
    return dlaf_symmetric_eigensolver(ctx, uplo, a, desc)


def dlaf_symmetric_generalized_eigensolver(ctx: int, uplo: str, a, b,
                                           desc: DLAF_descriptor,
                                           factorized: bool = False):
    """reference ``dlaf_symmetric_generalized_eigensolver[_factorized]_{s,d}``,
    routed through the ctx grid and the distributed driver chain
    (``src/c_api/eigensolver/gen_eigensolver.cpp:1-148``)."""
    from ..algos.eigensolver.dist_driver import eigh_gen_dist
    from ..matrix.dist_matrix import DistMatrix
    grid = dlaf_get_grid(ctx)
    da = DistMatrix.from_global(jnp.asarray(_as_lower(a, uplo)), desc.mb, grid)
    if factorized:
        bl = np.asarray(b) if uplo == "L" else np.asarray(b).conj().T
        db = DistMatrix.from_global(jnp.asarray(bl), desc.mb, grid,
                                    pad_identity=True)
        w, x = eigh_gen_dist(da, db, b_factorized=True)
    else:
        db = DistMatrix.from_global(jnp.asarray(_as_lower(b, uplo)), desc.mb,
                                    grid, pad_identity=True)
        w, x = eigh_gen_dist(da, db)
    return np.asarray(w), np.asarray(x.to_global())


# ScaLAPACK-style aliases (reference dlaf_pspotrf/pdpotrf/pssyevd/...)

def _scalapack_entry(fn, dtype):
    def wrapper(uplo, n, a, ia, ja, desca, ctx, **kw):
        desc = DLAF_descriptor.from_scalapack(desca) \
            if not isinstance(desca, DLAF_descriptor) else desca
        a = np.asarray(a, dtype)
        i0, j0 = ia - 1, ja - 1
        if i0 == 0 and j0 == 0 and n == desc.m:
            return fn(ctx, uplo, a, desc, **kw)
        # tile-aligned sub-matrix offsets (reference DLAF_descriptor i/j,
        # include/dlaf_c/desc.h:16): operate on the (n, n) block at (i0, j0)
        assert i0 % desc.mb == 0 and j0 % desc.nb == 0, \
            "ia/ja must be tile-aligned (reference requires block alignment)"
        assert i0 + n <= desc.m and j0 + n <= desc.n
        sub = np.ascontiguousarray(a[i0:i0 + n, j0:j0 + n])
        subdesc = dataclasses.replace(desc, m=n, n=n, i=i0, j=j0)
        out = fn(ctx, uplo, sub, subdesc, **kw)
        if isinstance(out, np.ndarray) and out.shape == (n, n):
            full = a.copy()
            full[i0:i0 + n, j0:j0 + n] = out
            return full
        return out
    return wrapper


dlaf_pspotrf = _scalapack_entry(dlaf_cholesky_factorization, np.float32)
dlaf_pdpotrf = _scalapack_entry(dlaf_cholesky_factorization, np.float64)
dlaf_pcpotrf = _scalapack_entry(dlaf_cholesky_factorization, np.complex64)
dlaf_pzpotrf = _scalapack_entry(dlaf_cholesky_factorization, np.complex128)
dlaf_pssyevd = _scalapack_entry(dlaf_symmetric_eigensolver, np.float32)
dlaf_pdsyevd = _scalapack_entry(dlaf_symmetric_eigensolver, np.float64)
dlaf_pcheevd = _scalapack_entry(dlaf_hermitian_eigensolver, np.complex64)
dlaf_pzheevd = _scalapack_entry(dlaf_hermitian_eigensolver, np.complex128)


def _sygvd_entry(dtype, factorized=False):
    """Two-matrix ScaLAPACK entry with tile-aligned ia/ja (and optional
    ib/jb) offsets, routed like the potrf/syevd wrappers (reference
    ``dlaf_pssygvd``: per-matrix (i, j, desc) triplets,
    ``include/dlaf_c/eigensolver/gen_eigensolver.h:147-164``)."""

    def wrapper(uplo, n, a, b, ia, ja, desca, ctx, ib=None, jb=None,
                descb=None):
        desc = DLAF_descriptor.from_scalapack(desca) \
            if not isinstance(desca, DLAF_descriptor) else desca
        descb_ = desc if descb is None else (
            DLAF_descriptor.from_scalapack(descb)
            if not isinstance(descb, DLAF_descriptor) else descb)
        a = np.asarray(a, dtype)
        b = np.asarray(b, dtype)

        def sub(x, d, i0, j0):
            if i0 == 0 and j0 == 0 and n == d.m:
                return x, d
            assert i0 % d.mb == 0 and j0 % d.nb == 0, \
                "ia/ja must be tile-aligned (reference requires block alignment)"
            assert i0 + n <= d.m and j0 + n <= d.n
            return (np.ascontiguousarray(x[i0:i0 + n, j0:j0 + n]),
                    dataclasses.replace(d, m=n, n=n, i=i0, j=j0))

        suba, subdesc = sub(a, desc, ia - 1, ja - 1)
        subb, _ = sub(b, descb_, (ib or ia) - 1, (jb or ja) - 1)
        return dlaf_symmetric_generalized_eigensolver(
            ctx, uplo, suba, subb, subdesc, factorized=factorized)

    return wrapper


dlaf_pssygvd = _sygvd_entry(np.float32)
dlaf_pdsygvd = _sygvd_entry(np.float64)
dlaf_pchegvd = _sygvd_entry(np.complex64)
dlaf_pzhegvd = _sygvd_entry(np.complex128)
dlaf_pssygvd_factorized = _sygvd_entry(np.float32, factorized=True)
dlaf_pdsygvd_factorized = _sygvd_entry(np.float64, factorized=True)
dlaf_pchegvd_factorized = _sygvd_entry(np.complex64, factorized=True)
dlaf_pzhegvd_factorized = _sygvd_entry(np.complex128, factorized=True)
