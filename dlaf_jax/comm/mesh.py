"""2-D device grid.

Analog of the reference's ``CommunicatorGrid``
(``communication/communicator_grid.h:37``): a ``jax.sharding.Mesh`` with axes
``("r", "c")`` — the row axis plays the role of the column communicator (ranks
sharing a grid column) and vice versa. The reference's per-grid communicator
*pipelines* (round-robin clones serializing collectives) have no equivalent
here: XLA orders collectives by dataflow per channel, which is exactly the
guarantee the pipelines existed to provide.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW_AXIS = "r"  # indexes the grid row coordinate p (tiles i with i % P == p)
COL_AXIS = "c"  # indexes the grid column coordinate q


class Grid:
    """Device grid of shape (P, Q) built over the available devices."""

    def __init__(self, grid_size: Optional[Tuple[int, int]] = None,
                 devices: Optional[Sequence] = None, order: str = "R"):
        """``order`` is the device->(p, q) assignment: "R" lays device k at
        (k // Q, k % Q), "C" at (k % P, k // P) — the reference
        ``dlaf_create_grid`` row/column-major rank orderings
        (``include/dlaf_c/grid.h:31``, ``src/c_api/grid.cpp``)."""
        if order not in ("R", "C"):
            raise ValueError(f"grid order must be 'R' or 'C', got {order!r}")
        devices = list(devices if devices is not None else jax.devices())
        if grid_size is None:
            grid_size = _default_grid(len(devices))
        P_, Q_ = grid_size
        if P_ * Q_ > len(devices):
            raise ValueError(f"grid {grid_size} needs {P_ * Q_} devices, "
                             f"have {len(devices)}")
        dev = np.asarray(devices[:P_ * Q_]).reshape(
            (P_, Q_) if order == "R" else (Q_, P_))
        if order == "C":
            dev = dev.T
        self.mesh = Mesh(dev, (ROW_AXIS, COL_AXIS))
        self.grid_size = (P_, Q_)

    @classmethod
    def multihost(cls, intra_axis: str = ROW_AXIS,
                  devices: Optional[Sequence] = None) -> "Grid":
        """Network-aware grid for multi-process runtimes (the reference is
        MPI-multi-node first, ``communication/init.h:20-35``; on GPU nodes
        the analogous split is NVLink within a host vs the network across
        hosts).

        Arranges the mesh so collectives along ``intra_axis`` stay inside
        one process's devices (NVLink) and only the other axis crosses the
        process boundary (the network). Default ``intra_axis=ROW_AXIS`` because the
        row-axis ``all_gather`` of the solved panel is the highest-volume
        collective in the factorizations (``algos/cholesky.py`` step 4);
        grid shape is (local_device_count, n_processes) — each grid COLUMN
        is one process.
        """
        if intra_axis not in (ROW_AXIS, COL_AXIS):
            raise ValueError(f"intra_axis must be {ROW_AXIS!r} or "
                             f"{COL_AXIS!r}, got {intra_axis!r}")
        devices = list(devices if devices is not None else jax.devices())
        by_proc: dict = {}
        for d in devices:
            by_proc.setdefault(d.process_index, []).append(d)
        counts = {len(v) for v in by_proc.values()}
        if len(counts) != 1:
            raise ValueError("devices per process must be uniform, got "
                             f"{sorted((k, len(v)) for k, v in by_proc.items())}")
        procs = sorted(by_proc)
        nloc, nproc = counts.pop(), len(procs)
        if intra_axis == ROW_AXIS:
            # column q = process q's devices: (nloc, nproc) row-major flat
            flat = [by_proc[procs[q]][p]
                    for p in range(nloc) for q in range(nproc)]
            return cls((nloc, nproc), devices=flat)
        # row p = process p's devices
        flat = [d for pr in procs for d in by_proc[pr]]
        return cls((nproc, nloc), devices=flat)

    @property
    def nr_rows(self) -> int:
        return self.grid_size[0]

    @property
    def nr_cols(self) -> int:
        return self.grid_size[1]

    def canonical_sharding(self) -> NamedSharding:
        """Sharding for canonical (P, Q, lm, ln) shard-layout arrays."""
        return NamedSharding(self.mesh, P(ROW_AXIS, COL_AXIS, None, None))

    def replicated_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    def __repr__(self):
        return f"Grid{self.grid_size}"


def _default_grid(n: int) -> Tuple[int, int]:
    """Most-square (P, Q) with P*Q == n (reference grids are user-chosen;
    miniapps default to squarish)."""
    p = int(np.sqrt(n))
    while n % p:
        p -= 1
    return (p, n // p)
