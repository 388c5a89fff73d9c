"""Worker process for the multi-host (multi-process) test.

Run by tests/test_multihost.py as TWO separate processes, each owning 2
virtual CPU devices, joined via ``jax.distributed.initialize`` — the
single-machine analog of the reference's MPI multi-node bring-up
(``communication/init.h:20-35``, ``src/init.cpp:329-338``; the reference
tests the same way via ``mpiexec -n N`` on one machine,
``cmake/DLAF_AddTest.cmake:151-156``).

Each process:
  - initializes the distributed runtime (coordinator on localhost),
  - builds the global 2x2-grid mesh over all 4 devices,
  - constructs a DistMatrix via ``from_callback`` — each process fills only
    the shards its own devices address (no process ever holds the global
    array of another process's shard),
  - runs the distributed Cholesky,
  - checks ``||A - L L^H||`` on process 0 from the gathered factor.

Usage: python multihost_worker.py <process_id> <num_processes> <port>
"""
import os
import sys

proc_id, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dlaf_jax.cache import configure_compilation_cache  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
configure_compilation_cache(cpu=True)

jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=nprocs, process_id=proc_id)

import numpy as np

import dlaf_jax  # noqa: F401
from dlaf_jax.algos.cholesky import cholesky
from dlaf_jax.comm.mesh import Grid
from dlaf_jax.matrix.dist_matrix import DistMatrix

assert len(jax.devices()) == 2 * nprocs, jax.devices()
assert len(jax.local_devices()) == 2

n, nb = 64, 16
grid = Grid((2, 2))

# rank-independent seeded SPD generator, addressed per global region
# (reference util_matrix.h:299-432 seeds per element so every rank
# generates identical data)
rng = np.random.default_rng(1234)
base = rng.standard_normal((n, n)).astype(np.float32)
spd = base @ base.T + n * np.eye(n, dtype=np.float32)


def cb(index):
    return spd[index]


dm = DistMatrix.from_callback(cb, (n, n), nb, grid, np.float32)
out = cholesky(dm)

# gather the factor across processes for the residual check: fully
# replicate via a jitted identity with replicated out-sharding, then every
# process can read the whole array
from jax.sharding import NamedSharding, PartitionSpec as P

rep = jax.jit(lambda x: x, out_shardings=NamedSharding(grid.mesh, P()))(
    out.data)
from dlaf_jax.dist import gather_from_shards

full = gather_from_shards(np.asarray(jax.device_get(rep)), out.dist)
l = np.tril(np.asarray(full)[:n, :n])
res = np.max(np.abs(l @ l.T - spd))
bound = 100 * n * np.finfo(np.float32).eps * np.max(np.abs(spd))
print(f"[proc {proc_id}] residual {res:.3e} bound {bound:.3e}", flush=True)
assert res <= bound, (res, bound)

# DCN-aware grid: Grid.multihost puts each grid COLUMN inside one process,
# so row-axis collectives (the heavy panel all_gather) never cross the
# process boundary; verify the layout and that cholesky still passes on it
gridm = Grid.multihost()
assert gridm.grid_size == (2, nprocs), gridm.grid_size
import numpy as _np

devm = _np.asarray(gridm.mesh.devices)
for q in range(devm.shape[1]):
    pids = {d.process_index for d in devm[:, q]}
    assert len(pids) == 1, f"grid column {q} spans processes {pids}"
dmm = DistMatrix.from_callback(cb, (n, n), nb, gridm, np.float32)
outm = cholesky(dmm)
repm = jax.jit(lambda x: x, out_shardings=NamedSharding(gridm.mesh, P()))(
    outm.data)
fullm = gather_from_shards(np.asarray(jax.device_get(repm)), outm.dist)
lm = np.tril(np.asarray(fullm)[:n, :n])
resm = np.max(np.abs(lm @ lm.T - spd))
assert resm <= bound, (resm, bound)
print(f"[proc {proc_id}] multihost-grid residual {resm:.3e} OK", flush=True)

# multi-host from_global/to_global: every process passes the same global
# array (replicated-input convention); to_global replicates device-side
# then reads process-locally
dmg = DistMatrix.from_global(spd, nb, grid, pad_identity=True)
outg = cholesky(dmg)
lg = np.tril(np.asarray(outg.to_global()))
resg = np.max(np.abs(lg @ lg.T - spd))
assert resg <= bound, (resg, bound)
rt = np.asarray(dmg.to_global())
assert np.array_equal(rt, spd), "from_global/to_global round-trip"
print(f"[proc {proc_id}] from_global residual {resg:.3e} OK", flush=True)
print(f"[proc {proc_id}] OK", flush=True)
