"""Static collective-schedule analysis (deadlock / divergence detector).

The reference ships race-detection tooling in CI (thread sanitizer jobs,
``ci/*san*``; SURVEY.md §5) because its task graph has mutable shared
tiles.  dlaf_jax's SPMD programs cannot data-race — every shard_map body
is a pure function — but they CAN deadlock: a collective (psum,
all_gather, ppermute, ...) must be executed by every rank of its mesh
axis in the same order.  Since one traced program runs on all ranks, the
only way schedules diverge is *rank-dependent control flow around a
collective*:

  * a collective inside one branch of ``lax.cond`` whose predicate
    differs across ranks (e.g. derived from ``jax.lax.axis_index``),
  * a collective inside ``lax.while_loop`` whose trip count differs
    across ranks.

``collective_schedule`` extracts the ordered collective schedule from a
function's jaxpr (recursing through pjit/shard_map/scan/while/cond), and
``check_collective_safety`` flags the two divergence patterns above.
``assert_same_schedule`` additionally proves two call signatures (e.g.
different rank counts of the same algorithm) lower to the same schedule
shape.  Used by tests/test_collective_safety.py across every distributed
algorithm entry point — the structured analog of the reference's
sanitizer lane.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import jax
from jax.extend import core as jcore

# primitive names that imply cross-rank synchronization
COLLECTIVE_PRIMS = {
    "psum", "psum2", "all_gather", "all_to_all", "ppermute", "pmax",
    "pmin", "reduce_scatter", "axis_all_gather", "pbroadcast",
    "psum_invariant",
}

# higher-order primitives whose subjaxprs we walk, with the params key(s)
# holding them
_SUBJAXPR_KEYS = ("jaxpr", "call_jaxpr", "branches", "cond_jaxpr",
                  "body_jaxpr", "fun_jaxpr")


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective in the schedule. ``path`` is the control-flow path
    from the top ('' = straight-line; 'scan/' = inside a scan body;
    'cond[0]/' = inside branch 0 of a cond; 'while/' = in a while body)."""
    path: str
    prim: str
    axes: tuple

    def __str__(self):
        return f"{self.path}{self.prim}{list(self.axes)}"


def _axes_of(params: dict) -> tuple:
    for key in ("axes", "axis_name", "named_axes"):
        if key in params and params[key] is not None:
            ax = params[key]
            if isinstance(ax, (tuple, list, frozenset, set)):
                return tuple(sorted(map(str, ax)))
            return (str(ax),)
    return ()


def _walk(jaxpr, path: str, out: list, conds: dict, whiles: list) -> None:
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in COLLECTIVE_PRIMS:
            out.append(CollectiveOp(path, name, _axes_of(eqn.params)))
            if path.endswith("while/") or "while/" in path:
                whiles.append(out[-1])
            continue
        if name == "cond":
            site = f"{path}cond@{len(conds)}"
            branch_scheds = []
            for i, br in enumerate(eqn.params["branches"]):
                sub: list = []
                _walk(br.jaxpr, f"{path}cond[{i}]/", sub, conds, whiles)
                branch_scheds.append(tuple((op.prim, op.axes,
                                            op.path.split("]/", 1)[-1])
                                           for op in sub))
                out.extend(sub)
            conds[site] = branch_scheds
            continue
        if name == "while":
            _walk(eqn.params["cond_jaxpr"].jaxpr, f"{path}while.cond/",
                  out, conds, whiles)
            _walk(eqn.params["body_jaxpr"].jaxpr, f"{path}while/", out,
                  conds, whiles)
            continue
        if name == "scan":
            _walk(eqn.params["jaxpr"].jaxpr, f"{path}scan/", out, conds,
                  whiles)
            continue
        for key in _SUBJAXPR_KEYS:
            sub_p = eqn.params.get(key)
            if sub_p is None:
                continue
            subs = sub_p if isinstance(sub_p, (tuple, list)) else (sub_p,)
            for s in subs:
                inner = getattr(s, "jaxpr", s)
                if isinstance(inner, jcore.Jaxpr):
                    _walk(inner, path, out, conds, whiles)


def _analyze(fn: Callable, *args, **kwargs):
    jaxpr = jax.make_jaxpr(fn)(*args, **kwargs)
    out: list = []
    conds: dict = {}
    whiles: list = []
    _walk(jaxpr.jaxpr, "", out, conds, whiles)
    return out, conds, whiles


def collective_schedule(fn: Callable, *args, **kwargs) -> list:
    """Ordered list of CollectiveOp in ``fn``'s lowered program (trace
    only; nothing executes)."""
    return _analyze(fn, *args, **kwargs)[0]


def check_collective_safety(fn: Callable, *args, **kwargs) -> list:
    """Returns a list of finding strings; empty = statically
    deadlock-free.

    Findings:
      * ``cond-divergent``: the branches of a ``lax.cond`` contain
        DIFFERENT collective schedules (including one branch having none).
        If the predicate is rank-dependent, ranks deadlock; if it is
        replicated, the program is safe but fragile — hoist the
        collective out of the cond.
      * ``while-collective``: a collective inside a ``lax.while_loop``
        body. Safe only if the trip count is replicated across ranks.
    """
    _, conds, whiles = _analyze(fn, *args, **kwargs)
    findings: list = []
    for op in whiles:
        findings.append(
            f"while-collective: {op} — trip count must be replicated "
            f"across ranks")
    for site, branch_scheds in sorted(conds.items()):
        if any(bs for bs in branch_scheds) and \
                len(set(branch_scheds)) > 1:
            findings.append(
                f"cond-divergent: {site} branches have different "
                f"collective schedules "
                f"{[list(map(str, bs)) for bs in branch_scheds]}")
    return findings


def assert_same_schedule(fn: Callable, argsets: Sequence[tuple],
                         **kwargs) -> Any:
    """Assert every argset lowers ``fn`` to the same collective schedule
    shape (prim+axes sequence, paths ignored). Returns the schedule."""
    ref: Any = None
    for args in argsets:
        sched = [(op.prim, op.axes) for op in
                 collective_schedule(fn, *args, **kwargs)]
        if ref is None:
            ref = sched
        elif sched != ref:
            raise AssertionError(
                f"collective schedule diverges across argsets: {ref} vs "
                f"{sched}")
    return ref
