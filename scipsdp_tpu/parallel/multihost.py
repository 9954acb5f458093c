"""Multi-host branch-and-bound scaffolding.

The reference has no distributed mode at all (SURVEY.md §2.5: the only MPI
symbol is MUMPS's sequential stub).  The scale-out follows
BASELINE.json's north star:

* each host owns a shard of the open-node frontier (partitioned over the network);
* every host runs the same batched device solves on its local chips
  (node-batch + block axes over NVLink, `parallel/mesh.py`);
* incumbent values and global dual bounds synchronize periodically with a
  host-collective (all-gather of (incumbent, best_open_bound) pairs);
* work stealing: hosts with empty frontiers receive node ranges from the
  most loaded host at the next sync point.

This module provides the host-collective layer and the distributed driver.
On a single host it degenerates to `solve_misdp`; multi-host execution uses
`jax.distributed.initialize()` + the process-spanning mesh.  The collective
uses a tiny jitted psum/all-gather over a host-spanning mesh so no extra
transport is needed beyond JAX itself.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import numpy as np

from scipsdp_tpu.models.problem import MISDP
from scipsdp_tpu.utils.config import Settings


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> Tuple[int, int]:
    """Initialize jax.distributed when running multi-host; returns
    (process_index, process_count).  Safe to call single-host."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()


def sync_bounds(incumbent: float, best_open_bound: float,
                nopen: int) -> Tuple[float, float, np.ndarray]:
    """All-gather (incumbent, bound, load) across hosts.

    Returns (global_incumbent, global_dual_bound, per-host open counts).
    Uses a process-spanning all-gather via
    jax.experimental.multihost_utils; on one process it is the identity.
    """
    if jax.process_count() == 1:
        return incumbent, best_open_bound, np.array([nopen])
    from jax.experimental import multihost_utils

    local = np.array([incumbent, best_open_bound, float(nopen)])
    allv = multihost_utils.process_allgather(local)   # (nproc, 3)
    global_inc = float(np.min(allv[:, 0]))
    global_bound = float(np.min(allv[:, 1]))
    return global_inc, global_bound, allv[:, 2].astype(int)


def partition_root(prob: MISDP, nparts: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Split the root box into ``nparts`` disjoint sub-boxes by fixing the
    leading integer variables (static frontier partitioning over hosts).

    For nparts a power of two and enough binary variables this is an exact
    partition; surplus parts get empty (conflicting) boxes.
    """
    parts = [(prob.lb.copy(), prob.ub.copy())]
    ints = [j for j in np.where(prob.integral)[0]
            if prob.ub[j] - prob.lb[j] <= 64]  # bounded integer vars only
    k = 0
    while len(parts) < nparts and k < len(ints):
        j = ints[k]
        newparts = []
        for lb, ub in parts:
            span = ub[j] - lb[j]
            if span < 1:
                newparts.append((lb, ub))
                continue
            mid = np.floor(0.5 * (lb[j] + ub[j]))
            l1, u1 = lb.copy(), ub.copy()
            l2, u2 = lb.copy(), ub.copy()
            u1[j] = mid
            l2[j] = mid + 1
            newparts += [(l1, u1), (l2, u2)]
        parts = newparts
        k += 1
    # pad with empty boxes, truncate extras back into the last part
    while len(parts) < nparts:
        lb = prob.lb.copy()
        ub = prob.ub.copy()
        lb[:] = 1.0
        ub[:] = 0.0   # conflicting: presolved away instantly
        parts.append((lb, ub))
    return parts[:nparts]


class DistributedSync:
    """Lockstep multi-host coordination for the B&B loop.

    `solve_misdp` calls this hook once per loop iteration on EVERY host
    (a barrier: all frontier nodes are at rest).  Each call all-gathers a
    small scalar vector (incumbent value, best open bound, open-node
    count); every ``sync_every``-th call additionally runs a work-stealing
    exchange when some host is idle while another still has open nodes.

    Work stealing protocol (deterministic, computed identically on every
    host from the gathered loads): the most-loaded host donates up to
    ``max_steal`` cut-free nodes, serialized as flat (lb, ub, bound,
    depth) boxes into a fixed-shape buffer; idle hosts take round-robin
    slices of the donated batch.

    Termination: globally done when no host has open nodes at the
    barrier (nothing is in flight at hook time, so the count is exact).
    """

    def __init__(self, nvars: int = -1, sync_every: int = 4,
                 max_steal: int = 8):
        self.nvars = nvars   # informational; the live width comes from ctx
        self.sync_every = max(1, sync_every)
        self.max_steal = max_steal
        self.calls = 0
        self.global_incumbent = np.inf
        self.global_bound = np.inf

    def _allgather(self, vec: np.ndarray) -> np.ndarray:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(vec))

    def __call__(self, ctx) -> bool:
        self.calls += 1
        pid = jax.process_index()
        local = np.array([ctx.incumbent_val, ctx.best_open_bound,
                          float(ctx.nopen),
                          1.0 if getattr(ctx, "stopping", False) else 0.0])
        allv = self._allgather(local)
        ginc = float(np.min(allv[:, 0]))
        self.global_incumbent = ginc
        self.global_bound = float(np.min(
            np.minimum(allv[:, 1], allv[:, 0])))
        if ginc < ctx.incumbent_val - 1e-12:
            ctx.adopt_incumbent(ginc)
        loads = allv[:, 2].astype(int)
        stopped = allv[:, 3] > 0.5
        # done when every host is out of work or has hit its local limit
        if bool(np.all(stopped | (loads == 0))):
            return True

        if self.calls % self.sync_every == 0:
            # receivers: running hosts that are idle; donor: the most
            # loaded host (a stopped host's open nodes are drained by the
            # running ones)
            idle = np.where((loads == 0) & ~stopped)[0]
            donor = int(np.argmax(loads))
            if len(idle) and loads[donor] > 1:
                # node boxes live in the INTERNAL (presolved) variable
                # space, identical on every host because distributed mode
                # disables bound-dependent presolve shrinkage
                m = ctx.nvars
                width = 2 * m + 2
                buf = np.full((self.max_steal, width), np.nan)
                if pid == donor:
                    nodes = ctx.pop_for_donation(
                        min(self.max_steal, int(loads[donor]) // 2))
                    for i, (nlb, nub, nbound, ndepth) in enumerate(nodes):
                        buf[i] = np.concatenate(
                            [nlb, nub, [nbound, float(ndepth)]])
                allbuf = self._allgather(buf)      # (nproc, K, width)
                donated = allbuf[donor]
                valid = ~np.isnan(donated[:, -2])
                take = []
                for i in np.where(valid)[0]:
                    # round-robin over idle hosts
                    tgt = idle[i % len(idle)]
                    if tgt == pid:
                        row = donated[i]
                        take.append((row[:m], row[m:2 * m],
                                     float(row[-2]), int(row[-1])))
                if take:
                    ctx.push_nodes(take)
        return False


def solve_misdp_distributed(prob: MISDP,
                            settings: Optional[Settings] = None,
                            sync_every: int = 4,
                            max_steal: int = 8):
    """Distributed B&B: each process starts on a partition of the root box
    and runs the local `solve_misdp` machinery with a lockstep
    DistributedSync hook — periodic incumbent/dual-bound synchronization
    and dynamic work redistribution when a host's frontier empties
    (the north-star scale-out of SURVEY.md section 2.5; the reference has
    no distributed mode at all).

    Single-process: equivalent to solve_misdp(prob).  The incumbent
    SOLUTION vector lives on the host that found it; every host returns
    the globally reduced objective and dual bound.
    """
    from scipsdp_tpu.core.branchbound import solve_misdp

    pid, nproc = jax.process_index(), jax.process_count()
    if nproc == 1:
        return solve_misdp(prob, settings)

    # stolen node boxes must live in ONE shared variable space: disable
    # the bound-dependent presolve reductions (fixing/aggregation depend
    # on each host's root partition)
    settings = settings or Settings()
    settings = dataclasses.replace(
        settings,
        presolve=dataclasses.replace(settings.presolve, fixvars=False,
                                     aggregate=False))
    lb, ub = partition_root(prob, nproc)[pid]
    sub = dataclasses.replace(prob, lb=lb, ub=ub)
    hook = DistributedSync(prob.nvars, sync_every=sync_every,
                           max_steal=max_steal)
    res = solve_misdp(sub, settings, sync_hook=hook)
    # final reduction of objectives/bounds across hosts
    inc = res.objval if res.objval is not None else np.inf
    ginc, gbound, _ = sync_bounds(
        inc * prob.objsense if res.objval is not None else np.inf,
        res.dual_bound * prob.objsense, res.stats.nodes)
    from scipsdp_tpu.utils.status import SolveStatus
    status = res.status
    if np.isfinite(ginc) and status == SolveStatus.INFEASIBLE:
        # another host holds the incumbent
        status = SolveStatus.OPTIMAL
    return dataclasses.replace(
        res,
        status=status,
        objval=(prob.objsense * ginc if np.isfinite(ginc) else None),
        dual_bound=prob.objsense * gbound,
    )
