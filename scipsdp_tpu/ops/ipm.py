"""Batched primal-dual interior-point SDP solver.

This is the batched device replacement for the reference's SDP back-ends
(src/sdpi/sdpisolver_{dsdp,sdpa,mosek}.c) *and* the presolve contract of the
solver-independent interface (SCIPsdpiSolve, src/sdpi/sdpi.c:3123-3650),
fused into one jitted function over a *batch* of SDPs that share problem
data (A, A_0, LP rows) and differ per instance in bounds/objective/cuts —
exactly the shape of branch-and-bound node relaxations.

Problem form (the reference dual form, sdpi.c:37-58), per batch instance:

    min  b^T y
    s.t. Z^k(y) = sum_j A^k_j y_j - A^k_0  >= 0 (PSD)   for blocks k
         G y >= h                                         (LP rows, >=-form)
         l <= y <= u

The *penalty formulation* (sdpisolver.h:237-245; sdpi.c:3437-3599) is built
in structurally: variable index m (the last one) is the penalty variable r
with coefficient matrix I on every block and coefficient 1 on every LP row.
Callers select the mode purely through bounds and objective:

  * direct solve:      lb[m] = ub[m] = 0 (r fixed), b[m] = 0
  * penalty solve:     lb[m] = 0, ub[m] = +inf,     b[m] = Gamma
  * feasibility probe: penalty bounds, b[:m] = 0, b[m] = 1  (Gamma = 1,
    objective zeroed; optimal r > peninfeasadjust*feastol => infeasible,
    sdpi.c:3450-3490)

Algorithm: infeasible-start Mehrotra predictor-corrector with the HKM
direction; Schur complement M_ij = sum_k tr(A_i X A_j S^{-1}) plus diagonal
contributions of LP rows and bounds; per-instance convergence masks so one
batch runs until every instance is done.

Heterogeneous block sizes (SURVEY.md hard part (ii)): blocks are grouped
into *size buckets*, each padded only to its bucket's maximum — the data
and state are tuples of per-bucket arrays, so a problem with one 100x100
block and twenty 5x5 blocks does not pay 400x padded FLOPs on the small
ones.  All shapes stay static; the bucket structure is part of the jit
cache key.

Presolve (vectorized analog of sdpi.c:3190-3275 and prepareLPData
sdpi.c:1131): bound-conflict detection, fixed-variable elimination by
masking, LP rows over fixed variables checked & dropped, single-free-
variable rows converted to bounds, all-variables-fixed instances decided by
a batched eigenvalue check (checkFixedFeasibilitySdp, sdpi.c:1377).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from scipsdp_tpu.models.problem import DenseSDPData
from scipsdp_tpu.ops.eigen import (
    gersh_step_from_ymat,
    max_step_eigh_from_ymat,
    max_step_from_ymat,
    max_step_pos,
    min_eigenvalue,
    sym,
    ymat,
)
from scipsdp_tpu.utils.config import IPMSettings
from scipsdp_tpu.utils.status import SolverResultStatus

INF_THRESH = 1e19  # values beyond this are treated as infinite

# Stage names (jax.named_scope) that profiler reductions attribute device
# time to: W-features, Schur Gram, Cholesky factors, triangular inverses.
STAGES = ("wfeat", "schur_gram", "chol", "tril_inv")


@jax.named_scope("schur_gram")
def _schur_product(Wall: jnp.ndarray) -> jnp.ndarray:
    """M = Wall @ Wall^T per batch element — THE hot matmul of the IPM
    (one batched GEMM)."""
    return jnp.einsum("xif,xjf->xij", Wall, Wall)


@jax.named_scope("wfeat")
def _wfeat_flat(LxOp, A_t, Lsinv_t, B, mp, budget=2**30):
    """W features W_j = LxOp A_j Lsinv^T produced DIRECTLY in the
    flattened (B, mp, K*n*n) layout via an mp-chunked scan.

    The naive two-einsum chain materializes (B, K, mp, n, n)
    intermediates; chunking over mp bounds the peak intermediate at
    (B, K, jc, n, n), about ``budget`` logical bytes at the operands'
    dtype.  Small shapes take the single-chunk path (identical to the
    fused einsum chain)."""
    K, _, n, _ = A_t.shape
    itemsize = jnp.dtype(jnp.result_type(LxOp, A_t)).itemsize
    per_j = B * K * n * n * itemsize
    jc = int(max(1, min(mp, budget // max(per_j, 1))))

    def chunk(Asl):
        P = jnp.einsum("xkba,kjbc->xkjac", LxOp, Asl)
        W = jnp.einsum("xkjab,xkcb->xkjac", P, Lsinv_t)
        return jnp.transpose(W, (0, 2, 1, 3, 4)).reshape(
            B, Asl.shape[1], -1)

    if jc >= mp:
        return chunk(A_t)
    mp_p = -(-mp // jc) * jc
    A_p = jnp.pad(A_t, ((0, 0), (0, mp_p - mp), (0, 0), (0, 0)))
    starts = jnp.arange(mp_p // jc) * jc

    def one(j0):
        return chunk(jax.lax.dynamic_slice_in_dim(A_p, j0, jc, axis=1))

    chunks = jax.lax.map(one, starts)          # (nc, B, jc, F)
    W = jnp.moveaxis(chunks, 0, 1).reshape(B, mp_p, -1)
    return W[:, :mp]


@jax.named_scope("chol")
def _chol(A: jnp.ndarray) -> jnp.ndarray:
    """Batched lower Cholesky.  NaN semantics match potrf (a non-PSD
    input yields NaNs, which the PSD probes test for)."""
    return jnp.linalg.cholesky(A)


@jax.named_scope("tril_inv")
def _tril_inv(L: jnp.ndarray) -> jnp.ndarray:
    """Batched lower-triangular inverse (identity-RHS forward solves)."""
    eye = jnp.broadcast_to(jnp.eye(L.shape[-1], dtype=L.dtype), L.shape)
    return jax.scipy.linalg.solve_triangular(L, eye, lower=True)


@dataclasses.dataclass(frozen=True)
class IPMData:
    """Static (per-problem) device arrays for the batched solver.

    Per-bucket tuples: bucket t holds K_t blocks padded to size n_t;
    mp = nvars + 1 variables, index ``nvars`` being the structural penalty
    variable r; p LP rows in >=-form (at least one row; a trivially-true
    dummy is added if the problem has none).
    """

    A: Tuple[jnp.ndarray, ...]        # per bucket (K_t, mp, n_t, n_t)
    C: Tuple[jnp.ndarray, ...]        # per bucket (K_t, n_t, n_t)
    dimmask: Tuple[jnp.ndarray, ...]  # per bucket (K_t, n_t) bool
    G: jnp.ndarray        # (p, mp)    penalty column = 1
    h: jnp.ndarray        # (p,)
    b_base: jnp.ndarray   # (mp,) objective with b[m] = 0
    nvars: int            # m (without penalty var)
    ndim_sdp: int         # total real SDP dimensions (for mu)
    block_of: Tuple[Tuple[int, int], ...]  # original block k -> (bucket, idx)

    def tree_flatten(self):
        return ((self.A, self.C, self.dimmask, self.G, self.h, self.b_base),
                (self.nvars, self.ndim_sdp, self.block_of))

    @classmethod
    def tree_unflatten(cls, aux, children):
        A, C, dimmask, G, h, b_base = children
        return cls(A, C, dimmask, G, h, b_base, aux[0], aux[1], aux[2])

    @property
    def nbuckets(self) -> int:
        return len(self.A)


jax.tree_util.register_pytree_node(
    IPMData, IPMData.tree_flatten, IPMData.tree_unflatten
)


def _bucketize(sizes, max_buckets: int = 4):
    """Group block sizes into at most ``max_buckets`` buckets; returns a
    list of (bucket_padded_size, [block indices])."""
    order = sorted(set(int(s) for s in sizes))
    # merge smallest-gap neighbors until within budget
    groups = [[s] for s in order]
    while len(groups) > max_buckets:
        # merging two buckets pads the smaller one up: merge where the
        # wasted (padded - real)^~ area is smallest
        costs = [groups[i + 1][-1] - groups[i][0]
                 for i in range(len(groups) - 1)]
        i = int(np.argmin(costs))
        groups[i] = groups[i] + groups[i + 1]
        del groups[i + 1]
    out = []
    for g in groups:
        cap = g[-1]
        idxs = [k for k, s in enumerate(sizes) if int(s) in g]
        out.append((cap, idxs))
    return out


def build_ipm_data(dense: DenseSDPData, dtype=jnp.float64,
                   max_buckets: int = 4) -> IPMData:
    """Bucket blocks by size, append the structural penalty variable, and
    pad degenerate shapes."""
    m = dense.nvars
    mp = m + 1

    sizes = [int(s) for s in dense.blocksizes]
    if not sizes:
        buckets = [(1, [])]
    else:
        buckets = _bucketize(sizes, max_buckets)

    A_t, C_t, mask_t = [], [], []
    block_of = [None] * len(sizes)
    for t, (cap, idxs) in enumerate(buckets):
        Kt = max(len(idxs), 1)
        A = np.zeros((Kt, mp, cap, cap))
        C = np.zeros((Kt, cap, cap))
        dm = np.zeros((Kt, cap), dtype=bool)
        for slot, k in enumerate(idxs):
            nk = sizes[k]
            A[slot, :m, :nk, :nk] = dense.A[k][:, :nk, :nk]
            C[slot, :nk, :nk] = dense.C[k][:nk, :nk]
            dm[slot, :nk] = True
            block_of[k] = (t, slot)
        # padding diagonal of C is -1 so the slack block gets +1 there
        for slot in range(Kt):
            for d in range(cap):
                if not dm[slot, d]:
                    C[slot, d, d] = -1.0
            # penalty variable: identity on real dims
            A[slot, m] = np.diag(dm[slot].astype(np.float64))
        A_t.append(jnp.asarray(A, dtype))
        C_t.append(jnp.asarray(C, dtype))
        mask_t.append(jnp.asarray(dm))

    p = dense.G.shape[0]
    if p == 0:
        G = np.zeros((1, mp))
        h = np.array([-1.0])  # trivially satisfied dummy row
    else:
        G = np.concatenate([dense.G, np.ones((p, 1))], axis=1)
        h = dense.h.copy()

    ndim_sdp = int(sum(int(np.asarray(mk).sum()) for mk in mask_t))
    return IPMData(
        A=tuple(A_t),
        C=tuple(C_t),
        dimmask=tuple(mask_t),
        G=jnp.asarray(G, dtype),
        h=jnp.asarray(h, dtype),
        b_base=jnp.asarray(np.concatenate([dense.obj, [0.0]]), dtype),
        nvars=m,
        ndim_sdp=max(ndim_sdp, 1),
        block_of=tuple(bo if bo is not None else (0, 0) for bo in block_of),
    )


class PresolveOut(NamedTuple):
    lb: jnp.ndarray        # (B, mp) tightened
    ub: jnp.ndarray
    fix: jnp.ndarray       # (B, mp) bool
    fixval: jnp.ndarray    # (B, mp)
    lbmask: jnp.ndarray    # (B, mp) finite-and-free lower bound rows
    ubmask: jnp.ndarray
    rowmask: jnp.ndarray   # (B, P) active rows (LP rows ++ cut rows)
    conflict: jnp.ndarray  # (B,) bool
    allfixed: jnp.ndarray  # (B,) bool
    fixed_feasible: jnp.ndarray  # (B,) bool (valid when allfixed)


@jax.named_scope("ipm_presolve")
def presolve(data: IPMData, Gall, hall, rowvalid, lb, ub, feastol, epsfix,
             rounds: int) -> PresolveOut:
    """Vectorized SDPI presolve (sdpi.c:3190-3275, prepareLPData:1131).

    Operates on the unified per-node row system ``Gall`` (B, P, mp) /
    ``hall`` (B, P): the problem's static LP rows broadcast over the batch
    followed by per-node cut rows (eigenvector cuts, rank-1 cuts, ...).
    """
    B = lb.shape[0]
    Gnz = (Gall != 0)
    rowmask = rowvalid
    conflict = jnp.zeros((B,), dtype=bool)
    barange = jnp.arange(B)[:, None]

    for _ in range(rounds):
        fin_lb = lb > -INF_THRESH
        fin_ub = ub < INF_THRESH
        conflict = conflict | jnp.any(lb > ub + feastol, axis=1)
        fix = fin_lb & fin_ub & (ub - lb <= epsfix)
        fixval = jnp.where(fix, 0.5 * (lb + ub), 0.0)
        free = ~fix
        nfree = jnp.einsum("xpm,xm->xp", Gnz.astype(lb.dtype),
                           free.astype(lb.dtype))
        rowconst = jnp.einsum("xpm,xm->xp", Gall, fixval)
        # rows with all variables fixed: check & drop (sdpi.c bound conflicts)
        rows0 = rowmask & (nfree < 0.5)
        unsat = rows0 & (rowconst < hall - feastol)
        conflict = conflict | jnp.any(unsat, axis=1)
        rowmask = rowmask & ~rows0
        # rows with exactly one free variable -> bound (prepareLPData)
        rows1 = rowmask & (nfree > 0.5) & (nfree < 1.5)
        jstar = jnp.argmax(Gnz & free[:, None, :], axis=2)   # (B, P)
        g = jnp.take_along_axis(Gall, jstar[:, :, None], axis=2)[:, :, 0]
        newb = (hall - rowconst) / jnp.where(jnp.abs(g) > 0, g, 1.0)
        cand_lb = jnp.where(rows1 & (g > 0), newb, -jnp.inf)
        cand_ub = jnp.where(rows1 & (g < 0), newb, jnp.inf)
        lb = lb.at[barange, jstar].max(cand_lb)
        ub = ub.at[barange, jstar].min(cand_ub)
        rowmask = rowmask & ~rows1

    fin_lb = lb > -INF_THRESH
    fin_ub = ub < INF_THRESH
    conflict = conflict | jnp.any(lb > ub + feastol, axis=1)
    fix = fin_lb & fin_ub & (ub - lb <= epsfix)
    fixval = jnp.where(fix, 0.5 * (lb + ub), 0.0)
    allfixed = jnp.all(fix, axis=1)

    # all-fixed feasibility by eigenvalue check (checkFixedFeasibilitySdp)
    fixed_feasible = jnp.ones((B,), dtype=bool)
    for t in range(data.nbuckets):
        Zf = jnp.einsum("kjab,xj->xkab", data.A[t], fixval) - data.C[t][None]
        lam = min_eigenvalue(Zf, data.dimmask[t][None, :, :])   # (B, K_t)
        fixed_feasible = fixed_feasible & jnp.all(lam >= -feastol, axis=1)

    return PresolveOut(
        lb=lb,
        ub=ub,
        fix=fix,
        fixval=fixval,
        lbmask=fin_lb & ~fix,
        ubmask=fin_ub & ~fix,
        rowmask=rowmask,
        conflict=conflict,
        allfixed=allfixed,
        fixed_feasible=fixed_feasible,
    )


class IPMState(NamedTuple):
    y: jnp.ndarray                  # (B, mp)
    X: Tuple[jnp.ndarray, ...]      # per bucket (B, K_t, n_t, n_t)
    S: Tuple[jnp.ndarray, ...]
    xl: jnp.ndarray    # (B, P)
    sl: jnp.ndarray    # (B, P)
    xlb: jnp.ndarray   # (B, mp)
    slb: jnp.ndarray   # (B, mp)
    xub: jnp.ndarray   # (B, mp)
    sub: jnp.ndarray   # (B, mp)
    it: jnp.ndarray    # ()
    done: jnp.ndarray  # (B,)
    converged: jnp.ndarray  # (B,)
    failed: jnp.ndarray     # (B,)
    best_merit: jnp.ndarray  # (B,) best progress merit seen
    stall: jnp.ndarray       # (B,) iterations without progress
    nan32: jnp.ndarray       # (B,) f32/refine direction NaN'd: instance
    #                          is NOT failed — the precision pick escapes
    #                          to the f64 branch instead (per-solve tier
    #                          escalation, sdpisolver_sdpa.cpp:1416-1441)
    esc: jnp.ndarray         # (B,) STALLED in the fast (f32/refine) tier
    #                          and escalated to the stable (f64) tier —
    #                          sticky until done; a second stall there
    #                          fails the instance (the reference's
    #                          fast->stable settings escalation)


class SolveOutput(NamedTuple):
    status: jnp.ndarray     # (B,) int32 SolverResultStatus
    dobj: jnp.ndarray       # (B,) objective b^T y (incl. Gamma*r)
    y: jnp.ndarray          # (B, mp)
    r: jnp.ndarray          # (B,) penalty variable value
    gap: jnp.ndarray        # (B,) complementarity gap
    pinf: jnp.ndarray       # (B,) stationarity residual (scaled)
    dinf: jnp.ndarray       # (B,) constraint residual (scaled)
    iters: jnp.ndarray      # () iterations used by the batch
    X: Tuple[jnp.ndarray, ...]  # per-bucket primal blocks
    xl: jnp.ndarray         # (B, P) row primal multipliers (LP ++ cuts)
    xlb: jnp.ndarray        # (B, mp) lower-bound multipliers (dual fixing!)
    xub: jnp.ndarray        # (B, mp) upper-bound multipliers
    # pre-optimal snapshot (settings.preopt_gap > 0): first iterate whose
    # relative gap fell below preopt_gap — the more-interior warmstart
    # point the reference captures (sdpisolver_sdpa.cpp:1612-1618)
    y_pre: Optional[jnp.ndarray] = None       # (B, mp)
    X_pre: Optional[Tuple[jnp.ndarray, ...]] = None
    has_pre: Optional[jnp.ndarray] = None     # (B,) bool


def ipm_solve(
    data: IPMData,
    b: jnp.ndarray,       # (B, mp) objective incl. penalty coefficient
    lb: jnp.ndarray,      # (B, mp)
    ub: jnp.ndarray,      # (B, mp)
    Gcut: jnp.ndarray = None,     # (B, q, mp) per-node cut rows  Gcut y >= hcut
    hcut: jnp.ndarray = None,     # (B, q)
    cutvalid: jnp.ndarray = None,  # (B, q) bool
    warm_y: jnp.ndarray = None,   # (B, mp) parent dual solution (warmstart)
    warm_mask: jnp.ndarray = None,  # (B,) bool: rows with valid warm_y
    gaptol_vec: jnp.ndarray = None,  # (B,) per-instance gap tolerance (the
    #                                  penalty ladder shrinks it toward
    #                                  min_gaptol, sdpi.c:3497-3599)
    warm_X: Tuple[jnp.ndarray, ...] = None,  # per-bucket (B, K_t, n, n)
    #                                  parent primal matrices (fillStartX,
    #                                  relax_sdp.c:2959-3049)
    ip_point: Tuple[jnp.ndarray, Tuple[jnp.ndarray, ...]] = None,
    #                                  (y_ip (mp,), X_ip per-bucket
    #                                  (K_t, n, n)) root analytic centers:
    #                                  warmstartiptype=2 convex-combines
    #                                  the projected parent point with them
    #                                  instead of the scaled identity
    #                                  (relax_sdp.c:2820-2945,5589)
    feastol_vec: jnp.ndarray = None,  # (B,) per-instance CONVERGENCE
    #                                  feastol override — the
    #                                  feastol-tightened re-solve rung
    #                                  after an independent solution-check
    #                                  failure (INFEASFEASTOLCHANGE,
    #                                  sdpisolver_dsdp.c:66,1549)
    *,
    settings: IPMSettings,
) -> SolveOutput:
    """Solve a batch of SDPs. All shapes static; call under jit."""
    if settings.dtype == "float32":
        # an f32 solve is compared against f64 references: keep its
        # matmuls in true f32 (no TF32 on GPU tensor cores)
        with jax.default_matmul_precision("float32"):
            return _ipm_solve(data, b, lb, ub, Gcut, hcut, cutvalid, warm_y,
                              warm_mask, gaptol_vec, warm_X, ip_point,
                              feastol_vec, settings=settings)
    return _ipm_solve(data, b, lb, ub, Gcut, hcut, cutvalid, warm_y,
                      warm_mask, gaptol_vec, warm_X, ip_point, feastol_vec,
                      settings=settings)


def _ipm_solve(data, b, lb, ub, Gcut, hcut, cutvalid, warm_y, warm_mask,
               gaptol_vec, warm_X, ip_point, feastol_vec, *,
               settings: IPMSettings) -> SolveOutput:
    dtype = jnp.float64 if settings.dtype == "float64" else jnp.float32
    b = b.astype(dtype)
    lb = lb.astype(dtype)
    ub = ub.astype(dtype)
    B, mp = b.shape
    NB = data.nbuckets
    feastol = settings.feastol
    gaptol = (settings.gaptol if gaptol_vec is None
              else gaptol_vec.astype(dtype))

    def bmap(fn):
        """Apply fn(bucket_index) for every bucket, returning a tuple."""
        return tuple(fn(t) for t in range(NB))

    def bsum(vals):
        """Sum a tuple of (B,) arrays."""
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out

    # unified per-node row system: static LP rows ++ per-node cuts
    Gs = jnp.broadcast_to(data.G[None], (B,) + data.G.shape)
    hs = jnp.broadcast_to(data.h[None], (B, data.G.shape[0]))
    valids = jnp.ones((B, data.G.shape[0]), dtype=bool)
    if Gcut is not None:
        Gall = jnp.concatenate([Gs, Gcut.astype(dtype)], axis=1)
        hall = jnp.concatenate([hs, hcut.astype(dtype)], axis=1)
        rowvalid = jnp.concatenate([valids, cutvalid], axis=1)
    else:
        Gall, hall, rowvalid = Gs, hs, valids

    pre = presolve(data, Gall, hall, rowvalid, lb, ub, feastol,
                   settings.epsilon, settings.presolve_rounds)

    pad_diag = bmap(lambda t: data.dimmask[t][None, :, :])       # (1,K_t,n_t)
    pad_outer = bmap(lambda t: pad_diag[t][..., :, None]
                     & pad_diag[t][..., None, :])
    eyen = bmap(lambda t: jnp.eye(data.A[t].shape[-1], dtype=dtype))
    eye_active = bmap(lambda t: eyen[t][None, None]
                      * pad_diag[t][..., None] * pad_diag[t][..., None, :])

    nu = (
        jnp.full((B,), float(data.ndim_sdp), dtype)
        + jnp.sum(pre.rowmask, axis=1)
        + jnp.sum(pre.lbmask, axis=1)
        + jnp.sum(pre.ubmask, axis=1)
    )
    nu = jnp.maximum(nu, 1.0)

    def blockmap_y(y):
        """Z_t(y) = sum_j A_j y_j - A_0 per bucket."""
        return bmap(lambda t: jnp.einsum("kjab,xj->xkab", data.A[t], y)
                    - data.C[t][None])

    # ---- initial point ----------------------------------------------------
    two = pre.lbmask & pre.ubmask
    y0 = jnp.where(two, 0.5 * (pre.lb + pre.ub), 0.0)
    y0 = jnp.where(pre.lbmask & ~pre.ubmask, jnp.maximum(pre.lb + 1.0, 0.0), y0)
    y0 = jnp.where(pre.ubmask & ~pre.lbmask, jnp.minimum(pre.ub - 1.0, 0.0), y0)
    y0 = jnp.where(pre.fix, pre.fixval, y0)
    if warm_y is not None:
        # warmstart (relax_sdp.c determineWarmStartInformation semantics,
        # warmstartproject=2: project the parent solution into the child's
        # bounds with a strict-interior margin)
        span = jnp.where(two, pre.ub - pre.lb, 2.0)
        margin = 0.05 * span
        yw = jnp.clip(warm_y.astype(dtype),
                      jnp.where(pre.lbmask, pre.lb + margin, -jnp.inf),
                      jnp.where(pre.ubmask, pre.ub - margin, jnp.inf))
        wm = (warm_mask if warm_mask is not None
              else jnp.ones((B,), bool))[:, None]
        y0 = jnp.where(pre.fix, pre.fixval, jnp.where(wm, yw, y0))

    Z0 = blockmap_y(y0)
    normb = jnp.max(jnp.abs(b), axis=1)
    # initial-point scale: exclude the penalty objective coefficient Gamma
    # (b[m]) — a large Gamma must not blow up X0/S0 (lambda* heuristic,
    # sdpisolver_sdpa.cpp lambdastar)
    normb_orig = jnp.max(jnp.abs(b[:, : data.nvars]), axis=1) if data.nvars > 0 \
        else jnp.zeros((B,), dtype)
    normZ0 = bsum(bmap(lambda t: jnp.max(
        jnp.abs(jnp.where(pad_outer[t], Z0[t], 0.0)), axis=(1, 2, 3))))
    normh = jnp.max(jnp.abs(jnp.where(pre.rowmask, hall, 0.0)), axis=1)
    scale = settings.init_point_scale * jnp.maximum(
        1.0, jnp.maximum(normb_orig, jnp.maximum(normZ0, normh))
    )  # (B,)
    xi = scale[:, None, None, None]
    X0 = bmap(lambda t: xi * eyen[t][None, None]
              * jnp.ones((B, data.A[t].shape[0], 1, 1), dtype))
    S0 = X0
    if warm_y is not None:
        # dual slack matrix from the projected parent point, floored on
        # the PSD cone and convex-combined with an interior target
        # (fillStartZ, relax_sdp.c:2649-2954): iptype=1 scaled identity,
        # iptype=2 the root analytic center (``ip_point``), factor =
        # warmstartipfactor
        f = settings.warmstartipfactor
        wmk = (warm_mask if warm_mask is not None
               else jnp.ones((B,), bool))[:, None, None, None]

        def psd_floor(t, Mt, floor_rel):
            """Project onto the PSD cone with a relative eigenvalue floor
            (the WARMSTART_MINVAL role, relax_sdp.c:107-112)."""
            lamW, VW = jnp.linalg.eigh(
                jnp.where(pad_outer[t], Mt, eyen[t][None, None] * xi))
            lfloor = floor_rel * jnp.maximum(
                1.0, jnp.max(jnp.abs(lamW), axis=-1, keepdims=True))
            lamWp = jnp.maximum(lamW, lfloor)
            proj = jnp.einsum("xkae,xke,xkbe->xkab", VW, lamWp, VW)
            return jnp.where(pad_outer[t], proj, eyen[t][None, None] * xi)

        if ip_point is not None:
            # analytic-center targets: S_ip = Z(y_ip), X_ip as provided,
            # both floored into the interior
            y_ip, X_ip = ip_point
            Zip = bmap(lambda t: jnp.einsum(
                "kjab,j->kab", data.A[t], y_ip.astype(dtype))
                - data.C[t])
            S_tgt = bmap(lambda t: psd_floor(
                t, jnp.broadcast_to(Zip[t][None], Z0[t].shape), 1e-2))
            X_tgt = bmap(lambda t: psd_floor(
                t, jnp.broadcast_to(X_ip[t][None].astype(dtype),
                                    X0[t].shape), 1e-2))
        else:
            S_tgt = X0     # scaled identity
            X_tgt = X0

        def warm_S(t):
            Zproj = psd_floor(t, Z0[t], 1e-3)
            S0w = (1.0 - f) * Zproj + f * S_tgt[t]
            return sym(jnp.where(wmk, S0w, S0[t]))

        S0 = bmap(warm_S)

        if warm_X is not None:
            # fillStartX (relax_sdp.c:2959-3049): same treatment for the
            # stored parent primal
            def warm_Xf(t):
                Xproj = psd_floor(t, sym(warm_X[t].astype(dtype)), 1e-3)
                X0w = (1.0 - f) * Xproj + f * X_tgt[t]
                return sym(jnp.where(wmk, X0w, X0[t]))

            X0 = bmap(warm_Xf)
    sl0 = jnp.where(pre.rowmask,
                    jnp.maximum(jnp.einsum("xpm,xm->xp", Gall, y0) - hall,
                                scale[:, None]),
                    1.0)
    xl0 = jnp.where(pre.rowmask, scale[:, None], 0.0)
    slb0 = jnp.where(pre.lbmask, jnp.maximum(y0 - pre.lb, 1.0), 1.0)
    sub0 = jnp.where(pre.ubmask, jnp.maximum(pre.ub - y0, 1.0), 1.0)
    xlb0 = jnp.where(pre.lbmask, scale[:, None], 0.0)
    xub0 = jnp.where(pre.ubmask, scale[:, None], 0.0)

    done0 = pre.conflict | pre.allfixed
    st0 = IPMState(
        y=y0, X=X0, S=S0, xl=xl0, sl=sl0, xlb=xlb0, slb=slb0, xub=xub0,
        sub=sub0, it=jnp.asarray(0, jnp.int32), done=done0,
        converged=jnp.zeros((B,), bool), failed=jnp.zeros((B,), bool),
        best_merit=jnp.full((B,), jnp.inf, dtype),
        stall=jnp.zeros((B,), jnp.int32),
        nan32=jnp.zeros((B,), bool),
        esc=jnp.zeros((B,), bool),
    )

    cmax = bmap(lambda t: jnp.max(jnp.abs(data.C[t])))
    datascale = 1.0 + jnp.maximum(jnp.max(jnp.stack(cmax)),
                                  jnp.max(jnp.abs(data.h)))
    free_outer = (~pre.fix)[:, :, None] & (~pre.fix)[:, None, :]

    # mixed-precision direction phase (IPMSettings.phase32): while every
    # active instance's relative gap is above phase32_switch, all O(n^3)
    # direction kernels run in f32 against the exact f64 residuals
    # (inexact Newton); the endgame runs full f64.  The f32 shadow of the
    # static data is cast once, outside the loop.  "refine" additionally
    # assembles RHS/recoveries in f64 and iteratively refines the Schur
    # solve, pushing the f64 handoff from phase32_switch (1e-3) down to
    # refine_switch.
    use_refine = settings.phase32 == "refine" and dtype == jnp.float64
    use_lite = settings.phase32 == "lite" and dtype == jnp.float64
    use_phase32 = (settings.phase32 == "on" and dtype == jnp.float64) \
        or use_refine or use_lite
    if use_phase32:
        A32 = bmap(lambda t: data.A[t].astype(jnp.float32))
        G32 = Gall.astype(jnp.float32)

    class EvalOut(NamedTuple):
        Rp: Tuple[jnp.ndarray, ...]   # dual-infeasibility residual Z(y)-S
        rpl: jnp.ndarray
        rplb: jnp.ndarray
        rpub: jnp.ndarray
        rd: jnp.ndarray               # stationarity residual
        gap: jnp.ndarray
        relgap: jnp.ndarray
        pinf: jnp.ndarray
        dinf: jnp.ndarray
        conv: jnp.ndarray

    def comp_gap(st: IPMState):
        gsdp = bsum(bmap(lambda t: jnp.sum(
            jnp.where(pad_outer[t], st.X[t] * st.S[t], 0.0), axis=(1, 2, 3))))
        return (
            gsdp
            + jnp.sum(jnp.where(pre.rowmask, st.xl * st.sl, 0.0), axis=1)
            + jnp.sum(jnp.where(pre.lbmask, st.xlb * st.slb, 0.0), axis=1)
            + jnp.sum(jnp.where(pre.ubmask, st.xub * st.sub, 0.0), axis=1)
        )

    _PROBE_MULTS = (1.0, 2.0, 4.0, 8.0, 16.0)

    def probe_ladder_scaled(Yxs, Yss, gp, gd):
        """step_rule="probe": certified PSD max-steps from ONE stacked f32
        Cholesky probing a geometric candidate ladder above the Gershgorin
        base — in the SCALED space: X + a dX >= 0  <=>  I + a Y >= 0 with
        Y = L^{-1} dX L^{-T}, which stays well-conditioned in f32 even
        near convergence where cond(X) ~ 1/mu made the direct-space probe
        NaN spuriously (advisor r3).  The PSD segment
        {a >= 0 : I + a Y >= 0} is an interval containing 0, so any
        candidate whose probe factorizes certifies every smaller step too;
        the largest passing candidate is within 2x of the exact max-step.
        Replaces the power iteration + two full probe rounds with a
        single stacked factorization per bucket."""
        f32p = jnp.float32
        capv = 1.0 / settings.tau
        nc = len(_PROBE_MULTS)
        cp = [jnp.minimum(gp * mlt, capv).astype(f32p)
              for mlt in _PROBE_MULTS]
        cd = [jnp.minimum(gd * mlt, capv).astype(f32p)
              for mlt in _PROBE_MULTS]
        okx = [jnp.ones((B,), bool) for _ in range(nc)]
        oks = [jnp.ones((B,), bool) for _ in range(nc)]
        for t in range(NB):
            Yx = Yxs[t].astype(f32p)
            Ys = Yss[t].astype(f32p)
            Kt = Yx.shape[1]
            eyep = jnp.eye(Yx.shape[-1], dtype=f32p)
            # certify with a PSD margin: factor I(1-delta) + aY, so a
            # trial passes only when lambda_min(I + aY) > delta — robust
            # to f32 rounding differences between Cholesky
            # implementations (a borderline spurious pass certifies a
            # too-large step and NaNs the next iterate)
            eyem = (1.0 - 1e-5) * eyep
            trials = [eyem + cp[k][:, None, None, None] * Yx
                      for k in range(nc)]
            trials += [eyem + cd[k][:, None, None, None] * Ys
                       for k in range(nc)]
            Lp = _chol(jnp.concatenate(trials, axis=1))
            nanb = jnp.any(jnp.isnan(Lp), axis=(2, 3))   # (B, 2*nc*Kt)
            for k in range(nc):
                okx[k] = okx[k] & ~jnp.any(
                    nanb[:, k * Kt:(k + 1) * Kt], axis=1)
                off = (nc + k) * Kt
                oks[k] = oks[k] & ~jnp.any(
                    nanb[:, off:off + Kt], axis=1)
        # largest passing candidate wins; if even the certified Gershgorin
        # base fails the f32 factorization (marginal), shrink it
        ap = (0.4 * gp).astype(f32p)
        ad = (0.4 * gd).astype(f32p)
        for k in range(nc):
            ap = jnp.where(okx[k], cp[k], ap)
            ad = jnp.where(oks[k], cd[k], ad)
        return ap, ad

    def probe_steps(Lxinv, Lsinv, dX, dS, cast32=False):
        """PSD max-steps for step_rule="probe": ONE congruence per bucket
        yields both the Gershgorin base (certified) and the scaled
        directions the ladder probes — the psd_steps congruence and the
        probe trials share their work."""
        Yxs, Yss, gx, gs_ = [], [], [], []
        for t in range(NB):
            dXt = dX[t].astype(jnp.float32) if cast32 else dX[t]
            dSt = dS[t].astype(jnp.float32) if cast32 else dS[t]
            Yb = ymat(jnp.concatenate([Lxinv[t], Lsinv[t]], axis=1),
                      jnp.concatenate([dXt, dSt], axis=1))
            Kt = dX[t].shape[1]
            stp = gersh_step_from_ymat(Yb)
            gx.append(jnp.min(stp[:, :Kt], axis=1))
            gs_.append(jnp.min(stp[:, Kt:], axis=1))
            Yxs.append(Yb[:, :Kt])
            Yss.append(Yb[:, Kt:])
        gp = jnp.min(jnp.stack(gx), axis=0)
        gd = jnp.min(jnp.stack(gs_), axis=0)
        return probe_ladder_scaled(Yxs, Yss, gp, gd)

    def evaluate(st: IPMState) -> EvalOut:
        """Residuals + duality gap + per-instance convergence (always f64;
        computed ONCE per iteration on the new state and carried, so the
        next iteration's direction solve reuses it)."""
        yh = jnp.where(pre.fix, pre.fixval, st.y)
        Z = blockmap_y(yh)
        Rp = bmap(lambda t: jnp.where(pad_outer[t], Z[t] - st.S[t], 0.0))
        Gy = jnp.einsum("xpm,xm->xp", Gall, yh)
        rpl = jnp.where(pre.rowmask, Gy - hall - st.sl, 0.0)
        rplb = jnp.where(pre.lbmask, (yh - pre.lb) - st.slb, 0.0)
        rpub = jnp.where(pre.ubmask, (pre.ub - yh) - st.sub, 0.0)
        AstarX = bsum(bmap(lambda t: jnp.einsum("kjab,xkba->xj", data.A[t],
                                                st.X[t])))
        rd = (b - AstarX - jnp.einsum("xpm,xp->xm", Gall, st.xl)
              - st.xlb + st.xub)
        rd = jnp.where(pre.fix, 0.0, rd)
        gap = comp_gap(st)
        dobj = jnp.sum(b * yh, axis=1)
        # explicit primal (Lagrange-dual) objective of the reduced problem
        # with fixed variables folded into the constant data:
        #   pobj = <A_0eff, X> + h_eff.xl + l.xlb - u.xub + sum_fix b_j f_j
        CX = bsum(bmap(lambda t: jnp.sum(
            jnp.where(pad_outer[t], data.C[t][None] * st.X[t], 0.0),
            axis=(1, 2, 3))))
        GTxl = jnp.einsum("xpm,xp->xm", Gall, st.xl)
        hxl = jnp.sum(jnp.where(pre.rowmask, hall * st.xl, 0.0), axis=1)
        lxlb = jnp.sum(jnp.where(pre.lbmask, pre.lb * st.xlb, 0.0), axis=1)
        uxub = jnp.sum(jnp.where(pre.ubmask, pre.ub * st.xub, 0.0), axis=1)
        fixcorr = jnp.sum(
            jnp.where(pre.fix, pre.fixval * (AstarX + GTxl - b), 0.0), axis=1
        )
        pobj = CX + hxl + lxlb - uxub - fixcorr
        pinf = jnp.max(jnp.abs(rd), axis=1) / (1.0 + normb)
        dinf_sdp = bmap(lambda t: jnp.max(jnp.abs(Rp[t]), axis=(1, 2, 3)))
        dinf = jnp.maximum(
            jnp.max(jnp.stack(dinf_sdp), axis=0),
            jnp.maximum(
                jnp.max(jnp.abs(rpl), axis=1),
                jnp.maximum(jnp.max(jnp.abs(rplb), axis=1),
                            jnp.max(jnp.abs(rpub), axis=1)),
            ),
        ) / datascale
        relgap = gap / (1.0 + jnp.abs(dobj))
        # strong-duality check: guards against spurious convergence when a
        # huge objective scale (e.g. penalty Gamma) makes the scaled
        # residual tolerances too lax (role of the reference's independent
        # sdpsolchecker re-verification, sdpsolchecker.c:58)
        dualgap = jnp.abs(dobj - pobj) / (
            1.0 + jnp.maximum(jnp.abs(dobj), jnp.abs(pobj))
        )
        ftv = (feastol if feastol_vec is None
               else feastol_vec.astype(pinf.dtype))
        conv = (
            (pinf <= ftv) & (dinf <= ftv)
            & (relgap <= gaptol) & (dualgap <= 10.0 * gaptol)
        )
        return EvalOut(Rp=Rp, rpl=rpl, rplb=rplb, rpub=rpub, rd=rd, gap=gap,
                       relgap=relgap, pinf=pinf, dinf=dinf, conv=conv)

    # profiler attribution (named_scope shows up as tf_op in device traces)
    evaluate = jax.named_scope("ev64")(evaluate)
    probe_steps = jax.named_scope("probe_step")(probe_steps)

    def cond(carry):
        st, _ = carry
        return (st.it < settings.max_iters) & ~jnp.all(st.done)

    def iter_products(st: IPMState, ev: EvalOut, dtp):
        """One Mehrotra predictor-corrector direction + step-length pass
        with every factorization/solve/matmul in dtype ``dtp``.

        Per bucket, ONE stacked Cholesky + ONE stacked triangular inverse
        cover both X and S; the Schur factor is inverted explicitly so
        both direction solves and all PSD max-step rules become batched
        matmuls (ops/eigen.ymat)."""
        f32 = dtp == jnp.float32
        if f32:
            # reduced-precision matmul passes (TF32 on GPU tensor cores)
            # are far too coarse for Newton directions (NaN within a few
            # iterations): force true-f32 accumulation
            with jax.default_matmul_precision("float32"):
                return _iter_products_impl(st, ev, dtp)
        return _iter_products_impl(st, ev, dtp)

    def _iter_products_impl(st: IPMState, ev: EvalOut, dtp):
        f32 = dtp == jnp.float32
        Ad = A32 if f32 else data.A
        Gd = G32 if f32 else Gall

        def cast(a):
            return a.astype(dtp)

        X = bmap(lambda t: cast(st.X[t]))
        S = bmap(lambda t: cast(st.S[t]))
        xl, sl = cast(st.xl), cast(st.sl)
        xlb, slb = cast(st.xlb), cast(st.slb)
        xub, sub = cast(st.xub), cast(st.sub)
        Rp = bmap(lambda t: cast(ev.Rp[t]))
        rpl, rplb = cast(ev.rpl), cast(ev.rplb)
        rpub, rd = cast(ev.rpub), cast(ev.rd)
        mu = cast(ev.gap) / cast(nu)
        eyed = bmap(lambda t: jnp.eye(data.A[t].shape[-1], dtype=dtp))
        eye_act = bmap(lambda t: eyed[t][None, None]
                       * pad_diag[t][..., None] * pad_diag[t][..., None, :])
        eye_mp = jnp.eye(mp, dtype=dtp)

        def chol_inv(t):
            Kt = X[t].shape[1]
            both = jnp.concatenate([X[t], S[t]], axis=1)   # (B, 2K, n, n)
            L = _chol(both)
            Linv = _tril_inv(L)
            return (L[:, :Kt], L[:, Kt:], Linv[:, :Kt], Linv[:, Kt:])

        LXS = bmap(chol_inv)
        Lx = tuple(v[0] for v in LXS)
        Ls = tuple(v[1] for v in LXS)
        Lxinv = tuple(v[2] for v in LXS)
        Lsinv = tuple(v[3] for v in LXS)
        Sinv = bmap(lambda t: sym(jnp.einsum("xkba,xkbc->xkac",
                                             Lsinv[t], Lsinv[t])))

        # Schur complement M_ij = sum_k tr(A_i X A_j S^{-1}) — the
        # reference hot loop (Schur assembly inside DSDP/SDPA per IPM
        # iteration).  Factorized form: W_j = Lx^T A_j Ls^{-T} gives
        # M = sum_{t,k} <W_i, W_j>_F; LP/cut rows contribute
        # G^T diag(xl/sl) G = Wg^T Wg — everything stacks into one feature
        # axis and the whole Schur complement is ONE batched matmul.
        def wfeat(t):
            # W_j = Lx^T A_j Ls^{-T}, emitted flat (mp-chunked at large
            # shapes — see _wfeat_flat; the 'xkba' spec transposes Lx)
            return _wfeat_flat(Lx[t], Ad[t], Lsinv[t], B, mp)

        wl = jnp.where(pre.rowmask, xl / sl, 0.0)
        Wg = jnp.sqrt(wl)[:, :, None] * Gd                 # (B, P, mp)
        Wall = jnp.concatenate(
            list(bmap(wfeat)) + [jnp.swapaxes(Wg, 1, 2)], axis=2)
        M = _schur_product(Wall)
        wlb = jnp.where(pre.lbmask, xlb / slb, 0.0)
        wub = jnp.where(pre.ubmask, xub / sub, 0.0)
        M = M + (wlb + wub)[:, :, None] * eye_mp[None]
        # fixed variables: identity row/col, dy = 0
        M = jnp.where(free_outer, M, 0.0)
        M = M + (pre.fix.astype(dtp))[:, :, None] * eye_mp[None]
        chol_reg = settings.chol_reg if not f32 else max(
            settings.chol_reg, 1e-9)
        reg = chol_reg * (1.0 + jnp.max(jnp.abs(M), axis=(1, 2)))
        M = M + reg[:, None, None] * eye_mp[None]
        if f32:
            # Jacobi equilibration: near convergence the Schur diagonal
            # spans many orders of magnitude (diverging bound
            # multipliers); cond(D M D) << cond(M) is what lets the f32
            # factorization carry the solve far below the 1e-3 wall
            dM = jnp.maximum(jnp.einsum("xii->xi", M), 1e-30)
            dsc = 1.0 / jnp.sqrt(dM)
            Ms = M * dsc[:, :, None] * dsc[:, None, :]
            Lm = _chol(Ms)
            Lminv = _tril_inv(Lm)
            Minv = (jnp.einsum("xba,xbc->xac", Lminv, Lminv)
                    * dsc[:, :, None] * dsc[:, None, :])
        else:
            Lm = _chol(M)
            Lminv = _tril_inv(Lm)
            Minv = jnp.einsum("xba,xbc->xac", Lminv, Lminv)  # Lm^-T Lm^-1

        lite = f32 and settings.phase32 == "lite"
        if lite:
            # "lite" refinement: f32 assembly throughout, but the Schur
            # back-solve is polished by f64 residual passes against the
            # exact Gram of the f32 features (f64 matvecs only — the
            # cheap slice of the full "refine" branch)
            f64 = jnp.float64
            Wall64 = Wall.astype(f64)
            diag64 = (wlb + wub).astype(f64)
            reg64 = reg.astype(f64)

        def solve_dy(rhs):
            dy = jnp.einsum("xij,xj->xi", Minv, rhs)
            if not lite:
                return dy
            rhs64 = jnp.where(pre.fix, 0.0, rhs.astype(jnp.float64))
            dy = dy.astype(jnp.float64)
            for _ in range(max(int(settings.schur_refine), 0)):
                vf = jnp.where(pre.fix, 0.0, dy)
                wt = jnp.einsum("xif,xi->xf", Wall64, vf)
                u = (jnp.einsum("xif,xf->xi", Wall64, wt)
                     + diag64 * vf + reg64[:, None] * vf)
                r = rhs64 - jnp.where(pre.fix, 0.0, u)
                dy = dy + jnp.einsum("xij,xj->xi", Minv,
                                     r.astype(dtp)).astype(jnp.float64)
            return jnp.where(pre.fix, 0.0, dy).astype(dtp)

        def direction(Rc, rcl, rclb, rcub):
            PsiSinv = bmap(lambda t: jnp.einsum(
                "xkab,xkbc->xkac",
                Rc[t] - jnp.einsum("xkab,xkbc->xkac", X[t], Rp[t]),
                Sinv[t]))
            rhs = (
                bsum(bmap(lambda t: jnp.einsum("kjab,xkba->xj", Ad[t],
                                               PsiSinv[t])))
                + jnp.einsum("xpm,xp->xm", Gd,
                             jnp.where(pre.rowmask,
                                       (rcl - xl * rpl) / sl, 0.0))
                + jnp.where(pre.lbmask, (rclb - xlb * rplb) / slb, 0.0)
                - jnp.where(pre.ubmask, (rcub - xub * rpub) / sub, 0.0)
                - rd
            )
            rhs = jnp.where(pre.fix, 0.0, rhs)
            dy = solve_dy(rhs)
            dS = bmap(lambda t: jnp.where(
                pad_outer[t],
                jnp.einsum("kjab,xj->xkab", Ad[t], dy) + Rp[t],
                0.0))
            dsl = jnp.where(pre.rowmask,
                            jnp.einsum("xpm,xm->xp", Gd, dy) + rpl, 0.0)
            dslb = jnp.where(pre.lbmask, dy + rplb, 0.0)
            dsub = jnp.where(pre.ubmask, -dy + rpub, 0.0)
            dX = bmap(lambda t: jnp.where(pad_outer[t], sym(jnp.einsum(
                "xkab,xkbc->xkac",
                Rc[t] - jnp.einsum("xkab,xkbc->xkac", X[t], dS[t]),
                Sinv[t])), 0.0))
            dxl = jnp.where(pre.rowmask, (rcl - xl * dsl) / sl, 0.0)
            dxlb = jnp.where(pre.lbmask, (rclb - xlb * dslb) / slb, 0.0)
            dxub = jnp.where(pre.ubmask, (rcub - xub * dsub) / sub, 0.0)
            return dy, dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub

        if settings.step_rule == "power":
            def psd_ymat_step(Y):
                return max_step_from_ymat(Y)
        elif settings.step_rule in ("gershgorin", "probe"):
            psd_ymat_step = gersh_step_from_ymat
        else:
            psd_ymat_step = max_step_eigh_from_ymat

        def psd_steps(dX, dS, step_fn):
            """min over blocks of the X- and S-side PSD max-steps, with the
            X/S congruence transforms stacked into one kernel sequence."""
            apv, adv = [], []
            for t in range(NB):
                Yb = ymat(jnp.concatenate([Lxinv[t], Lsinv[t]], axis=1),
                          jnp.concatenate([dX[t], dS[t]], axis=1))
                stp = step_fn(Yb)
                Kt = dX[t].shape[1]
                apv.append(jnp.min(stp[:, :Kt], axis=1))
                adv.append(jnp.min(stp[:, Kt:], axis=1))
            return (jnp.min(jnp.stack(apv), axis=0),
                    jnp.min(jnp.stack(adv), axis=0))

        def steplens(dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub, step_fn,
                     psd=None):
            ap, ad = psd_steps(dX, dS, step_fn) if psd is None else psd
            ap = jnp.minimum(ap, max_step_pos(xl, dxl, pre.rowmask))
            ap = jnp.minimum(ap, max_step_pos(xlb, dxlb, pre.lbmask))
            ap = jnp.minimum(ap, max_step_pos(xub, dxub, pre.ubmask))
            ad = jnp.minimum(ad, max_step_pos(sl, dsl, pre.rowmask))
            ad = jnp.minimum(ad, max_step_pos(slb, dslb, pre.lbmask))
            ad = jnp.minimum(ad, max_step_pos(sub, dsub, pre.ubmask))
            return ap, ad

        XS = bmap(lambda t: jnp.einsum("xkab,xkbc->xkac", X[t], S[t]))
        # predictor (affine scaling)
        Rc_a = bmap(lambda t: jnp.where(pad_outer[t], -XS[t], 0.0))
        rcl_a = jnp.where(pre.rowmask, -xl * sl, 0.0)
        rclb_a = jnp.where(pre.lbmask, -xlb * slb, 0.0)
        rcub_a = jnp.where(pre.ubmask, -xub * sub, 0.0)
        da = direction(Rc_a, rcl_a, rclb_a, rcub_a)
        dy_a, dX_a, dS_a, dxl_a, dsl_a, dxlb_a, dslb_a, dxub_a, dsub_a = da
        # the affine step lengths only feed Mehrotra's sigma estimate, so
        # the cheap conservative Gershgorin bound replaces the exact PSD
        # max-step here regardless of step rule
        ap_a, ad_a = steplens(dX_a, dS_a, dxl_a, dsl_a, dxlb_a, dslb_a,
                              dxub_a, dsub_a, gersh_step_from_ymat)
        ap_a = jnp.minimum(ap_a, 1.0)
        ad_a = jnp.minimum(ad_a, 1.0)

        # Mehrotra centering parameter
        apx = ap_a[:, None, None, None]
        adx = ad_a[:, None, None, None]
        gap = cast(ev.gap)
        gap_sdp_a = bsum(bmap(lambda t: jnp.sum(jnp.where(
            pad_outer[t],
            (X[t] + apx * dX_a[t]) * (S[t] + adx * dS_a[t]), 0.0),
            axis=(1, 2, 3))))
        gap_a = (
            gap_sdp_a
            + jnp.sum(jnp.where(pre.rowmask,
                                (xl + ap_a[:, None] * dxl_a)
                                * (sl + ad_a[:, None] * dsl_a), 0.0), axis=1)
            + jnp.sum(jnp.where(pre.lbmask,
                                (xlb + ap_a[:, None] * dxlb_a)
                                * (slb + ad_a[:, None] * dslb_a), 0.0), axis=1)
            + jnp.sum(jnp.where(pre.ubmask,
                                (xub + ap_a[:, None] * dxub_a)
                                * (sub + ad_a[:, None] * dsub_a), 0.0), axis=1)
        )
        sigma = jnp.clip(
            (jnp.maximum(gap_a, 0.0) / jnp.maximum(gap, 1e-30)) ** 3,
            settings.sigma_min, 1.0)

        # corrector
        smu = (sigma * mu)[:, None, None, None]
        Rc_c = bmap(lambda t: jnp.where(
            pad_outer[t],
            smu * eye_act[t] - XS[t]
            - jnp.einsum("xkab,xkbc->xkac", dX_a[t], dS_a[t]),
            0.0))
        rcl_c = jnp.where(pre.rowmask,
                          sigma[:, None] * mu[:, None] - xl * sl
                          - dxl_a * dsl_a, 0.0)
        rclb_c = jnp.where(pre.lbmask,
                           sigma[:, None] * mu[:, None] - xlb * slb
                           - dxlb_a * dslb_a, 0.0)
        rcub_c = jnp.where(pre.ubmask,
                           sigma[:, None] * mu[:, None] - xub * sub
                           - dxub_a * dsub_a, 0.0)
        dc = direction(Rc_c, rcl_c, rclb_c, rcub_c)
        dy, dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub = dc
        psd_pair = None
        if settings.step_rule == "probe":
            app, adp = probe_steps(Lxinv, Lsinv, dX, dS)
            psd_pair = (app.astype(dtp), adp.astype(dtp))
        ap, ad = steplens(dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub,
                          psd_ymat_step, psd=psd_pair)
        # NOTE: an adaptive fraction-to-boundary rule (tau -> 0.98 once the
        # relative gap is small) was measured NET NEGATIVE here:
        # example_small 30->63 iterations with extra recovery-ladder rungs
        # (aggressive tail steps destabilize instances in the same batch)
        ap = jnp.minimum(settings.tau * ap, 1.0)
        ad = jnp.minimum(settings.tau * ad, 1.0)

        if settings.step_rule == "power":
            # the power estimate can overshoot the PSD boundary: probe the
            # stepped matrices with a (stacked) Cholesky and shrink
            # offending steps
            for _ in range(2):
                okx = jnp.ones((B,), bool)
                oks = jnp.ones((B,), bool)
                for t in range(NB):
                    Kt = dX[t].shape[1]
                    probe = jnp.concatenate(
                        [X[t] + ap[:, None, None, None] * dX[t],
                         S[t] + ad[:, None, None, None] * dS[t]], axis=1)
                    Lp = _chol(probe)
                    nan_half = jnp.any(jnp.isnan(Lp), axis=(2, 3))
                    okx = okx & ~jnp.any(nan_half[:, :Kt], axis=1)
                    oks = oks & ~jnp.any(nan_half[:, Kt:], axis=1)
                ap = jnp.where(okx, ap, 0.4 * ap)
                ad = jnp.where(oks, ad, 0.4 * ad)

        f64 = jnp.float64 if dtype == jnp.float64 else dtype

        def up(a):
            return a.astype(f64)

        return (up(dy), tuple(up(v) for v in dX), tuple(up(v) for v in dS),
                up(dxl), up(dsl), up(dxlb), up(dslb), up(dxub), up(dsub),
                up(ap), up(ad))

    iter_products = jax.named_scope("prod_plain")(iter_products)

    def iter_products_refine(st: IPMState, ev: EvalOut):
        """f32-factorization / f64-assembly Mehrotra pass ("refine" mode).

        Factor-class kernels (Cholesky, triangular inverse, W features,
        Schur Gram, step-rule congruences/probes) run in f32 (true f32:
        the scope below keeps TF32 out).  Everything whose
        ACCURACY the Newton step depends on near convergence stays f64:
        the corrector targets (X S products at size ~mu), the RHS built
        from the carried f64 residuals, the dS/dX recoveries, and the
        Schur solve — refined to f64 accuracy by ``schur_refine`` passes
        of (f64 residual matvec -> f32 back-solve) against the f32
        feature Gram + regularization, i.e. classical mixed-precision
        iterative refinement with the f32 factor as preconditioner."""
        f32 = jnp.float32
        with jax.default_matmul_precision("float32"):
            X32 = bmap(lambda t: st.X[t].astype(f32))
            S32 = bmap(lambda t: st.S[t].astype(f32))

            def chol_inv(t):
                Kt = X32[t].shape[1]
                both = jnp.concatenate([X32[t], S32[t]], axis=1)
                # Jacobi equilibration before the f32 factorization:
                # production-size blocks (n ~ 129) span diagonal ranges
                # beyond f32 Cholesky's comfort and NaN'd on nearly every
                # cls_64 node (round 5).  Any factor basis serves the
                # congruences downstream — X = Lx Lx^T is all they need —
                # so factor D B D (cond(DBD) << cond(B)) and fold D into
                # the returned inverse factor: B^-1 = D Lm^-T Lm^-1 D.
                dg = jnp.sqrt(jnp.clip(
                    jnp.einsum("xkaa->xka", both), 1e-30, None))
                dinv = 1.0 / dg
                scaled = both * dinv[..., :, None] * dinv[..., None, :]
                # NOTE an f32 NaN here (cond beyond f32 even equilibrated,
                # typically near convergence or under penalty divergence)
                # is handled by the nan32 one-iteration f64 repair in
                # ``body``.  Both a floored-f32 refactor and an exact f64
                # factor cast to f32 were tried instead: the affected
                # instances stall either way — they need the f64
                # downstream (Schur/W/recovery) too.
                L = _chol(scaled)
                Linv = _tril_inv(L) * dinv[..., None, :]
                return (Linv[:, :Kt], Linv[:, Kt:])

            chol_inv = jax.named_scope("rf_cholinv")(chol_inv)
            LXS = bmap(chol_inv)
            Lxinv = tuple(v[0] for v in LXS)
            Lsinv = tuple(v[1] for v in LXS)
            Sinv32 = bmap(lambda t: sym(jnp.einsum(
                "xkba,xkbc->xkac", Lsinv[t], Lsinv[t])))
            Sinv64 = bmap(lambda t: Sinv32[t].astype(dtype))

            # exact f64 contractions.  Sinv is f32-VALUED
            # (preconditioner-quality inverse); exactness is only needed in
            # the cancelling products/sums.
            def mm_f64(a, b):
                return jnp.einsum("...ab,...bc->...ac", a.astype(dtype),
                                  b.astype(dtype))

            def astar_f64(P):
                return bsum(bmap(lambda t: jnp.einsum(
                    "kjab,xkba->xj", data.A[t], P[t])))

            def aapply_f64(dy):
                return bmap(lambda t: jnp.einsum(
                    "kjab,xj->xkab", data.A[t], dy))

            def gt_f64(w):
                return jnp.einsum("xpm,xp->xm", Gall, w)

            def grow_f64(dy):
                return jnp.einsum("xpm,xm->xp", Gall, dy)

            # W features + Schur Gram in f32 (the FLOP-heavy kernels)
            def wfeat(t):
                # Lx^T A_j Ls^{-T}: Lx = inv(Lxinv), but only the PRODUCT
                # matters; use Lxinv^{-1} implicitly via X32 = Lx Lx^T:
                # W_j = Lx^T A_j Ls^{-T} and M_ij = <W_i, W_j> equals
                # tr(A_i X A_j S^{-1}); compute via X32 A_j Ls^{-T} paired
                # against Ls^{-1} A_i ... instead keep the round-2 form:
                # P = Lx^T A_j, needing Lx.  Recover Lx from Lxinv by one
                # triangular inverse?  Cheaper: W'_j = Lxinv X32 A_j
                # Ls^{-T} = Lx^T A_j Ls^{-T} exactly (Lxinv X = Lx^T).
                LxT = jnp.einsum("xkab,xkbc->xkac", Lxinv[t], X32[t])
                # mp-chunked flat emission (see _wfeat_flat); LxT enters
                # the 'xkba' slot transposed so the product is LxT A_j
                return _wfeat_flat(jnp.swapaxes(LxT, -1, -2), A32[t],
                                   Lsinv[t], B, mp)

            wl64 = jnp.where(pre.rowmask, st.xl / st.sl, 0.0)
            wlb64 = jnp.where(pre.lbmask, st.xlb / st.slb, 0.0)
            wub64 = jnp.where(pre.ubmask, st.xub / st.sub, 0.0)
            Wg = jnp.sqrt(wl64).astype(f32)[:, :, None] * G32
            Wall = jnp.concatenate(
                list(bmap(wfeat)) + [jnp.swapaxes(Wg, 1, 2)], axis=2)
            M = _schur_product(Wall)
            eye_mp32 = jnp.eye(mp, dtype=f32)
            M = M + (wlb64 + wub64).astype(f32)[:, :, None] * eye_mp32[None]
            M = jnp.where(free_outer, M, 0.0)
            M = M + (pre.fix.astype(f32))[:, :, None] * eye_mp32[None]
            # f32-safe regularization: the factor is only a preconditioner
            # (the refinement target includes the same shift, so the
            # system actually solved is the proximally-regularized Newton
            # system — standard for IPM Schur complements)
            reg32 = max(settings.chol_reg, 1e-7)
            reg = reg32 * (1.0 + jnp.max(jnp.abs(M), axis=(1, 2)))
            M = M + reg[:, None, None] * eye_mp32[None]
            # Jacobi equilibration before the f32 factorization: near
            # convergence the Schur diagonal spans many orders of
            # magnitude (diverging bound multipliers), and cond(D M D)
            # << cond(M) is what keeps the f32-preconditioned refinement
            # contracting
            dM = jnp.maximum(jnp.einsum("xii->xi", M), 1e-30)
            dsc = 1.0 / jnp.sqrt(dM)
            Ms = M * dsc[:, :, None] * dsc[:, None, :]
            Lm = _chol(Ms)
            Lminv = _tril_inv(Lm)
            Minv = jnp.einsum("xba,xbc->xac", Lminv, Lminv)
            dsc64 = dsc.astype(dtype)

            diag64 = wlb64 + wub64
            reg64 = reg.astype(dtype)
            Wall64 = Wall.astype(dtype)

            def mv_M(vf):
                wt = jnp.einsum("xif,xi->xf", Wall64, vf)
                return (jnp.einsum("xif,xf->xi", Wall64, wt)
                        + diag64 * vf + reg64[:, None] * vf)

            def precond(r64):
                """f32 back-solve through the equilibrated factor."""
                v = (dsc64 * r64).astype(f32)
                u = jnp.einsum("xij,xj->xi", Minv, v).astype(dtype)
                return dsc64 * u

            def schur_solve(rhs):
                """(M_tilde + reg I) dy = rhs to f64 accuracy: f32
                preconditioned solve + f64 residual refinement against the
                exact Gram of the f32 features."""
                rhsf = jnp.where(pre.fix, 0.0, rhs)
                dy = precond(rhsf)
                for _ in range(max(int(settings.schur_refine), 0)):
                    vf = jnp.where(pre.fix, 0.0, dy)
                    u = mv_M(vf)
                    r = rhsf - jnp.where(pre.fix, 0.0, u)
                    dy = dy + precond(r)
                return jnp.where(pre.fix, 0.0, dy)

            schur_solve = jax.named_scope("rf_schur_solve")(schur_solve)

            # X * Rp is direction-independent: hoisted out of direction()
            XRp = bmap(lambda t: mm_f64(st.X[t], ev.Rp[t]))
            def direction(Rc, rcl, rclb, rcub):
                """Newton direction with exact assembly/recovery (inputs
                and outputs f64; only the Schur back-solve passes through
                f32)."""
                PsiSinv = bmap(lambda t: mm_f64(Rc[t] - XRp[t],
                                                Sinv32[t]))
                rhs = (
                    astar_f64(PsiSinv)
                    + gt_f64(jnp.where(pre.rowmask,
                                       (rcl - st.xl * ev.rpl) / st.sl,
                                       0.0))
                    + jnp.where(pre.lbmask,
                                (rclb - st.xlb * ev.rplb) / st.slb, 0.0)
                    - jnp.where(pre.ubmask,
                                (rcub - st.xub * ev.rpub) / st.sub, 0.0)
                    - ev.rd
                )
                dy = schur_solve(jnp.where(pre.fix, 0.0, rhs))
                dSr = aapply_f64(dy)
                dS = bmap(lambda t: jnp.where(
                    pad_outer[t], dSr[t] + ev.Rp[t], 0.0))
                dsl = jnp.where(pre.rowmask, grow_f64(dy) + ev.rpl, 0.0)
                dslb = jnp.where(pre.lbmask, dy + ev.rplb, 0.0)
                dsub = jnp.where(pre.ubmask, -dy + ev.rpub, 0.0)
                # dX recovery stays exact: an f32 recovery was measured to
                # break convergence across the testset (the recovered
                # primal must track the size-mu complementarity targets)
                dX = bmap(lambda t: jnp.where(pad_outer[t], sym(mm_f64(
                    Rc[t] - mm_f64(st.X[t], dS[t]),
                    Sinv32[t])), 0.0))
                dxl = jnp.where(pre.rowmask, (rcl - st.xl * dsl) / st.sl,
                                0.0)
                dxlb = jnp.where(pre.lbmask,
                                 (rclb - st.xlb * dslb) / st.slb, 0.0)
                dxub = jnp.where(pre.ubmask,
                                 (rcub - st.xub * dsub) / st.sub, 0.0)
                return dy, dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub

            direction = jax.named_scope("rf_direction")(direction)

            if settings.step_rule == "power":
                psd_ymat_step = max_step_from_ymat
            elif settings.step_rule in ("gershgorin", "probe"):
                psd_ymat_step = gersh_step_from_ymat
            else:
                psd_ymat_step = max_step_eigh_from_ymat

            def psd_steps(dX, dS, step_fn):
                """f32 congruence transforms + step rule (errors only cost
                slight step conservatism; tau and the probes guard)."""
                apv, adv = [], []
                for t in range(NB):
                    Yb = ymat(jnp.concatenate([Lxinv[t], Lsinv[t]], axis=1),
                              jnp.concatenate([dX[t].astype(f32),
                                               dS[t].astype(f32)], axis=1))
                    stp = step_fn(Yb)
                    Kt = dX[t].shape[1]
                    apv.append(jnp.min(stp[:, :Kt], axis=1))
                    adv.append(jnp.min(stp[:, Kt:], axis=1))
                return (jnp.min(jnp.stack(apv), axis=0).astype(dtype),
                        jnp.min(jnp.stack(adv), axis=0).astype(dtype))

            def steplens(dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub, step_fn,
                         psd=None):
                ap, ad = psd_steps(dX, dS, step_fn) if psd is None else psd
                ap = jnp.minimum(ap, max_step_pos(st.xl, dxl, pre.rowmask))
                ap = jnp.minimum(ap, max_step_pos(st.xlb, dxlb, pre.lbmask))
                ap = jnp.minimum(ap, max_step_pos(st.xub, dxub, pre.ubmask))
                ad = jnp.minimum(ad, max_step_pos(st.sl, dsl, pre.rowmask))
                ad = jnp.minimum(ad, max_step_pos(st.slb, dslb,
                                                  pre.lbmask))
                ad = jnp.minimum(ad, max_step_pos(st.sub, dsub,
                                                  pre.ubmask))
                return ap, ad

            XS = bmap(lambda t: mm_f64(st.X[t], st.S[t]))
            Rc_a = bmap(lambda t: jnp.where(pad_outer[t], -XS[t], 0.0))
            rcl_a = jnp.where(pre.rowmask, -st.xl * st.sl, 0.0)
            rclb_a = jnp.where(pre.lbmask, -st.xlb * st.slb, 0.0)
            rcub_a = jnp.where(pre.ubmask, -st.xub * st.sub, 0.0)
            da = direction(Rc_a, rcl_a, rclb_a, rcub_a)
            (dy_a, dX_a, dS_a, dxl_a, dsl_a, dxlb_a, dslb_a, dxub_a,
             dsub_a) = da
            ap_a, ad_a = steplens(dX_a, dS_a, dxl_a, dsl_a, dxlb_a,
                                  dslb_a, dxub_a, dsub_a,
                                  gersh_step_from_ymat)
            ap_a = jnp.minimum(ap_a, 1.0)
            ad_a = jnp.minimum(ad_a, 1.0)

            apx = ap_a[:, None, None, None]
            adx = ad_a[:, None, None, None]
            gap = ev.gap
            mu = ev.gap / nu
            gap_sdp_a = bsum(bmap(lambda t: jnp.sum(jnp.where(
                pad_outer[t],
                (st.X[t] + apx * dX_a[t]) * (st.S[t] + adx * dS_a[t]),
                0.0), axis=(1, 2, 3))))
            gap_a = (
                gap_sdp_a
                + jnp.sum(jnp.where(pre.rowmask,
                                    (st.xl + ap_a[:, None] * dxl_a)
                                    * (st.sl + ad_a[:, None] * dsl_a),
                                    0.0), axis=1)
                + jnp.sum(jnp.where(pre.lbmask,
                                    (st.xlb + ap_a[:, None] * dxlb_a)
                                    * (st.slb + ad_a[:, None] * dslb_a),
                                    0.0), axis=1)
                + jnp.sum(jnp.where(pre.ubmask,
                                    (st.xub + ap_a[:, None] * dxub_a)
                                    * (st.sub + ad_a[:, None] * dsub_a),
                                    0.0), axis=1)
            )
            sigma = jnp.clip(
                (jnp.maximum(gap_a, 0.0) / jnp.maximum(gap, 1e-30)) ** 3,
                settings.sigma_min, 1.0)

            smu = (sigma * mu)[:, None, None, None]
            Rc_c = bmap(lambda t: jnp.where(
                pad_outer[t],
                smu * eye_active[t] - XS[t]
                - mm_f64(dX_a[t], dS_a[t]),
                0.0))
            rcl_c = jnp.where(pre.rowmask,
                              sigma[:, None] * mu[:, None] - st.xl * st.sl
                              - dxl_a * dsl_a, 0.0)
            rclb_c = jnp.where(pre.lbmask,
                               sigma[:, None] * mu[:, None]
                               - st.xlb * st.slb - dxlb_a * dslb_a, 0.0)
            rcub_c = jnp.where(pre.ubmask,
                               sigma[:, None] * mu[:, None]
                               - st.xub * st.sub - dxub_a * dsub_a, 0.0)
            dc = direction(Rc_c, rcl_c, rclb_c, rcub_c)
            dy, dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub = dc
            psd_pair = None
            if settings.step_rule == "probe":
                app, adp = probe_steps(Lxinv, Lsinv, dX, dS, cast32=True)
                psd_pair = (app.astype(dtype), adp.astype(dtype))
            ap, ad = steplens(dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub,
                              psd_ymat_step, psd=psd_pair)
            ap = jnp.minimum(settings.tau * ap, 1.0)
            ad = jnp.minimum(settings.tau * ad, 1.0)

            # Gondzio multiple centrality correctors: reuse the factored
            # Schur complement to pull outlier complementarity products
            # toward [beta_min, beta_max] * sigma*mu, accepting per
            # instance only when the step lengths actually improve
            # (Gondzio 1996; each extra corrector costs one direction()
            # — einsums only, no new factorization)
            for _ in range(max(int(settings.gondzio), 0)):
                aptv = jnp.minimum(ap + 0.1, 1.0)
                adtv = jnp.minimum(ad + 0.1, 1.0)
                apt = aptv[:, None, None, None]
                adt = adtv[:, None, None, None]
                tgt = (sigma * mu)
                bmin, bmax = 0.1, 10.0

                def cor_term(prod, lo, hi):
                    return jnp.clip(prod, lo, hi) - prod

                Rc_g = bmap(lambda t: jnp.where(
                    pad_outer[t],
                    # trial-point complementarity, symmetrized target
                    cor_term(mm_f64(
                        st.X[t] + apt * dX[t], st.S[t] + adt * dS[t]),
                        (bmin * tgt)[:, None, None, None]
                        * eye_active[t],
                        (bmax * tgt)[:, None, None, None]
                        * eye_active[t]),
                    0.0))
                trial_l = (st.xl + aptv[:, None] * dxl) \
                    * (st.sl + adtv[:, None] * dsl)
                rcl_g = jnp.where(pre.rowmask, cor_term(
                    trial_l, bmin * tgt[:, None], bmax * tgt[:, None]),
                    0.0)
                trial_lb = (st.xlb + aptv[:, None] * dxlb) \
                    * (st.slb + adtv[:, None] * dslb)
                rclb_g = jnp.where(pre.lbmask, cor_term(
                    trial_lb, bmin * tgt[:, None], bmax * tgt[:, None]),
                    0.0)
                trial_ub = (st.xub + aptv[:, None] * dxub) \
                    * (st.sub + adtv[:, None] * dsub)
                rcub_g = jnp.where(pre.ubmask, cor_term(
                    trial_ub, bmin * tgt[:, None], bmax * tgt[:, None]),
                    0.0)
                dg = direction(Rc_g, rcl_g, rclb_g, rcub_g)
                cur = (dy, dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub)
                cand = tuple(
                    jax.tree_util.tree_map(lambda a, b: a + b, x, g)
                    for x, g in zip(cur, dg))
                (dy2, dX2, dS2, dxl2, dsl2, dxlb2, dslb2, dxub2,
                 dsub2) = cand
                # the acceptance comparison must judge the corrected
                # direction by the SAME step rule as the current one —
                # comparing Gershgorin-rule steps against probe-certified
                # steps (up to 16x larger) made acc never fire and each
                # corrector a guaranteed wasted solve (advisor r3)
                psd2 = None
                if settings.step_rule == "probe":
                    a2p, d2p = probe_steps(Lxinv, Lsinv, dX2, dS2,
                                           cast32=True)
                    psd2 = (a2p.astype(dtype), d2p.astype(dtype))
                ap2, ad2 = steplens(dX2, dS2, dxl2, dsl2, dxlb2, dslb2,
                                    dxub2, dsub2, psd_ymat_step, psd=psd2)
                ap2 = jnp.minimum(settings.tau * ap2, 1.0)
                ad2 = jnp.minimum(settings.tau * ad2, 1.0)
                acc = (ap2 + ad2) >= (ap + ad) + 0.05
                accx = acc[:, None, None, None]
                accv = acc[:, None]

                def pick(new, old, mask):
                    return jnp.where(mask, new, old)

                dy = pick(dy2, dy, accv)
                dX = bmap(lambda t: pick(dX2[t], dX[t], accx))
                dS = bmap(lambda t: pick(dS2[t], dS[t], accx))
                dxl = pick(dxl2, dxl, accv)
                dsl = pick(dsl2, dsl, accv)
                dxlb = pick(dxlb2, dxlb, accv)
                dslb = pick(dslb2, dslb, accv)
                dxub = pick(dxub2, dxub, accv)
                dsub = pick(dsub2, dsub, accv)
                ap = jnp.where(acc, ap2, ap)
                ad = jnp.where(acc, ad2, ad)

            if settings.step_rule == "power":
                # f32 Cholesky probes (same NaN semantics; only the step
                # SAFETY depends on them, not accuracy)
                for _ in range(2):
                    okx = jnp.ones((B,), bool)
                    oks = jnp.ones((B,), bool)
                    for t in range(NB):
                        Kt = dX[t].shape[1]
                        probe = jnp.concatenate(
                            [(st.X[t] + ap[:, None, None, None] * dX[t]),
                             (st.S[t] + ad[:, None, None, None] * dS[t])],
                            axis=1).astype(f32)
                        Lp = jnp.linalg.cholesky(probe)
                        nan_half = jnp.any(jnp.isnan(Lp), axis=(2, 3))
                        okx = okx & ~jnp.any(nan_half[:, :Kt], axis=1)
                        oks = oks & ~jnp.any(nan_half[:, Kt:], axis=1)
                    ap = jnp.where(okx, ap, 0.4 * ap)
                    ad = jnp.where(oks, ad, 0.4 * ad)

            return (dy, dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub, ap, ad)

    iter_products_refine = jax.named_scope("refine")(iter_products_refine)
    track_pre = settings.preopt_gap > 0.0

    def body(carry):
        if track_pre:
            st, ev, pre_c = carry
        else:
            st, ev = carry
        if use_refine:
            # "refine" from the FIRST iteration (a plain-f32 warm tier was
            # measured counterproductive: its weaker directions cost more
            # refine iterations than they save); full f64 only below
            # refine_switch (default 0 = never) or on the f32-NaN escape
            active = ~st.done
            use32 = (jnp.all(jnp.where(active,
                                       ev.relgap > settings.refine_switch,
                                       True))
                     & ~jnp.all(st.done) & ~jnp.any(st.nan32 & active)
                     & ~jnp.any(st.esc & active))
            prods = jax.lax.cond(
                use32,
                lambda c: iter_products_refine(c[0], c[1]),
                lambda c: iter_products(c[0], c[1], dtype),
                (st, ev))
        elif use_phase32:
            # 2-tier: f32 only while EVERY active instance is still far
            # from convergence (a near-converged instance needs
            # f64-accurate directions)
            switch = (settings.refine_switch if use_lite
                      else settings.phase32_switch)
            use32 = (jnp.all(jnp.where(~st.done,
                                       ev.relgap > switch,
                                       True)) & ~jnp.all(st.done)
                     & ~jnp.any(st.nan32 & ~st.done)
                     & ~jnp.any(st.esc & ~st.done))
            prods = jax.lax.cond(
                use32,
                lambda c: iter_products(c[0], c[1], jnp.float32),
                lambda c: iter_products(c[0], c[1], dtype),
                (st, ev))
        else:
            prods = iter_products(st, ev, dtype)
        dy, dX, dS, dxl, dsl, dxlb, dslb, dxub, dsub, ap, ad = prods

        # freeze finished instances; detect numerical failure (NaN)
        bad = jnp.any(jnp.isnan(dy), axis=1) | jnp.isnan(ap) | jnp.isnan(ad)
        for t in range(NB):
            bad = bad | jnp.any(jnp.isnan(dX[t]), axis=(1, 2, 3))
        if use_phase32:
            # a NaN from the f32/refine branch is a PRECISION failure, not
            # a solve failure: skip the update and run the next iteration
            # in the f64 branch.  The escalation is a one-iteration REPAIR,
            # not a permanent tier change: nan32 clears after each f64
            # iteration, so the batch drops back to the refine tier (worst
            # case of ping-ponging is one wasted f32 iteration per f64 one)
            soft = bad & use32 & ~st.done
            if getattr(settings, "nan32_policy", "repair") == "fail":
                # hand NaN'd instances straight to the recovery ladder
                # (turbo probe rung / host ladder) instead of re-running
                # the batch in f64
                failed = st.failed | (bad & ~st.done)
                nan32 = st.nan32
            else:
                failed = st.failed | (bad & ~use32 & ~st.done)
                nan32 = jnp.where(use32, st.nan32 | soft,
                                  jnp.zeros_like(st.nan32))
        else:
            failed = st.failed | (bad & ~st.done)
            nan32 = st.nan32
        act = (~st.done) & ~bad
        # guarded updates (where, not multiply-by-zero: 0 * NaN = NaN
        # would poison frozen instances' states)
        a1 = jnp.where(act, ap, 0.0)[:, None]
        a2 = jnp.where(act, ad, 0.0)[:, None]
        a1x = a1[:, :, None, None]
        a2x = a2[:, :, None, None]
        actx = act[:, None, None, None]

        def updm(old, d, a):
            return jnp.where(actx, old + a * d, old)

        def updv(old, d, a):
            return jnp.where(act[:, None], old + a * d, old)

        new = IPMState(
            y=updv(st.y, dy, a2),
            X=bmap(lambda t: updm(st.X[t], dX[t], a1x)),
            S=bmap(lambda t: updm(st.S[t], dS[t], a2x)),
            xl=updv(st.xl, dxl, a1),
            sl=updv(st.sl, dsl, a2),
            xlb=updv(st.xlb, dxlb, a1),
            slb=updv(st.slb, dslb, a2),
            xub=updv(st.xub, dxub, a1),
            sub=updv(st.sub, dsub, a2),
            it=st.it + 1,
            done=st.done,
            converged=st.converged,
            failed=failed,
            best_merit=st.best_merit,
            stall=st.stall,
            nan32=nan32,
            esc=st.esc,
        )
        ev_n = evaluate(new)
        conv = ev_n.conv
        # stall detection: instances making no progress burn the whole
        # batch's wall clock (the while_loop runs until ALL are done) —
        # declare them failed early and let the recovery ladder handle them
        merit = ev_n.relgap + ev_n.pinf + ev_n.dinf
        improved = merit < settings.stall_factor * new.best_merit
        best_merit = jnp.where(improved, merit, new.best_merit)
        stall_cnt = jnp.where(improved | new.done, 0, new.stall + 1)
        stalled = stall_cnt >= settings.stall_window
        # fast->stable tier escalation (sdpisolver_sdpa.cpp:1416-1441
        # role): an instance stalling in the f32/refine tier escalates to
        # the f64 branch (sticky via ``esc``) with a fresh stall budget;
        # only a SECOND stall — in the stable tier — fails it.  At n=65
        # CLS shapes the fast tier's accuracy floor sits above gaptol for
        # ~30% of node relaxations; failing them flooded the recovery
        # ladder (148 of 487 nodes unsolved in one turbo chunk).
        can_esc = use_refine or use_phase32
        esc_now = (stalled & ~new.done & ~conv & ~new.esc) if can_esc \
            else jnp.zeros_like(stalled)
        failed2 = new.failed | (stalled & ~new.done & ~conv & ~esc_now)
        stall_cnt = jnp.where(esc_now, 0, stall_cnt)
        newly_conv = conv & ~new.done & ~failed2
        st_out = new._replace(
            converged=new.converged | newly_conv,
            done=new.done | newly_conv | failed2,
            failed=failed2,
            best_merit=best_merit,
            stall=stall_cnt,
            esc=new.esc | esc_now,
        )
        if not track_pre:
            return (st_out, ev_n)
        # pre-optimal snapshot: first iterate below the preopt gap
        y_pre, X_pre, has_pre = pre_c
        hit = (~has_pre) & ~new.done & (ev_n.relgap <= settings.preopt_gap)
        hx = hit[:, None, None, None]
        return (st_out, ev_n, (
            jnp.where(hit[:, None], new.y, y_pre),
            bmap(lambda t: jnp.where(hx, new.X[t], X_pre[t])),
            has_pre | hit,
        ))

    def cond_w(carry):
        return cond(carry[:2])

    if track_pre:
        pre0 = (st0.y, st0.X, jnp.zeros((B,), bool))
        st, ev, pre_fin = jax.lax.while_loop(
            cond_w, body, (st0, evaluate(st0), pre0))
    else:
        st, ev = jax.lax.while_loop(cond_w, body, (st0, evaluate(st0)))
        pre_fin = None

    conv, gap, pinf, dinf = ev.conv, ev.gap, ev.pinf, ev.dinf
    converged = st.converged | (conv & ~pre.conflict & ~pre.allfixed)
    yh = jnp.where(pre.fix, pre.fixval, st.y)
    dobj = jnp.sum(b * yh, axis=1)
    dobj = jnp.where(pre.allfixed & pre.fixed_feasible,
                     jnp.sum(b * pre.fixval, axis=1), dobj)

    status = jnp.full((B,), int(SolverResultStatus.FAILED), jnp.int32)
    # iteration-limit: ran out of iterations while still making progress
    # (stall-detected instances keep FAILED; SCIPsdpiIsIterlimExc analog)
    status = jnp.where((~st.done) & (~st.failed)
                       & (st.it >= settings.max_iters),
                       int(SolverResultStatus.ITERLIMIT), status)
    status = jnp.where(converged, int(SolverResultStatus.OPTIMAL), status)
    status = jnp.where(
        pre.allfixed & ~pre.conflict,
        jnp.where(pre.fixed_feasible,
                  int(SolverResultStatus.PRESOLVED_OPTIMAL),
                  int(SolverResultStatus.PRESOLVED_INFEASIBLE)),
        status,
    )
    status = jnp.where(pre.conflict,
                       int(SolverResultStatus.PRESOLVED_INFEASIBLE), status)

    return SolveOutput(
        status=status,
        dobj=dobj,
        y=yh,
        r=yh[:, data.nvars],
        gap=gap,
        pinf=pinf,
        dinf=dinf,
        iters=st.it,
        X=st.X,
        xl=st.xl,
        xlb=st.xlb,
        xub=st.xub,
        y_pre=(None if pre_fin is None
               else jnp.where(pre.fix, pre.fixval, pre_fin[0])),
        X_pre=(None if pre_fin is None else pre_fin[1]),
        has_pre=(None if pre_fin is None else pre_fin[2]),
    )
