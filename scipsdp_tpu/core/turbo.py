"""Device-resident branch-and-bound ("turbo" path).

The host-side B&B loop (core/branchbound.py) pays per batch: one device
dispatch, host numpy bookkeeping, and result transfers.
For the common MISDP shape — integer branching (incl. indicator
constraints), no rank-1 / bilinear-lift enforcement, no LP outer
approximation — the whole tree loop vectorizes, so this module keeps the
ENTIRE frontier on device and runs K B&B rounds per dispatch inside one
jitted graph:

    select top-B nodes (lax.top_k on bounds)  ->  batched IPM relaxation
    (ops/ipm.ipm_solve, plus an in-graph feasibility-probe rung)  ->
    fused rounding heuristics + incumbent update  ->  vectorized branching
    (the four reference rules)  ->  scatter children into free slots

The reference's per-node plugin callbacks collapse into array ops; SCIP's
tree (which the reference relies on, SURVEY.md section 1) becomes a
fixed-capacity slab of node boxes — the device analog of the native
frontier store (native/frontier.cpp), living in device memory.

Fallback contract: `solve_turbo` returns ``None`` when it cannot finish
faithfully (frontier overflow, too many unsolved relaxations for the
in-graph ladder); the caller then reruns the host path, which implements
the full recovery ladder and every enforcement feature.

Reference behavior mirrored: calcRelax outcome rules (relax_sdp.c:4205-
4346), fracround/randround heuristics (heur_sdpfracround.c, heur_sdprand.c),
best-first selection (scipsdpdefplugins.c:152-158), branching rules
(branch_sdp*.c), bound pruning at the reference tolerances (BASELINE.md).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from scipsdp_tpu.models.problem import MISDP, DenseSDPData
from scipsdp_tpu.ops.ipm import IPMData, build_ipm_data, ipm_solve
from scipsdp_tpu.utils.config import Settings
from scipsdp_tpu.utils.status import SolverResultStatus

OPT = int(SolverResultStatus.OPTIMAL)
PRE_OPT = int(SolverResultStatus.PRESOLVED_OPTIMAL)
PRE_INF = int(SolverResultStatus.PRESOLVED_INFEASIBLE)
INFEAS = int(SolverResultStatus.INFEASIBLE)
FAILED = int(SolverResultStatus.FAILED)
ITERLIM = int(SolverResultStatus.ITERLIMIT)


class TurboState(NamedTuple):
    """Whole B&B state, device-resident between dispatches."""

    flb: jnp.ndarray       # (N, m) frontier node lower bounds
    fub: jnp.ndarray       # (N, m)
    fbound: jnp.ndarray    # (N,) parent dual bound (minimization sense)
    fwarm: jnp.ndarray     # (N, m) parent relaxation solution
    fwok: jnp.ndarray      # (N,) warmstart validity
    fvalid: jnp.ndarray    # (N,) slot occupied
    inc_val: jnp.ndarray   # () incumbent objective (internal sense)
    inc_y: jnp.ndarray     # (m,)
    has_inc: jnp.ndarray   # () bool
    nodes: jnp.ndarray     # () processed node count
    rounds: jnp.ndarray    # () executed (non-idle) rounds
    iters: jnp.ndarray     # () accumulated IPM iterations
    nsolves: jnp.ndarray   # () solver invocations (incl. probe rungs)
    nheur: jnp.ndarray     # () heuristic incumbents
    ndirect: jnp.ndarray   # () instances decided at the direct rung
    nunsolved: jnp.ndarray  # () relaxations with no usable information
    npruned_inf: jnp.ndarray  # () nodes cut off as infeasible
    overflow: jnp.ndarray  # () bool: frontier slab ran out of slots


def eligible(prob: MISDP, dense: DenseSDPData, settings: Settings,
             lp_mode: bool) -> bool:
    """The turbo path covers exactly the feature set it implements; any
    other problem goes through the general host loop."""
    bb = settings.bb
    return (
        not lp_mode
        and not prob.liftinfo
        and not bool(np.any(dense.rank1))
        and bool(np.any(prob.integral))   # pure-continuous = 1 root solve;
        #                                   the host ladder handles it
        and bb.node_selection == "bestbound"
        and bb.diving_freq == 0
        and not (bb.warmstart and bb.warmstartproject == 4)
        and bb.turbo != "off"
    )


def _branch_scores(y, frac, obj, rule):
    """Vectorized branching scores ((B, m) -> per-var score); mirrors
    core/branching.select_branch_var (branch_sdp*.c)."""
    inf_score = jnp.minimum(frac, 1.0 - frac)
    if rule == "mostfrac":
        return frac
    if rule == "mostinf":
        return inf_score
    if rule == "objective":
        return jnp.abs(obj)[None, :] + 1e-9 * inf_score
    # default: infobjective
    return inf_score * jnp.maximum(jnp.abs(obj), 1e-6)[None, :]


def make_round(settings: Settings, integral: np.ndarray, B: int,
               ind_pairs: Optional[np.ndarray] = None, mesh=None,
               check_feastol: Optional[float] = None):
    """Build the single-round function over (IPMData, TurboState).

    The problem data is a TRACED argument (not a closure): the jitted
    chunk is cached module-wide by (batch, settings, integrality, data
    shapes), so repeated solves — and every warm-up — reuse one compiled
    executable.

    ``ind_pairs``: (K, 2) [binvar, slackvar] indicator links; vectorized
    propagation (binvar fixed 1 => slack <= 0), candidate/leaf indicator
    feasibility, and enforcement branching on a violated binvar (the
    cons_indicator roles)."""
    bb = settings.bb
    feastol = bb.feastol
    # solution-check PSD tolerance; DIMACS-scaled when
    # bb.usedimacsfeastol (cons_sdp.c:703-710)
    chktol = feastol if check_feastol is None else float(check_feastol)
    m = int(integral.shape[0])
    mp = m + 1
    integral_d = jnp.asarray(integral)
    warm_on = bool(bb.warmstart)
    ipms = settings.ipm
    nind = 0 if ind_pairs is None else int(ind_pairs.shape[0])
    if nind:
        ibv = jnp.asarray(ind_pairs[:, 0])
        isv = jnp.asarray(ind_pairs[:, 1])

    if mesh is not None:
        # multi-chip: the selected node batch shards over the mesh's
        # "nodes" axis — GSPMD propagates the sharding through the whole
        # IPM (block data shards over "blocks" via data_sharding); the
        # frontier slab stays replicated (top_k/scatter are global)
        from jax.sharding import NamedSharding, PartitionSpec

        def shard_nodes(a):
            spec = PartitionSpec(*(("nodes",) + (None,) * (a.ndim - 1)))
            return jax.lax.with_sharding_constraint(
                a, NamedSharding(mesh, spec))
    else:
        def shard_nodes(a):
            return a

    def ind_violated(yc, lo=None, hi=None):
        """(B, K) indicator violations of candidate points; with lo/hi
        given, only links whose binvar is still UNFIXED count (fixed
        binvars are handled by propagation)."""
        v = (yc[:, ibv] >= 0.5) & (yc[:, isv] > feastol)
        if lo is not None:
            v = v & ((hi[:, ibv] - lo[:, ibv]) > feastol)
        return v

    def psd_feasible(data, yc):
        """Batched feasibility of points: Z(y) + feastol*I PSD (Cholesky
        probe — same decision as the lambda_min >= -feastol check,
        cons_sdp.c:672, without an eigendecomposition) + LP rows, in the
        data's own precision."""
        yx = jnp.concatenate([yc, jnp.zeros((yc.shape[0], 1), yc.dtype)],
                             axis=1)
        ok = jnp.ones((yc.shape[0],), bool)
        for t in range(data.nbuckets):
            Z = jnp.einsum("kjab,xj->xkab", data.A[t], yx) - data.C[t][None]
            dm = data.dimmask[t]
            outer = dm[:, :, None] & dm[:, None, :]
            eye = jnp.eye(Z.shape[-1], dtype=Z.dtype)
            Zs = jnp.where(outer[None], Z + chktol * eye, eye)
            L = jnp.linalg.cholesky(Zs)
            ok = ok & ~jnp.any(jnp.isnan(L), axis=(1, 2, 3))
        Gy = jnp.einsum("pm,xm->xp", data.G, yx)
        ok = ok & jnp.all(Gy >= data.h[None] - feastol, axis=1)
        return ok

    psd_feasible = jax.named_scope("tb_psdfeas")(psd_feasible)

    def round_fn(data: IPMData, st: TurboState, key) -> TurboState:
        obj = data.b_base[:m]
        N = st.fvalid.shape[0]
        prune_slack = jnp.maximum(
            1e-9, 1e-6 * jnp.where(st.has_inc, jnp.abs(st.inc_val), 0.0))
        cutoff = jnp.where(st.has_inc,
                           st.inc_val - prune_slack
                           + bb.gaplimit * jnp.abs(st.inc_val),
                           jnp.inf)

        # ---- selection: best-bound top-B ---------------------------------
        prio = jnp.where(st.fvalid, st.fbound, jnp.inf)
        _, idx = jax.lax.top_k(-prio, B)
        sel_valid = st.fvalid[idx]
        sel_live = sel_valid & (st.fbound[idx] < cutoff)
        fvalid = st.fvalid.at[idx].set(False)

        lb = jnp.where(sel_live[:, None], st.flb[idx], 1.0)
        ub = jnp.where(sel_live[:, None], st.fub[idx], 0.0)
        if nind:
            # indicator propagation (binvar fixed 1 => slack <= 0) at
            # selection time, so stored child boxes stay plain
            on = lb[:, ibv] >= 0.5
            cur = ub[:, isv]
            ub = ub.at[:, isv].set(
                jnp.where(on, jnp.minimum(cur, 0.0), cur))
        par_bound = jnp.where(sel_live, st.fbound[idx], jnp.inf)
        warm_y = jnp.concatenate(
            [st.fwarm[idx], jnp.zeros((B, 1), st.fwarm.dtype)], axis=1)
        warm_ok = st.fwok[idx] & sel_live if warm_on else None

        lbx = shard_nodes(
            jnp.concatenate([lb, jnp.zeros((B, 1), lb.dtype)], axis=1))
        ubx = shard_nodes(
            jnp.concatenate([ub, jnp.zeros((B, 1), ub.dtype)], axis=1))
        bmat = shard_nodes(
            jnp.broadcast_to(data.b_base[None], (B, mp)) + 0.0)

        with jax.named_scope("tb_relax"):
            out = ipm_solve(data, bmat, lbx, ubx,
                            warm_y=shard_nodes(warm_y) if warm_on else None,
                            warm_mask=warm_ok if warm_on else None,
                            settings=ipms)
        status = out.status
        y = out.y[:, :m]
        bound = out.dobj

        # ---- in-graph rung 2: feasibility probe for failed instances -----
        # (Gamma = 1, zero objective; optimal r above the margin proves
        # dual infeasibility, sdpi.c:3450-3490)
        failed0 = sel_live & jnp.isin(status, jnp.asarray((FAILED, ITERLIM)))

        def probe(args):
            status, nsolves = args
            bprobe = jnp.zeros((B, mp), lbx.dtype).at[:, m].set(1.0)
            ubp = ubx.at[:, m].set(1e20)
            # decided instances get a conflict box: presolve retires them
            lbq = jnp.where(failed0[:, None], lbx, 1.0)
            ubq = jnp.where(failed0[:, None], ubp, 0.0)
            outp = ipm_solve(data, bprobe, lbq, ubq, settings=ipms)
            margin = ipms.peninfeasadjust * max(ipms.feastol, ipms.gaptol)
            proved = (failed0 & (outp.status == OPT) & (outp.r > margin))
            return jnp.where(proved, INFEAS, status), nsolves + 1

        probe = jax.named_scope("tb_probe_rung")(probe)
        status, nsolves = jax.lax.cond(
            jnp.any(failed0), probe, lambda a: a, (status, st.nsolves + 1))

        # ---- in-graph rung 3: one penalty solve at the ladder's start
        # tier (sdpi.c:3497-3599; Gamma = penaltyparam — larger tiers
        # measured DIVERGENT on the MkP family, r ~ 1e11 at Gamma = 3e6).
        # Ladder-hard instances otherwise accumulate ``nunsolved`` until
        # turbo bails to the host loop, which pays one device dispatch
        # PER serial ladder rung — mkp_12's throughput collapse was
        # exactly this fallback.  feasorig results
        # (r <= feastol) are adopted as OPTIMAL; converged penalty solves
        # with residual r still yield a valid dual bound for pruning
        # (GetLowerObjbound role, sdpi.c:3551).
        failed1 = sel_live & jnp.isin(status, jnp.asarray((FAILED, ITERLIM)))
        gam_mid = float(ipms.penaltyparam)

        def pen_rung(args):
            status, y, bound_pen, has_pen, feas_pen, nsolves = args
            bpen = jnp.broadcast_to(data.b_base[None], (B, mp)) + 0.0
            bpen = bpen.at[:, m].set(gam_mid)
            ubp = ubx.at[:, m].set(1e20)
            lbq = jnp.where(failed1[:, None], lbx, 1.0)
            ubq = jnp.where(failed1[:, None], ubp, 0.0)
            outp = ipm_solve(data, bpen, lbq, ubq, settings=ipms)
            conv = failed1 & (outp.status == OPT)
            feasorig = conv & (outp.r <= feastol)
            status = jnp.where(feasorig, OPT, status)
            y = jnp.where(feasorig[:, None], outp.y[:, :m], y)
            val = outp.dobj - gam_mid * outp.r
            bound_pen = jnp.where(conv, val, bound_pen)
            return (status, y, bound_pen, has_pen | conv,
                    feas_pen | feasorig, nsolves + 1)

        pen_rung = jax.named_scope("tb_pen_rung")(pen_rung)
        status, y, bound_pen, has_pen, feas_pen, nsolves = jax.lax.cond(
            jnp.any(failed1), pen_rung, lambda a: a,
            (status, y, jnp.full((B,), -jnp.inf, bound.dtype),
             jnp.zeros((B,), bool), jnp.zeros((B,), bool), nsolves))
        # adopted instances take the penalty value (their direct-solve
        # dobj carries no meaning); converged-with-residual instances
        # contribute their bound below, after the parent-bound fallback
        bound = jnp.where(feas_pen, bound_pen, bound)

        unsolved = sel_live & jnp.isin(status,
                                       jnp.asarray((FAILED, ITERLIM)))
        infeas = sel_live & jnp.isin(status, jnp.asarray((INFEAS, PRE_INF)))
        solved = sel_live & jnp.isin(status, jnp.asarray((OPT, PRE_OPT)))
        bound = jnp.where(solved, bound, par_bound)   # unsolved: keep parent
        # penalty-converged-but-inexact instances carry a valid dual bound
        # even though their relaxation stays "unsolved" for branching
        bound = jnp.where(unsolved & has_pen,
                          jnp.maximum(bound, bound_pen), bound)
        pruned = sel_live & ~infeas & (bound >= cutoff)

        # ---- incumbent candidates ---------------------------------------
        frac = jnp.where(integral_d[None, :],
                         jnp.abs(y - jnp.round(y)), 0.0)
        is_leaf_sol = solved & (jnp.max(frac, axis=1) <= feastol)
        if nind:
            # an integral solution violating an indicator is NOT a leaf:
            # it must be enforced by branching on the violated binvar
            iv = ind_violated(y, lb, ub)
            has_iv = jnp.any(iv, axis=1)
            is_leaf_sol = is_leaf_sol & ~has_iv

        # fused rounding heuristics (heur_sdpfracround / heur_sdprand),
        # each gated by its plugin toggle (freq = -1 in the tier files)
        yr0 = jnp.where(integral_d[None, :], jnp.round(y), y)
        fr = y - jnp.floor(y)
        rnd = jax.random.uniform(key, fr.shape, dtype=fr.dtype)
        yr1 = jnp.where(integral_d[None, :], jnp.floor(y) + (rnd < fr), y)
        heur_cands = ([yr0] if bb.heuristic_fracround else []) \
            + ([yr1] if bb.heuristic_rand else [])
        cands = []
        for yc in heur_cands:
            yc = jnp.clip(yc, lb, ub)
            # clipping against fractional bounds may destroy integrality;
            # such candidates are not MISDP-feasible
            fr_c = jnp.where(integral_d[None, :],
                             jnp.abs(yc - jnp.round(yc)), 0.0)
            feas = (psd_feasible(data, yc) & solved & ~is_leaf_sol
                    & (jnp.max(fr_c, axis=1) <= feastol))
            if nind:
                feas = feas & ~jnp.any(ind_violated(yc), axis=1)
            val = yc @ obj
            cands.append((feas, val, yc))
        # exact leaves: relaxation solution is integral -> value = bound
        cands.append((is_leaf_sol, bound, y))

        inc_val, inc_y, has_inc, nheur = (st.inc_val, st.inc_y, st.has_inc,
                                          st.nheur)
        for ci, (feas, val, yc) in enumerate(cands):
            val = jnp.where(feas, val, jnp.inf)
            i_best = jnp.argmin(val)
            v_best = val[i_best]
            better = v_best < inc_val - 1e-12
            inc_y = jnp.where(better, yc[i_best], inc_y)
            inc_val = jnp.where(better, v_best, inc_val)
            has_inc = has_inc | better
            if ci < len(heur_cands):
                nheur = nheur + better.astype(jnp.int32)

        # ---- branching ---------------------------------------------------
        expand = (solved & ~is_leaf_sol & ~pruned
                  & (status != PRE_OPT)) | (unsolved & ~pruned)
        scores = _branch_scores(y, frac, obj, bb.branching_rule)
        cand = (frac > feastol) & integral_d[None, :]
        scores = jnp.where(cand, scores, -jnp.inf)
        j_frac = jnp.argmax(scores, axis=1)
        has_frac = jnp.any(cand, axis=1)
        # unsolved nodes (or no fractional candidate): first unfixed
        # integer variable, split at the box midpoint
        unfixed = integral_d[None, :] & (ub - lb > feastol)
        j_unf = jnp.argmax(unfixed, axis=1)
        has_unf = jnp.any(unfixed, axis=1)
        if nind:
            # indicator enforcement: branch on the (unfixed) binvar of the
            # most violated link — children binvar<=0 / binvar>=1, the
            # latter forcing slack<=0 through selection-time propagation.
            # Priority: fractional branching first (reference enforces
            # indicators at integral solutions); y is only valid when
            # the relaxation solved
            iv_br = iv & solved[:, None]
            has_iv_br = jnp.any(iv_br, axis=1)
            j_iv = ibv[jnp.argmax(jnp.where(iv_br, y[:, isv], -jnp.inf),
                                  axis=1)]
            j_unf = jnp.where(has_iv_br, j_iv, j_unf)
            has_unf = has_unf | has_iv_br
        use_frac = solved & has_frac
        j = jnp.where(use_frac, j_frac, j_unf)
        # a non-leaf node that cannot be branched (unsolved relaxation and
        # no unfixed integer variable) would silently lose its subtree —
        # count it so the host loop (with the full recovery ladder) takes
        # over instead
        dead = expand & ~(use_frac | has_unf)
        expand = expand & (use_frac | has_unf)
        rows = jnp.arange(B)
        yj = y[rows, j]
        # integer split range: children [lb, s] and [s+1, ub] must cover
        # every integer point even if the box bounds are fractional
        lo = jnp.ceil(lb[rows, j] - 1e-6)
        hi = jnp.floor(ub[rows, j] + 1e-6)
        mid = jnp.floor(0.5 * (lo + hi))
        split = jnp.where(use_frac, jnp.floor(yj), mid)
        split = jnp.clip(split, lo, hi - 1.0)

        # children: (2B, m) boxes
        oh = jax.nn.one_hot(j, m, dtype=lb.dtype)
        ub1 = jnp.where(oh > 0, jnp.minimum(ub, split[:, None]), ub)
        lb2 = jnp.where(oh > 0, jnp.maximum(lb, split[:, None] + 1.0), lb)
        child_lb = jnp.concatenate([lb, lb2], axis=0)
        child_ub = jnp.concatenate([ub1, ub], axis=0)
        child_ok = jnp.concatenate([expand, expand], axis=0)
        child_bound = jnp.concatenate([bound, bound], axis=0)
        child_warm = jnp.concatenate([y, y], axis=0)
        child_wok = jnp.concatenate([solved, solved], axis=0) & child_ok

        # ---- scatter children into free slots ----------------------------
        free = ~fvalid
        _, slot = jax.lax.top_k(free.astype(jnp.int32), 2 * B)
        can_place = free[slot]
        place = child_ok & can_place
        # overflow doubles as the "host must take over" flag: slab full OR
        # a node whose subtree turbo cannot faithfully process
        overflow = st.overflow | jnp.any(child_ok & ~can_place) \
            | jnp.any(dead)
        fvalid = fvalid.at[slot].set(place | fvalid[slot])
        wrow = place[:, None]
        flb = st.flb.at[slot].set(jnp.where(wrow, child_lb, st.flb[slot]))
        fub = st.fub.at[slot].set(jnp.where(wrow, child_ub, st.fub[slot]))
        fbound = st.fbound.at[slot].set(
            jnp.where(place, child_bound, st.fbound[slot]))
        fwarm = st.fwarm.at[slot].set(
            jnp.where(wrow, child_warm, st.fwarm[slot]))
        fwok = st.fwok.at[slot].set(
            jnp.where(place, child_wok, st.fwok[slot]))

        # frontier-wide pruning frees slots for future children
        fvalid = fvalid & (fbound < cutoff)

        return TurboState(
            flb=flb, fub=fub, fbound=fbound, fwarm=fwarm, fwok=fwok,
            fvalid=fvalid,
            inc_val=inc_val, inc_y=inc_y, has_inc=has_inc,
            nodes=st.nodes + jnp.sum(sel_live).astype(jnp.int32),
            rounds=st.rounds + 1,
            iters=st.iters + out.iters.astype(jnp.int32),
            nsolves=nsolves,
            nheur=nheur,
            ndirect=st.ndirect + jnp.sum(solved).astype(jnp.int32),
            nunsolved=st.nunsolved + jnp.sum(unsolved).astype(jnp.int32),
            npruned_inf=st.npruned_inf + jnp.sum(infeas).astype(jnp.int32),
            overflow=overflow,
        )

    round_fn = jax.named_scope("tb_round")(round_fn)

    def chunk_fn(data: IPMData, st: TurboState, key, node_limit, k: int):
        """K rounds per dispatch; idle rounds (empty frontier) are skipped
        by a scalar cond so a finished tree costs nothing.  Returns the new
        state plus ONE packed scalar vector so the host loop costs a single
        small transfer per dispatch.

        ``node_limit`` is a traced scalar (NOT baked into the graph): the
        same compiled executable serves warm-up runs and production solves
        with different limits."""

        def one(i, st):
            live = jnp.any(st.fvalid) & (st.nodes < node_limit) \
                & ~st.overflow
            return jax.lax.cond(
                live,
                lambda s: round_fn(data, s, jax.random.fold_in(key, i)),
                lambda s: s, st)

        st = jax.lax.fori_loop(0, k, one, st)
        # EVERYTHING the host needs — loop control AND the end-of-solve
        # scalars — packed into one vector: each separate np.asarray fetch
        # is a host sync of its own
        open_bound = jnp.min(jnp.where(st.fvalid, st.fbound, jnp.inf))
        summary = jnp.stack([
            jnp.any(st.fvalid).astype(jnp.float64),
            st.overflow.astype(jnp.float64),
            st.nunsolved.astype(jnp.float64),
            st.nodes.astype(jnp.float64),
            st.rounds.astype(jnp.float64),
            st.iters.astype(jnp.float64),
            st.nsolves.astype(jnp.float64),
            st.nheur.astype(jnp.float64),
            st.ndirect.astype(jnp.float64),
            st.npruned_inf.astype(jnp.float64),
            st.inc_val.astype(jnp.float64),
            st.has_inc.astype(jnp.float64),
            open_bound,
            jnp.sum(st.fvalid).astype(jnp.float64),   # live frontier width
        ])
        return st, summary

    return chunk_fn


_CHUNK_CACHE: dict = {}
_INIT_CACHE: dict = {}


def _init_state(N: int, m: int, K: int):
    """Jitted TurboState builder: scatters K seed node boxes into the
    (N, m) frontier slab ON DEVICE, so a solve's setup costs one
    dispatch instead of one transfer per host array."""
    key = (N, m, K)
    fn = _INIT_CACHE.get(key)
    if fn is None:
        @jax.jit
        def init(seed_lb, seed_ub, seed_bound, inc_val, inc_y, has_inc):
            z = jnp.zeros((N, m))
            return TurboState(
                flb=z.at[:K].set(seed_lb),
                fub=z.at[:K].set(seed_ub),
                fbound=jnp.full((N,), jnp.inf).at[:K].set(seed_bound),
                fwarm=z,
                fwok=jnp.zeros((N,), bool),
                fvalid=jnp.zeros((N,), bool).at[:K].set(True),
                inc_val=inc_val,
                inc_y=inc_y,
                has_inc=has_inc,
                nodes=jnp.asarray(0, jnp.int32),
                rounds=jnp.asarray(0, jnp.int32),
                iters=jnp.asarray(0, jnp.int32),
                nsolves=jnp.asarray(0, jnp.int32),
                nheur=jnp.asarray(0, jnp.int32),
                ndirect=jnp.asarray(0, jnp.int32),
                nunsolved=jnp.asarray(0, jnp.int32),
                npruned_inf=jnp.asarray(0, jnp.int32),
                overflow=jnp.asarray(False),
            )

        while len(_INIT_CACHE) >= 32:
            _INIT_CACHE.pop(next(iter(_INIT_CACHE)))
        _INIT_CACHE[key] = init
        fn = init
    return fn


def _chunk_for(settings: Settings, integral: np.ndarray, B: int,
               data: IPMData, ind_pairs: Optional[np.ndarray] = None,
               mesh=None, check_feastol: Optional[float] = None):
    """Jitted chunk executable, cached module-wide.  The key is content-
    independent (data is a traced argument): batch width, solver settings,
    integrality pattern, and the data's array signature — so every
    solve of the same problem family reuses one compiled graph."""
    import dataclasses as _dc
    sig = tuple((tuple(np.shape(a)), str(np.asarray(a).dtype) if not
                 hasattr(a, "dtype") else str(a.dtype))
                for a in jax.tree_util.tree_leaves(data))
    # limits are traced / host-side, not part of the graph
    from scipsdp_tpu.parallel.mesh import mesh_key
    bb_key = _dc.replace(settings.bb, node_limit=0, time_limit=0.0)
    ind_key = None if ind_pairs is None else ind_pairs.tobytes()
    key = (B, settings.ipm, bb_key, integral.tobytes(), sig, ind_key,
           mesh_key(mesh), check_feastol)
    fn = _CHUNK_CACHE.get(key)
    if fn is None:
        fn = jax.jit(make_round(settings, integral, B, ind_pairs, mesh,
                                check_feastol),
                     static_argnames=("k",))
        while len(_CHUNK_CACHE) >= 32:
            _CHUNK_CACHE.pop(next(iter(_CHUNK_CACHE)))
        _CHUNK_CACHE[key] = fn
    return fn


class TurboResult(NamedTuple):
    inc_val: float
    inc_y: Optional[np.ndarray]
    dual_bound: float
    nodes: int
    rounds: int
    iters: int
    nsolves: int
    nheur: int
    ndirect: int
    nunsolved: int
    hit_node_limit: bool
    hit_time_limit: bool


def solve_turbo(dense: DenseSDPData, prob: MISDP, settings: Settings,
                root_lb: np.ndarray, root_ub: np.ndarray,
                inc_val0: float, inc_y0: Optional[np.ndarray],
                data: Optional[IPMData] = None,
                rounds_per_dispatch: int = 8,
                mesh=None,
                init_nodes=None,
                ) -> Optional[TurboResult]:
    """Run the device-resident B&B; returns None on fallback conditions.

    ``init_nodes``: optional list of (lb, ub, bound) open nodes to seed
    the frontier with INSTEAD of the root box — the deferred-engagement
    handoff from the host loop (the host proves the tree is large enough
    to amortize the chunk compile, then ships its whole frontier here)."""
    from scipsdp_tpu.utils.config import resolve_backend_autos
    settings = resolve_backend_autos(settings)
    bb = settings.bb
    B = bb.batch_size
    m = dense.nvars
    N = max(bb.turbo_capacity, 8 * B)
    if init_nodes is not None and len(init_nodes) > N // 2:
        return None   # frontier too large for the slab
    if data is None:
        data = build_ipm_data(dense)
    if mesh is not None and B % mesh.shape["nodes"]:
        mesh = None   # batch not divisible: single-device fallback
        #               (checked BEFORE sharding the data so the fallback
        #               graph runs over genuinely unsharded arrays)
    if mesh is not None:
        # shard the problem image over "blocks"; the chunk's sharding
        # constraints shard the node batch over "nodes"
        from scipsdp_tpu.parallel.mesh import data_sharding
        data = jax.device_put(data, data_sharding(mesh, data))
    ind_pairs = (np.asarray([(l.binvar, l.slackvar)
                             for l in prob.indicators], dtype=np.int32)
                 if prob.indicators else None)
    chk = (bb.feastol * (1.0 + float(np.sum(np.abs(dense.obj))))
           if bb.usedimacsfeastol else None)
    # adaptive batch ramp (turbo_adaptive_batch): run narrow while the
    # frontier is narrow, double the width once the frontier exceeds 4x
    # the current batch.  The state slab is width-independent, so a ramp
    # step just swaps the compiled executable (wide batches on small trees
    # expand up to 3x speculative nodes; deep trees still reach the
    # configured width).
    widths = [B]
    if bb.turbo_adaptive_batch and mesh is None and B > 8:
        widths, w = [], 8
        while w < B:
            widths.append(w)
            w *= 2
        widths.append(B)
    wi = 0
    if init_nodes is not None:
        while wi < len(widths) - 1 and len(init_nodes) >= 4 * widths[wi]:
            wi += 1

    def chunk_at(width):
        return _chunk_for(settings, dense.integral, width, data, ind_pairs,
                          mesh, check_feastol=chk)

    chunk = chunk_at(widths[wi])

    has0 = inc_y0 is not None and np.isfinite(inc_val0)
    if init_nodes is not None:
        K = len(init_nodes)
        flb0 = np.zeros((K, m))
        fub0 = np.zeros((K, m))
        fb0 = np.full((K,), np.inf)
        for i, (nlb, nub, nbound) in enumerate(init_nodes):
            flb0[i] = nlb
            fub0[i] = nub
            fb0[i] = nbound
    else:
        # root box as a 1-node seed; the jitted init scatters it — ONE
        # device dispatch instead of ~12 per-array host transfers for
        # the (N, m) slabs
        flb0 = root_lb[None, :]
        fub0 = root_ub[None, :]
        fb0 = np.array([-np.inf])
        K = 1
    st = _init_state(N, m, K)(
        jnp.asarray(flb0), jnp.asarray(fub0), jnp.asarray(fb0),
        jnp.asarray(float(inc_val0) if has0 else np.inf),
        jnp.asarray(inc_y0 if has0 else np.zeros((m,))),
        jnp.asarray(bool(has0)))

    t0 = time.time()
    key = jax.random.PRNGKey(settings.seed)
    hit_time = False
    node_limit = jnp.asarray(min(bb.node_limit, 2**31 - 1), jnp.int32)
    # a fixed number of rounds per dispatch: idle rounds are skipped
    # in-graph, so a tree that finishes mid-chunk wastes nothing
    k = max(1, rounds_per_dispatch)
    while True:
        key, sub = jax.random.split(key)
        st, summary = chunk(data, st, sub, node_limit, k=k)
        # one tiny host sync per chunk: a single packed scalar vector
        # carrying loop control AND the final statistics
        (any_valid, overflow, nunsolved, nodes, rounds, iters, nsolves,
         nheur, ndirect, _npruned, inc_val_f, has_inc_f,
         open_bound, nlive) = np.asarray(summary)
        if overflow or nunsolved > 4 * B:
            return None    # host path handles what turbo cannot
        if not any_valid or nodes >= bb.node_limit:
            break
        if time.time() - t0 > bb.time_limit:
            hit_time = True
            break
        # batch ramp: frontier outgrew the current width
        stepped = False
        while wi < len(widths) - 1 and nlive >= 4 * widths[wi]:
            wi += 1
            stepped = True
        if stepped:
            chunk = chunk_at(widths[wi])

    has_inc = bool(has_inc_f)
    inc_val = float(inc_val_f) if has_inc else np.inf
    dual_bound = min(float(open_bound), inc_val)
    return TurboResult(
        inc_val=inc_val,
        inc_y=(np.asarray(st.inc_y) if has_inc else None),
        dual_bound=dual_bound,
        nodes=int(nodes),
        rounds=int(rounds),
        iters=int(iters),
        nsolves=int(nsolves),
        nheur=int(nheur),
        ndirect=int(ndirect),
        nunsolved=int(nunsolved),
        hit_node_limit=int(nodes) >= bb.node_limit,
        hit_time_limit=hit_time,
    )
