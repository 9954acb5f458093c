"""Solver-independent SDP interface with the recovery ladder.

Device-batched analog of the reference SDPI (src/sdpi/sdpi.c): wraps the batched
IPM (ops/ipm.py) behind a stable host-side API and implements the layered
failure recovery of ``SCIPsdpiSolve`` (sdpi.c:3399-3599):

1. direct solve (penalty variable fixed to 0);
2. for failed instances, the *feasibility probe*: penalty formulation with
   Gamma = 1 and zeroed objective — an optimal r above
   ``peninfeasadjust * max(feastol, gaptol)`` proves dual infeasibility
   (sdpi.c:3450-3490);
3. penalty rescue solves with Gamma escalating from ``penaltyparam`` toward
   ``maxpenaltyparam`` in ``npenaltyincr`` steps (sdpi.c:3497-3599); a
   converged rescue with r <= feastol is feasible for the original problem
   (``feasorig``), otherwise its objective is still a valid lower bound
   (the analog of SCIPsdpiGetLowerObjbound, used at relax_sdp.c:4327);
4. a *box rescue* replacing infinite bounds by a large box: a converged
   box solve with an artificial bound active proves (numerically) dual
   unboundedness, otherwise it recovers an optimum the plain solve missed.

Every rung is one more batched jit call on the full batch (statuses of
already-decided instances are never overwritten), so the ladder costs
nothing when everything converges on the first try — the common case in
branch-and-bound.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from scipsdp_tpu.models.problem import DenseSDPData, INF
from scipsdp_tpu.ops.ipm import IPMData, build_ipm_data, ipm_solve
from scipsdp_tpu.utils.config import Settings
from scipsdp_tpu.utils.status import SolverResultStatus

BOX_BOUND = 1e7       # artificial box for unboundedness detection

# statuses with no usable bound: the recovery ladder keeps escalating these
_UNSOLVED_CODES = (int(SolverResultStatus.FAILED),
                   int(SolverResultStatus.ITERLIMIT),
                   int(SolverResultStatus.TIMELIMIT))


def _merge_outputs(out32, out64, take: np.ndarray):
    """Overwrite rows of a SolveOutput with the escalated f64 results."""
    def mix1(a, b):
        a = np.asarray(a)
        b = np.asarray(b)
        if a.ndim == 0:
            return np.maximum(a, b)
        t = take.reshape((-1,) + (1,) * (a.ndim - 1))
        return np.where(t, b.astype(np.float64) if a.dtype != b.dtype else b,
                        a)

    def mix(a, b):
        if isinstance(a, tuple):
            return tuple(mix1(x, y) for x, y in zip(a, b))
        return mix1(a, b)

    from scipsdp_tpu.ops.ipm import SolveOutput
    return SolveOutput(*(mix(a, b) for a, b in zip(out32, out64)))

BOX_ACTIVE_TOL = 0.99  # |y| >= BOX_ACTIVE_TOL * BOX_BOUND counts as active


@dataclasses.dataclass
class BatchSolveResult:
    """Per-instance outcome of one batched relaxation solve."""

    status: np.ndarray    # (B,) SolverResultStatus values
    objval: np.ndarray    # (B,) optimal value / valid lower bound (BOUND_ONLY)
    y: np.ndarray         # (B, m) dual solution (original variables)
    X: np.ndarray         # (B, K, n, n) primal SDP matrices
    xl: np.ndarray        # (B, p) primal LP-row multipliers
    xlb: np.ndarray       # (B, m) primal lower-bound multipliers
    xub: np.ndarray       # (B, m) primal upper-bound multipliers
    iters: int            # IPM iterations of the direct solve
    nsolves: int          # total batched solver invocations used
    npenalty: int         # instances decided via penalty formulation
    nunsolved: int        # instances with no usable information
    ndirect: int = 0      # instances decided at the direct rung (the
    #                       fastest settings tier; disp_sdpfastsettings)
    # fused rounding-heuristic results (when solve_batch got a seed)
    round_y: Optional[np.ndarray] = None     # (B, m) best rounded points
    round_feas: Optional[np.ndarray] = None  # (B,) feasibility flags
    round_val: Optional[np.ndarray] = None   # (B,) objective values
    # per-instance solver-settings tier that decided the instance via the
    # penalty ladder: (B, 2) [Gamma, gaptol], NaN rows for direct solves
    # (cons_savedsdpsettings role: children inherit the parent's tier)
    tier: Optional[np.ndarray] = None
    # pre-optimal iterate of the direct solve (warmstartpreoptsol)
    pre_y: Optional[np.ndarray] = None   # (B, m)
    pre_X: Optional[list] = None         # per-bucket (B, K, n, n)
    pre_has: Optional[np.ndarray] = None  # (B,)


_FUSED_JIT_CACHE: dict = {}


def _build_fused(ipms, feastol, m, integral_np, indicator_pairs,
                 use_frac=True, use_rand=True):
    """Build the jitted fused executable: ipm_solve + fracround/randround
    candidates + feasibility check, all in one device graph (one
    dispatch).  Module-level (NOT a bound method) so the module-wide cache
    never pins an SDPInterface instance — and its whole problem's device
    arrays — for process lifetime.  ``use_frac``/``use_rand`` gate the two
    rounding heuristics (heur_sdpfracround.c / heur_sdprand.c freq = -1)."""
    integral_np = np.asarray(integral_np)
    indicator_pairs = np.asarray(indicator_pairs, np.int32).reshape(-1, 2)

    def _fused_impl(data, b, lb, ub, key, Gcut=None, hcut=None,
                    cvalid=None, warm_y=None, warm_mask=None,
                    gaptol_vec=None, warm_X=None, ip_point=None,
                    feastol_vec=None):
        import dataclasses as _dc

        s = ipms
        if data.A[0].dtype == jnp.float32:
            s = _dc.replace(s, dtype="float32", chol_reg=1e-9)
        out = ipm_solve(data, b, lb, ub, Gcut, hcut, cvalid,
                        warm_y, warm_mask, gaptol_vec, warm_X, ip_point,
                        feastol_vec, settings=s)
        B = b.shape[0]
        y = out.y[:, :m]
        integral = jnp.asarray(integral_np)

        def finish(yc):
            yc = jnp.clip(yc, lb[:, :m], ub[:, :m])
            for bi, si in indicator_pairs:
                on = yc[:, bi] >= 0.5
                yc = yc.at[:, si].set(jnp.where(on, 0.0, yc[:, si]))
            yx = jnp.concatenate([yc, jnp.zeros((B, 1), yc.dtype)], axis=1)
            # feasibility: Z(y) + feastol*I PSD via a Cholesky probe — the
            # same accept/reject decision as the lambda_min >= -feastol
            # check (cons_sdp.c:672) without an eigendecomposition, in the
            # data's own precision
            ok = jnp.ones((B,), bool)
            for t in range(data.nbuckets):
                Z = jnp.einsum("kjab,xj->xkab", data.A[t], yx) \
                    - data.C[t][None]
                dm = data.dimmask[t]
                outer = dm[:, :, None] & dm[:, None, :]
                eye = jnp.eye(Z.shape[-1], dtype=Z.dtype)
                Zs = jnp.where(outer[None], Z + feastol * eye, eye)
                L = jnp.linalg.cholesky(Zs)
                ok = ok & ~jnp.any(jnp.isnan(L), axis=(1, 2, 3))
            Gy = jnp.einsum("pm,xm->xp", data.G, yx)
            ok = ok & jnp.all(Gy >= data.h[None] - feastol, axis=1)
            if Gcut is not None:
                Gcy = jnp.einsum("xqm,xm->xq", Gcut[:, :, :m], yc)
                ok = ok & jnp.all(jnp.where(cvalid, Gcy >= hcut - feastol,
                                            True), axis=1)
            # clipping against fractional bounds may destroy integrality
            frac_c = jnp.where(integral[None, :],
                               jnp.abs(yc - jnp.round(yc)), 0.0)
            ok = ok & (jnp.max(frac_c, axis=1) <= feastol)
            return yc, ok, jnp.sum(yc * data.b_base[None, :m], axis=1)

        y0 = jnp.where(integral[None, :], jnp.round(y), y)
        frac = y - jnp.floor(y)
        rnd = jax.random.uniform(key, frac.shape, dtype=frac.dtype)
        y1 = jnp.where(integral[None, :],
                       jnp.floor(y) + (rnd < frac), y)
        y0c, f0, v0 = finish(y0)
        y1c, f1, v1 = finish(y1)
        if not use_frac:
            f0 = jnp.zeros_like(f0)
        if not use_rand:
            f1 = jnp.zeros_like(f1)
        use1 = f1 & (~f0 | (v1 < v0))
        yr = jnp.where(use1[:, None], y1c, y0c)
        return out, yr, (f0 | f1), jnp.where(use1, v1, v0)

    def _fused_full_precision(*args, **kw):
        # the f32 tier's candidate checks decide incumbents: no TF32
        # matmul passes (f64 operands are unaffected)
        with jax.default_matmul_precision("float32"):
            return _fused_impl(*args, **kw)

    return jax.jit(_fused_full_precision)


class SDPInterface:
    """Batched SDP relaxation solver for one problem's data.

    Per-call inputs are only the per-node variable bounds (and optionally a
    per-node objective), matching how B&B node relaxations differ.
    """

    def __init__(self, dense: DenseSDPData, settings: Optional[Settings] = None,
                 indicator_pairs=None, mesh=None, lp_host: bool = False):
        import dataclasses as _dc

        from scipsdp_tpu.utils.config import resolve_backend_autos
        self.settings = resolve_backend_autos(settings or Settings())
        bb = self.settings.bb
        if (bb.warmstart and getattr(bb, "warmstartpreoptsol", False)
                and self.settings.ipm.preopt_gap == 0.0):
            # pre-optimal warmstart capture (sdpisolver_sdpa.cpp:1612-1618)
            self.settings = _dc.replace(
                self.settings,
                ipm=_dc.replace(self.settings.ipm,
                                preopt_gap=bb.warmstartpreoptgap))
        self.mesh = mesh
        self.dense = dense
        # LP-outer-approximation mode: node relaxations on the host
        # simplex (see _solve_batch_lp_host); opt-in by the LP-mode
        # solver so block-less problems elsewhere keep the IPM ladder
        self.lp_host = lp_host and len(dense.blocksizes) == 0
        self.data: IPMData = build_ipm_data(dense)
        self.m = dense.nvars
        # mixed precision: fast f32 tier with f64 escalation (the
        # reference's fast->stable solver-settings tiers)
        mp = self.settings.ipm.mixed_precision
        self._mp = mp == "on"
        if self._mp:
            self.data32 = build_ipm_data(dense, jnp.float32)
        # fused solve + rounding-heuristic dispatch (saves device round
        # trips: the environment is dispatch-latency-bound)
        self._indicator_pairs = (
            np.asarray(indicator_pairs, dtype=np.int32).reshape(-1, 2)
            if indicator_pairs is not None and len(indicator_pairs)
            else np.zeros((0, 2), np.int32))
        # the jitted executable is shared MODULE-WIDE across interfaces
        # whose trace would be identical (everything _build_fused closes
        # over is captured by this key; problem data is a traced
        # argument).  Without this, every fresh SDPInterface re-compiles —
        # the warmstartproject=4 rounding problems build one per node
        # (solvePrimalRoundingProblem role) and were paying a full XLA
        # compile each.  Keyed by mesh CONTENT, not id() (ids are reused
        # after GC); bounded so long multi-problem processes don't
        # accumulate executables.
        from scipsdp_tpu.parallel.mesh import mesh_key
        fkey = (self.settings.ipm, self.settings.bb.feastol, self.m,
                self.dense.integral.tobytes(),
                self._indicator_pairs.tobytes(), mesh_key(mesh),
                self.settings.bb.heuristic_fracround,
                self.settings.bb.heuristic_rand)
        fn = _FUSED_JIT_CACHE.get(fkey)
        if fn is None:
            fn = _build_fused(self.settings.ipm, self.settings.bb.feastol,
                              self.m, self.dense.integral,
                              self._indicator_pairs,
                              use_frac=self.settings.bb.heuristic_fracround,
                              use_rand=self.settings.bb.heuristic_rand)
            while len(_FUSED_JIT_CACHE) >= 32:
                _FUSED_JIT_CACHE.pop(next(iter(_FUSED_JIT_CACHE)))
            _FUSED_JIT_CACHE[fkey] = fn
        self._fused = fn
        # multi-chip: shard the problem image over the "blocks" axis and
        # every per-node array over the "nodes" axis; XLA propagates the
        # shardings through the fused executable and inserts the psum /
        # all-gather collectives for the cross-block Schur reductions
        # (SURVEY.md section 2.5 scale-out contract)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            from scipsdp_tpu.parallel.mesh import data_sharding
            self.data = jax.device_put(self.data,
                                       data_sharding(mesh, self.data))
            if self._mp:
                self.data32 = jax.device_put(
                    self.data32, data_sharding(mesh, self.data32))
            self._nodes_sharding = {
                1: NamedSharding(mesh, PartitionSpec("nodes")),
                2: NamedSharding(mesh, PartitionSpec("nodes", None)),
                3: NamedSharding(mesh, PartitionSpec("nodes", None, None)),
            }
        # statistics (the relaxator's counters, relax_sdp.c:166-235)
        self.stat_nsolves = 0
        self.stat_iterations = 0
        self.stat_npenalty = 0
        self.stat_nprobes = 0
        self.stat_nunsolved = 0
        self.stat_nonevar = 0   # instances decided by the one-var solver
        #                         (sdpi.c:3301-3381 special case)
        self.stat_nveri_resolve = 0  # feastol-tightened re-solve rungs
        #                              after an independent-check failure
        #                              (INFEASFEASTOLCHANGE role)

    # -- helpers -----------------------------------------------------------

    def _extend(self, arr: np.ndarray, val: float) -> np.ndarray:
        B = arr.shape[0]
        return np.concatenate([arr, np.full((B, 1), val)], axis=1)

    def _put(self, arr):
        """Move a per-node array to the device(s), sharded over "nodes"
        when a mesh is attached."""
        if arr is None:
            return None
        a = jnp.asarray(arr)
        if self.mesh is None:
            return a
        return jax.device_put(a, self._nodes_sharding[a.ndim])

    @staticmethod
    def _mask_decided(lbx, ubx, active):
        """Ladder rungs only need the still-failed instances; decided ones
        get a bound conflict so presolve retires them instantly (their
        results are ignored anyway)."""
        lbm = lbx.copy()
        ubm = ubx.copy()
        lbm[~active, :] = 1.0
        ubm[~active, :] = 0.0
        return lbm, ubm

    def set_interior_point(self, y_ip: np.ndarray,
                           X_ip) -> None:
        """Install root analytic centers for warmstartiptype=2 convex
        combinations (SCIPrelaxSdpComputeAnalyticCenters role); ``X_ip``
        is a per-bucket tuple of (K_t, n, n) primal center matrices."""
        self._ip_point = (
            self._put(np.concatenate([np.asarray(y_ip), [0.0]])),
            tuple(jnp.asarray(x) for x in X_ip),
        )

    _ip_point = None

    def _run(self, b, lb, ub, cuts=None, warm_y=None, warm_mask=None,
             f32=False, gaptol=None, warm_X=None, feastol_vec=None):
        """One batched solve through the SINGLE fused executable.

        Every recovery-ladder rung reuses the fused solve+rounding graph
        (with a fixed key, ignoring the rounding outputs) instead of a
        second jitted variant: each extra graph costs a full XLA compile
        (tens of seconds on CPU), far more than the
        rounding side-computation it drags along."""
        self.stat_nsolves += 1
        if cuts is None:
            cargs = (None, None, None)
        else:
            cargs = (self._put(cuts[0]), self._put(cuts[1]),
                     self._put(cuts[2]))
        key = jax.random.PRNGKey(0)
        dat = self.data32 if f32 else self.data
        if gaptol is None:
            gaptol = np.full(b.shape[0], self.settings.ipm.gaptol)
        out, _, _, _ = self._fused(dat, self._put(b), self._put(lb),
                                   self._put(ub), key, *cargs,
                                   self._put(warm_y), warm_mask,
                                   self._put(np.asarray(gaptol)),
                                   warm_X, self._ip_point,
                                   (None if feastol_vec is None
                                    else self._put(np.asarray(feastol_vec))))
        return out

    def conflict_cuts(self, res: "BatchSolveResult"):
        """Dual-aggregation cuts from the primal certificates
        (computeConflictCut, relax_sdp.c:954-1410): for any X_b >= 0 and
        LP multipliers xl >= 0,

            sum_j (sum_b tr(A_j^b X_b) + xl @ G_j) y_j
                >= sum_b tr(A_0^b X_b) + xl @ h

        holds for every point feasible w.r.t. the SDP blocks and LP rows —
        globally valid.  With the Farkas certificate of an infeasible node
        the row conflicts with that node's box; with a feasible node's
        optimal primal it is a supporting hyperplane.  Returns
        (G (B, m), lhs (B,))."""
        B = res.y.shape[0]
        g = np.zeros((B, self.m))
        lhs = np.zeros(B)
        if not hasattr(self, "_np_data"):
            self._np_data = (
                [np.asarray(a) for a in self.data.A],
                [np.asarray(c) for c in self.data.C],
                [np.asarray(d) for d in self.data.dimmask],
                np.asarray(self.data.G),
                np.asarray(self.data.h),
            )
        As, Cs, dms, G, h = self._np_data
        for t, Xt in enumerate(res.X):
            outer = dms[t][:, :, None] & dms[t][:, None, :]
            Xm = np.where(outer[None], np.asarray(Xt), 0.0)
            g += np.einsum("xkab,kjab->xj", Xm, As[t][:, : self.m])
            lhs += np.einsum("xkab,kab->x", Xm, Cs[t])
        if G.shape[0]:
            # only the static LP rows: per-node cut-row multipliers (res.xl
            # columns beyond p) are excluded — node-local cuts (e.g. rank-1
            # secants) are not globally valid, and validity of the
            # aggregation does not require using every multiplier
            xlp = np.maximum(res.xl[:, : G.shape[0]], 0.0)
            g += xlp @ G[:, : self.m]
            lhs += xlp @ h
        return g, lhs

    def _onevar_prepass(self, lb, ub, bmat, cuts):
        """One-active-variable fast path (sdpi.c:3301-3381): instances
        whose box leaves exactly one variable free are decided exactly by
        the special solver (ops/onevar.py) — LP/cut rows fold into bounds
        on the free variable, each block contributes a feasible interval,
        and the optimum sits at an interval endpoint.  Returns
        (lb', ub', decided) where decided maps instance -> (status,
        objval, y, cert) and decided instances carry a conflict box so the
        batched IPM retires them at the presolve rung (0 iterations).

        ``cert``: optional (block k, eigenvector v) — the active/violated
        eigenvector certificate, placed into the returned primal X so
        conflict-cut aggregation (computeConflictCut, relax_sdp.c:954)
        sees the supporting rank-1 witness."""
        from scipsdp_tpu.ops.onevar import (_lam_min_vec, feasible_interval,
                                            solve_one_var_sdp)
        ipms = self.settings.ipm
        feastol = ipms.feastol
        epsfix = max(ipms.epsilon, 1e-12)
        B, m = lb.shape
        dense = self.dense
        decided = {}
        if not ipms.onevar:
            return lb, ub, decided
        free_all = (ub - lb) > epsfix
        nfree = free_all.sum(axis=1)
        cand = np.where((nfree == 1) & ~(lb > ub + feastol).any(axis=1))[0]
        if cand.size == 0:
            return lb, ub, decided
        lb2, ub2 = lb.copy(), ub.copy()
        for i in cand:
            j = int(np.argmax(free_all[i]))
            fixval = 0.5 * (lb[i] + ub[i])
            fixval[j] = 0.0
            glo, ghi = float(lb[i, j]), float(ub[i, j])
            infeas = False
            # fold rows (static LP rows ++ this node's valid cut rows)
            rows = [(dense.G, dense.h)]
            if cuts is not None:
                Gc, hc, cval = cuts
                vrows = np.asarray(cval[i], bool)
                if vrows.any():
                    rows.append((np.asarray(Gc[i])[vrows, :m],
                                 np.asarray(hc[i])[vrows]))
            for Gr, hr in rows:
                if Gr.shape[0] == 0:
                    continue
                const = Gr[:, :m] @ fixval
                gj = Gr[:, j]
                inert = np.abs(gj) < 1e-14
                if np.any(inert & (const < hr - feastol)):
                    infeas = True
                    break
                pos = gj > 1e-14
                neg = gj < -1e-14
                if pos.any():
                    glo = max(glo, float(np.max(
                        (hr[pos] - const[pos]) / gj[pos])))
                if neg.any():
                    ghi = min(ghi, float(np.min(
                        (hr[neg] - const[neg]) / gj[neg])))
            cert = None
            if not infeas and glo > ghi + feastol:
                infeas = True
            if not infeas:
                for k in range(dense.nblocks):
                    nk = int(dense.blocksizes[k])
                    Aj = dense.A[k][j][:nk, :nk]
                    Ceff = (dense.C[k][:nk, :nk]
                            - np.einsum("m,mab->ab", fixval,
                                        dense.A[k][:, :nk, :nk]))
                    iv = feasible_interval(Aj, Ceff, glo, ghi, feastol)
                    if iv is None:
                        stat, _, c_inf = solve_one_var_sdp(
                            Aj, Ceff, 0.0, glo, ghi, feastol,
                            with_certificate=True)
                        cert = (k, c_inf.eigvec)
                        infeas = True
                        break
                    lft, rgt = iv
                    if lft > glo + 1e-12 * max(1.0, abs(lft)):
                        glo = lft
                        cert = (k, _lam_min_vec(lft, Aj, Ceff)[1])
                    if rgt < ghi - 1e-12 * max(1.0, abs(rgt)):
                        ghi = rgt
                        cert = (k, _lam_min_vec(rgt, Aj, Ceff)[1])
                    if glo > ghi + feastol:
                        infeas = True
                        break
            if infeas:
                decided[int(i)] = (int(SolverResultStatus.INFEASIBLE),
                                   np.inf, np.zeros(m), cert)
            else:
                c = float(bmat[i, j])
                if c > 0:
                    ystar = glo
                elif c < 0:
                    ystar = ghi
                else:
                    ystar = glo if np.isfinite(glo) else (
                        ghi if np.isfinite(ghi) else 0.0)
                if not np.isfinite(ystar):
                    decided[int(i)] = (int(SolverResultStatus.UNBOUNDED),
                                       -np.inf, np.zeros(m), None)
                else:
                    yfull = fixval.copy()
                    yfull[j] = ystar
                    objval = float(bmat[i, :m] @ yfull)
                    decided[int(i)] = (int(SolverResultStatus.OPTIMAL),
                                       objval, yfull, cert)
            # conflict box: the IPM retires the slot at the presolve rung
            lb2[i, :] = lb[i]
            ub2[i, :] = ub[i]
            lb2[i, j] = 1.0
            ub2[i, j] = 0.0
            self.stat_nonevar += 1
        return lb2, ub2, decided

    def _apply_onevar(self, decided, status, objval, y, X, xl, xlb, xub):
        """Overwrite the dispatch outputs with the one-var decisions."""
        for i, (st, ov, yi, cert) in decided.items():
            status[i] = st
            objval[i] = ov
            y[i] = yi
            xl[i] = 0.0
            xlb[i] = 0.0
            xub[i] = 0.0
            for t in range(len(X)):
                X[t][i] = 0.0
            if cert is not None:
                k, v = cert
                if v is not None:
                    t, slot = self.data.block_of[k]
                    nk = v.shape[0]
                    X[t][i, slot, :nk, :nk] = np.outer(v, v)

    # -- main entry --------------------------------------------------------

    def _solve_batch_lp_host(self, lb, ub, bmat, cuts, time_limit):
        """LP-mode node relaxations on the host (scipy HiGHS).

        The relaxation is  min b^T y  s.t.  G y >= h (+ cut rows),
        lb <= y <= ub — exactly SCIP's LP relaxation role (the ``none``
        back-end mode, sdpisolver_none.c + Makefile SDPS=none).  Returns
        the same BatchSolveResult contract as the IPM path, with HiGHS
        duals filling the bound-multiplier slots (prop_sdpredcost role).
        """
        import time as _time
        from scipy.optimize import linprog
        t0 = _time.time()
        B = lb.shape[0]
        m = self.m
        G = np.asarray(self.data.G)[:, :m]
        h = np.asarray(self.data.h)
        status = np.full((B,), int(SolverResultStatus.FAILED), np.int32)
        objval = np.full((B,), np.inf)
        y = np.zeros((B, m))
        xl_rows = G.shape[0] if cuts is None else G.shape[0] + cuts[0].shape[1]
        xl = np.zeros((B, xl_rows))
        xlb = np.zeros((B, m))
        xub = np.zeros((B, m))
        for i in range(B):
            if np.any(lb[i] > ub[i]):   # conflict/dummy box marker
                # (lb=1, ub=0 per slot — branchbound.py dummy-slot
                # convention); skip the LP solve entirely
                status[i] = int(SolverResultStatus.PRESOLVED_INFEASIBLE)
                continue
            A_ub = -G
            b_ub = -h
            if cuts is not None:
                Gc, hc, cval = cuts
                v = np.asarray(cval[i], bool)
                A_ub = np.concatenate([A_ub, -np.asarray(Gc[i, v][:, :m])])
                b_ub = np.concatenate([b_ub, -np.asarray(hc[i, v])])
            bounds = list(zip(
                np.where(lb[i] <= -1e19, -np.inf, lb[i]),
                np.where(ub[i] >= 1e19, np.inf, ub[i])))
            res = linprog(bmat[i, :m], A_ub=A_ub, b_ub=b_ub, bounds=bounds,
                          method="highs")
            if res.status == 0:
                status[i] = int(SolverResultStatus.OPTIMAL)
                objval[i] = float(res.fun)
                y[i] = res.x
                # HiGHS marginals: ineqlin <= 0 for <=-rows at optimum of
                # a min problem; LP-row multipliers are their negatives
                ng = G.shape[0]
                try:
                    mar = -np.asarray(res.ineqlin.marginals)
                    xl[i, :ng] = np.maximum(mar[:ng], 0.0)
                    xlb[i] = np.maximum(np.asarray(res.lower.marginals), 0.0)
                    xub[i] = np.maximum(-np.asarray(res.upper.marginals), 0.0)
                except Exception:
                    pass
            elif res.status == 2:
                status[i] = int(SolverResultStatus.INFEASIBLE)
            elif res.status == 3:
                status[i] = int(SolverResultStatus.UNBOUNDED) if hasattr(
                    SolverResultStatus, "UNBOUNDED") else int(
                        SolverResultStatus.FAILED)
                objval[i] = -np.inf
            if time_limit is not None and _time.time() - t0 > time_limit:
                break
        X = tuple(np.zeros((B,) + tuple(np.asarray(a).shape[:1])
                           + tuple(np.asarray(a).shape[2:]))
                  for a in self.data.A)
        nun = int(np.sum(status == int(SolverResultStatus.FAILED)))
        return BatchSolveResult(
            status=status, objval=objval, y=y, X=X, xl=xl, xlb=xlb,
            xub=xub, iters=0, nsolves=1, npenalty=0, nunsolved=nun,
            ndirect=int(np.sum(status != int(SolverResultStatus.FAILED))))

    def solve_batch(self, lb: np.ndarray, ub: np.ndarray,
                    obj: Optional[np.ndarray] = None,
                    cuts=None, rounding_seed: Optional[int] = None,
                    warm=None,
                    time_limit: Optional[float] = None,
                    tier: Optional[np.ndarray] = None) -> BatchSolveResult:
        """Solve B node relaxations; lb/ub: (B, m) bounds per node.

        ``cuts``: optional (Gcut (B,q,m), hcut (B,q), valid (B,q)) per-node
        linear cut rows  Gcut y >= hcut  in original variable space; the
        penalty column is 1 (cut rows are relaxed by r like LP rows in the
        penalty formulation, sdpisolver.h:237-245).

        ``time_limit``: wall-clock budget in seconds for this call; when
        exhausted, remaining recovery-ladder rungs are skipped and still-
        undecided instances get status TIMELIMIT (SCIPsdpiIsTimelimExc
        analog, sdpi.c:3653-4110).

        ``tier``: optional (B, 2) per-instance [Gamma, gaptol] inherited
        from the parent node's successful penalty solve
        (cons_savedsdpsettings, relax_sdp.c:4085-4120): when the direct
        solve fails, the penalty ladder STARTS at the inherited tier
        instead of re-climbing from the bottom.  NaN rows = no inheritance.
        """
        import time as _time
        t_start = _time.time()

        def out_of_time() -> bool:
            return (time_limit is not None
                    and _time.time() - t_start > time_limit)

        ipms = self.settings.ipm
        feastol = ipms.feastol
        B = lb.shape[0]
        m = self.m
        if obj is None:
            bmat = np.tile(np.asarray(self.data.b_base), (B, 1))
        else:
            bmat = self._extend(np.asarray(obj, dtype=np.float64), 0.0)
        if cuts is not None:
            Gc, hc, cval = cuts
            Gc = np.concatenate(
                [Gc, np.ones((B, Gc.shape[1], 1))], axis=2)
            cuts = (Gc, hc, cval)

        # pure-LP relaxations (LP outer-approximation mode: no SDP
        # blocks) solve with a HOST dual simplex (scipy HiGHS) — the
        # reference solves its LP relaxations with SCIP's simplex, not an
        # interior-point SDP ladder, and driving the batched IPM
        # machinery for them took nearly all of an LP-mode solve
        if (self.lp_host and self.settings.bb.lp_host_simplex
                and warm is None and rounding_seed is None):
            return self._solve_batch_lp_host(lb, ub, bmat, cuts,
                                             time_limit)

        # one-active-variable fast path (sdpi.c:3301-3381): decided
        # exactly on the host, masked out of the IPM with a conflict box
        lb_eff, ub_eff, onevar = self._onevar_prepass(lb, ub, bmat, cuts)

        # rung 1: direct solve, r fixed at 0 (optionally fused with the
        # rounding heuristics in a single device dispatch)
        lbx = self._extend(lb_eff, 0.0)
        ubx = self._extend(ub_eff, 0.0)
        round_y = round_feas = round_val = None
        wy = wm = wX = None
        if warm is not None:
            wy = self._put(self._extend(np.asarray(warm[0]), 0.0))
            wm = self._put(np.asarray(warm[1], dtype=bool))
            if len(warm) > 2 and warm[2] is not None:
                wX = tuple(jnp.asarray(x) for x in warm[2])
        if rounding_seed is not None:
            self.stat_nsolves += 1
            key = jax.random.PRNGKey(rounding_seed)
            cargs = ((None, None, None) if cuts is None else
                     (self._put(cuts[0]), self._put(cuts[1]),
                      self._put(cuts[2])))
            dat = self.data32 if self._mp else self.data
            out, ry, rf, rv = self._fused(
                dat, self._put(bmat), self._put(lbx),
                self._put(ubx), key, *cargs, wy, wm,
                self._put(np.full(B, ipms.gaptol)), wX, self._ip_point)
            round_y = np.asarray(ry)
            round_feas = np.asarray(rf)
            round_val = np.asarray(rv)
        else:
            out = self._run(bmat, lbx, ubx, cuts, wy, wm, f32=self._mp,
                            warm_X=wX)
        self.stat_iterations += int(out.iters)

        # f32 tier escalation: instances the fast tier failed are re-solved
        # in f64 before the penalty ladder sees them
        if self._mp:
            st32 = np.asarray(out.status)
            failed32 = np.isin(st32, _UNSOLVED_CODES)
            if failed32.any():
                lbq, ubq = self._mask_decided(lbx, ubx, failed32)
                out64 = self._run(bmat, lbq, ubq, cuts)
                s64 = np.asarray(out64.status)
                take = failed32 & ~np.isin(s64, _UNSOLVED_CODES)
                out = _merge_outputs(out, out64, take)

        pre_y = (None if out.y_pre is None
                 else np.asarray(out.y_pre)[:, :m])
        pre_X = (None if out.X_pre is None
                 else [np.asarray(x) for x in out.X_pre])
        pre_has = None if out.has_pre is None else np.asarray(out.has_pre)
        status = np.asarray(out.status).copy()
        objval = np.asarray(out.dobj).copy()
        y = np.asarray(out.y)[:, :m].copy()
        X = [np.array(xb) for xb in out.X]
        xl = np.asarray(out.xl).copy()
        xlb = np.asarray(out.xlb)[:, :m].copy()
        xub = np.asarray(out.xub)[:, :m].copy()
        direct_iters = int(out.iters)
        nsolves = 1
        npenalty = 0
        out_tier = np.full((B, 2), np.nan)
        if onevar:
            self._apply_onevar(onevar, status, objval, y, X, xl, xlb, xub)

        failed = np.isin(status, _UNSOLVED_CODES)
        live = ~(lb > ub).any(axis=1)    # dummy slots don't count
        ndirect = int((~failed & live).sum())
        if failed.any() and not out_of_time():
            # rung 2: feasibility probe (Gamma = 1, objective zero)
            self.stat_nprobes += 1
            ubp = ubx.copy()
            ubp[:, m] = INF
            bprobe = np.zeros_like(bmat)
            bprobe[:, m] = 1.0
            lbq, ubq = self._mask_decided(lbx, ubp, failed)
            outp = self._run(bprobe, lbq, ubq, cuts)
            nsolves += 1
            pstat = np.asarray(outp.status)
            rstar = np.asarray(outp.r)
            infeas_margin = ipms.peninfeasadjust * max(feastol, ipms.gaptol)
            proved_infeas = (
                failed
                & (pstat == int(SolverResultStatus.OPTIMAL))
                & (rstar > infeas_margin)
            )
            status[proved_infeas] = int(SolverResultStatus.INFEASIBLE)
            if proved_infeas.any():
                # keep the probe's primal certificate (X, lp multipliers):
                # it is the Farkas-style aggregation witness the conflict
                # cut is built from (computeConflictCut, relax_sdp.c:954)
                for t in range(len(X)):
                    X[t][proved_infeas] = np.asarray(outp.X[t])[proved_infeas]
                xl[proved_infeas] = np.asarray(outp.xl)[proved_infeas]
                xlb[proved_infeas] = np.asarray(outp.xlb)[proved_infeas, :m]
                xub[proved_infeas] = np.asarray(outp.xub)[proved_infeas, :m]
            failed = np.isin(status, _UNSOLVED_CODES)

        if failed.any() and not out_of_time():
            # rung 3: penalty rescue with the reference's escalation rule
            # (sdpi.c:3497-3599): per instance, Gamma grows toward
            # maxpenaltyparam and gaptol shrinks toward MIN_GAPTOL; when a
            # solve converges but its r > feastol (not ``feasorig``), the
            # primal penalty bound decides which knob moves —
            # Tr(X) ~ Gamma within PENALTYBOUNDTOL (``penaltybound``, read
            # off the r-column bound multiplier: xlb_r = Gamma - Tr(X))
            # means the penalty cap binds, so raise Gamma; otherwise the
            # solve was just not accurate enough, so tighten gaptol.
            gamma = np.full(B, ipms.penaltyparam)
            gtol = np.full(B, ipms.gaptol)
            if tier is not None:
                # settings inheritance: start at the parent's tier
                tg = np.asarray(tier[:, 0], dtype=np.float64)
                tt = np.asarray(tier[:, 1], dtype=np.float64)
                okg = np.isfinite(tg)
                gamma[okg] = np.clip(tg[okg], ipms.penaltyparam,
                                     ipms.maxpenaltyparam)
                okt = np.isfinite(tt)
                gtol[okt] = np.clip(tt[okt], ipms.min_gaptol, ipms.gaptol)
            if ipms.npenaltyincr > 0:
                pfact = (ipms.maxpenaltyparam / ipms.penaltyparam) ** (
                    1.0 / ipms.npenaltyincr)
                gfact = (ipms.min_gaptol / ipms.gaptol) ** (
                    1.0 / ipms.npenaltyincr)
            else:
                pfact = 2.0 * ipms.maxpenaltyparam / ipms.penaltyparam
                gfact = 0.5 * ipms.min_gaptol / ipms.gaptol
            bound_only = np.full(B, -np.inf)
            have_bound = np.zeros(B, dtype=bool)
            did_spec = np.zeros(B, dtype=bool)

            # --- speculative parallel ladder (one dispatch) -------------
            # The serial escalation below pays one full batched solve per
            # rung for what is typically 1-2 straggler instances while the
            # other B-2 slots ride along masked.  Those idle slots are a
            # settings-diversified concurrent portfolio waiting to happen
            # (SCIPsdpiClone + concurrent paramsetprefix role, sdpi.c:2144
            # / settings/concurrent2.set): clone each failed instance into
            # the free slots at DIFFERENT (Gamma, gaptol) tiers sampled
            # along the escalation lattice (both edges + the diagonal) and
            # solve the whole ladder in ONE dispatch, adopting the
            # lowest-tier acceptable outcome — the same decision set the
            # serial staircase explores, minus ~10 dispatches.
            n_i = max(int(ipms.npenaltyincr), 1)
            sched = []
            for i, j in ((1, 0), (0, 1), (1, 1), (2, 0), (0, 2), (2, 2),
                         (4, 0), (0, 4), (4, 4), (8, 0), (0, 8), (8, 8)):
                ij = (min(i, n_i), min(j, n_i))
                if ij not in sched and ij != (0, 0):
                    sched.append(ij)
            fidx = np.where(failed)[0]
            ntiers = min(len(sched) + 1, B // max(len(fidx), 1))
            if ntiers >= 3 and not out_of_time():
                free = [s for s in range(B) if not failed[s]]
                bpen = bmat.copy()
                lbq = np.ones_like(lbx)     # default: conflict box
                ubq = np.zeros_like(ubx)
                gt_vec = np.full(B, ipms.gaptol)
                cuts_s = None
                if cuts is not None:
                    Gc0, hc0, cv0 = cuts
                    Gc_s, hc_s, cv_s = (Gc0.copy(), hc0.copy(), cv0.copy())
                assign = {}   # owner -> [(slot, (i, j)), ...]
                tpos = 0
                for f in fidx:
                    slots = [int(f)] + [free.pop() for _ in range(
                        min(ntiers - 1, len(free)))]
                    assign[int(f)] = []
                    for k, s in enumerate(slots):
                        i, j = ((0, 0) if k == 0 else sched[k - 1])
                        g_s = min(gamma[f] * pfact ** i,
                                  ipms.maxpenaltyparam)
                        t_s = max(gtol[f] * gfact ** j, ipms.min_gaptol)
                        bpen[s] = bmat[f]
                        bpen[s, m] = g_s
                        lbq[s] = lbx[f]
                        ubq[s] = ubx[f]
                        ubq[s, m] = INF
                        gt_vec[s] = t_s
                        if cuts is not None:
                            Gc_s[s] = Gc0[f]
                            hc_s[s] = hc0[f]
                            cv_s[s] = cv0[f]
                        assign[int(f)].append((s, g_s, t_s))
                if cuts is not None:
                    cuts_s = (Gc_s, hc_s, cv_s)
                outk = self._run(bpen, lbq, ubq, cuts_s, gaptol=gt_vec)
                nsolves += 1
                kstat = np.asarray(outk.status)
                kr = np.asarray(outk.r)
                kdobj = np.asarray(outk.dobj)
                ky = np.asarray(outk.y)
                kxl = np.asarray(outk.xl)
                kxlb = np.asarray(outk.xlb)
                kxub = np.asarray(outk.xub)
                kX = [np.asarray(xb) for xb in outk.X]
                for f, slots in assign.items():
                    for s, g_s, t_s in slots:
                        conv = kstat[s] == int(SolverResultStatus.OPTIMAL)
                        if conv and kr[s] <= feastol:
                            npenalty += 1
                            status[f] = int(SolverResultStatus.OPTIMAL)
                            objval[f] = kdobj[s] - g_s * kr[s]
                            y[f] = ky[s, :m]
                            for t in range(len(X)):
                                X[t][f] = kX[t][s]
                            xl[f] = kxl[s]
                            xlb[f] = kxlb[s, :m]
                            xub[f] = kxub[s, :m]
                            out_tier[f] = (g_s, t_s)
                            break
                        if conv:
                            bound_only[f] = max(bound_only[f], kdobj[s])
                            have_bound[f] = True
                    did_spec[f] = True
                failed = np.isin(status, _UNSOLVED_CODES)

            # --- serial escalation (fallback when slots are scarce) -----
            for _ in range(2 * ipms.npenaltyincr + 2):
                active = (failed & ~did_spec
                          & (gamma < ipms.maxpenaltyparam + ipms.epsilon)
                          & (gtol > 0.99 * ipms.min_gaptol))
                if not active.any() or out_of_time():
                    break
                bpen = bmat.copy()
                bpen[:, m] = gamma
                ubp = ubx.copy()
                ubp[:, m] = INF
                lbq, ubq = self._mask_decided(lbx, ubp, active)
                outk = self._run(bpen, lbq, ubq, cuts, gaptol=gtol)
                nsolves += 1
                kstat = np.asarray(outk.status)
                kr = np.asarray(outk.r)
                kconv = kstat == int(SolverResultStatus.OPTIMAL)
                # not acceptable -> raise Gamma (sdpi.c:3540-3546)
                notacc = active & ~kconv
                gamma[notacc] *= pfact
                feasorig = active & kconv & (kr <= feastol)
                if feasorig.any():
                    npenalty += int(feasorig.sum())
                    out_tier[feasorig, 0] = gamma[feasorig]
                    out_tier[feasorig, 1] = gtol[feasorig]
                    status[feasorig] = int(SolverResultStatus.OPTIMAL)
                    ky = np.asarray(outk.y)
                    objval[feasorig] = (
                        np.asarray(outk.dobj)[feasorig]
                        - gamma[feasorig] * kr[feasorig]
                    )
                    y[feasorig] = ky[feasorig, :m]
                    for t in range(len(X)):
                        X[t][feasorig] = np.asarray(outk.X[t])[feasorig]
                    xl[feasorig] = np.asarray(outk.xl)[feasorig]
                    xlb[feasorig] = np.asarray(outk.xlb)[feasorig, :m]
                    xub[feasorig] = np.asarray(outk.xub)[feasorig, :m]
                # converged but r > feastol: the penalty objective still
                # bounds the original optimum from below (sdpi.c
                # GetLowerObjbound / bestbound update :3551), and the
                # penaltybound test picks the next knob (:3554-3570)
                usable = active & kconv & ~feasorig
                bound_only = np.where(
                    usable, np.maximum(bound_only, np.asarray(outk.dobj)),
                    bound_only,
                )
                have_bound = have_bound | usable
                xlb_r = np.asarray(outk.xlb)[:, m]
                penaltybound = xlb_r < ipms.penaltyboundtol * gamma
                gamma[usable & penaltybound] *= pfact
                gtol[usable & ~penaltybound] *= gfact
                failed = np.isin(status, _UNSOLVED_CODES)

            salvage = failed & have_bound
            if salvage.any():
                status[salvage] = int(SolverResultStatus.BOUND_ONLY)
                objval[salvage] = bound_only[salvage]
                failed = np.isin(status, _UNSOLVED_CODES)
            # ladder-exhausted instances: children (and requeues) start at
            # the TOP tier instead of re-climbing the whole ladder on
            # every visit (cons_savedsdpsettings inheritance extended to
            # unsuccessful ladders — the climb itself is what they would
            # repeat, relax_sdp.c:4085-4120 role)
            exhausted = salvage | failed
            if exhausted.any():
                # one step below the top so the child still gets one
                # near-top penalty attempt (its relaxation may be easier)
                out_tier[exhausted, 0] = ipms.maxpenaltyparam / pfact
                out_tier[exhausted, 1] = ipms.min_gaptol / gfact

        if failed.any() and not out_of_time():
            # Farkas-style box bound from the primal iterate
            # (computeConflictCut aggregation, relax_sdp.c:954-1410):
            # for ANY X >= 0 and xl >= 0,
            #   b^T y  =  (b - g)^T y + g^T y  >=  (b - g)^T y + lhs
            # with g_j = sum_b tr(A_j^b X_b) + xl G_j and lhs = tr(C X)
            # + xl h; minimizing the linear term over the node box gives
            # a VALID dual bound even when the solve cannot certify —
            # exactly the weak-duality nodes (mostly-fixed boxes, y side
            # converged, pinf stalled) that otherwise exhaust the ladder
            # and branch bound-less forever (example_multaggr2 round 5).
            import types as _types
            g, lhs = self.conflict_cuts(
                _types.SimpleNamespace(X=X, xl=xl, y=y))
            coef = bmat[:, :m] - g
            lo = np.where(lb <= -1e19, -np.inf, lb)
            hi = np.where(ub >= 1e19, np.inf, ub)
            with np.errstate(invalid="ignore"):
                t1 = coef * lo
                t2 = coef * hi
            terms = np.where(np.abs(coef) <= 1e-14, 0.0,
                             np.minimum(t1, t2))
            bnd = lhs + terms.sum(axis=1)
            good = failed & np.isfinite(bnd)
            if good.any():
                # safety margin for the iterate's numerical PSD slack
                bnd = bnd - feastol * (1.0 + np.abs(bnd))
                status[good] = int(SolverResultStatus.BOUND_ONLY)
                objval[good] = bnd[good]
                failed = np.isin(status, _UNSOLVED_CODES)

        if failed.any() and not out_of_time():
            # rung 4: box rescue / unboundedness detection
            lbb = lbx.copy()
            ubb = ubx.copy()
            art_lb = lbb[:, :m] < -BOX_BOUND
            art_ub = ubb[:, :m] > BOX_BOUND
            lbb[:, :m] = np.maximum(lbb[:, :m], -BOX_BOUND)
            ubb[:, :m] = np.minimum(ubb[:, :m], BOX_BOUND)
            lbb, ubb = self._mask_decided(lbb, ubb, failed)
            outb = self._run(bmat, lbb, ubb, cuts)
            nsolves += 1
            bstat = np.asarray(outb.status)
            byfull = np.asarray(outb.y)[:, :m]
            at_box = np.any(
                (art_lb & (byfull <= -BOX_ACTIVE_TOL * BOX_BOUND))
                | (art_ub & (byfull >= BOX_ACTIVE_TOL * BOX_BOUND)),
                axis=1,
            )
            bconv = bstat == int(SolverResultStatus.OPTIMAL)
            unbounded = failed & bconv & at_box
            recovered = failed & bconv & ~at_box
            status[unbounded] = int(SolverResultStatus.UNBOUNDED)
            objval[unbounded] = -np.inf
            status[recovered] = int(SolverResultStatus.OPTIMAL)
            objval[recovered] = np.asarray(outb.dobj)[recovered]
            y[recovered] = byfull[recovered]
            for t in range(len(X)):
                X[t][recovered] = np.asarray(outb.X[t])[recovered]
            xl[recovered] = np.asarray(outb.xl)[recovered]
            xlb[recovered] = np.asarray(outb.xlb)[recovered, :m]
            xub[recovered] = np.asarray(outb.xub)[recovered, :m]

        # independent solution verification + feastol-tightened re-solve
        # (sdpsolchecker.c:58 contract; INFEASFEASTOLCHANGE re-solve loop,
        # sdpisolver_dsdp.c:66,1549): a "converged" instance whose returned
        # y fails the independent feastol check is re-solved with the
        # CONVERGENCE feastol tightened 10x (traced — no recompile), and
        # only declared FAILED when even the tightened solves cannot
        # produce a verifiable solution.  One-var-decided instances are
        # exempt: their optimum is an exact eigenvalue-interval endpoint
        # (the interval computation IS the independent check), they sit by
        # construction AT the feastol boundary, and their slots carry a
        # conflict box so an IPM re-solve could only report infeasible.
        optm = (status == int(SolverResultStatus.OPTIMAL)) & live
        for i in onevar:
            optm[i] = False
        if optm.any():
            from scipsdp_tpu.core.feascheck import check_points
            okv = np.asarray(check_points(self.data, self._put(y),
                                          self._put(lb), self._put(ub),
                                          feastol=float(feastol))[0])
            bad = optm & ~okv
            ft = feastol
            while bad.any() and ft > 1e-9 and not out_of_time():
                ft *= 0.1
                self.stat_nveri_resolve += 1
                lbq, ubq = self._mask_decided(lbx, ubx, bad)
                outv = self._run(bmat, lbq, ubq, cuts,
                                 feastol_vec=np.full(B, ft))
                nsolves += 1
                vstat = np.asarray(outv.status)
                take = bad & (vstat == int(SolverResultStatus.OPTIMAL))
                if take.any():
                    objval[take] = np.asarray(outv.dobj)[take]
                    y[take] = np.asarray(outv.y)[take, :m]
                    for t in range(len(X)):
                        X[t][take] = np.asarray(outv.X[t])[take]
                    xl[take] = np.asarray(outv.xl)[take]
                    xlb[take] = np.asarray(outv.xlb)[take, :m]
                    xub[take] = np.asarray(outv.xub)[take, :m]
                    okv = np.asarray(check_points(
                        self.data, self._put(y), self._put(lb),
                        self._put(ub), feastol=float(feastol))[0])
                    bad = bad & ~(take & okv)
            status[bad] = int(SolverResultStatus.FAILED)

        if out_of_time():
            # ladder was cut short by the per-solve budget: undecided
            # instances report TIMELIMIT, not numerical failure
            timed_out = np.isin(status, (int(SolverResultStatus.FAILED),
                                         int(SolverResultStatus.ITERLIMIT)))
            status[timed_out] = int(SolverResultStatus.TIMELIMIT)

        nunsolved = int(np.isin(status, _UNSOLVED_CODES).sum())
        self.stat_npenalty += npenalty
        self.stat_nunsolved += nunsolved

        return BatchSolveResult(
            status=status,
            objval=objval,
            y=y,
            X=X,
            xl=xl,
            xlb=xlb,
            xub=xub,
            iters=direct_iters,
            nsolves=nsolves,
            npenalty=npenalty,
            nunsolved=nunsolved,
            ndirect=ndirect,
            tier=out_tier,
            pre_y=pre_y,
            pre_X=pre_X,
            pre_has=pre_has,
            round_y=round_y,
            round_feas=round_feas,
            round_val=round_val,
        )
