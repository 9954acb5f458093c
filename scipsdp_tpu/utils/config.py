"""Typed configuration tree.

Mirrors the reference's parameter registry (SCIP params plus the ~37
``relaxing/SDP/*`` params of relax_sdp.c:5374-5560, the SDPI params of
src/sdpi/sdpi.c:197-203 and type_sdpi.h:47-66, and SCIP-SDP's re-defaulted
SCIP params, scipsdpdefplugins.c:127-204) as plain dataclasses so a Settings
instance can be closed over by jitted solver functions (all fields are static
Python scalars).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class IPMSettings:
    """Interior-point solver parameters (replaces DSDP/SDPA/MOSEK knobs).

    Tolerance semantics follow the reference: ``gaptol`` is the relative
    duality-gap stopping criterion (relaxing/SDP/sdpsolvergaptol, default
    1e-5, relax_sdp.c:70-71), ``feastol`` the feasibility tolerance of the
    returned solution (relaxing/SDP/sdpsolverfeastol, 1e-5).
    """

    gaptol: float = 1e-5
    feastol: float = 1e-5
    epsilon: float = 1e-9          # equality test (sdpi.c DEFAULT_EPSILON)
    max_iters: int = 100           # IPM iteration cap per solve attempt
    # penalty formulation ladder (sdpi.c:197-203, sdpisolver.h:237-245).
    # The reference starts Gamma at 1e5 (tuned for DSDP/SDPA); our IPM
    # converges best from a gentle Gamma with escalation toward 1e10 —
    # large Gamma inflates the objective scale and degrades the Schur
    # conditioning before it is needed.
    penaltyparam: float = 1e3      # starting Gamma
    maxpenaltyparam: float = 1e10  # maximal Gamma
    npenaltyincr: int = 8          # number of Gamma increases
    peninfeasadjust: float = 1.1   # infeasibility margin (relax_sdp.c:96)
    min_gaptol: float = 1e-10      # MIN_GAPTOL floor when the ladder
                                   # tightens gaptol (sdpi.c:56,3507)
    penaltyboundtol: float = 1e-3  # Tr(X) ~ Gamma relative tolerance that
                                   # decides "raise Gamma" vs "tighten
                                   # gaptol" (PENALTYBOUNDTOL,
                                   # sdpisolver_dsdp.c:61)
    # numerics
    dtype: str = "float64"         # "float64" | "float32"
    mixed_precision: str = "off"   # "on" | "off": try a fast f32 solve
                                   # first and escalate failures to f64
                                   # (the reference's fast->stable settings
                                   # tiers).  f32 cannot reach gaptol 1e-5,
                                   # so the tier only pays off with
                                   # loosened tolerances — off by default
    phase32: str = "auto"          # inexact-Newton mixed precision INSIDE
                                   # one solve: while every active
                                   # instance's relative gap is above
                                   # ``phase32_switch``, search directions
                                   # (factorizations + solves + matmuls)
                                   # are computed in f32 against the exact
                                   # f64 residuals; the endgame runs full
                                   # f64.  "auto" resolves per backend in
                                   # resolve_backend_autos
    phase32_switch: float = 1e-3   # relative-gap handoff point
    # phase32 = "refine": a 3-tier precision ladder — plain-f32
    # directions while relgap > phase32_switch, then an f64-assembled
    # phase whose equilibrated-f32 Schur solves are polished by f64
    # residual refinement ("refine" proper) down to refine_switch, then
    # full f64.  With the default refine_switch = 0 the refine tier
    # carries the solve all the way to gaptol (full f64 only fires via
    # the NaN escape).
    # phase32 = "lite" (experimental): plain-f32 assembly + refined Schur
    # solves only — cheaper but measured insufficient on CLS/MkP.
    refine_switch: float = 0.0     # relative-gap f64 handoff for "refine"
    schur_refine: int = 3          # f64 refinement passes on the Schur
                                   # solve in "refine" mode (3 measured
                                   # necessary for TT near convergence)
    gondzio: int = 0               # extra Gondzio centrality correctors
                                   # per iteration (reuse the factored
                                   # Schur complement; 0 = plain Mehrotra)
    # stall detection: declare FAILED after ``stall_window`` iterations
    # without a ``stall_factor`` merit (relgap+pinf+dinf) improvement
    stall_factor: float = 0.8
    stall_window: int = 15
    # what to do when an f32/refine direction NaNs (cond beyond f32):
    # "repair" = one full-f64 iteration, then back to the f32 tier;
    # "fail"   = mark the instance FAILED (recovery ladder / turbo probe
    #            rung takes over)
    nan32_policy: str = "repair"
    tau: float = 0.95              # fraction-to-boundary step factor
    #   (an adaptive tau->0.98 tail rule was measured NET NEGATIVE:
    #   example_small 30->63 iterations with extra ladder rungs)
    sigma_min: float = 1e-8        # minimum centering parameter
    chol_reg: float = 1e-12        # Schur diagonal regularization (relative)
    init_point_scale: float = 1.0  # lambda*-style initial point scaling
                                   # (SDPA lambdastar, relax_sdp.c:74);
                                   # multiplied by per-instance data norms;
                                   # 1.0 measured ~20% fewer IPM iterations
                                   # than 10.0 across the testset
    presolve_rounds: int = 3       # vectorized prepareLPData passes
                                   # (sdpi.c:1131 loop)
    warmstartipfactor: float = 0.5  # identity share in warmstart convex
                                    # combination (DEFAULT_WARMSTARTIPFACTOR)
    preopt_gap: float = 0.0        # > 0: snapshot the first iterate whose
                                   # relative gap drops below this value
                                   # (the PRE-optimal point SDPA captures
                                   # for warmstarts, sdpisolver_sdpa.cpp:
                                   # 1612-1618); 0 = off.  Set through
                                   # BBSettings.warmstartpreoptsol
    onevar: bool = True            # one-active-variable fast path: decide
                                   # instances with exactly one free var
                                   # on the host (ops/onevar.py) and mask
                                   # them out of the IPM dispatch
                                   # (SCIPsolveOneVarSDP, sdpi.c:3301-3381)
    step_rule: str = "auto"        # PSD max-step: "eigh" (exact),
                                   # "probe" (Gershgorin base + ONE
                                   # stacked f32 Cholesky over a geometric
                                   # candidate ladder, certified via PSD-
                                   # segment convexity, within 2x of the
                                   # exact step), "power" (power iteration
                                   # + probe repair) or "gershgorin"
                                   # (eigh-free, conservative, ~doubles
                                   # iterations).  "auto" resolves per
                                   # backend in resolve_backend_autos


@dataclasses.dataclass(frozen=True)
class BBSettings:
    """Branch-and-bound orchestration parameters."""

    # SCIP-SDP re-defaults (scipsdpdefplugins.c:127-204)
    feastol: float = 1e-5          # numerics/feastol
    dualfeastol: float = 1e-5      # numerics/dualfeastol
    gaplimit: float = 0.0          # relative B&B gap limit
    node_limit: int = 1_000_000
    time_limit: float = 1e20
    lp_host_simplex: bool = True   # LP-mode node relaxations via a host
                                   # dual simplex (scipy HiGHS) instead of
                                   # the batched IPM — the reference's
                                   # LPs are solved by SCIP's simplex;
                                   # the IPM path took nearly all of
                                   # an LP-mode example_TT solve
    # best-first node selection is the reference default because SDP
    # warmstarts are weak (scipsdpdefplugins.c:152-158)
    node_selection: str = "bestbound"
    branching_rule: str = "infobjective"  # see core/branching.py; the
                                           # reference registers 4 rules
    batch_size: int = 16           # open nodes solved per device step
                                   # (device analog of concurrent solvers,
                                   # sdpi.c:2144 SCIPsdpiClone portfolio)
    heuristic_fracround: bool = True  # heur_sdpfracround.c analog
    heuristic_rand: bool = True    # heur_sdprand.c analog (randomized
                                   # rounding candidate in the fused
                                   # heuristic dispatch; settings tier
                                   # scip-4.set turns exactly this off)
    heuristic_innerlp: bool = False   # heur_sdpinnerlp.c analog (root
                                      # diagonally-dominant inner LP;
                                      # reference HEUR_FREQ = -1: off)
    diving_freq: int = 0           # heur_sdpfracdiving batched dives every
                                   # N batches (0 = off)
    obbt_at_root: bool = False     # prop_sdpobbt root tightening
    prop_freq: int = 1             # SDP-structural propagation cadence at
                                   # node creation (consPropSdp role,
                                   # cons_sdp.c:7046: propagateUpperBounds
                                   # + propagate3Minors on the matrix
                                   # view); every k-th depth, 0 = off.
                                   # Reference cons_sdp PROP_FREQ = 1
    obbt_freq: int = -1            # in-tree OBBT every k-th depth on the
                                   # current node's box (prop_sdpobbt.c;
                                   # the reference default PROP_FREQ = -1
                                   # keeps it OFF)
    enableproptiming: bool = False  # per-routine propagation timing
                                    # (constraints/SDP/enableproptiming,
                                    # cons_sdp.c:265-292); shown in the
                                    # statistics table
    conflict_nogoods: bool = True  # conflict analysis on propagation
                                   # conflicts (cons_sdp.c:4793,5138
                                   # analog): learn a binary no-good row
                                   # from each propagation-infeasible
                                   # child's fixings
    warmstart: bool = False        # relaxing/SDP/warmstart (DEFAULT FALSE)
    # warmstart recipe knobs (relax_sdp.c:77-86 defaults): project 2 =
    # clip the parent point into the child bounds (the interior-margin
    # projection in ops/ipm.py); 4 = solve the primal/dual rounding
    # problems first (core/probing.py::rounding_problem)
    warmstartproject: int = 2      # DEFAULT_WARMSTARTPROJECT
    warmstartiptype: int = 1       # DEFAULT_WARMSTARTIPTYPE: 1 scaled
                                   # identity, 2 root analytic centers
                                   # (SCIPrelaxSdpComputeAnalyticCenters,
                                   # relax_sdp.c:5589; prop_companalcent)
    warmstartprimal: bool = True   # feed the stored parent X as the IPM
                                   # primal start (fillStartX,
                                   # relax_sdp.c:2959-3049)
    warmstartroundonlyinf: bool = False  # DEFAULT_WARMSTARTROUNDONLYINF
    warmstartpreoptsol: bool = False  # warmstart children from a PRE-
                                      # optimal iterate instead of the
                                      # optimum (more interior -> better
                                      # starts; relax_sdp.c:77-86,
                                      # sdpisolver_sdpa.cpp:1612-1618)
    warmstartpreoptgap: float = 1e-2  # relative gap of the captured
                                      # pre-optimal iterate
    objlimit_pruning: bool = True
    # conflict constraints from relaxation certificates (relax_sdp.c:100-105
    # defaults): globally valid dual-aggregation rows used for propagation
    conflictconss: bool = True     # DEFAULT_CONFLICTCONSS
    conflictfeas: bool = True      # DEFAULT_CONFLICTFEAS (feasible nodes)
    conflictinfeas: bool = True    # DEFAULT_CONFLICTINFEAS (Farkas rows)
    conflictcmir: bool = False     # DEFAULT_CONFLICTCMIR
    max_conflict_rows: int = 256   # rolling cap on stored conflict rows
    # device-resident B&B (core/turbo.py): "auto" uses it whenever the
    # problem fits its feature set (integer branching, no rank-1 /
    # indicator / lift enforcement, best-first), falling back to the host
    # loop otherwise or when turbo bails (frontier overflow, ladder-hard
    # instances); "on" forces eligibility checks only; "off" disables
    turbo: str = "auto"
    turbo_capacity: int = 2048     # frontier slab slots (device memory)
    turbo_rounds: int = 32         # B&B rounds fused per device dispatch
                                   # (idle rounds are skipped by a scalar
                                   # cond, so a finished tree costs
                                   # nothing; each dispatch costs a host
                                   # sync — fuse generously)
    turbo_adaptive_batch: bool = True
    # ramp the effective batch width 8 -> batch_size as the live frontier
    # grows (width doubles once the frontier exceeds 4x the current
    # batch): small trees stop paying for speculative nodes a wide batch
    # would expand (cls_18 solves in 41 nodes at B=8 but 129 at B=64),
    # while deep trees (tt_14, 3k+ nodes) still reach the configured
    # width.  The frontier slab is batch-width-independent, so ramp steps
    # just switch compiled executables over the same device state.
    # LP-mode exact enforcement (constraints/SDP/enforcesdp,
    # cons_sdp.c:8276-8423): when an integral LP solution stays
    # SDP-infeasible after ``enforce_after`` separation rounds, solve the
    # node's TRUE SDP — infeasible => exact cutoff; integral optimum =>
    # node solved; fractional => adopt the exact bound and branch.  The
    # reference defaults enforcesdp FALSE and relies on endless
    # separation; here it is ON because it replaces an unsound requeue
    # cap and kills the separation convergence tail.
    enforcesdp: bool = True
    enforce_after: int = 4         # separation requeues before the exact
                                   # SDP probing solve
    usedimacsfeastol: bool = False  # scale the solution-check eigenvalue
                                    # tolerance by 1 + sum |obj_j| (the
                                    # DIMACS-error convention; cons_sdp.c
                                    # usedimacsfeastol, :703-710,
                                    # dimacsfeastol = 1e-5*(1+sum),
                                    # :7716-7727).  Reference default FALSE
    slatercheck: int = 0           # per-node dual Slater accounting
                                   # (sdpi.c:197 slatercheck: 0 off,
                                   # 1 statistics, 2 statistics + print);
                                   # summarized table_slater-style in the
                                   # statistics output


@dataclasses.dataclass(frozen=True)
class PresolveSettings:
    """Problem-level presolve switches (constraints/SDP/* params,
    cons_sdp.c:123-127 — defaults mirror the reference)."""

    diaggezerocuts: bool = False   # DEFAULT_DIAGGEZEROCUTS
    twominorlinconss: bool = False  # DEFAULT_TWOMINORLINCONSS
    move_1x1_blocks: bool = True    # move_1x1_blocks_to_lp
    diagzeroimplcuts: bool = True   # DEFAULT_DIAGZEROIMPLCUTS
    twominorprodconss: bool = False  # DEFAULT_TWOMINORPRODCONSS
    twominorsocconss: bool = False   # DEFAULT_TWOMINORSOCCONSS: the SOC
                                     # form of X_st^2 <= X_ss X_tt per
                                     # 2-minor (cons_sdp.c:2786-2807),
                                     # posed here as quadratic constraints
                                     # that the quad->rank-1 upgrade lifts
    twominorvarbounds: bool = True  # DEFAULT_TWOMINORVARBOUNDS
    tightenmatrices: bool = False   # DEFAULT_TIGHTENMATRICES
    fixvars: bool = True            # eliminate fixed variables from the
                                    # problem image (fixAndAggrVars /
                                    # SdpVarfixer role)
    aggregate: bool = True          # doubleton-equality aggregation
                                    # (multiaggrVar role)
    # 0: generated linear rows only propagate (LP mode also separates);
    # 1: rows join the relaxation (DEFAULT_PRESOLLINCONSSPARAM = 0)
    presollinconssparam: int = 0


@dataclasses.dataclass(frozen=True)
class CutSettings:
    """Eigenvector-cut separation switches (constraints/SDP/* params,
    cons_sdp.c:133-145 — defaults mirror the reference)."""

    generatecmir: bool = True        # DEFAULT_GENERATECMIR: strengthen
                                     # every eigenvector cut by c-MIR
    separateonecut: bool = False     # DEFAULT_SEPARATEONECUT: only the
                                     # most negative eigenvalue per block
    multiplesparsecuts: bool = False  # DEFAULT_MULTIPLESPARSECUTS
    maxnsparsecuts: int = 0          # DEFAULT_MAXNSPARSECUTS (-1: no limit)
    sparsifyfactor: float = 0.1      # DEFAULT_SPARSIFYFACTOR (target size
                                     # relative to number of variables)
    sparsifytargetsize: int = -1     # DEFAULT_SPARSIFYTARGETSIZE


@dataclasses.dataclass(frozen=True)
class Settings:
    ipm: IPMSettings = dataclasses.field(default_factory=IPMSettings)
    bb: BBSettings = dataclasses.field(default_factory=BBSettings)
    presolve: PresolveSettings = dataclasses.field(
        default_factory=PresolveSettings)
    cuts: CutSettings = dataclasses.field(default_factory=CutSettings)
    # misc/solvesdps master switch: 1 = nonlinear B&B with SDP relaxations
    # (default), 0 = LP outer approximation with eigenvector cuts
    # (relax_sdp.c:5428, param-change callback :5302-5373)
    solve_sdps: int = 1
    # symmetry handling (reference: compute_symmetry_bliss.cpp +
    # prop_sdpsymmetry; opt-in here, see core/symmetry.py).
    # mode "lexrows": static lexicographic ordering rows per orbit at
    # presolve; "orbital": full automorphism-group computation at the root
    # plus orbital fixing at every B&B node (prop_sdpsymmetry.c role) —
    # the two must not be combined on the same orbits, so the mode picks one
    use_symmetry: bool = False
    symmetry_mode: str = "lexrows"   # "lexrows" | "orbital"
    # multi-chip: shard node batches ("nodes") and SDP blocks ("blocks")
    # over all visible devices (parallel/mesh.py; the device replacement for
    # the reference's concurrent-solver portfolio at scale)
    use_mesh: bool = False
    mesh_devices: int = 0            # 0 = all local devices; >0 pins the
    #                                  mesh size (scaling studies/tests)
    verbosity: int = 0
    seed: int = 0

    def replace(self, **kw) -> "Settings":
        return dataclasses.replace(self, **kw)


def default_settings(**kw) -> Settings:
    return Settings(**kw)


# Per-backend resolution of the "auto" IPM knobs.  Both backends compute
# f64 natively, so both take the plain f64 path: exact eigh step rule,
# no f32 direction tier.
BACKEND_AUTOS = {
    "cpu": {"step_rule": "eigh", "phase32": "off"},
    "gpu": {"step_rule": "eigh", "phase32": "off"},
}


def resolve_backend_autos(settings: Settings) -> Settings:
    """Resolve backend-dependent "auto" IPM knobs (step_rule, phase32) for
    the active jax backend; idempotent.  A backend without an entry in
    ``BACKEND_AUTOS`` is an error."""
    ipm = settings.ipm
    if ipm.step_rule != "auto" and ipm.phase32 != "auto":
        return settings
    import jax

    backend = jax.default_backend()
    if backend not in BACKEND_AUTOS:
        raise RuntimeError(
            f"unsupported jax backend {backend!r}: expected one of "
            f"{sorted(BACKEND_AUTOS)}")
    autos = BACKEND_AUTOS[backend]
    repl = {k: v for k, v in autos.items() if getattr(ipm, k) == "auto"}
    return dataclasses.replace(
        settings, ipm=dataclasses.replace(ipm, **repl))
