"""End-of-run statistics tables.

Analog of the reference's display columns and statistics tables
(disp_sdpiterations.c, disp_sdpavgiterations.c, disp_sdppenalty.c,
disp_sdpunsolved.c; table_relaxsdp.c; relax_sdp.c's ~35 statistics
getters:6016-6562): the same counters, formatted as one text table.
"""

from __future__ import annotations


def format_relax_statistics(stats, iface=None) -> str:
    """Render the relaxator statistics table (table_relaxsdp analog)."""
    lines = ["SDP relaxator statistics:"]

    def row(k, v):
        lines.append(f"  {k:<32}: {v}")

    row("B&B nodes", stats.nodes)
    row("batched relaxation solves", stats.relax_solves)
    row("solver calls (incl. ladder)", stats.solver_calls)
    row("IPM iterations (direct solves)", stats.ipm_iterations)
    avg = stats.ipm_iterations / max(stats.relax_solves, 1)
    row("average IPM iterations", f"{avg:.2f}")
    row("fastest-tier (direct) decisions", getattr(stats, "ndirect", 0))
    row("device tree-loop nodes", getattr(stats, "turbo_nodes", 0))
    row("device tree-loop bail-outs", getattr(stats, "turbo_bails", 0))
    row("penalty-formulation decisions", stats.npenalty)
    row("unsolved relaxations", stats.nunsolved)
    row("heuristic solutions found", stats.heur_found)
    row("cutting planes", stats.ncuts)
    row("separation rounds", stats.sep_rounds)
    row("redcost bound tightenings", stats.redcost_tightenings)
    if getattr(stats, "roundingprobinf", 0):
        row("rounding-problem cutoffs", stats.roundingprobinf)
    if getattr(stats, "nnogoods", 0):
        row("learned no-good rows", stats.nnogoods)
    if getattr(stats, "orbital_fixings", 0):
        row("orbital fixings (symmetry)", stats.orbital_fixings)
    if getattr(stats, "nnogoods_dropped", 0):
        row("no-goods dropped (length cap)", stats.nnogoods_dropped)
    if getattr(stats, "ncuts_dropped", 0):
        row("pool cuts dropped (pool cap)", stats.ncuts_dropped)
    if getattr(stats, "sym_capped", ""):
        row("automorphism search capped", stats.sym_capped)
    if getattr(stats, "nstolen", 0) or getattr(stats, "ndonated", 0):
        row("multi-host: nodes stolen", stats.nstolen)
        row("multi-host: nodes donated", stats.ndonated)
    row("relaxation solve time (s)", f"{stats.solve_time:.2f}")
    row("wall time (s)", f"{stats.wall_time:.2f}")
    pt = getattr(stats, "prop_times", None)
    if pt:
        lines.append("propagation timing (enableproptiming):")
        for k, v in sorted(pt.items()):
            row(k, f"{v:.3f}s")
    # table_slater.c analog: per-node dual Slater condition breakdown
    nsl = (getattr(stats, "slater_holds", 0)
           + getattr(stats, "slater_fails", 0)
           + getattr(stats, "slater_undecided", 0))
    if nsl:
        lines.append("Slater condition (dual, per node):")
        row("holds", f"{stats.slater_holds} ({stats.slater_holds/nsl:.0%})")
        row("fails (boundary/infeasible)",
            f"{stats.slater_fails} ({stats.slater_fails/nsl:.0%})")
        row("undecided",
            f"{stats.slater_undecided} ({stats.slater_undecided/nsl:.0%})")
    nslp = (getattr(stats, "slater_primal_holds", 0)
            + getattr(stats, "slater_primal_fails", 0)
            + getattr(stats, "slater_primal_undecided", 0))
    if nslp:
        lines.append("Slater condition (primal, per node):")
        row("holds", f"{stats.slater_primal_holds} "
            f"({stats.slater_primal_holds/nslp:.0%})")
        row("fails", f"{stats.slater_primal_fails} "
            f"({stats.slater_primal_fails/nslp:.0%})")
        row("undecided", f"{stats.slater_primal_undecided} "
            f"({stats.slater_primal_undecided/nslp:.0%})")
    if getattr(stats, "nenforce_sdp", 0):
        row("LP-mode exact-SDP enforcements", stats.nenforce_sdp)
    if getattr(stats, "ndropped_nodes", 0):
        row("nodes dropped undecidable", stats.ndropped_nodes)
    if iface is not None:
        row("interface: total solves", iface.stat_nsolves)
        row("interface: feasibility probes", iface.stat_nprobes)
        row("interface: penalty successes", iface.stat_npenalty)
        row("interface: unsolved", iface.stat_nunsolved)
        if getattr(iface, "stat_nonevar", 0):
            row("interface: one-var fast path", iface.stat_nonevar)
        if getattr(iface, "stat_nveri_resolve", 0):
            row("interface: verify re-solves", iface.stat_nveri_resolve)
    return "\n".join(lines)
