"""Command-line driver.

Minimal analog of the reference's shell (src/scipsdp/main.c -> SCIP shell):
read a problem (.dat-s/.cbf/.cip, optionally .gz), solve it, print the
solve log and statistics, optionally write the solution / the problem.

    python -m scipsdp_tpu INSTANCE [options]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="scipsdp_tpu",
        description="GPU-batched mixed-integer SDP solver (SCIP-SDP capability)")
    ap.add_argument("instance", help="problem file (.dat-s/.cbf/.cip[.gz])")
    ap.add_argument("--lp-approx", action="store_true",
                    help="LP outer approximation mode (misc/solvesdps = 0)")
    ap.add_argument("--gaptol", type=float, default=1e-5)
    ap.add_argument("--feastol", type=float, default=1e-5)
    ap.add_argument("--node-limit", type=int, default=1_000_000)
    ap.add_argument("--time-limit", type=float, default=1e20)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--branching", default="infobjective",
                    choices=["mostfrac", "mostinf", "objective",
                             "infobjective"])
    ap.add_argument("--checkpoint", metavar="FILE",
                    help="periodic frontier checkpoint file")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the checkpoint file")
    ap.add_argument("--slater", action="store_true",
                    help="report the root Slater condition diagnosis "
                         "(table_slater analog)")
    ap.add_argument("--slatercheck", type=int, default=0,
                    help="per-node dual Slater accounting: 0 off, "
                         "1 statistics, 2 statistics + per-batch print "
                         "(sdpi.c slatercheck)")
    ap.add_argument("--settings", metavar="FILE",
                    help="SCIP-style .set parameter file "
                         "(reference settings/*.set work)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (without it a GPU is required)")
    ap.add_argument("--mesh", action="store_true",
                    help="shard node batches over all visible devices")
    ap.add_argument("--warmstart", action="store_true",
                    help="warmstart node solves from the parent solution "
                         "(relaxing/SDP/warmstart)")
    ap.add_argument("--innerlp", action="store_true",
                    help="run the inner-approximation LP heuristic at the "
                         "root (heur_sdpinnerlp)")
    ap.add_argument("--diving-freq", type=int, default=0,
                    help="batched fracdiving every N batches (0 = off)")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--write", metavar="OUT",
                    help="write the problem to OUT (.dat-s or .cbf)")
    ap.add_argument("--write-transformed", metavar="OUT",
                    help="presolve, then write the TRANSFORMED problem to "
                         "OUT incl. generated linear constraint classes "
                         "(reference changelog.txt:6-11 CBF-writer parity)")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        print(f"error: no GPU found (jax backend "
              f"{jax.default_backend()!r}); pass --cpu to run on the CPU",
              file=sys.stderr)
        return 2
    else:
        from scipsdp_tpu import enable_compilation_cache
        enable_compilation_cache()

    from scipsdp_tpu.core.branchbound import solve_misdp
    from scipsdp_tpu.models.io import read_problem
    from scipsdp_tpu.utils.config import BBSettings, IPMSettings, Settings
    from scipsdp_tpu.utils.statistics import format_relax_statistics

    prob = read_problem(args.instance)
    if not args.quiet:
        print(f"read problem <{prob.name}>: {prob.nvars} variables "
              f"({int(prob.integral.sum())} integer), {prob.nblocks} SDP "
              f"block(s), {prob.lp.nrows} linear constraint(s), "
              f"{len(prob.indicators)} indicator constraint(s)")

    if args.write:
        from scipsdp_tpu.models.writers import (write_cbf, write_cip,
                                                write_sdpa)
        if args.write.endswith(".cbf"):
            write_cbf(prob, args.write)
        elif args.write.endswith(".cip"):
            write_cip(prob, args.write)
        else:
            write_sdpa(prob, args.write)
        print(f"wrote problem to {args.write}")

    settings = Settings(
        ipm=IPMSettings(gaptol=args.gaptol, feastol=args.feastol),
        bb=BBSettings(feastol=args.feastol, node_limit=args.node_limit,
                      time_limit=args.time_limit, batch_size=args.batch_size,
                      branching_rule=args.branching,
                      warmstart=args.warmstart,
                      heuristic_innerlp=args.innerlp,
                      diving_freq=args.diving_freq,
                      slatercheck=args.slatercheck),
        solve_sdps=0 if args.lp_approx else 1,
        use_mesh=args.mesh,
    )
    if args.settings:
        from scipsdp_tpu.utils.paramfile import load_settings_file
        settings = load_settings_file(args.settings, settings)
    if args.write_transformed:
        from scipsdp_tpu.core.presolve_sdp import presolve_problem
        from scipsdp_tpu.models.writers import write_problem
        write_problem(presolve_problem(prob, settings),
                      args.write_transformed, transformed=True)
        print(f"wrote transformed problem to {args.write_transformed}")
    if args.slater:
        from scipsdp_tpu.core.probing import slater_check, slater_check_primal
        from scipsdp_tpu.core.sdpi import SDPInterface
        from scipsdp_tpu.models.problem import densify
        iface = SDPInterface(densify(prob), settings)
        st = slater_check(iface, prob.lb[None, :], prob.ub[None, :])
        names = {1: "holds", 0: "fails (boundary/infeasible)",
                 -1: "undecided"}
        print(f"root dual Slater condition  : {names[int(st[0])]}")
        stp = slater_check_primal(prob, settings, prob.lb, prob.ub)
        print(f"root primal Slater condition: {names[stp]}")

    res = solve_misdp(prob, settings, log=not args.quiet,
                      checkpoint=args.checkpoint, resume=args.resume)

    print(f"\nSCIP-SDP status     : {res.status.name}")
    if res.objval is not None:
        print(f"objective value     : {res.objval:.10g}")
    print(f"dual bound          : {res.dual_bound:.10g}")
    print(f"gap                 : {res.gap:.3g}")
    print()
    print(format_relax_statistics(res.stats))
    if res.best_y is not None and not args.quiet:
        names = prob.varnames or [f"x{j}" for j in range(prob.nvars)]
        nz = [(names[j], v) for j, v in enumerate(res.best_y) if abs(v) > 1e-9]
        print("\nsolution (nonzero entries):")
        for nm, v in nz[:50]:
            print(f"  {nm:<24} {v:.10g}")
        if len(nz) > 50:
            print(f"  ... ({len(nz) - 50} more)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
