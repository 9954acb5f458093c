"""Benchmark: full branch-and-bound throughput on the flagship MISDP.

Prints ONE JSON line:
  {"metric": "bb_nodes_per_s", "value": N, "unit": ..., "device": {...}}

Metric: B&B nodes per second for a complete solve of cls_48
(``cardinality_least_squares(48, 96, 10, seed=5)``: one 97x97 SDP block,
97 variables) through ``solve_misdp`` — batched IPM relaxations, recovery
ladder, heuristics, propagation and pruning all included.  A warm-up
solve with a small node limit first compiles every device graph, so the
timed solve measures steady state.  ``--smoke`` uses cls_14.

Runs in one process on the GPU and fails when JAX finds none.

    python bench.py [--smoke] [--batch 32]
"""

import argparse
import json
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        sys.stderr.write(f"bench.py needs a GPU; jax backend is "
                         f"{jax.default_backend()!r}\n")
        return 1
    import scipsdp_tpu
    scipsdp_tpu.enable_compilation_cache()

    from scipsdp_tpu.core.branchbound import solve_misdp
    from scipsdp_tpu.models.families import cardinality_least_squares
    from scipsdp_tpu.utils.config import BBSettings, Settings
    from scipsdp_tpu.utils.status import SolveStatus

    if args.smoke:
        name, prob = "cls_14", cardinality_least_squares(14, 28, 5, seed=3)
    else:
        name, prob = "cls_48", cardinality_least_squares(48, 96, 10, seed=5)

    warm = Settings(bb=BBSettings(batch_size=args.batch,
                                  node_limit=2 * args.batch))
    solve_misdp(prob, warm)
    t0 = time.perf_counter()
    res = solve_misdp(prob, Settings(bb=BBSettings(batch_size=args.batch)))
    wall = time.perf_counter() - t0
    ok = (res.status == SolveStatus.OPTIMAL and res.gap == 0.0
          and res.stats.turbo_bails == 0)
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "bb_nodes_per_s",
        "value": res.stats.nodes / wall,
        "unit": "nodes/s",
        "instance": name,
        "batch": args.batch,
        "nodes": res.stats.nodes,
        "wall_s": wall,
        "status": res.status.name,
        "objective": res.objval,
        "turbo_bails": res.stats.turbo_bails,
        "ok": ok,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
