"""Family-scale benchmark: nodes/s and time-to-solution vs batch
width at sizes where the tree actually fills wide batches (a 39-node
tree at batch 8 cannot show batch throughput), with per-size DSDP
baselines, up to the production tier (blocks 65-129).

Generates CLS/MkP/TT instances (models/families.py) at sizes whose B&B
trees hold hundreds+ of live nodes, solves each at several batch widths
on the live backend, and prints one JSON line per run plus a summary
table, each naming the device.  Writes BENCH_FAMILIES.json.  Runs in
one process on the GPU and fails when JAX finds none.

Per-row metrics:
  time_s            — time-to-solution (the honest headline)
  nodes_per_s       — processed-node throughput (includes speculative
                      nodes a wide batch expands beyond the B=8 tree)
  speculation       — nodes / min(nodes across batches for the family):
                      >1 quantifies the speculative inflation
  baseline_nodes_per_s / vs_baseline
                    — per-size single-thread DSDP denominator
                      (baseline_dsdp.baseline_nodes_per_s: BASELINE.md's
                      100 nodes/s CLS anchor scaled by the measured
                      per-size DSDP op-mix cost; sdpisolver_dsdp.c solve
                      path)

Correctness anchor: families have no reference optima, so each solve
must (a) finish OPTIMAL with gap 0, and (b) at the smallest batch and
largest batch agree on the objective to 1e-6 relative — a cross-batch
consistency check (the per-instance optimum is batch-independent).
"""

import argparse
import json
import time

import numpy as np
import jax

import baseline_dsdp
from scipsdp_tpu.core.branchbound import solve_misdp
from scipsdp_tpu.models.families import (cardinality_least_squares,
                                         min_k_partition, truss_topology)
from scipsdp_tpu.utils.config import BBSettings, Settings

CONFIGS = [
    # (label, generator factory, batches)
    ("cls_14", lambda: cardinality_least_squares(14, 28, 5, seed=3),
     (8, 32, 64)),
    ("cls_18", lambda: cardinality_least_squares(18, 36, 6, seed=3),
     (8, 32, 64, 128)),
    ("cls_22", lambda: cardinality_least_squares(22, 44, 7, seed=3),
     (8, 32, 64, 128)),
    ("mkp_10", lambda: min_k_partition(10, 3, 0.7, seed=1), (8, 32, 64)),
    ("mkp_12", lambda: min_k_partition(12, 3, 0.6, seed=1), (8, 32, 64)),
    ("tt_10", lambda: truss_topology(10, 2, seed=1), (8, 32, 64)),
    ("tt_14", lambda: truss_topology(14, 3, seed=1), (8, 32, 64)),
    # production-size tier: block sizes 65-129 where the reference's
    # per-node cost is O(m n^3 + m^2 n^2) while the batched GEMMs fill the
    # card; node_limit caps keep wall time bounded — nodes/s at the cap
    # is the throughput metric (objective consistency still checked when
    # both batches finish)
    ("cls_32", lambda: cardinality_least_squares(32, 64, 8, seed=5),
     (32, 128)),
    ("cls_48", lambda: cardinality_least_squares(48, 96, 10, seed=5),
     (32, 128)),
    ("cls_64", lambda: cardinality_least_squares(64, 128, 12, seed=5),
     (32, 128)),
]
NODE_CAPS = {"cls_32": 4000, "cls_48": 2000, "cls_64": 1000}


def run_one(prob, batch, node_limit=200_000, time_limit=900.0):
    s = Settings(bb=BBSettings(batch_size=batch, node_limit=node_limit,
                               time_limit=time_limit))
    t0 = time.perf_counter()
    res = solve_misdp(prob, s)
    dt = time.perf_counter() - t0
    return res, dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", help="comma-separated config labels")
    ap.add_argument("--out", default="BENCH_FAMILIES.json")
    args = ap.parse_args()
    only = set(args.only.split(",")) if args.only else None

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench_families.py needs a GPU; jax backend is "
                         f"{jax.default_backend()!r}")
    import scipsdp_tpu
    scipsdp_tpu.enable_compilation_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    rows = []
    for label, gen, batches in CONFIGS:
        if only and label not in only:
            continue
        prob = gen()
        n_blk = max(b.size for b in prob.blocks)
        base = baseline_dsdp.baseline_nodes_per_s(n_blk, prob.nvars)
        objs = {}
        fam_rows = []
        cap = NODE_CAPS.get(label, 200_000)
        for batch in batches:
            # warm-up at THIS batch width compiles the graphs (every
            # (shape, batch) pair is its own executable)
            _ = run_one(prob, batch, node_limit=3 * batch)
            res, dt = run_one(prob, batch, node_limit=cap)
            nps = res.stats.nodes / max(dt, 1e-9)
            row = {
                "family": label, "nvars": prob.nvars, "nblk": n_blk,
                "batch": batch,
                "status": res.status.name,
                "nodes": res.stats.nodes,
                "iters": res.stats.ipm_iterations,
                "rounds": res.stats.relax_solves,
                "time_s": round(dt, 3),
                "nodes_per_s": round(nps, 2),
                "baseline_nodes_per_s": round(base, 2),
                "vs_baseline": round(nps / base, 2),
                "objective": res.objval,
                "device": device,
            }
            objs[batch] = res.objval
            fam_rows.append(row)
            rows.append(row)
            print(json.dumps(row), flush=True)
            with open(args.out, "w") as f:   # incremental: survive kills
                json.dump(rows, f, indent=1)
        # speculative-node inflation vs the family's leanest tree
        min_nodes = min(r["nodes"] for r in fam_rows)
        for r in fam_rows:
            r["speculation"] = round(r["nodes"] / max(min_nodes, 1), 2)
        vals = [v for v in objs.values() if v is not None]
        if vals and (max(vals) - min(vals)) > 1e-6 * max(1.0, abs(vals[0])):
            print(json.dumps({"family": label,
                              "WARNING": "cross-batch objective mismatch",
                              "objs": {str(k): v
                                       for k, v in objs.items()}}),
                  flush=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    # summary table
    print("\nfamily      nvars  batch  nodes   time(s)  nodes/s  "
          "vs_dsdp  spec")
    for r in rows:
        print(f"{r['family']:<11} {r['nvars']:>5} {r['batch']:>6} "
              f"{r['nodes']:>6} {r['time_s']:>8.1f} "
              f"{r['nodes_per_s']:>8.1f} {r['vs_baseline']:>8.2f} "
              f"{r.get('speculation', 1.0):>5.2f}  {r['status']}")


if __name__ == "__main__":
    main()
