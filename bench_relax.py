"""Relaxation-engine throughput: batched IPM node-relaxation solves per
second vs batch width at production sizes, against the per-size
single-thread DSDP denominator.

The full-solve family bench (bench_families.py) measures
time-to-solution, where the adaptive batch ramp keeps small trees
narrow — so it cannot show batch leverage.  This bench measures the
ENGINE rate directly: one fused IPM dispatch solving B node relaxations
(different boxes per slot, as a real frontier slice would be), timed at
several widths.

Whether dispatch time grows linearly in B (no batch leverage) or stays
flat decides the default batch width; the H100 answer is not measured
yet.

vs_baseline: relaxations/s over the per-size DSDP nodes/s
(baseline_dsdp.baseline_nodes_per_s — one relaxation per node, the
BASELINE.md 100 nodes/s CLS anchor scaled by the measured per-size
DSDP op-mix cost; calibrated quiet-host table in BASELINE_SIZES.json,
written by `python baseline_dsdp.py --calibrate`).

Prints one JSON line per (size, batch) naming the device; writes
BENCH_RELAX.json.  Runs in one process on the GPU and fails when JAX
finds none.
"""

import argparse
import json
import time

import numpy as np
import jax
import jax.numpy as jnp

import baseline_dsdp
from scipsdp_tpu.models.families import cardinality_least_squares
from scipsdp_tpu.models.problem import densify
from scipsdp_tpu.ops.ipm import build_ipm_data, ipm_solve
from scipsdp_tpu.utils.config import BBSettings, Settings, resolve_backend_autos

CONFIGS = [
    ("cls_22", lambda: cardinality_least_squares(22, 44, 7, seed=3),
     (8, 32, 128)),
    ("cls_32", lambda: cardinality_least_squares(32, 64, 8, seed=5),
     (8, 32, 128)),
    ("cls_48", lambda: cardinality_least_squares(48, 96, 10, seed=5),
     (8, 32, 128)),
    ("cls_64", lambda: cardinality_least_squares(64, 128, 12, seed=5),
     (8, 32, 128)),
]


def boxes_for(prob, m, B, seed):
    """B node boxes as a best-first frontier slice would produce them:
    the root box with a few random integer variables fixed per slot
    (distinct inputs per dispatch, so no timed call repeats another)."""
    rng = np.random.RandomState(seed)
    lb = np.tile(prob.lb[:m], (B, 1))
    ub = np.tile(prob.ub[:m], (B, 1))
    ints = np.where(prob.integral)[0]
    for i in range(B):
        k = rng.randint(1, 4)
        for j in rng.choice(ints, size=min(k, len(ints)), replace=False):
            v = float(rng.randint(0, 2))
            lb[i, j] = ub[i, j] = v
    return lb, ub


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", help="comma-separated labels")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="BENCH_RELAX.json")
    args = ap.parse_args()
    only = set(args.only.split(",")) if args.only else None

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench_relax.py needs a GPU; jax backend is "
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
        dense = densify(prob)
        data = build_ipm_data(dense)
        m = dense.nvars
        n_blk = max(b.size for b in prob.blocks)
        base = baseline_dsdp.baseline_nodes_per_s(n_blk, m)
        s = resolve_backend_autos(Settings(bb=BBSettings()))
        for B in batches:
            sol = jax.jit(lambda bm, lo, hi: ipm_solve(
                data, bm, lo, hi, settings=s.ipm))
            bmat = jnp.asarray(np.tile(np.concatenate(
                [dense.obj, [0.0]]), (B, 1)))

            def one(seed):
                lb, ub = boxes_for(prob, m, B, seed)
                lbx = jnp.asarray(np.concatenate(
                    [lb, np.zeros((B, 1))], 1))
                ubx = jnp.asarray(np.concatenate(
                    [ub, np.zeros((B, 1))], 1))
                t0 = time.perf_counter()
                out = sol(bmat, lbx, ubx)
                st = np.asarray(out.status)   # waits for the device
                return time.perf_counter() - t0, st, int(out.iters)

            one(0)                            # warm/compile
            times, iters, solved = [], [], 0
            for r in range(args.reps):
                dt, st, it = one(r + 1)
                times.append(dt)
                iters.append(it)
                solved = int((st == 1).sum())
            dt = float(np.median(times))
            row = {
                "label": label, "m": m, "n": n_blk, "batch": B,
                "median_dispatch_s": round(dt, 3),
                "iters": int(np.median(iters)),
                "solved": solved,
                "relax_per_s": round(B / dt, 2),
                "baseline_nodes_per_s": round(base, 2),
                "vs_baseline": round(B / dt / base, 2),
                "device": device,
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=1)
    print(f"\n{'label':<8} {'m':>4} {'batch':>6} {'disp(s)':>8} "
          f"{'relax/s':>8} {'dsdp/s':>8} {'vs':>6}")
    for r in rows:
        print(f"{r['label']:<8} {r['m']:>4} {r['batch']:>6} "
              f"{r['median_dispatch_s']:>8.3f} {r['relax_per_s']:>8.1f} "
              f"{r['baseline_nodes_per_s']:>8.1f} "
              f"{r['vs_baseline']:>6.2f}")


if __name__ == "__main__":
    main()
