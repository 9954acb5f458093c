"""Smoke test of the MISDP solver's main path on NVIDIA GPUs.

    python chip_smoke.py           # phases 1-4 on one card
    python chip_smoke.py --four    # phase 5 only: cls_48 on a 4-card mesh

Phases, each a hard failure (exit code 1, no result line):

1. device — JAX's platform is "gpu"; prints the card's name and power
   limit as ``nvidia-smi --query-gpu=name,power.limit`` reports them.
2. stage parity — one batched relaxation solve (``ipm_solve``, B=32) at
   the cls_48 and cls_64 shapes, on the GPU and on the CPU in f64 in the
   same process: statuses identical, dual objectives within 1e-6 relative.
3. main path — ``solve_misdp`` on cls_48 at B=32 to OPTIMAL with gap 0,
   carried by the device tree loop (a hand-back to the host loop fails);
   the incumbent passes an independent numpy check; then the CLI on the
   written instance; then cls_64 with a node limit of 64, printing the
   card's peak memory.
4. brute-force reference — cls_14 against an enumeration of every
   support of size <= 5 by ``numpy.linalg.lstsq``, within 1e-4 relative.
5. ``--four`` — cls_48 with ``use_mesh=True`` on a 1-D nodes mesh of 4
   cards at B=64 against the one-card solve of phase 3, within 1e-6.

Every instance is generated from a seed; files are written only under
``chiprun_out/`` of the checkout.  The last line of standard output is
one JSON object: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "chip_smoke")

# (nfeatures, nsamples, k, seed) of cardinality_least_squares; big-M = 10
CLS14 = (14, 28, 5, 3)
CLS48 = (48, 96, 10, 5)
CLS64 = (64, 128, 12, 5)
BIG_M = 10.0
PARITY_RTOL = 1e-6      # GPU vs CPU, and 4 cards vs 1 card: same f64 math
REF_RTOL = 1e-4         # solver vs an independent numpy reference (the
#                         solver's gaptol is 1e-5)


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def rel_err(a, b):
    return abs(a - b) / max(1.0, abs(b))


# ---------------------------------------------------------------- numpy
# Independent references: plain numpy on the generator's least-squares
# data, sharing no code with the solver.

def block_matrix(block, y):
    """Z(y) = sum_j A_j y_j - A_0 of one SDP block (lower-triangle
    triplets), dense and symmetric."""
    Z = np.zeros((block.size, block.size))
    np.add.at(Z, (block.row, block.col), block.val * y[block.var])
    np.add.at(Z, (block.const_row, block.const_col), -block.const_val)
    return Z + np.tril(Z, -1).T


def support_lstsq(A, bvec, support):
    """min ||A_S x - b||^2 over x on the support S; returns (t, x_S)."""
    if len(support) == 0:
        return float(bvec @ bvec), np.zeros(0)
    x, *_ = np.linalg.lstsq(A[:, support], bvec, rcond=None)
    r = A[:, support] @ x - bvec
    return float(r @ r), x


def check_cls_incumbent(prob, A, bvec, y, objval, feastol=1e-5,
                        rtol=REF_RTOL):
    """Independent check of a cardinality-least-squares incumbent
    y = (x, z, t).  Returns the list of violations (empty = valid)."""
    n = A.shape[1]
    y = np.asarray(y, float)
    if y.shape != (2 * n + 1,):
        return [f"incumbent has shape {y.shape}, expected {(2 * n + 1,)}"]
    bad = []
    z = y[n:2 * n]
    frac = float(np.max(np.abs(z - np.round(z))))
    if frac > feastol:
        bad.append(f"z not integral (max fractionality {frac:.3g})")
    tol_b = feastol * np.maximum(1.0, np.abs(np.where(np.isfinite(prob.ub),
                                                      prob.ub, 0.0)))
    if np.any(y < prob.lb - tol_b) or np.any(y > prob.ub + tol_b):
        bad.append("variable bounds violated")
    D = prob.lp.dense(prob.nvars)
    act = D @ y
    lo_ok = act >= prob.lp.lhs - feastol * np.maximum(1.0, np.abs(
        np.where(np.isfinite(prob.lp.lhs), prob.lp.lhs, 0.0)))
    hi_ok = act <= prob.lp.rhs + feastol * np.maximum(1.0, np.abs(
        np.where(np.isfinite(prob.lp.rhs), prob.lp.rhs, 0.0)))
    if not np.all(lo_ok & hi_ok):
        bad.append(f"LP rows violated: {np.flatnonzero(~(lo_ok & hi_ok))}")
    for k, blk in enumerate(prob.blocks):
        lam = float(np.linalg.eigvalsh(block_matrix(blk, y))[0])
        if lam < -feastol:
            bad.append(f"SDP block {k} not PSD (lambda_min {lam:.3g})")
    support = np.flatnonzero(np.round(z) == 1.0)
    t_ref, x_s = support_lstsq(A, bvec, support)
    if np.any(np.abs(x_s) > BIG_M):
        bad.append("least-squares fit on the support leaves the box")
    if rel_err(objval, t_ref) > rtol:
        bad.append(f"objective {objval!r} != lstsq {t_ref!r} on the "
                   f"support")
    if rel_err(y[2 * n], objval) > rtol:
        bad.append(f"t = {y[2 * n]!r} differs from the objective")
    return bad


def cls_enumerate(A, bvec, k):
    """Brute-force optimum of min ||Ax - b||^2, ||x||_0 <= k, |x| <= M:
    lstsq on every support of size <= k.  Returns (t*, support, count).
    A support whose fit leaves the box would need a constrained solve, so
    one that beats the best in-box fit is an error."""
    n = A.shape[1]
    best, best_s, leaves, count = np.inf, (), np.inf, 0
    for r in range(k + 1):
        for s in itertools.combinations(range(n), r):
            t, x = support_lstsq(A, bvec, list(s))
            count += 1
            if np.all(np.abs(x) <= BIG_M):
                if t < best:
                    best, best_s = t, s
            else:
                leaves = min(leaves, t)
    if leaves < best:
        raise SmokeFailure("an out-of-box support beats every in-box fit; "
                           "the enumeration cannot decide")
    return best, best_s, count


# ---------------------------------------------------------------- phases

def device_phase():
    import jax

    backend = jax.default_backend()
    require(backend == "gpu", f"jax backend is {backend!r}, not 'gpu'")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0 and smi.stdout.strip(),
            f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        print(f"[device] {line.strip()}")
    d = jax.devices()[0]
    print(f"[device] jax: {d.platform} {d.device_kind} x{len(jax.devices())}"
          f", jax {jax.__version__}")


def relax_boxes(prob, m, B, seed):
    """B node boxes as a best-first frontier slice holds them: the root
    box with 1-3 random binaries fixed per slot."""
    rng = np.random.RandomState(seed)
    lb = np.tile(prob.lb[:m], (B, 1))
    ub = np.tile(prob.ub[:m], (B, 1))
    ints = np.flatnonzero(prob.integral[:m])
    for i in range(B):
        for j in rng.choice(ints, size=rng.randint(1, 4), replace=False):
            lb[i, j] = ub[i, j] = float(rng.randint(0, 2))
    return lb, ub


def parity_phase(label, prob, B=32, seed=0):
    """The same batched relaxation solve on the default device and on the
    CPU, in f64 on both."""
    import jax
    import jax.numpy as jnp

    from scipsdp_tpu.models.problem import densify
    from scipsdp_tpu.ops.ipm import build_ipm_data, ipm_solve
    from scipsdp_tpu.utils.config import Settings, resolve_backend_autos

    dense = densify(prob)
    m = dense.nvars
    ipms = resolve_backend_autos(Settings()).ipm
    lb, ub = relax_boxes(prob, m, B, seed)
    pad = np.zeros((B, 1))
    args = (build_ipm_data(dense),
            jnp.asarray(np.tile(np.concatenate([dense.obj, [0.0]]), (B, 1))),
            jnp.asarray(np.concatenate([lb, pad], 1)),
            jnp.asarray(np.concatenate([ub, pad], 1)))

    def solve(d, b, lo, hi):
        return ipm_solve(d, b, lo, hi, settings=ipms)

    fn = jax.jit(solve)
    t0 = time.perf_counter()
    dev = fn(*args)
    st_dev = np.asarray(dev.status)
    t_dev = time.perf_counter() - t0
    cpu_args = jax.device_put(args, jax.devices("cpu")[0])
    t0 = time.perf_counter()
    ref = fn(*cpu_args)
    st_ref = np.asarray(ref.status)
    t_ref = time.perf_counter() - t0
    require(ref.dobj.devices() == {jax.devices("cpu")[0]},
            "the reference solve did not run on the CPU")
    d_dev, d_ref = np.asarray(dev.dobj), np.asarray(ref.dobj)
    require(np.array_equal(st_dev, st_ref),
            f"{label}: statuses differ: {st_dev} vs {st_ref}")
    opt = st_ref == 1
    require(opt.any(), f"{label}: no relaxation solved to optimality")
    err = float(np.max(np.abs(d_dev - d_ref)[opt]
                       / np.maximum(1.0, np.abs(d_ref[opt]))))
    print(f"[parity] {label}: B={B} n={prob.blocks[0].size} m={m}, "
          f"{int(opt.sum())}/{B} OPTIMAL, iters {int(dev.iters)} (device) "
          f"{int(ref.iters)} (cpu), max rel dobj diff {err:.3e} "
          f"(tol {PARITY_RTOL:g}; float64 on both, step_rule="
          f"{ipms.step_rule}, phase32={ipms.phase32}); "
          f"{t_dev:.1f}s device / {t_ref:.1f}s cpu incl. compile")
    require(err <= PARITY_RTOL, f"{label}: dual objectives differ by {err}")
    return {"label": label, "B": B, "optimal": int(opt.sum()),
            "max_rel_dobj_diff": err, "iters_device": int(dev.iters),
            "iters_cpu": int(ref.iters)}


def solve_cls(prob, batch, **kw):
    from scipsdp_tpu.core.branchbound import solve_misdp
    from scipsdp_tpu.utils.config import BBSettings, Settings

    bb = BBSettings(batch_size=batch, node_limit=kw.pop("node_limit",
                                                        1_000_000))
    t0 = time.perf_counter()
    res = solve_misdp(prob, Settings(bb=bb, **kw))
    return res, time.perf_counter() - t0


def require_device_loop(label, res):
    s = res.stats
    require(s.turbo_bails == 0,
            f"{label}: the device tree loop handed back to the host loop")
    require(s.turbo_nodes > 0 and s.turbo_nodes == s.nodes,
            f"{label}: device tree loop ran {s.turbo_nodes} of "
            f"{s.nodes} nodes")


def main_path_phase(prob, A, bvec, label="cls_48", batch=32):
    from scipsdp_tpu.utils.status import SolveStatus

    res, wall = solve_cls(prob, batch)
    require(res.status == SolveStatus.OPTIMAL,
            f"{label}: status {res.status.name}")
    require(res.gap == 0.0, f"{label}: gap {res.gap}")
    require_device_loop(label, res)
    bad = check_cls_incumbent(prob, A, bvec, res.best_y, res.objval)
    require(not bad, f"{label}: incumbent check failed: {bad}")
    print(f"[main] {label}: OPTIMAL objective {res.objval!r} gap 0, "
          f"{res.stats.nodes} nodes on the device tree loop, "
          f"{res.stats.ipm_iterations} IPM iterations, B={batch}, "
          f"{wall:.1f}s incl. compile; incumbent passes the numpy check")
    return res, wall


def cli_phase(prob, objval, label="cls_48", batch=32):
    from scipsdp_tpu.__main__ import main as cli_main
    from scipsdp_tpu.models.writers import write_sdpa

    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{label}.dat-s")
    write_sdpa(prob, path)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([path, "-q", "--batch-size", str(batch)])
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    status = re.search(r"status\s*:\s*(\S+)", out)
    obj = re.search(r"objective value\s*:\s*(\S+)", out)
    require(rc == 0 and status and status.group(1) == "OPTIMAL" and obj,
            f"CLI on {path}: rc {rc}, output tail {out[-500:]!r}")
    cli_obj = float(obj.group(1))
    require(rel_err(cli_obj, objval) <= REF_RTOL,
            f"CLI objective {cli_obj} vs API {objval}")
    print(f"[cli] python -m scipsdp_tpu {os.path.relpath(path, HERE)}: "
          f"OPTIMAL {cli_obj!r} ({wall:.1f}s)")


def production_phase(prob, label="cls_64", batch=32, node_limit=64):
    import jax

    from scipsdp_tpu.utils.status import SolveStatus

    res, wall = solve_cls(prob, batch, node_limit=node_limit)
    require(res.status in (SolveStatus.NODE_LIMIT, SolveStatus.OPTIMAL),
            f"{label}: status {res.status.name}")
    require_device_loop(label, res)
    require(np.isfinite(res.dual_bound), f"{label}: no dual bound")
    mem = jax.devices()[0].memory_stats() or {}
    peak = mem.get("peak_bytes_in_use")
    limit = mem.get("bytes_limit")
    print(f"[main] {label}: {res.status.name} after {res.stats.nodes} nodes "
          f"(limit {node_limit}, B={batch}), incumbent {res.objval!r}, "
          f"dual bound {res.dual_bound!r}, {wall:.1f}s incl. compile; "
          f"device peak_bytes_in_use {peak} of bytes_limit {limit} "
          f"(process peak, all phases so far)")
    return {"status": res.status.name, "nodes": res.stats.nodes,
            "objective": res.objval, "dual_bound": res.dual_bound,
            "wall_s": wall, "peak_bytes_in_use": peak, "bytes_limit": limit}


def brute_force_phase(prob, A, bvec, k, label="cls_14", batch=8):
    from scipsdp_tpu.utils.status import SolveStatus

    t0 = time.perf_counter()
    t_ref, sup, count = cls_enumerate(A, bvec, k)
    t_enum = time.perf_counter() - t0
    res, wall = solve_cls(prob, batch)
    require(res.status == SolveStatus.OPTIMAL,
            f"{label}: status {res.status.name}")
    bad = check_cls_incumbent(prob, A, bvec, res.best_y, res.objval)
    require(not bad, f"{label}: incumbent check failed: {bad}")
    err = rel_err(res.objval, t_ref)
    print(f"[brute] {label}: solver {res.objval!r} vs enumeration {t_ref!r} "
          f"(support {list(sup)}, {count} lstsq solves in {t_enum:.1f}s), "
          f"rel diff {err:.3e} (tol {REF_RTOL:g}); {res.stats.nodes} nodes, "
          f"{wall:.1f}s incl. compile")
    require(err <= REF_RTOL, f"{label}: solver disagrees with enumeration")
    return {"objective": res.objval, "enumerated": t_ref, "count": count}


def four_card_phase(prob, A, bvec, label="cls_48", batch=64):
    import jax

    from scipsdp_tpu.utils.status import SolveStatus

    require(len(jax.devices()) >= 4,
            f"--four needs 4 GPUs, have {len(jax.devices())}")
    one, wall1 = main_path_phase(prob, A, bvec, label, batch=32)
    res, wall = solve_cls(prob, batch, use_mesh=True, mesh_devices=4)
    require(res.status == SolveStatus.OPTIMAL,
            f"{label} on 4 cards: status {res.status.name}")
    require_device_loop(f"{label} on 4 cards", res)
    bad = check_cls_incumbent(prob, A, bvec, res.best_y, res.objval)
    require(not bad, f"{label} on 4 cards: incumbent check failed: {bad}")
    err = rel_err(res.objval, one.objval)
    print(f"[four] {label}: 4-card nodes mesh B={batch}: OPTIMAL "
          f"{res.objval!r} after {res.stats.nodes} nodes, {wall:.1f}s incl. "
          f"compile; 1 card B=32: {one.objval!r} after {one.stats.nodes} "
          f"nodes, {wall1:.1f}s; rel diff {err:.3e} (tol {PARITY_RTOL:g})")
    require(err <= PARITY_RTOL, f"{label}: 4-card objective differs")
    return {"objective_4": res.objval, "objective_1": one.objval,
            "nodes_4": res.stats.nodes, "nodes_1": one.stats.nodes,
            "wall_4": wall, "wall_1": wall1}


def cls_instance(spec):
    from scipsdp_tpu.models.families import (cardinality_least_squares,
                                             cls_data)

    nf, ns, k, seed = spec
    A, bvec = cls_data(nf, ns, k, seed)
    return cardinality_least_squares(nf, ns, k, M=BIG_M, seed=seed), A, bvec


def run(four: bool) -> dict:
    import jax

    import scipsdp_tpu

    report = {}
    t0 = time.perf_counter()
    device_phase()
    scipsdp_tpu.enable_compilation_cache()
    prob48, A48, b48 = cls_instance(CLS48)
    if four:
        report["four"] = four_card_phase(prob48, A48, b48)
    else:
        prob64, _, _ = cls_instance(CLS64)
        report["parity"] = [parity_phase("cls_48", prob48),
                            parity_phase("cls_64", prob64)]
        res48, wall48 = main_path_phase(prob48, A48, b48)
        report["cls_48"] = {"objective": res48.objval,
                            "nodes": res48.stats.nodes, "wall_s": wall48}
        cli_phase(prob48, res48.objval)
        report["cls_64"] = production_phase(prob64)
        prob14, A14, b14 = cls_instance(CLS14)
        report["cls_14"] = brute_force_phase(prob14, A14, b14, CLS14[2])
    report["wall_s"] = time.perf_counter() - t0
    d = jax.devices()[0]
    report["device"] = {"platform": d.platform, "kind": d.device_kind,
                        "count": len(jax.devices())}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh phase and its comparison")
    args = ap.parse_args(argv)
    try:
        report = run(args.four)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "four.json" if args.four
                           else "smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"[done] {report['wall_s']:.1f}s")
    print(json.dumps({"ok": True, "device": report["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
