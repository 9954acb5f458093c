"""Stage profile of the MISDP solver on one NVIDIA GPU.

    python profile_h100.py precision   # off+eigh vs refine+probe, cls_48
    python profile_h100.py trace       # per-stage device time, cls_48 IPM
    python profile_h100.py memory      # cls_64 turbo-chunk memory vs width

``precision`` solves cls_48 at B=32 to the end under each IPM precision
setting, in turns (A B C C B A), after one warm-up solve each that
compiles every graph; it reports wall time, IPM iterations, nodes, status
and objective.

``trace`` traces one steady batched relaxation solve (``ipm_solve``,
cls_48, B=32, the default settings) with ``jax.profiler`` and attributes
device time to the IPM stages named in ``ops/ipm.STAGES`` through the
``op_name`` metadata of the compiled HLO; run it with
``XLA_FLAGS=--xla_gpu_enable_command_buffer=`` so that kernels are not
folded into CUDA graphs, whose trace events carry no op.  Each stage's
FLOPs and bytes
come from its shapes; its roofline share is the larger of FLOPs over the
FP64 tensor-core peak and bytes over the HBM peak, divided by its device
time.  Also reports the device idle share of the window.

``memory`` compiles the device tree-loop chunk for cls_64 at several
batch widths and prints ``memory_analysis()`` beside the card's
``bytes_limit``.

Results go to ``chiprun_out/profile/<command>.json``.  Needs a GPU.
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "profile")

# Published peaks (NVIDIA H100 data sheet, dense): FP64 tensor core,
# FP64 vector, HBM bytes/s.  Keyed by jax's device_kind.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp64_tc": 67e12, "fp64": 34e12,
                              "hbm": 3.35e12, "part": "H100 SXM"},
    "NVIDIA H100 PCIe": {"fp64_tc": 51e12, "fp64": 26e12, "hbm": 2.0e12,
                         "part": "H100 PCIe"},
}
CLS48 = (48, 96, 10, 5)
CLS64 = (64, 128, 12, 5)


def device_info():
    import subprocess

    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"profile_h100.py needs a GPU; jax backend is "
                         f"{jax.default_backend()!r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    d = jax.devices()[0]
    return {"kind": d.device_kind, "count": len(jax.devices()),
            "nvidia_smi": smi.stdout.strip().splitlines()[0]}


def cls(spec):
    from scipsdp_tpu.models.families import cardinality_least_squares
    nf, ns, k, seed = spec
    return cardinality_least_squares(nf, ns, k, seed=seed)


def precision(reps=2, time_limit=240.0):
    from scipsdp_tpu.core.branchbound import solve_misdp
    from scipsdp_tpu.utils.config import BBSettings, IPMSettings, Settings

    prob = cls(CLS48)
    configs = {"off+eigh": ("off", "eigh"), "refine+probe": ("refine", "probe"),
               "off+probe": ("off", "probe")}

    def settings(name, **bb):
        p32, rule = configs[name]
        return Settings(ipm=IPMSettings(phase32=p32, step_rule=rule),
                        bb=BBSettings(batch_size=32, **bb))

    for name in configs:
        t0 = time.perf_counter()
        solve_misdp(prob, settings(name, node_limit=64))
        print(f"[precision] warm-up {name}: {time.perf_counter() - t0:.1f}s",
              flush=True)
    order = list(configs) + list(reversed(configs))
    runs = []
    for name in order * (reps // 2) + (list(configs) if reps % 2 else []):
        t0 = time.perf_counter()
        res = solve_misdp(prob, settings(name, time_limit=time_limit))
        wall = time.perf_counter() - t0
        row = {"config": name, "wall_s": wall, "status": res.status.name,
               "objective": res.objval, "gap": res.gap,
               "nodes": res.stats.nodes,
               "ipm_iterations": res.stats.ipm_iterations,
               "turbo_bails": res.stats.turbo_bails}
        runs.append(row)
        print(f"[precision] {json.dumps(row)}", flush=True)
    return {"instance": "cls_48", "batch": 32, "runs": runs}


def stage_flops_bytes(B, K, n, mp, F, iters):
    """FLOPs and minimal device-memory bytes of each IPM stage over
    ``iters`` iterations of the plain f64 path (8-byte words)."""
    w = 8
    per = {
        # W_j = Lx^T A_j Ls^{-T}: two n x n products per (batch, block, j)
        "wfeat": (4.0 * B * K * mp * n ** 3,
                  w * (K * mp * n * n + 2 * B * K * n * n + B * mp * F)),
        # M = W W^T over F features
        "schur_gram": (2.0 * B * mp * mp * F, w * (B * mp * F + B * mp * mp)),
        # X, S factors (2K per instance) and the Schur factor
        "chol": (B * (2 * K * n ** 3 + mp ** 3) / 3.0,
                 w * 2 * B * (2 * K * n * n + mp * mp)),
        # identity-RHS triangular solves
        "tril_inv": (float(B * (2 * K * n ** 3 + mp ** 3)),
                     w * 2 * B * (2 * K * n * n + mp * mp)),
    }
    return {k: (f * iters, b * iters) for k, (f, b) in per.items()}


def hlo_scopes(compiled_text):
    """HLO instruction name -> op_name metadata of the compiled module."""
    out = {}
    for line in compiled_text.splitlines():
        m = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*op_name=\"([^\"]*)\"",
                     line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def reduce_trace(xplane_path, scopes, stages, plane_prefix="/device:GPU"):
    """Device time per stage, device busy time and window span from a
    profiler trace of one call (events of the planes named
    ``plane_prefix*`` that carry an ``hlo_op``)."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    per_stage = {s: 0.0 for s in stages}
    per_op = {}
    intervals = []
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                hlo = stats.get("hlo_op")
                if hlo is None:
                    continue
                dur = ev.duration_ns * 1e-9
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                scope = scopes.get(hlo, "")
                per_op[hlo] = per_op.get(hlo, 0.0) + dur
                for s in stages:
                    if f"/{s}/" in scope + "/":
                        per_stage[s] += dur
                        break
    intervals.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = (intervals[-1][1] - intervals[0][0]) if intervals else 0
    per_stage["total"] = sum(per_op.values())
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:25]
    return per_stage, busy * 1e-9, span * 1e-9, [
        {"hlo_op": k, "s": v, "op_name": scopes.get(k, "")} for k, v in top]


def trace(B=32):
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from scipsdp_tpu.models.problem import densify
    from scipsdp_tpu.ops.ipm import STAGES, build_ipm_data, ipm_solve
    from scipsdp_tpu.utils.config import Settings, resolve_backend_autos

    prob = cls(CLS48)
    dense = densify(prob)
    data = build_ipm_data(dense)
    m = dense.nvars
    ipms = resolve_backend_autos(Settings()).ipm
    fn = jax.jit(lambda d, b, lo, hi: ipm_solve(d, b, lo, hi,
                                                settings=ipms))
    bm = jnp.asarray(np.tile(np.concatenate([dense.obj, [0.0]]), (B, 1)))

    def boxes(seed):
        lb, ub = chip_smoke.relax_boxes(prob, m, B, seed)
        pad = np.zeros((B, 1))
        return (jnp.asarray(np.concatenate([lb, pad], 1)),
                jnp.asarray(np.concatenate([ub, pad], 1)))

    lo, hi = boxes(0)
    compiled = fn.lower(data, bm, lo, hi).compile()
    scopes = hlo_scopes(compiled.as_text())
    for seed in (1, 2):                      # warm: steady state
        jax.block_until_ready(fn(data, bm, *boxes(seed)))
    lo, hi = boxes(3)
    t0 = time.perf_counter()
    out = fn(data, bm, lo, hi)
    jax.block_until_ready(out)
    wall_untraced = time.perf_counter() - t0
    tdir = os.path.join(OUT_DIR, "trace")
    lo, hi = boxes(4)
    jax.profiler.start_trace(tdir)
    t0 = time.perf_counter()
    out = fn(data, bm, lo, hi)
    jax.block_until_ready(out)
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    # eigh: the exact step rule's eigendecompositions, beside the stages
    per_stage, busy, span, top = reduce_trace(path, scopes,
                                              STAGES + ("eigh",))
    iters = int(out.iters)
    K, _, n, _ = data.A[0].shape
    mp = m + 1
    F = K * n * n + int(data.G.shape[0])
    fb = stage_flops_bytes(B, K, n, mp, F, iters)
    peaks = PEAKS[jax.devices()[0].device_kind]
    stages = {"eigh": {"device_s": per_stage["eigh"]}}
    for s in STAGES:
        f, b = fb[s]
        t = per_stage[s]
        tmin = max(f / peaks["fp64_tc"], b / peaks["hbm"])
        stages[s] = {"device_s": t, "flops": f, "bytes": b,
                     "tflops_per_s": f / t / 1e12 if t else None,
                     "roofline_share": tmin / t if t else None,
                     "bound": ("fp64" if f / peaks["fp64_tc"]
                               >= b / peaks["hbm"] else "hbm")}
        print(f"[trace] {s}: {json.dumps(stages[s])}", flush=True)
    res = {"instance": "cls_48", "B": B, "iters": iters, "n": int(n),
           "mp": mp, "F": F, "wall_untraced_s": wall_untraced,
           "wall_traced_s": wall, "device_busy_s": busy,
           "device_span_s": span,
           "device_kernel_s": per_stage["total"],
           "idle_share": 1.0 - busy / wall if wall else None,
           "stages": stages, "peaks": peaks, "top_ops": top,
           "xla_flags": os.environ.get("XLA_FLAGS", ""),
           "trace": os.path.relpath(path, HERE),
           "statuses": np.bincount(np.asarray(out.status)).tolist()}
    print(f"[trace] iters {iters}, wall {wall:.3f}s (untraced "
          f"{wall_untraced:.3f}s), device busy {busy:.3f}s, idle share "
          f"{res['idle_share']:.3f}", flush=True)
    for row in top[:12]:
        print(f"[trace] top {row['s'] * 1e3:9.2f} ms  {row['hlo_op']}  "
              f"{row['op_name'][-90:]}", flush=True)
    return res


def memory(widths=(32, 64, 128)):
    import jax
    import jax.numpy as jnp

    from scipsdp_tpu.core.turbo import _chunk_for, _init_state
    from scipsdp_tpu.models.problem import densify
    from scipsdp_tpu.ops.ipm import build_ipm_data
    from scipsdp_tpu.utils.config import (BBSettings, Settings,
                                          resolve_backend_autos)

    prob = cls(CLS64)
    dense = densify(prob)
    data = build_ipm_data(dense)
    m = dense.nvars
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    rows = []
    for B in widths:
        s = resolve_backend_autos(Settings(bb=BBSettings(batch_size=B)))
        N = max(s.bb.turbo_capacity, 8 * B)
        st = _init_state(N, m, 1)(
            jnp.asarray(prob.lb[None, :m]), jnp.asarray(prob.ub[None, :m]),
            jnp.asarray([-np.inf]), jnp.asarray(np.inf),
            jnp.zeros((m,)), jnp.asarray(False))
        chunk = _chunk_for(s, dense.integral, B, data, None, None)
        t0 = time.perf_counter()
        comp = chunk.lower(data, st, jax.random.PRNGKey(0),
                           jnp.asarray(64, jnp.int32),
                           k=s.bb.turbo_rounds).compile()
        ma = comp.memory_analysis()
        row = {"B": B, "compile_s": time.perf_counter() - t0,
               "temp_bytes": ma.temp_size_in_bytes,
               "argument_bytes": ma.argument_size_in_bytes,
               "output_bytes": ma.output_size_in_bytes,
               "generated_code_bytes": ma.generated_code_size_in_bytes,
               "bytes_limit": limit}
        rows.append(row)
        print(f"[memory] cls_64 {json.dumps(row)}", flush=True)
    return {"instance": "cls_64", "rows": rows}


def main(argv):
    cmds = {"precision": precision, "trace": trace, "memory": memory}
    if len(argv) != 1 or argv[0] not in cmds:
        raise SystemExit(f"usage: python profile_h100.py {{{','.join(cmds)}}}")
    info = device_info()
    import scipsdp_tpu
    scipsdp_tpu.enable_compilation_cache()
    print(f"[device] {info['nvidia_smi']} ({info['kind']})", flush=True)
    res = cmds[argv[0]]()
    res["device"] = info
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{argv[0]}.json"), "w") as f:
        json.dump(res, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
