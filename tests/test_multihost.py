"""Multi-host distributed B&B (parallel/multihost.py).

The reference has no distributed mode (SURVEY.md section 2.5) — this is
north-star functionality: root-box partitioning over processes, lockstep
incumbent/dual-bound synchronization inside the tree loop, and dynamic
work stealing when a host's frontier empties.

The real thing is exercised here with TWO OS processes running
jax.distributed over the CPU backend (the same code path as multi-host
DCN deployments, minus the transport): the problem is built so that one
process's root partition is instantly infeasible, forcing it to idle and
steal nodes from the other; both processes must agree on the optimum and
the idle one must record stolen nodes.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from scipsdp_tpu.models.problem import (
    INF, LinearConstraints, MISDP, SDPBlock)
from scipsdp_tpu.parallel.multihost import partition_root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json, os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
out = sys.argv[4]
use_mesh = len(sys.argv) > 5 and sys.argv[5] == "mesh"
import jax
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)
import numpy as np
from scipsdp_tpu.models.problem import (
    INF, LinearConstraints, MISDP, SDPBlock)
from scipsdp_tpu.parallel.multihost import solve_misdp_distributed
from scipsdp_tpu.utils.config import BBSettings, Settings

# y0 is forced to 1 by the SDP block (Z = y0 - 1 >= 0); the root is
# partitioned on y0, so one process starts infeasible and must steal.
m = 6
obj = -np.array([1.0, 1.1, 1.2, 1.3, 0.9, 0.8])
blk = SDPBlock(size=1, var=[0], row=[0], col=[0], val=[1.0],
               const_row=[0], const_col=[0], const_val=[1.0])
lp = LinearConstraints.from_rows(
    [(list(range(m)), [1.0] * m, -INF, 2.0)])
prob = MISDP(nvars=m, obj=obj, lb=np.zeros(m), ub=np.ones(m),
             integral=np.ones(m, bool), blocks=[blk], lp=lp,
             name="steal")
res = solve_misdp_distributed(
    prob, Settings(bb=BBSettings(batch_size=2), use_mesh=use_mesh),
    sync_every=1)
json.dump({"pid": pid, "status": res.status.name, "objval": res.objval,
           "nstolen": res.stats.nstolen, "ndonated": res.stats.ndonated,
           "nodes": res.stats.nodes},
          open(out, "w"))
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_partition_root_disjoint_cover():
    prob = MISDP(nvars=3, obj=np.zeros(3), lb=np.zeros(3),
                 ub=np.ones(3), integral=np.ones(3, bool), blocks=[],
                 lp=LinearConstraints.empty(), name="p")
    parts = partition_root(prob, 2)
    assert len(parts) == 2
    (l0, u0), (l1, u1) = parts
    assert u0[0] == 0.0 and l1[0] == 1.0   # split on the leading binary


@pytest.mark.slow
@pytest.mark.parametrize("mesh_mode", ["nomesh", "mesh"])
def test_two_process_steal_and_agree(tmp_path, mesh_mode):
    """mesh_mode="mesh" is the combined scale-out test: each host shards
    its node batches over a LOCAL 2-device mesh while stealing work from
    the other host over the distributed layer."""
    port = _free_port()
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": REPO,
        "XLA_FLAGS": ("--xla_force_host_platform_device_count=2"
                      if mesh_mode == "mesh" else ""),
    })
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    outs = [tmp_path / f"out{i}.json" for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), "2", str(port),
             str(outs[i]), mesh_mode],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(2)
    ]
    for p in procs:
        try:
            p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out (deadlock?)")
    for p in procs:
        assert p.returncode == 0, p.stderr.read().decode()[-2000:]
    res = [json.load(open(o)) for o in outs]
    # both processes agree on the global optimum: y0=1 forced, best
    # remaining coefficient 1.3 -> objective -(1.0 + 1.3)
    for r in res:
        assert r["status"] == "OPTIMAL"
        assert abs(r["objval"] - (-2.3)) < 1e-4, r
    # the process whose partition was infeasible must have stolen work,
    # and the other must have donated it
    assert sum(r["nstolen"] for r in res) > 0, res
    assert sum(r["ndonated"] for r in res) > 0, res
