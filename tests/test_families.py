"""Problem-family generator smoke tests (the benchmark model zoo)."""

from scipsdp_tpu.core.branchbound import solve_misdp
from scipsdp_tpu.models.families import (
    cardinality_least_squares,
    min_k_partition,
    truss_topology,
)
from scipsdp_tpu.utils.config import BBSettings, Settings
from scipsdp_tpu.utils.status import SolveStatus


def test_cls_family_solves():
    prob = cardinality_least_squares(nfeatures=5, nsamples=8, k=2)
    res = solve_misdp(prob, Settings(bb=BBSettings(node_limit=200)))
    assert res.status == SolveStatus.OPTIMAL
    assert res.objval >= -1e-9   # least-squares epigraph is nonnegative


def test_tt_family_solves():
    prob = truss_topology(nbars=4, nloads=1)
    res = solve_misdp(prob, Settings(bb=BBSettings(node_limit=200)))
    assert res.status in (SolveStatus.OPTIMAL, SolveStatus.INFEASIBLE)


def test_mkp_family_solves():
    prob = min_k_partition(nvertices=5, k=2)
    res = solve_misdp(prob, Settings(bb=BBSettings(node_limit=200)))
    assert res.status == SolveStatus.OPTIMAL


def test_mkp12_turbo_completes_without_bail():
    """Regression: mkp_12's ladder-hard relaxations made turbo
    accumulate nunsolved past its bail threshold and fall back to the
    per-rung host ladder, one dispatch per rung.  The in-graph
    penalty rung (core/turbo.py tb_pen_rung) must keep the device path
    alive and reach the known optimum 30.0."""
    import numpy as np

    from scipsdp_tpu.core import turbo as T
    from scipsdp_tpu.models.problem import densify
    from scipsdp_tpu.ops.ipm import build_ipm_data
    from scipsdp_tpu.utils.config import resolve_backend_autos

    prob = min_k_partition(12, 3, 0.6, seed=1)
    dense = densify(prob)
    data = build_ipm_data(dense)
    m = dense.nvars
    s = resolve_backend_autos(Settings(bb=BBSettings(batch_size=8)))
    res = T.solve_turbo(dense, prob, s, np.asarray(prob.lb[:m]),
                        np.asarray(prob.ub[:m]), np.inf, None, data=data,
                        rounds_per_dispatch=8)
    assert res is not None, "turbo bailed to the host path"
    assert res.inc_val == 30.0
