"""The IPM precision tiers, end to end on generated instances.

The default path on every backend is plain f64 with the exact eigh step
rule (utils/config.py BACKEND_AUTOS).  The f32-factor tier
(phase32="refine") and the probe step rule stay as explicit settings;
this file pins them through full solves against independent references:
lstsq enumeration for cardinality least squares, and the default-tier
solve for the other families.
"""

import dataclasses

import numpy as np
import pytest

from scipsdp_tpu.core.branchbound import solve_misdp
from scipsdp_tpu.models.families import (cardinality_least_squares,
                                         cls_data, min_k_partition,
                                         truss_topology)
from scipsdp_tpu.models.problem import LinearConstraints, MISDP, SDPBlock
from scipsdp_tpu.utils.config import BBSettings, IPMSettings, Settings
from scipsdp_tpu.utils.status import SolveStatus

REFINE_PROBE = IPMSettings(phase32="refine", step_rule="probe")
CLS = (6, 12, 3)


def _cls_optimum(chip_smoke, seed):
    A, b = cls_data(*CLS, seed)
    return chip_smoke.cls_enumerate(A, b, CLS[2])[0]


def _infeasible():
    """[[y, 1], [1, y]] >= 0 needs y >= 1, but y <= 0.5."""
    blk = SDPBlock(size=2, var=[0, 0], row=[0, 1], col=[0, 1],
                   val=[1.0, 1.0], const_row=[1], const_col=[0],
                   const_val=[-1.0])
    return MISDP(nvars=1, obj=np.array([1.0]), lb=np.zeros(1),
                 ub=np.array([0.5]), integral=np.array([True]),
                 blocks=[blk], lp=LinearConstraints.empty(), name="inf")


CASES = {
    "cls_seed0": lambda: cardinality_least_squares(*CLS, seed=0),
    "cls_seed1": lambda: cardinality_least_squares(*CLS, seed=1),
    "tt_4": lambda: truss_topology(4, 2, seed=1),
    "mkp_6": lambda: min_k_partition(6, 3, 0.7, seed=1),
    "infeasible": _infeasible,
}


def _expected(name, prob, chip_smoke):
    if name == "infeasible":
        return "infeasible"
    if name.startswith("cls"):
        return _cls_optimum(chip_smoke, int(name[-1]))
    res = solve_misdp(prob)
    assert res.status == SolveStatus.OPTIMAL
    return res.objval


def _check(res, expect):
    if expect == "infeasible":
        assert res.status == SolveStatus.INFEASIBLE, res
        return
    assert res.status == SolveStatus.OPTIMAL, res
    assert abs(res.objval - expect) <= 1e-4 * max(1.0, abs(expect)), (
        res.objval, expect)


@pytest.mark.parametrize("name", list(CASES))
def test_refine_probe_parity(name, chip_smoke):
    """Full solves under the f32-factor tier with the probe step rule."""
    prob = CASES[name]()
    expect = _expected(name, prob, chip_smoke)
    _check(solve_misdp(prob, Settings(ipm=REFINE_PROBE)), expect)


def test_refine_probe_gondzio(chip_smoke):
    """Gondzio correctors under the probe rule: the acceptance test
    compares probe-certified steps on both sides, so the corrected
    direction can be adopted and the solve stays correct."""
    prob = CASES["cls_seed0"]()
    s = Settings(ipm=dataclasses.replace(REFINE_PROBE, gondzio=2))
    _check(solve_misdp(prob, s), _cls_optimum(chip_smoke, 0))


def test_refine_probe_turbo_path(chip_smoke):
    """The device tree loop under the refine tier (turbo forced on)."""
    prob = CASES["cls_seed0"]()
    s = Settings(ipm=REFINE_PROBE, bb=BBSettings(batch_size=4, turbo="on"))
    res = solve_misdp(prob, s)
    _check(res, _cls_optimum(chip_smoke, 0))
    assert res.stats.turbo_bails == 0 and res.stats.turbo_nodes > 0


def test_dimacs_feastol_option(chip_smoke):
    """usedimacsfeastol (cons_sdp.c:703-710): the check tolerance scales
    by 1 + sum|obj|; solves stay at parity with the option on, on the
    host loop and on the device tree loop."""
    prob = CASES["cls_seed0"]()
    expect = _cls_optimum(chip_smoke, 0)
    _check(solve_misdp(prob, Settings(bb=BBSettings(usedimacsfeastol=True))),
           expect)
    s = Settings(bb=BBSettings(usedimacsfeastol=True, batch_size=4,
                               turbo="on"))
    _check(solve_misdp(prob, s), expect)
