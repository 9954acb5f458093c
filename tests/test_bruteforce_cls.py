"""solve_misdp against brute force on small cardinality-least-squares
instances: every support of size <= k is fitted by numpy lstsq, through
both B&B engines (the host loop and the device tree loop)."""

import pytest

from scipsdp_tpu.core.branchbound import solve_misdp
from scipsdp_tpu.models.families import cardinality_least_squares, cls_data
from scipsdp_tpu.utils.config import BBSettings, Settings
from scipsdp_tpu.utils.status import SolveStatus

SIZE = (7, 14, 3)


@pytest.mark.parametrize("turbo", ["off", "on"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cls_matches_enumeration(seed, turbo, chip_smoke):
    A, b = cls_data(*SIZE, seed)
    t_ref, support, count = chip_smoke.cls_enumerate(A, b, SIZE[2])
    assert count == 1 + 7 + 21 + 35
    prob = cardinality_least_squares(*SIZE, seed=seed)
    res = solve_misdp(prob, Settings(bb=BBSettings(batch_size=4,
                                                   turbo=turbo)))
    assert res.status == SolveStatus.OPTIMAL
    assert res.gap == 0.0
    assert abs(res.objval - t_ref) <= 1e-4 * max(1.0, t_ref)
    assert chip_smoke.check_cls_incumbent(prob, A, b, res.best_y,
                                          res.objval) == []
    if turbo == "on":
        assert res.stats.turbo_bails == 0
        assert res.stats.turbo_nodes == res.stats.nodes > 0
    else:
        assert res.stats.turbo_nodes == 0
