"""Transformed-problem writing (reference changelog.txt:6-11: the CBF
writer emits the transformed problem's generated linear constraint
classes)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from scipsdp_tpu.core.branchbound import solve_misdp
from scipsdp_tpu.core.presolve_sdp import presolve_problem
from scipsdp_tpu.models.io import read_problem
from scipsdp_tpu.models.writers import transformed_for_write, write_problem
from scipsdp_tpu.utils.config import PresolveSettings, Settings


def _gen_settings():
    return Settings(presolve=PresolveSettings(
        diaggezerocuts=True, twominorlinconss=True,
        diagzeroimplcuts=True, twominorvarbounds=True))


def test_transformed_merges_proprows(instances_dir):
    prob = read_problem(os.path.join(instances_dir, "example_small.dat-s"))
    s = _gen_settings()
    tp = presolve_problem(prob, s)
    merged = transformed_for_write(tp)
    extra = (0 if tp.proprows is None else tp.proprows.nrows)
    assert merged.lp.nrows == tp.lp.nrows + extra
    assert merged.proprows is None


@pytest.mark.parametrize("name", ["example_small.dat-s",
                                  "example_cbf_primal.cbf"])
def test_roundtrip_transformed_cbf(tmp_path, instances_dir, name):
    prob = read_problem(os.path.join(instances_dir, name))
    s = _gen_settings()
    tp = presolve_problem(prob, s)
    out = str(tmp_path / "transformed.cbf")
    write_problem(tp, out, transformed=True)
    back = read_problem(out)
    # generated rows survived the round trip
    merged = transformed_for_write(tp)
    assert back.lp.nrows == merged.lp.nrows
    r_orig = solve_misdp(prob)
    r_back = solve_misdp(back)
    assert r_orig.objval is not None and r_back.objval is not None
    assert abs(r_orig.objval - r_back.objval) < 1e-4


def test_roundtrip_objsense_offset(tmp_path):
    """MAX-sense + objective offset survive CBF write->read."""
    from scipsdp_tpu.models.problem import INF, LinearConstraints, MISDP

    prob = MISDP(
        nvars=2, obj=np.array([-1.0, -2.0]),     # internal min form
        lb=np.zeros(2), ub=np.ones(2), integral=np.ones(2, bool),
        blocks=[], lp=LinearConstraints.from_rows(
            [([0, 1], [1.0, 1.0], -INF, 1.0)]),
        name="sense", objsense=-1.0, objoffset=5.0,
    )
    # user problem: maximize (1*y0 + 2*y1) + 5 s.t. y0+y1 <= 1 -> 7
    out = str(tmp_path / "sense.cbf")
    write_problem(prob, out)
    back = read_problem(out)
    assert back.objsense == -1.0
    assert abs(back.objoffset - 5.0) < 1e-12
    r = solve_misdp(back)
    assert abs(r.objval - 7.0) < 1e-4


def test_cli_write_transformed(tmp_path):
    from scipsdp_tpu.models.families import cardinality_least_squares
    from scipsdp_tpu.models.writers import write_sdpa

    src = str(tmp_path / "cls.dat-s")
    write_sdpa(cardinality_least_squares(6, 12, 3, seed=0), src)
    out = str(tmp_path / "t.cbf")
    cp = subprocess.run(
        [sys.executable, "-m", "scipsdp_tpu", src,
         "--cpu", "-q", "--node-limit", "1", "--write-transformed", out],
        capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        timeout=300)
    assert cp.returncode == 0, cp.stderr[-2000:]
    assert os.path.exists(out)
    back = read_problem(out)
    assert back.nvars >= 1
