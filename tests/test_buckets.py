"""Heterogeneous block-size bucketing tests (SURVEY hard part (ii))."""

import numpy as np
import pytest

from scipsdp_tpu.core.branchbound import solve_misdp
from scipsdp_tpu.core.sdpi import SDPInterface
from scipsdp_tpu.models.problem import INF, LinearConstraints, MISDP, SDPBlock, densify
from scipsdp_tpu.ops.ipm import _bucketize, build_ipm_data


def _hetero_prob():
    """One 12x12 block and two 2x2 blocks with very different sizes:
    min -y1-y2 s.t. y1 <= 3 via big block diag, y2 <= 2 via small blocks."""
    big = SDPBlock(size=12, var=[0] * 12, row=list(range(12)),
                   col=list(range(12)), val=[-1.0] * 12,
                   const_row=list(range(12)), const_col=list(range(12)),
                   const_val=[-3.0] * 12)           # 3I - y1 I >= 0
    small1 = SDPBlock(size=2, var=[1, 1], row=[0, 1], col=[0, 1],
                      val=[-1.0, -1.0], const_row=[0, 1], const_col=[0, 1],
                      const_val=[-2.0, -2.0])       # 2I - y2 I >= 0
    small2 = SDPBlock(size=2, var=[0, 1], row=[0, 1], col=[0, 1],
                      val=[1.0, 1.0], const_row=[], const_col=[],
                      const_val=[])                 # diag(y1, y2) >= 0
    return MISDP(nvars=2, obj=np.array([-1.0, -1.0]),
                 lb=np.zeros(2), ub=np.full(2, INF),
                 integral=np.array([True, False]),
                 blocks=[big, small1, small2],
                 lp=LinearConstraints.empty(), name="hetero")


def test_bucketize_groups_sizes():
    assert _bucketize([12, 2, 2]) == [(2, [1, 2]), (12, [0])]
    # merging under budget keeps the largest as its own cap
    out = _bucketize([3, 4, 50, 51], max_buckets=2)
    assert out[0][0] == 4 and out[1][0] == 51
    assert sorted(out[0][1]) == [0, 1] and sorted(out[1][1]) == [2, 3]


def test_hetero_data_shapes():
    prob = _hetero_prob()
    data = build_ipm_data(densify(prob))
    assert data.nbuckets == 2
    shapes = sorted(a.shape[-1] for a in data.A)
    assert shapes == [2, 12]
    # block_of maps every original block somewhere consistent
    assert len(data.block_of) == 3


def test_hetero_solve():
    prob = _hetero_prob()
    iface = SDPInterface(densify(prob))
    res = iface.solve_batch(prob.lb[None, :], prob.ub[None, :])
    assert res.status[0] == 1
    np.testing.assert_allclose(res.objval[0], -5.0, atol=1e-4)
    result = solve_misdp(prob)
    np.testing.assert_allclose(result.objval, -5.0, atol=1e-4)


def test_wfeat_flat_chunked_matches_naive():
    """The mp-chunked flat W-feature producer must agree with the naive
    two-einsum chain exactly."""
    import jax.numpy as jnp
    import numpy as np

    from scipsdp_tpu.ops.ipm import _wfeat_flat

    rng = np.random.RandomState(3)
    B, K, mp, n = 3, 2, 11, 7
    Lx = jnp.asarray(rng.randn(B, K, n, n))
    A = jnp.asarray(rng.randn(K, mp, n, n))
    Ls = jnp.asarray(rng.randn(B, K, n, n))
    P = jnp.einsum("xkba,kjbc->xkjac", Lx, A)
    W = jnp.einsum("xkjab,xkcb->xkjac", P, Ls)
    want = np.asarray(jnp.transpose(W, (0, 2, 1, 3, 4)).reshape(B, mp, -1))
    got_one = np.asarray(_wfeat_flat(Lx, A, Ls, B, mp))
    np.testing.assert_allclose(got_one, want, rtol=1e-12)
    # tiny budget (3 features of f64) forces multiple chunks incl. a
    # ragged final chunk
    got_chunked = np.asarray(_wfeat_flat(Lx, A, Ls, B, mp,
                                         budget=3 * B * K * n * n * 8))
    np.testing.assert_allclose(got_chunked, want, rtol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_wfeat_flat_budget_counts_logical_bytes(dtype):
    """The chunk budget is logical bytes at the operands' dtype: a budget
    of exactly mp features runs one chunk, one feature less scans."""
    import jax
    import jax.numpy as jnp

    from scipsdp_tpu.ops.ipm import _wfeat_flat

    rng = np.random.RandomState(4)
    B, K, mp, n = 2, 1, 5, 6
    Lx = jnp.asarray(rng.randn(B, K, n, n), dtype)
    A = jnp.asarray(rng.randn(K, mp, n, n), dtype)
    Ls = jnp.asarray(rng.randn(B, K, n, n), dtype)
    per_j = B * K * n * n * jnp.dtype(dtype).itemsize

    def scans(budget):
        jaxpr = jax.make_jaxpr(
            lambda a, b, c: _wfeat_flat(a, b, c, B, mp, budget=budget))(
                Lx, A, Ls)
        return "scan" in str(jaxpr)

    assert not scans(mp * per_j)
    assert scans(mp * per_j - 1)
    one = np.asarray(_wfeat_flat(Lx, A, Ls, B, mp, budget=mp * per_j))
    many = np.asarray(_wfeat_flat(Lx, A, Ls, B, mp, budget=2 * per_j))
    np.testing.assert_allclose(many, one,
                               rtol=1e-5 if dtype == "float32" else 1e-12)
