"""Eigenvector cutting planes for SDP blocks.

Batched port of the reference's cut separation (cons_sdp.c):
``separateSol``:1612 assembles Z(y) = sum_j A_j y_j - A_0 per block,
computes all eigenvectors with negative eigenvalues
(SCIPlapackComputeEigenvectorsNegative), and for each eigenvector v emits
the linear cut  sum_j (v^T A_j v) y_j >= v^T A_0 v
(``produceCutFromEigenvector``:896, coefficient computation
``multiplyConstraintMatrix``:827).  Here one batched ``eigh`` yields every
cut of every block of every node at once, and the coefficients are one
einsum.

Also provides the truncated-power-method sparsification of cuts
(``truncatedPowerMethod``:1140, ``sparsifyCut``:1243): find an
s-sparse approximate smallest eigenvector by iterating (shifted) power
steps truncated to the s largest entries.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scipsdp_tpu.ops.ipm import IPMData


class CutBatch(NamedTuple):
    """Per-bucket tuples: element t has shapes (B, K_t, n_t, ...)."""

    coefs: tuple   # per bucket (B, K_t, n_t, mp) coefficients (v^T A_j v)
    rhs: tuple     # per bucket (B, K_t, n_t) right-hand sides (v^T A_0 v)
    valid: tuple   # per bucket (B, K_t, n_t) bool: eigenvalue < -tol
    lam: tuple     # per bucket (B, K_t, n_t) eigenvalues of Z(y)


@functools.partial(jax.jit, static_argnames=("tol",))
def separate_eigenvector_cuts(data: IPMData, y: jnp.ndarray,
                              tol: float = 1e-6) -> CutBatch:
    """All eigenvector cuts violated at points ``y`` (B, m or mp).

    The cut from eigenvector v of block k is valid for every feasible
    point (it is implied by Z_k >= 0); ``valid`` marks those actually
    violated at y (eigenvalue < -tol).  Returned coefficient rows are in
    the extended variable space (mp = m + 1, penalty column = v^T I v = 1).
    """
    B = y.shape[0]
    mp = data.A[0].shape[1]
    if y.shape[1] == mp - 1:
        y = jnp.concatenate([y, jnp.zeros((B, 1), y.dtype)], axis=1)
    coefs_t, rhs_t, valid_t, lam_t = [], [], [], []
    for t in range(data.nbuckets):
        Z = jnp.einsum("kjab,xj->xkab", data.A[t], y) - data.C[t][None]
        # mask padding: large positive diagonal so padded eigenpairs are
        # never selected as negative
        n = Z.shape[-1]
        outer = (data.dimmask[t][None, :, :, None]
                 & data.dimmask[t][None, :, None, :])
        big = 1.0 + jnp.max(jnp.abs(Z), axis=(-1, -2), keepdims=True)
        Zm = jnp.where(outer, Z, big * jnp.eye(n, dtype=Z.dtype))
        lam, V = jnp.linalg.eigh(Zm)      # (B,K,n), (B,K,n,n) cols = vecs
        # coefficients: for eigenvector v (column e): v^T A_j v
        coefs = jnp.einsum("xkae,kjab,xkbe->xkej", V, data.A[t], V)
        rhs = jnp.einsum("xkae,kab,xkbe->xke", V, data.C[t], V)
        realblock = data.dimmask[t].any(axis=1)  # (K_t,)
        valid = (lam < -tol) & realblock[None, :, None]
        coefs_t.append(coefs)
        rhs_t.append(rhs)
        valid_t.append(valid)
        lam_t.append(lam)
    return CutBatch(coefs=tuple(coefs_t), rhs=tuple(rhs_t),
                    valid=tuple(valid_t), lam=tuple(lam_t))


def sparsify_cut_tpower(Zk: jnp.ndarray, sparsity: int, iters: int = 20):
    """Truncated power method: s-sparse approximate most-negative
    eigenvector of symmetric Zk (n, n) (cons_sdp.c:1140-1338).

    Works on the shifted matrix  sigma*I - Z  so the target eigenvalue is
    the largest; after each power step only the ``sparsity`` largest-
    magnitude entries are kept.
    """
    n = Zk.shape[-1]
    sigma = jnp.sum(jnp.abs(Zk))  # upper bound on spectral radius
    Ms = sigma * jnp.eye(n, dtype=Zk.dtype) - Zk

    def trunc(v):
        av = jnp.abs(v)
        thresh = jax.lax.top_k(av, sparsity)[0][-1]
        v = jnp.where(av >= thresh, v, 0.0)
        return v / jnp.maximum(jnp.linalg.norm(v), 1e-30)

    def body(_, v):
        return trunc(Ms @ v)

    v0 = trunc(jnp.ones((n,), Zk.dtype))
    v = jax.lax.fori_loop(0, iters, body, v0)
    return v


def multiple_sparse_cuts(Zk, sparsity: int, maxncuts: int = -1,
                         tol: float = 1e-6, iters: int = 50):
    """Disjoint-support sparse eigenvector directions of one block
    (addMultipleSparseCuts, cons_sdp.c:1340-1610): repeatedly find an
    s-sparse approximate most-negative eigenvector by the truncated power
    method on the shifted matrix, *exactly* recompute the smallest
    eigenpair of the support submatrix (RECOMPUTESPARSEEV role), emit the
    lifted vector when its Rayleigh quotient is < -tol, then remove the
    support rows/columns and repeat until no negative direction remains.

    Host-side helper (cut generation runs on host in LP mode); returns a
    list of dense n-vectors with disjoint supports.
    """
    import numpy as np

    Z = np.asarray(Zk, dtype=np.float64).copy()
    n = Z.shape[-1]
    alive = np.ones(n, dtype=bool)
    out = []
    while (maxncuts < 0 or len(out) < maxncuts) and alive.sum() >= 1:
        idx = np.where(alive)[0]
        sub = Z[np.ix_(idx, idx)]
        s = min(sparsity, len(idx))
        v = np.asarray(sparsify_cut_tpower(jnp.asarray(sub), s, iters))
        supp = np.where(np.abs(v) > 1e-12)[0]
        if supp.size == 0:
            break
        # exact smallest eigenpair of the support submatrix
        ssub = sub[np.ix_(supp, supp)]
        lam, V = np.linalg.eigh(ssub)
        if lam[0] >= -tol:
            break
        lifted = np.zeros(n)
        lifted[idx[supp]] = V[:, 0]
        out.append(lifted)
        alive[idx[supp]] = False
    return out
