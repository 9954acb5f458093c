"""Batched dense eigen/linear-algebra helpers (the L0 layer).

Device replacement for the reference's LAPACK interface
(src/sdpi/lapack_interface.c: SCIPlapackComputeIthEigenvalue,
SCIPlapackComputeEigenvectorsNegative, matrix multiplies): everything is
batched `jnp.linalg.eigh`/`cholesky` over padded dense blocks, jit/vmap
friendly.  Padded dimensions are expected to carry benign diagonal entries
(see models/problem.densify) so batched factorizations stay valid.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sym(M: jnp.ndarray) -> jnp.ndarray:
    """Symmetrize the trailing two axes."""
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


def min_eigenvalue(M: jnp.ndarray, dimmask: jnp.ndarray) -> jnp.ndarray:
    """Smallest eigenvalue over the *real* dimensions of padded blocks.

    ``M``: (..., n, n); ``dimmask``: (..., n) bool.  Padded rows/cols are
    replaced by an identity scaled to a large positive value so they can
    never be the minimum (analog of SCIPlapackComputeIthEigenvalue with
    i = 1, lapack_interface.c:178).
    """
    n = M.shape[-1]
    big = 1.0 + jnp.max(jnp.abs(M), axis=(-1, -2), keepdims=True)
    outer = dimmask[..., :, None] & dimmask[..., None, :]
    eye = jnp.eye(n, dtype=M.dtype)
    Mm = jnp.where(outer, M, big * eye)
    w = jnp.linalg.eigvalsh(Mm)
    return w[..., 0]


def max_step_psd(L: jnp.ndarray, dM: jnp.ndarray) -> jnp.ndarray:
    """Largest alpha with  M + alpha*dM >= 0,  given M = L L^T (Cholesky).

    Returns +inf (a large number) when dM keeps M PSD for all alpha.
    Batched over leading axes.  This is the line-search min-eig check of
    the IPM step rule (BASELINE.json north star kernel #3).
    """
    # Y = L^{-1} dM L^{-T};  M + a dM >= 0  <=>  1 + a*lambda_min(Y) >= 0
    W = jax.scipy.linalg.solve_triangular(L, dM, lower=True)
    Y = jax.scipy.linalg.solve_triangular(
        L, jnp.swapaxes(W, -1, -2), lower=True
    )
    Y = sym(Y)
    lam_min = jnp.linalg.eigvalsh(Y)[..., 0]
    safe = lam_min >= -1e-14
    return jnp.where(safe, jnp.inf, -1.0 / jnp.where(safe, -1.0, lam_min))


def max_step_psd_power(L: jnp.ndarray, dM: jnp.ndarray,
                       iters: int = 16) -> jnp.ndarray:
    """Like :func:`max_step_psd` but via shifted power iteration instead of
    a full eigendecomposition.

    The step rule only needs lambda_max of  -Y = -L^{-1} dM L^{-T}, which
    a dozen batched matvecs estimate well, without a full eigh.  The estimate can slightly
    overestimate the allowed step, so callers pair this with a Cholesky
    probe that shrinks steps leaving the PSD cone (ops/ipm.py).
    """
    W = jax.scipy.linalg.solve_triangular(L, dM, lower=True)
    Y = jax.scipy.linalg.solve_triangular(
        L, jnp.swapaxes(W, -1, -2), lower=True
    )
    S = -sym(Y)
    n = S.shape[-1]
    # Gershgorin shift makes S + cI PSD so power iteration finds c + lam_max
    c = jnp.max(jnp.sum(jnp.abs(S), axis=-1), axis=-1)
    Sc = S + c[..., None, None] * jnp.eye(n, dtype=S.dtype)
    v = jnp.ones(S.shape[:-1], S.dtype)[..., None] / jnp.sqrt(
        jnp.asarray(n, S.dtype))

    def body(_, v):
        w = Sc @ v
        return w / jnp.maximum(
            jnp.linalg.norm(w, axis=(-2, -1), keepdims=True), 1e-300)

    v = jax.lax.fori_loop(0, iters, body, v)
    lam = jnp.sum(v * (Sc @ v), axis=(-2, -1)) - c
    safe = lam <= 1e-12
    return jnp.where(safe, jnp.inf, 1.0 / jnp.where(safe, 1.0, lam))


def ymat(Linv: jnp.ndarray, dM: jnp.ndarray) -> jnp.ndarray:
    """Congruence transform Y = Linv dM Linv^T used by the PSD max-step
    rules:  M + a dM >= 0  <=>  I + a Y >= 0  when M = L L^T.

    Matmul-only (the caller supplies the explicit triangular inverse): the
    solver computes Linv once per iteration and turns every step-rule
    solve into two batched matmuls.
    """
    T = jnp.einsum("...ab,...bc->...ac", Linv, dM)
    return sym(jnp.einsum("...ac,...dc->...ad", T, Linv))


def max_step_from_ymat(Y: jnp.ndarray, iters: int = 16) -> jnp.ndarray:
    """Largest alpha with  I + alpha*Y >= 0  via shifted power iteration
    (the solve-free core of :func:`max_step_psd_power`)."""
    S = -Y
    n = S.shape[-1]
    c = jnp.max(jnp.sum(jnp.abs(S), axis=-1), axis=-1)
    Sc = S + c[..., None, None] * jnp.eye(n, dtype=S.dtype)
    v = jnp.ones(S.shape[:-1], S.dtype)[..., None] / jnp.sqrt(
        jnp.asarray(n, S.dtype))

    def body(_, v):
        w = Sc @ v
        return w / jnp.maximum(
            jnp.linalg.norm(w, axis=(-2, -1), keepdims=True),
            jnp.asarray(1e-30, S.dtype))

    v = jax.lax.fori_loop(0, iters, body, v)
    lam = jnp.sum(v * (Sc @ v), axis=(-2, -1)) - c
    safe = lam <= 1e-12
    return jnp.where(safe, jnp.inf, 1.0 / jnp.where(safe, 1.0, lam))


def max_step_eigh_from_ymat(Y: jnp.ndarray) -> jnp.ndarray:
    """Exact variant of :func:`max_step_from_ymat` (full eigendecomposition;
    the default step rule)."""
    lam_min = jnp.linalg.eigvalsh(Y)[..., 0]
    safe = lam_min >= -1e-14
    return jnp.where(safe, jnp.inf, -1.0 / jnp.where(safe, -1.0, lam_min))


def gersh_step_from_ymat(Y: jnp.ndarray) -> jnp.ndarray:
    """Conservative Gershgorin bound variant (eigh- and iteration-free)."""
    lam_bound = jnp.max(jnp.sum(jnp.abs(Y), axis=-1), axis=-1)
    return 1.0 / jnp.maximum(lam_bound, jnp.asarray(1e-30, Y.dtype))


def max_step_pos(v: jnp.ndarray, dv: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Largest alpha with  v + alpha*dv >= 0  elementwise over masked entries.

    ``v`` strictly positive where mask; reduces over the last axis.
    """
    neg = (dv < 0) & mask
    ratio = jnp.where(neg, -v / jnp.where(neg, dv, -1.0), jnp.inf)
    return jnp.min(ratio, axis=-1)


def spd_inverse(M: jnp.ndarray, L: jnp.ndarray = None) -> jnp.ndarray:
    """Inverse of a symmetric positive definite matrix via Cholesky.

    Avoids LU decomposition and guarantees a symmetric result.  ``L`` may pass a precomputed Cholesky factor.
    """
    if L is None:
        L = jnp.linalg.cholesky(M)
    n = M.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=M.dtype), M.shape)
    W = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    inv = jnp.matmul(jnp.swapaxes(W, -1, -2), W)
    return sym(inv)


def chol_solve(L: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """Solve (L L^T) x = rhs for batched lower-triangular L, rhs (..., n)."""
    y = jax.scipy.linalg.solve_triangular(L, rhs[..., None], lower=True)
    x = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), y, lower=False
    )
    return x[..., 0]
