"""Small dense linear solves from elementwise ops, and colored autodiff
Jacobians for structured sparsity.

For the few solves the framework needs outside the Newton loop (DAE
consistent-IC projection, mass-matrix application at setup), this
module provides partial-pivot Gaussian elimination built from
elementwise jnp ops — dtype-agnostic, jittable, vmappable.  (Whether it
should give way to ``lax.linalg.lu`` is an open design question.)
"""
import jax
import jax.numpy as jnp
import numpy as np


def group_columns(sparsity):
    """Greedy CPR column grouping of a Jacobian sparsity pattern.

    Columns that share no nonzero row land in the same group, so one
    directional derivative recovers all of them (Curtis–Powell–Reid).
    Host-side; ``sparsity`` is any dense/sparse (n, n) 0/1 pattern.
    Returns ``(groups, n_groups)`` with ``groups[j]`` the group of
    column j.  Device counterpart of the reference's scipy
    ``group_columns`` use (common.py:1710-1715) — there it seeds
    finite differences, here it seeds forward-mode tangents.
    """
    if hasattr(sparsity, "toarray"):
        sparsity = sparsity.toarray()
    S = np.asarray(sparsity) != 0
    if S.ndim != 2 or S.shape[0] != S.shape[1]:
        raise ValueError(f"sparsity must be square 2-D, got {S.shape}")
    n = S.shape[1]
    groups = np.full(n, -1, dtype=np.int32)
    n_groups = 0
    # visit densest columns first: a better greedy bound
    order = np.argsort(-S.sum(axis=0), kind="stable")
    for j in order:
        if groups[j] >= 0:
            continue
        groups[j] = n_groups
        covered = S[:, j].copy()
        for k in order:
            if groups[k] < 0 and not np.any(covered & S[:, k]):
                groups[k] = n_groups
                covered |= S[:, k]
        n_groups += 1
    return groups, n_groups


def colored_jacfwd(fun, sparsity, n, dtype):
    """A ``jac(t, y)`` evaluating the sparse Jacobian of ``fun(t, y)``
    in ``n_groups`` forward-mode tangents instead of ``n``.

    The tangent seeds are the group indicator vectors; one vmapped
    ``jax.jvp`` sweep computes all compressed columns, and the dense
    (n, n) J is scattered back through the sparsity mask (zeros stay
    hard zeros).  O(colors) RHS-width JVPs — for banded/stencil
    problems that is O(bandwidth) instead of O(n).
    """
    groups, n_groups = group_columns(sparsity)
    seeds = np.zeros((n_groups, n))
    seeds[groups, np.arange(n)] = 1.0
    seeds = jnp.asarray(seeds, dtype)
    if hasattr(sparsity, "toarray"):
        sparsity = sparsity.toarray()
    mask = jnp.asarray(np.asarray(sparsity) != 0)
    groups_j = jnp.asarray(groups)

    def jac(t, y):
        _, Jg = jax.vmap(
            lambda v: jax.jvp(lambda yy: fun(t, yy), (y,), (v,)))(seeds)
        # Jg[g] = J @ seed_g; column j of J lives in Jg[groups[j]]
        # wherever the pattern says it is nonzero
        return jnp.where(mask, Jg[groups_j].T, jnp.zeros((), dtype))

    return jac


def gauss_solve(A, B):
    """Solve A X = B with partial pivoting; B may be (n,) or (n, m)."""
    A = jnp.asarray(A)
    vec = B.ndim == 1
    B = jnp.asarray(B)
    if vec:
        B = B[:, None]
    n = A.shape[0]
    m = B.shape[1]
    Ab = jnp.concatenate([A, B.astype(A.dtype)], axis=1)
    rows = jnp.arange(n)

    def elim(k, Ab):
        col = jnp.abs(Ab[:, k])
        col = jnp.where(rows < k, -jnp.inf, jnp.real(col))
        p = jnp.argmax(col)
        rk = Ab[k]
        rp = Ab[p]
        Ab = Ab.at[k].set(rp).at[p].set(rk)
        pivot = Ab[k, k]
        factors = Ab[:, k] / pivot
        factors = jnp.where(rows > k, factors, 0.0)
        return Ab - factors[:, None] * Ab[k][None, :]

    Ab = jax.lax.fori_loop(0, n, elim, Ab)

    def back(i, X):
        k = n - 1 - i
        dot = jnp.sum(jnp.where((rows > k)[:, None],
                                Ab[k, :n][:, None] * X, 0.0), axis=0)
        xk = (Ab[k, n:] - dot) / Ab[k, k]
        return X.at[k].set(xk)

    X = jax.lax.fori_loop(0, n, back,
                          jnp.zeros((n, m), Ab.dtype))
    return X[:, 0] if vec else X
