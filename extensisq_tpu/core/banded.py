"""Banded linear algebra via block-tridiagonal cyclic reduction.

Device-native replacement for the reference's sparse SuperLU route
(/root/reference/extensisq/common.py:1756-1776 picks ``splu`` when the
Jacobian is sparse; the banded MoL systems it serves are exercised by
the Medazko problem, /root/reference/tests/test_ivp.py:262-291).  A
direct gbtrf translation would be an O(n) *sequential* scalar loop —
the worst possible shape for XLA.  Instead, a matrix with bandwidths
``(kl, ku)`` is exactly block-tridiagonal with blocks of size
``b = max(kl, ku)``, and block cyclic reduction factors/solves it in
``log2(n/b)`` *sequential* levels of fully batched b×b matmuls —
vmappable over ensembles and dtype-generic.

Storage conventions
-------------------
* banded ``AB`` — LAPACK-style ``(kl+ku+1, n)``:
  ``AB[ku + i - j, j] = A[i, j]`` for ``-kl <= i - j <= ku``.
* blocks — ``(m, b, b)`` arrays ``D`` (diagonal), ``L`` (coupling of
  block i to block i-1), ``U`` (coupling of block i to block i+1),
  with ``m`` a power of two (identity-padded past ``n``).

Pivoting happens *within* b×b blocks (partial-pivot ``gauss_solve``);
there is no pivoting across blocks — standard for cyclic reduction and
safe for the diagonally-dominant Newton matrices ``M - h*d*J`` this
serves.  The dense LU path remains available for ill-conditioned
systems.
"""
import jax
import jax.numpy as jnp
import numpy as np

from .linalg import gauss_solve
from .numerics import einsum, matmul


def bands_of_sparsity(sparsity):
    """Host-side ``(kl, ku)`` of a 0/1 sparsity pattern."""
    if hasattr(sparsity, "toarray"):
        sparsity = sparsity.toarray()
    S = np.asarray(sparsity) != 0
    i, j = np.nonzero(S)
    if i.size == 0:
        return 0, 0
    return int(np.maximum(i - j, 0).max()), int(np.maximum(j - i, 0).max())


def rcm_order(sparsity):
    """Host-side reverse Cuthill–McKee ordering of a 0/1 sparsity
    pattern (symmetrized).  Returns ``perm`` (int array: user index
    for each reordered slot, so ``y_perm = y[perm]``).

    The device-native answer to the reference's "any sparsity" SuperLU
    route (common.py:1756-1776): an irregular pattern whose NATURAL
    bandwidths are huge often reorders to a narrow band, which then
    rides the block-cyclic-reduction factor/solve instead of falling
    back to dense O(n^3).  Classic RCM: BFS from a minimum-degree
    vertex of each connected component, neighbours visited in
    increasing-degree order, final order reversed."""
    if hasattr(sparsity, "toarray"):
        sparsity = sparsity.toarray()
    S = np.asarray(sparsity) != 0
    n = S.shape[0]
    S = S | S.T
    np.fill_diagonal(S, False)
    adj = [np.nonzero(S[i])[0] for i in range(n)]
    deg = np.array([a.size for a in adj])
    # pre-sort each adjacency list by degree (ties: index)
    adj = [a[np.lexsort((a, deg[a]))] for a in adj]
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    k = 0
    while k < n:
        # next component: its minimum-degree unvisited vertex
        rest = np.nonzero(~visited)[0]
        start = rest[np.argmin(deg[rest])]
        visited[start] = True
        order[k] = start
        head = k
        k += 1
        while head < k:
            for v in adj[order[head]]:
                if not visited[v]:
                    visited[v] = True
                    order[k] = v
                    k += 1
            head += 1
    return order[::-1].copy()


def banded_from_dense(A, kl, ku):
    """Pack a dense (n, n) matrix into (kl+ku+1, n) banded storage."""
    A = jnp.asarray(A)
    n = A.shape[0]
    d = np.arange(kl + ku + 1)[:, None]          # band row
    j = np.arange(n)[None, :]                    # column
    i = j + d - ku                               # matrix row
    valid = (i >= 0) & (i < n)
    return jnp.where(valid, A[np.clip(i, 0, n - 1), j],
                     jnp.zeros((), A.dtype))


def dense_from_banded(AB, kl, ku, n):
    """Unpack banded storage to a dense (n, n) matrix (testing)."""
    AB = jnp.asarray(AB)
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    d = ku + i - j
    valid = (d >= 0) & (d <= kl + ku)
    return jnp.where(valid, AB[np.clip(d, 0, kl + ku), j],
                     jnp.zeros((), AB.dtype))


def banded_matvec(AB, kl, ku, x):
    """y = A @ x from banded storage: a sum over the 'kl+ku+1'
    diagonals — each term an elementwise product of shifted vectors."""
    AB = jnp.asarray(AB)
    n = x.shape[0]
    y = jnp.zeros_like(x)
    for d in range(kl + ku + 1):
        o = d - ku                               # i = j + o
        diag = AB[d]
        if o == 0:
            y = y + diag * x
        elif o > 0:                              # row i gets A[i, i-o]x
            y = y + jnp.concatenate(
                [jnp.zeros((o,), x.dtype), diag[:n - o] * x[:n - o]])
        else:
            k = -o
            y = y + jnp.concatenate(
                [diag[k:] * x[k:], jnp.zeros((k,), x.dtype)])
    return y


def banded_colored_jacfwd(fun, kl, ku, n, dtype):
    """``jac(t, y) -> AB`` evaluating a banded Jacobian in
    ``kl + ku + 1`` forward-mode tangents.

    Banded coloring is exact and trivial: columns j and j + (kl+ku+1)
    can never share a nonzero row, so ``groups[j] = j % (kl+ku+1)``
    (the banded special case of the reference's group_columns use,
    common.py:1706-1754).  The compressed columns scatter straight
    into banded storage — the dense (n, n) matrix is never formed.
    """
    C = kl + ku + 1
    groups = np.arange(n) % C
    seeds = np.zeros((C, n))
    seeds[groups, np.arange(n)] = 1.0
    seeds = jnp.asarray(seeds, dtype)
    # AB[d, j] = J[j + d - ku, j] = Jg[j % C, j + d - ku]
    d = np.arange(C)[:, None]
    j = np.arange(n)[None, :]
    i = j + d - ku
    valid = (i >= 0) & (i < n)
    i_c = np.clip(i, 0, n - 1)
    g = np.broadcast_to(groups[None, :], (C, n))

    def jac(t, y):
        _, Jg = jax.vmap(
            lambda v: jax.jvp(lambda yy: fun(t, yy), (y,), (v,)))(seeds)
        return jnp.where(valid, Jg[g, i_c], jnp.zeros((), dtype))

    return jac


def _next_pow2(m):
    p = 1
    while p < m:
        p *= 2
    return p


def block_shapes(n, kl, ku):
    """Static (b, m, n_pad) for the block-tridiagonal layout."""
    b = max(kl, ku, 1)
    m = _next_pow2(max(-(-n // b), 1))
    return b, m, m * b


def blocks_from_banded(AB, kl, ku, n):
    """(D, L, U) block-tridiagonal form of banded storage, identity-
    padded to a power-of-two number of blocks (pad rows decouple:
    D = I, L = U = 0, rhs pads with zeros)."""
    AB = jnp.asarray(AB)
    C = kl + ku + 1
    b, m, n_pad = block_shapes(n, kl, ku)
    ABp = jnp.concatenate(
        [jnp.pad(AB, ((0, 0), (0, n_pad - n))),
         jnp.zeros((1, n_pad), AB.dtype)], axis=0)    # row C = hard zero

    i = np.arange(m)[:, None, None]
    r = np.arange(b)[None, :, None]
    c = np.arange(b)[None, None, :]

    def gather(row_off, col_block):
        d = ku + r - c + row_off                  # band row index
        col = col_block * b + c
        bad = (d < 0) | (d >= C) | (col < 0) | (col >= n_pad)
        d = np.where(bad, C, np.clip(d, 0, C - 1))
        col = np.clip(col, 0, n_pad - 1)
        d_b, col_b = np.broadcast_arrays(d, col)
        return ABp[d_b, col_b]

    D = gather(0, i)
    # identity on padded diagonal entries so pad blocks stay inert
    pad_eye = ((i * b + r >= n) & (r == c))
    D = jnp.where(pad_eye, jnp.ones((), AB.dtype), D)
    L = gather(b, i - 1)                          # rows i*b+r, cols -b
    U = gather(-b, i + 1)
    L = L.at[0].set(jnp.zeros((b, b), AB.dtype))
    U = U.at[m - 1].set(jnp.zeros((b, b), AB.dtype))
    return D, L, U


def _inv_batched(D):
    b = D.shape[-1]
    eye = jnp.eye(b, dtype=D.dtype)
    return jax.vmap(lambda A: gauss_solve(A, eye))(D)


def _shift_down(X):
    """X'[k] = X[k-1], zeros at k = 0."""
    return jnp.concatenate([jnp.zeros_like(X[:1]), X[:-1]], axis=0)


def _shift_up(X):
    """X'[k] = X[k+1], zeros at k = m-1."""
    return jnp.concatenate([X[1:], jnp.zeros_like(X[:1])], axis=0)


def bcr_factor(D, L, U):
    """Factor a block-tridiagonal system by cyclic reduction.

    Each level eliminates the odd-indexed blocks:

        x_o = D_o^{-1} (f_o - L_o x_left - U_o x_right)

    substituted into the even rows gives the half-size system

        D' = D_e - P U_o<   - Q L_o        P = L_e D_o<^{-1}
        L' = -P L_o<                       Q = U_e D_o^{-1}
        U' = -Q U_o                        (``<`` = left odd neighbor)

    Stored per level: (P, Q, D_o^{-1}, L_o, U_o) — everything the
    solve needs to replay forward (rhs reduction) and backward (odd
    back-substitution) in batched b×b matmuls.  Returns the factor
    pytree ``(levels, root_inverse)``; structure is static in the
    block count, so it can live inside ``lax.while_loop`` carries.
    """
    levels = []
    while D.shape[0] > 1:
        De, Do = D[0::2], D[1::2]
        Le, Lo = L[0::2], L[1::2]
        Ue, Uo = U[0::2], U[1::2]
        Dinv = _inv_batched(Do)
        P = matmul(Le, _shift_down(Dinv))
        Q = matmul(Ue, Dinv)
        levels.append((P, Q, Dinv, Lo, Uo))
        D = De - matmul(P, _shift_down(Uo)) - matmul(Q, Lo)
        L = -matmul(P, _shift_down(Lo))
        U = -matmul(Q, Uo)
    return tuple(levels), _inv_batched(D)


def _bmv(M, v):
    return einsum("kij,kj->ki", M, v)


def bcr_solve(fact, f):
    """Solve with a :func:`bcr_factor` result; ``f`` is (m, b) blocked
    or flat (m*b,).  Returns the same shape."""
    levels, root = fact
    flat = f.ndim == 1
    if flat:
        f = f.reshape(-1, root.shape[-1])
    fo_stack = []
    for (P, Q, Dinv, Lo, Uo) in levels:
        fe, fo = f[0::2], f[1::2]
        fo_stack.append(fo)
        f = fe - _bmv(P, _shift_down(fo)) - _bmv(Q, fo)
    x = _bmv(root, f)
    for (P, Q, Dinv, Lo, Uo), fo in zip(reversed(levels),
                                        reversed(fo_stack)):
        xo = _bmv(Dinv, fo - _bmv(Lo, x) - _bmv(Uo, _shift_up(x)))
        x = jnp.stack([x, xo], axis=1).reshape(-1, x.shape[-1])
    return x.reshape(-1) if flat else x


def bcr_zero_factor(n, kl, ku, dtype):
    """A zero-filled factor pytree with the static structure
    :func:`bcr_factor` produces for this problem size — the state
    initializer's placeholder (mirrors ``LU=jnp.zeros((n, n))`` on the
    dense path)."""
    b, m, _ = block_shapes(n, kl, ku)
    levels = []
    while m > 1:
        m //= 2
        z = jnp.zeros((m, b, b), dtype)
        levels.append((z, z, z, z, z))
    return tuple(levels), jnp.zeros((1, b, b), dtype)


def banded_factor(AB, kl, ku, n):
    """Convenience: banded storage -> BCR factor."""
    return bcr_factor(*blocks_from_banded(AB, kl, ku, n))


def banded_solve(fact, b_vec, n, kl, ku):
    """Solve A x = b for a flat (n,) right-hand side (zero-padded to
    the block layout internally)."""
    bsz, m, n_pad = block_shapes(n, kl, ku)
    f = jnp.concatenate([b_vec,
                         jnp.zeros((n_pad - n,), b_vec.dtype)])
    return bcr_solve(fact, f.reshape(m, bsz)).reshape(-1)[:n]
