"""Dense-output representation and evaluation.

Every interpolant in the framework — Horner polynomials from tableau
``P`` matrices, cubic/quintic Hermite fallbacks, Nystrom split
polynomials, the Adams dintp polynomial, piecewise-cubic ESDIRK output —
is normalized to ONE segment form::

    y(u) = y_anchor + sum_k Q[:, k] * u**(k+1),   u = (t - t_anchor)/h

with ``Q`` of shape (n, degree).  This replaces the reference's zoo of
``DenseOutput`` subclasses (/root/reference/extensisq/common.py:766-821,
1489-1613, shampine.py:498-612, hosea.py:29-43) with data, so a whole
trajectory's dense output is a stack of (t_anchor, h, y_anchor, Q) rows
that evaluates with searchsorted + Horner — vectorized, jittable, and
usable inside traced code (e.g. the adjoint backward RHS).
"""
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from .numerics import einsum


def horner(u, Q, y_anchor):
    """y(u) = y_anchor + sum_k Q[:, k] u^(k+1), scalar u."""
    p = Q.shape[1]
    acc = Q[:, p - 1]
    for k in range(p - 2, -1, -1):
        acc = acc * u + Q[:, k]
    return y_anchor + u * acc


def hermite_cubic_coefficients(h, y_old, y, f_old, f):
    """C1 cubic Hermite as Q coefficients (common.py:793-821).

    With m0 = h*f_old, m1 = h*f:
      y(u) = y_old + m0 u + (3dy - 2m0 - m1) u^2 + (m0 + m1 - 2dy) u^3
    """
    m0 = h * f_old
    m1 = h * f
    dy = y - y_old
    Q = jnp.stack([m0, 3.0 * dy - 2.0 * m0 - m1, m0 + m1 - 2.0 * dy],
                  axis=1)
    return Q


def linear_coefficients(y_old, y):
    """Linear segment (SWAG extrapolated final step, shampine.py:590-612)."""
    return (y - y_old)[:, None]


def quintic_hermite_coefficients(h, y_old, y, f_old, f):
    """C2 quintic Hermite for 2nd-order ODE state [u, v]
    (common.py:1528-1578); f are accelerations (length n//2).

    Returns Q of shape (2n, 5) in the unified anchor form.
    """
    n = y_old.shape[0] // 2
    x0, v0 = y_old[:n], y_old[n:]
    x1, v1 = y[:n], y[n:]
    a0, a1 = f_old, f
    # position: quintic with (x0, v0 h, a0 h^2 / 2) and end values
    P = np.array([[1, 0, 0, -10, 15, -6],
                  [0, 1, 0, -6, 8, -3],
                  [0, 0, 1/2, -3/2, 3/2, -1/2],
                  [0, 0, 0, 10, -15, 6],
                  [0, 0, 0, -4, 7, -3],
                  [0, 0, 0, 1/2, -1, 1/2]])
    basis = jnp.stack([x0, v0 * h, a0 * h * h, x1, v1 * h, a1 * h * h])
    coef_x = einsum("bn,bp->np", basis, jnp.asarray(P))  # (n, 6)
    # velocity = derivative / h
    Pp = P[:, 1:] * np.arange(1, 6)
    basis_v = jnp.stack([x0 / h, v0, a0 * h, x1 / h, v1, a1 * h])
    coef_v = einsum("bn,bp->np", basis_v, jnp.asarray(Pp))  # (n, 5)
    # unified form: subtract anchor, coefficients for u^1..u^5
    Qx = coef_x[:, 1:]            # coef_x[:,0] == x0
    Qv = jnp.concatenate(
        [coef_v[:, 1:], jnp.zeros_like(coef_v[:, :1])], axis=1)
    # coef_v[:,0] == v0 is the anchor for v
    return jnp.concatenate([Qx, Qv], axis=0)


def nystrom_coefficients(h, y_old, Q, Qp):
    """Unified coefficients from Nystrom interpolation matrices
    (common.py:1489-1525): Q = K^T P (n, p), Qp = K^T Pp.

    u(x) = u0 + x h v0 + x^2 h^2 (Q poly),  v(x) = v0 + x h (Qp poly).
    """
    n = y_old.shape[0] // 2
    v0 = y_old[n:]
    Qx = jnp.concatenate([(h * v0)[:, None], Q * h * h], axis=1)
    Qv = Qp * h
    p = max(Qx.shape[1], Qv.shape[1])
    Qx = jnp.pad(Qx, ((0, 0), (0, p - Qx.shape[1])))
    Qv = jnp.pad(Qv, ((0, 0), (0, p - Qv.shape[1])))
    return jnp.concatenate([Qx, Qv], axis=0)


class OdeSolution(NamedTuple):
    """Evaluable dense output over a whole trajectory (pytree).

    Segment i covers [ts[i], ts[i+1]] (or reversed for backward
    integration).  ``Q`` rows are zero-padded to a common degree.
    Callable like scipy's OdeSolution: sol(t) -> (n,) or (n, m).
    """
    ts: Any          # (N+1,) strictly monotone
    t_anchor: Any    # (N,)
    h: Any           # (N,) signed
    y_anchor: Any    # (N, n)
    Q: Any           # (N, n, p)

    @property
    def t_min(self):
        return jnp.minimum(self.ts[0], self.ts[-1])

    @property
    def t_max(self):
        return jnp.maximum(self.ts[0], self.ts[-1])

    def _eval_one(self, t):
        ts = self.ts
        ascending = ts[-1] >= ts[0]
        tq = jnp.where(ascending, t, -t)
        grid = jnp.where(ascending, ts, -ts)
        idx = jnp.clip(jnp.searchsorted(grid[1:-1], tq, side="left"),
                       0, self.h.shape[0] - 1)
        u = (t - self.t_anchor[idx]) / self.h[idx]
        return horner(u, self.Q[idx], self.y_anchor[idx])

    def __call__(self, t):
        t = jnp.asarray(t)
        if t.ndim == 0:
            return self._eval_one(t)
        return jax.vmap(self._eval_one)(t).T


def stack_segments(segments):
    """Build an OdeSolution from a host-side list of
    (t_old, t_new, t_anchor, h, y_anchor, Q) tuples, zero-padding Q."""
    ts = [segments[0][0]] + [s[1] for s in segments]
    p = max(int(s[5].shape[1]) for s in segments)
    Qs = []
    for s in segments:
        Q = np.asarray(s[5])
        if Q.shape[1] < p:
            Q = np.pad(Q, ((0, 0), (0, p - Q.shape[1])))
        Qs.append(Q)
    return OdeSolution(
        ts=jnp.asarray(np.asarray(ts)),
        t_anchor=jnp.asarray(np.asarray([s[2] for s in segments])),
        h=jnp.asarray(np.asarray([s[3] for s in segments])),
        y_anchor=jnp.asarray(np.stack([np.asarray(s[4])
                                       for s in segments])),
        Q=jnp.asarray(np.stack(Qs)))
