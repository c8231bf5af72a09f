"""Sensitivity analysis: forward, adjoint-at-endpoint, adjoint-integral.

API mirror of /root/reference/extensisq/sensitivity.py with one upgrade
the reference calls out as impossible for it (SURVEY.md 2.3): the user
derivatives ``jac``/``dfdp``/``dgdy``/``dgdp`` are OPTIONAL here —
when omitted they come from autodiff:

* forward sensitivities build the augmented RHS from ``jax.jvp``
  (J s_i + df/dp_i in one JVP per parameter, no Jacobian materialized);
* adjoint solves build -J^T mu and (df/dp)^T mu from one ``jax.vjp``
  call per RHS evaluation.

The backward RHS interpolates the forward solution *inside the traced
integrator* — possible because this framework's dense output is a
device-evaluable pytree (core/interpolate.OdeSolution), where the
reference interpolates through a Python object (sensitivity.py:347-354).

``grad_solve``/``solve_final`` additionally expose a whole solve to
``jax.grad`` via ``jax.custom_vjp`` (continuous adjoint), making
parameter ensembles differentiable end to end.
"""
from collections import namedtuple
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from .core.numerics import matmul

SensitivityOutput = namedtuple("ForwardSensitivityOutput",
                               "sensf yf sol")
AdjointSensitivityOutputEnd = namedtuple("AdjointSensitivityOutput",
                                         "sens gf sol_y sol_bw")
AdjointSensitivityOutputInt = namedtuple("AdjointSensitivityOutput",
                                         "sens G sol_y sol_bw")


def _embed(f, p):
    """close over the parameter vector: f(t, y, *p) -> f(t, y)"""
    if f is None:
        return None
    return lambda t, y: f(t, y, *p)


def sens_forward(fun, t_span, y0, jac=None, dfdp=None, dy0dp=None, p=(),
                 atol=1e-6, rtol=1e-3, method=None, dense_output=False,
                 t_eval=None, use_approx_jac=False):
    """Forward (internal-differentiation) sensitivities dy/dp.

    Signature-compatible with the reference (sensitivity.py:60-217);
    ``jac``/``dfdp`` may be None (autodiff via jvp).  The augmented
    system of size ny*(np+1) is integrated in one solve.

    With an implicit method, the augmented Newton Jacobian is handled
    the reference's way (sensitivity.py:183-210): by default the exact
    augmented Jacobian is evaluated through its block sparsity pattern
    (here: colored forward AD, 2*ny tangents regardless of np);
    ``use_approx_jac=True`` instead supplies the block-diagonal
    approximation diag(J, ..., J) — one base-Jacobian evaluation,
    ignoring the sensitivity-to-state coupling, traded for possibly
    more Newton iterations.  Explicit methods ignore the flag (warned).
    """
    import warnings
    from .ivp import solve_ivp
    from .types import Method
    if method is None:
        from .methods import BS5 as method
    if isinstance(method, str):
        from .methods import METHODS_BY_NAME
        method = METHODS_BY_NAME[method]
    y0 = np.atleast_1d(np.asarray(y0, dtype=float))
    p = jnp.atleast_1d(jnp.asarray(p, dtype=float))
    Ny, Np = y0.size, p.size
    if dy0dp is None:
        dy0dp = np.zeros((Ny, Np))
    dy0dp = np.asarray(dy0dp, dtype=float)
    if dy0dp.shape != (Ny, Np):
        raise ValueError("`dy0dp` should be an array of shape (ny, np)")
    t0, tf = t_span
    if t_eval is not None and t_eval[-1] != tf:
        raise ValueError(
            "if `t_eval` is used, the last point should be t_span[-1]")

    fun_p = lambda t, y, pp: jnp.asarray(fun(t, y, *pp))  # noqa: E731
    jac_e = _embed(jac, tuple(p))
    dfdp_e = _embed(dfdp, tuple(p))

    if jac_e is not None and dfdp_e is not None:
        def sens_rhs(t, y, s):
            # s: (Np, Ny) rows = per-parameter sensitivities
            J = jnp.asarray(jac_e(t, y))
            D = jnp.asarray(dfdp_e(t, y))       # (Ny, Np)
            return matmul(s, J.T) + D.T
    else:
        def sens_rhs(t, y, s):
            eye = jnp.eye(Np)

            def one(si, ei):
                _, ds = jax.jvp(lambda yy, pp: fun_p(t, yy, pp),
                                (y, p), (si, ei))
                return ds

            return jax.vmap(one)(s, eye)

    def total_fun(t, z):
        y = z[:Ny]
        s = z[Ny:].reshape(Np, Ny)
        dy = fun_p(t, y, p)
        ds = sens_rhs(t, y, s)
        return jnp.concatenate([dy, ds.reshape(-1)])

    # per-parameter absolute tolerance scaling (sensitivity.py:165-170)
    total_atol = np.empty((Np + 1) * Ny)
    total_atol[:Ny] = atol
    p_np = np.asarray(p)
    for i in range(Np):
        factor = abs(p_np[i]) or 1.0
        total_atol[(i + 1) * Ny:(i + 2) * Ny] = atol / factor

    # augmented-system Newton Jacobian for implicit methods
    # (reference sensitivity.py:183-210)
    extra = {}
    if isinstance(method, Method) and method.family == "esdirk":
        m = (Np + 1) * Ny
        if use_approx_jac:
            if jac_e is not None:
                base_jac = jac_e
            else:
                base_jac = jax.jacfwd(
                    lambda t, y: fun_p(t, y, p), argnums=1)

            def total_jac(t, z):
                J = jnp.asarray(base_jac(t, z[:Ny]))
                return jax.scipy.linalg.block_diag(*([J] * (Np + 1)))

            extra["jac"] = total_jac
        else:
            # exact block pattern: every block row depends on y, and
            # sensitivity block i on itself; colored AD needs only
            # 2*ny tangents for it, independent of np
            S = np.zeros((m, m), dtype=int)
            S[:, :Ny] = 1
            for i in range(Np):
                S[(i + 1) * Ny:(i + 2) * Ny,
                  (i + 1) * Ny:(i + 2) * Ny] = 1
            extra["jac_sparsity"] = S
    elif use_approx_jac:
        warnings.warn("use_approx_jac has no effect for explicit "
                      "methods", stacklevel=2)

    z0 = np.concatenate([y0, dy0dp.T.reshape(-1)])
    sol = solve_ivp(total_fun, t_span, z0, atol=total_atol, rtol=rtol,
                    method=method, dense_output=dense_output,
                    t_eval=t_eval, **extra)
    if not sol.success:
        raise RuntimeError("IVP solver not converged")
    yf = sol.y[:Ny, -1]
    sensf = sol.y[Ny:, -1].reshape(Np, Ny).T
    return SensitivityOutput(sensf, yf, sol)


def _g_derivatives(g, dgdy, dgdp, p):
    gp = lambda t, y, pp: jnp.asarray(g(t, y, *pp)).reshape(())  # noqa
    if dgdy is None:
        dgdy_e = lambda t, y: jax.grad(gp, argnums=1)(t, y, p)   # noqa
    else:
        dgdy_e = _embed(dgdy, tuple(p))
    if dgdp is None:
        dgdp_e = lambda t, y: jax.grad(gp, argnums=2)(t, y, p)   # noqa
    else:
        dgdp_e = _embed(dgdp, tuple(p))
    return gp, dgdy_e, dgdp_e


def _vjp_terms(fun_p, t, y, p, mu):
    """(J^T mu, dfdp^T mu) in one vjp call."""
    _, pullback = jax.vjp(lambda yy, pp: fun_p(t, yy, pp), y, p)
    JTmu, DTmu = pullback(mu)
    return JTmu, DTmu


def sens_adjoint_end(fun, t_span, y0, jac=None, dfdp=None, dy0dp=None,
                     p=(), g=None, dgdp=None, dgdy=None, method=None,
                     rtol=1e-3, atol=1e-6, atol_adj=1e-6, atol_quad=1e-6,
                     sol_y=None):
    """dg/dp at t_f by the adjoint method (sensitivity.py:220-387)."""
    from .ivp import solve_ivp
    if method is None:
        from .methods import BS5 as method
    y0 = np.atleast_1d(np.asarray(y0, dtype=float))
    p = jnp.atleast_1d(jnp.asarray(p, dtype=float))
    Ny, Np = y0.size, p.size
    if dy0dp is None:
        dy0dp = np.zeros((Ny, Np))
    t0, tf = t_span

    fun_p = lambda t, y, pp: jnp.asarray(fun(t, y, *pp))  # noqa: E731
    gp, dgdy_e, dgdp_e = _g_derivatives(g, dgdy, dgdp, p)

    if sol_y is None:
        sol_y = solve_ivp(lambda t, y: fun_p(t, y, p), t_span, y0,
                          method=method, atol=atol, rtol=rtol,
                          dense_output=True)
        if not sol_y.success:
            raise RuntimeError(
                "IVP solver not converged in forward solve of y")
    if sol_y.sol is None:
        raise ValueError("sol_y should have a dense output")
    interp = sol_y.sol

    if jac is not None and dfdp is not None:
        jac_e = _embed(jac, tuple(p))
        dfdp_e = _embed(dfdp, tuple(p))

        def fun_bw(t, z):
            mu = z[:Ny]
            y = interp(t)
            dmu = -matmul(jnp.asarray(jac_e(t, y)).T, mu)
            dxi = matmul(jnp.asarray(dfdp_e(t, y)).T, mu)
            return jnp.concatenate([dmu, dxi])
    else:
        def fun_bw(t, z):
            mu = z[:Ny]
            y = interp(t)
            JTmu, DTmu = _vjp_terms(fun_p, t, y, p, mu)
            return jnp.concatenate([-JTmu, DTmu])

    yf = np.asarray(interp(tf))
    zf = np.concatenate([np.asarray(dgdy_e(tf, jnp.asarray(yf))),
                         np.zeros(Np)])
    atol_bw = np.concatenate([np.full(Ny, atol_adj),
                              np.full(Np, atol_quad)])
    sol_bw = solve_ivp(fun_bw, (tf, t0), zf, method=method, atol=atol_bw,
                       rtol=rtol)
    if not sol_bw.success:
        raise RuntimeError(
            "IVP solver not converged in backward solve of lambda")

    mu0 = sol_bw.y[:Ny, -1]
    integral = -sol_bw.y[Ny:, -1]
    sens = (np.asarray(dgdp_e(tf, jnp.asarray(yf)))
            + mu0 @ np.asarray(dy0dp) + integral)
    gf = float(np.asarray(gp(tf, jnp.asarray(yf), p)))
    return AdjointSensitivityOutputEnd(sens, gf, sol_y, sol_bw)


def sens_adjoint_int(fun, t_span, y0, jac=None, dfdp=None, dy0dp=None,
                     p=(), g=None, dgdp=None, dgdy=None, method=None,
                     rtol=1e-3, atol=1e-6, atol_adj=1e-6, atol_quad=1e-6,
                     sol_y=None):
    """dG/dp for G = integral of g over t_span
    (sensitivity.py:390-559)."""
    from .ivp import solve_ivp
    if method is None:
        from .methods import BS5 as method
    y0 = np.atleast_1d(np.asarray(y0, dtype=float))
    p = jnp.atleast_1d(jnp.asarray(p, dtype=float))
    Ny, Np = y0.size, p.size
    if dy0dp is None:
        dy0dp = np.zeros((Ny, Np))
    t0, tf = t_span

    fun_p = lambda t, y, pp: jnp.asarray(fun(t, y, *pp))  # noqa: E731
    gp, dgdy_e, dgdp_e = _g_derivatives(g, dgdy, dgdp, p)

    if sol_y is None:
        sol_y = solve_ivp(lambda t, y: fun_p(t, y, p), t_span, y0,
                          method=method, atol=atol, rtol=rtol,
                          dense_output=True)
        if not sol_y.success:
            raise RuntimeError(
                "IVP solver not converged in forward solve of y")
    if sol_y.sol is None:
        raise ValueError("sol_y should have a dense output")
    interp = sol_y.sol

    def fun_bw(t, z):
        lam = z[:Ny]
        y = interp(t)
        JTlam, DTlam = _vjp_terms(fun_p, t, y, p, lam)
        dlam = -(JTlam + jnp.asarray(dgdy_e(t, y)))
        dxi = DTlam + jnp.asarray(dgdp_e(t, y))
        dzeta = jnp.asarray(gp(t, y, p)).reshape(1)
        return jnp.concatenate([dlam, dxi, dzeta])

    zf = np.zeros(Ny + Np + 1)
    atol_bw = np.concatenate([np.full(Ny, atol_adj),
                              np.full(Np, atol_quad),
                              [np.min(atol_quad)]])
    sol_bw = solve_ivp(fun_bw, (tf, t0), zf, method=method, atol=atol_bw,
                       rtol=rtol)
    if not sol_bw.success:
        raise RuntimeError(
            "IVP solver not converged in backward solve of lambda")

    lam0 = sol_bw.y[:Ny, -1]
    integral = -sol_bw.y[Ny:-1, -1]
    G = -float(sol_bw.y[-1, -1])
    sens = lam0 @ np.asarray(dy0dp) + integral
    return AdjointSensitivityOutputInt(sens, G, sol_y, sol_bw)


# ---------------------------------------------------------------------------
# grad-native device solve: continuous adjoint through jax.grad
# ---------------------------------------------------------------------------

@partial(jax.custom_vjp, nondiff_argnums=(0, 4, 5, 6, 7))
def solve_final(fun, t_span, y0, p, method=None, rtol=1e-6, atol=1e-9,
                max_steps=10_000):
    """y(t_f) as a differentiable function of (t_span, y0, p).

    ``fun(t, y, p)`` with a pytree parameter ``p``.  The backward pass
    integrates the continuous adjoint against the recorded dense output
    — O(1) memory in the number of steps on the tape side, vmappable,
    and usable under jax.grad/jax.value_and_grad.
    """
    from .solve import solve
    out = solve(lambda t, y: fun(t, y, p), t_span, y0, method=method,
                rtol=rtol, atol=atol, max_steps=max_steps)
    return out.y


def _solve_final_fwd(fun, t_span, y0, p, method, rtol, atol, max_steps):
    from .solve import solve
    out = solve(lambda t, y: fun(t, y, p), t_span, y0, method=method,
                rtol=rtol, atol=atol, max_steps=max_steps,
                save_steps=True)
    return out.y, (t_span, y0, p, out)


def _solve_final_bwd(fun, method, rtol, atol, max_steps, residuals, ct):
    from .solve import solve
    t_span, y0, p, fwd = residuals
    t0, tf = t_span
    n = y0.shape[0]

    # device-evaluable interpolant from the recorded segments
    record = fwd.record
    nseg = fwd.nsteps

    def interp(t):
        sgn = jnp.sign(jnp.asarray(tf) - jnp.asarray(t0))
        sgn = jnp.where(sgn == 0, 1.0, sgn)
        grid = jnp.where(jnp.arange(record["t_hi"].shape[0]) < nseg,
                         sgn * record["t_hi"], jnp.inf)
        idx = jnp.clip(jnp.searchsorted(grid, sgn * t, side="left"),
                       0, jnp.maximum(nseg - 1, 0))
        u = (t - record["t_lo"][idx]) / record["h"][idx]
        from .core.interpolate import horner
        return horner(u, record["Q"][idx], record["y_anchor"][idx])

    from jax.flatten_util import ravel_pytree
    p_flat, unravel = ravel_pytree(p)
    Npf = p_flat.shape[0]

    def fun_bw(t, z):
        mu = z[:n]
        y = interp(t)

        def f_of(yy, pf):
            return jnp.asarray(fun(t, yy, unravel(pf)))

        _, pullback = jax.vjp(f_of, y, p_flat)
        JTmu, DTmu = pullback(mu)
        return jnp.concatenate([-JTmu, DTmu])

    zf = jnp.concatenate([jnp.asarray(ct), jnp.zeros(Npf)])
    bw = solve(fun_bw, (tf, t0), zf, method=method, rtol=rtol, atol=atol,
               max_steps=max_steps)
    mu0 = bw.y[:n]
    # dyf/dp = int mu^T df/dp dt; xi accumulates it backward (negated)
    dp = unravel(-bw.y[n:])
    # gradient wrt t_span: d yf/d tf = f(tf, yf); d yf/d t0 = -mu0 . f(t0,y0)
    f_tf = jnp.asarray(fun(tf, fwd.y, p))
    f_t0 = jnp.asarray(fun(t0, y0, p))
    dtf = jnp.vdot(ct, f_tf)
    dt0 = -jnp.vdot(mu0, f_t0)
    return ((dt0, dtf), mu0, dp)


solve_final.defvjp(_solve_final_fwd, _solve_final_bwd)
