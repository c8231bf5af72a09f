"""Explicit Runge-Kutta-Nystrom stepper for 2nd-order ODEs.

State convention matches the reference
(/root/reference/extensisq/common.py:1207-1310): the user state is
``y = [u, v]`` and ``fun(t, y)`` returns ``[v, a]``; only accelerations
are stored in ``K``.  Displacements update with ``h^2 A`` weights,
velocities with ``h Ap``.  Velocity-independent (strict) methods omit
``Ap``.
"""
import jax.numpy as jnp
import numpy as np

from ..core.hstart import h_start
from ..core.interpolate import (quintic_hermite_coefficients,
                                nystrom_coefficients)
from .erk import ERKStepper, ERKState, _weighted_sum
from ..core.numerics import matmul


class RKNStepper(ERKStepper):
    family = "rkn"

    def __init__(self, fun, tableau, n, dtype, sc_params=None, options=None):
        if n % 2:
            raise ValueError(
                "This method is for second order problems and `fun` should"
                " have signature: [v, a] = fun(t, [x, v]).")
        self.m = n // 2
        self.fun_first_order = fun
        super().__init__(fun, tableau, n, dtype, sc_params=sc_params,
                         options=options)
        # acceleration-only RHS (common.py:1276-1279)
        self.afun = lambda t, y: fun(t, y)[self.m:]
        self.Ap = (np.zeros_like(self.A) if tableau.Ap is None
                   else np.asarray(tableau.Ap))
        self.Bp = np.asarray(tableau.Bp)
        E = np.asarray(tableau.E).copy()
        Ep = np.asarray(tableau.Ep).copy()
        if self.options.get("scale_embedded"):
            # damped embedded estimate (murua.py:223-226)
            E = E * 0.75
            Ep = Ep * 0.75
        self.E_u = E
        self.E_v = Ep
        # FSAL from the velocity error tail (common.py:1269-1270)
        self.fsal = bool(Ep[-1] != 0.0)

    def validate_problem(self, fun_np, t0, y0):
        """Host-side structural probe of the 2nd-order form
        (common.py:1248-1267); called by the host driver only."""
        m = self.m
        y0 = np.asarray(y0)
        f0 = np.asarray(fun_np(t0, y0))
        msg = ("This method is for second order problems and `fun` should "
               "have signature: [v, a] = fun(t, [x, v]).")
        if not np.all(y0[m:] == f0[:m]):
            raise AssertionError(msg)
        if np.all(y0[m:] == y0[:m]):
            y_test = y0.copy()
            y_test[m:] = y_test[m:] * (1 + 1e-8) + 1e-8
            if not np.all(np.asarray(fun_np(t0, y_test))[:m]
                          == y_test[m:]):
                raise AssertionError(msg)
        if self.tab.Ap is None:
            y_test = y0.copy()
            y_test[m:] = y_test[m:] * (1 + 1e-8) + 1e-8
            if not np.all(np.asarray(fun_np(t0, y_test))[m:] == f0[m:]):
                raise AssertionError(
                    "This method is for velocity independent ODEs, but "
                    "`fun` seems velocity dependent.")

    # -- construction --------------------------------------------------------

    def init(self, t0, y0, params, first_step=None):
        t0 = jnp.asarray(t0, self.real_dtype)
        y0 = jnp.asarray(y0, self.dtype)
        f_full = self.fun_first_order(t0, y0)
        nfev = 1
        if first_step is None:
            b = t0 + params.direction * jnp.minimum(
                jnp.abs(params.t_bound - t0), params.max_step)
            h_abs = jnp.abs(h_start(
                self.fun_first_order, t0, b, y0, f_full,
                self.tab.order_secondary, params.rtol, params.atol))
            nfev += 1 + min(self.n + 1, 3)
        else:
            h_abs = jnp.asarray(first_step, self.real_dtype)
        k_rows = self.s + 1 if self.carry_stages else 0
        K0 = jnp.zeros((k_rows, self.m), self.dtype)
        a0 = f_full[self.m:]
        z = jnp.asarray(0.0, self.real_dtype)
        i0 = jnp.asarray(0, jnp.int32)
        return ERKState(
            t=t0, y=y0, f=a0, h_abs=h_abs,
            status=jnp.asarray(0, jnp.int32),
            standard_sc=jnp.asarray(True),
            error_norm_old=jnp.asarray(1.0, self.real_dtype),
            h_previous=z, max_factor=jnp.asarray(10.0, self.real_dtype),
            t_old=t0, y_old=y0, f_old=a0, K=K0,
            nfev=jnp.asarray(nfev, jnp.int32),
            nsteps=i0, nfailed=i0, jflstp=i0, okstp=i0, havg=z)

    # -- RKN stage machinery (common.py:1281-1310) ---------------------------

    def _run_stages(self, t, y, h, lo, hi, K_rows):
        m = self.m
        v = y[m:]
        for i in range(lo, hi):
            dt = self.C[i] * h
            du = _weighted_sum(K_rows[:i], self.A[i, :i]) * (h * h) + dt * v
            dv = _weighted_sum(K_rows[:i], self.Ap[i, :i]) * h
            dy = jnp.concatenate([du, dv])
            K_rows.append(self.afun(t + dt, y + dy))
        return hi - lo

    def _solution_error(self, t, y, h, K_rows):
        m = self.m
        v = y[m:]
        du = _weighted_sum(K_rows[:self.s], self.B) * (h * h) + h * v
        dv = _weighted_sum(K_rows[:self.s], self.Bp) * h
        y_new = y + jnp.concatenate([du, dv])
        nfev = 0
        if self.fsal:
            K_rows.append(self.afun(t + h, y_new))
            nfev = 1
        mm = self.s + (1 if self.fsal else 0)
        eu = _weighted_sum(K_rows[:mm], self.E_u[:mm]) * (h * h)
        ev = _weighted_sum(K_rows[:mm], self.E_v[:mm]) * h
        err = jnp.concatenate([eu, ev])
        return y_new, err, nfev

    # non-FSAL endpoint eval must go through afun; reuse step() via fun
    # override: ERKStepper.step calls self.fun for the endpoint
    @property
    def fun(self):
        return self.afun

    @fun.setter
    def fun(self, value):
        # base-class __init__ assigns the full first-order fun here
        self._fun_full = value

    def error_estimate(self, state):
        """Concatenated displacement/velocity error estimate
        (common.py:1304-1310)."""
        h = state.h_previous
        mm = self.s + (1 if self.fsal else 0)
        rows = list(state.K)[:mm]
        eu = _weighted_sum(rows, self.E_u[:mm]) * h * h
        ev = _weighted_sum(rows, self.E_v[:mm]) * h
        return jnp.concatenate([eu, ev])

    # -- dense output --------------------------------------------------------

    def record_coefficients(self, state):
        h = state.h_previous
        if self.tab.P is not None and self.tab.Pp is not None:
            Q = matmul(state.K.T, jnp.asarray(np.asarray(self.tab.P)))
            Qp = matmul(state.K.T, jnp.asarray(np.asarray(self.tab.Pp)))
            return nystrom_coefficients(h, state.y_old, Q, Qp)
        return quintic_hermite_coefficients(
            h, state.y_old, state.y, state.f_old, state.f)

    def dense_segments(self, state, interpolant=None):
        name = interpolant if interpolant is not None else \
            self.options.get("interpolant", None)
        h = state.h_previous
        spec = None
        if self.tab.interpolants:
            spec = self.tab.interpolants.get(name)
        if spec is None:
            if self.tab.P is not None and self.tab.Pp is not None:
                Q = matmul(state.K.T, jnp.asarray(np.asarray(self.tab.P)))
                Qp = matmul(state.K.T, jnp.asarray(np.asarray(self.tab.Pp)))
                Qall = nystrom_coefficients(h, state.y_old, Q, Qp)
                return [(state.t_old, h, state.y_old, Qall)], 0
            # free quintic Hermite (common.py:1528-1578)
            Q = quintic_hermite_coefficients(
                h, state.y_old, state.y, state.f_old, state.f)
            return [(state.t_old, h, state.y_old, Q)], 0

        # extra-stage interpolants (fine.py:381-414, murua.py:228-246)
        C_extra = np.atleast_1d(np.asarray(spec["C_extra"]))
        A_extra = np.atleast_2d(np.asarray(spec["A_extra"]))
        Ap_extra = np.atleast_2d(np.asarray(spec["Ap_extra"]))
        P = np.asarray(spec["P"])
        Pp = np.asarray(spec["Pp"])
        m = self.m
        t_old, y_old = state.t_old, state.y_old
        v_old = y_old[m:]
        rows = list(state.K)
        nfev = 0
        for j, cx in enumerate(C_extra):
            sx = self.s + 1 + j
            dt = cx * h
            du = _weighted_sum(rows[:sx], A_extra[j, :sx]) * (h * h) \
                + dt * v_old
            dv = _weighted_sum(rows[:sx], Ap_extra[j, :sx]) * h
            dy = jnp.concatenate([du, dv])
            rows.append(self.afun(t_old + dt, y_old + dy))
            nfev += 1
        K_ext = jnp.stack(rows)
        Q = matmul(K_ext.T, jnp.asarray(P))
        Qp = matmul(K_ext.T, jnp.asarray(Pp))
        Qall = nystrom_coefficients(h, y_old, Q, Qp)
        return [(t_old, h, y_old, Qall)], nfev
