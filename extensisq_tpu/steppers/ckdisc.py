"""CKdisc: Cash-Karp variable-order (5/3/2) stepper for non-smooth
problems.

Rewrite of /root/reference/extensisq/cash.py:253-416.  The method
anticipates failure: staged error assessments E1/E2 after stages 2/4
veto the remaining work, and fallback solutions of reduced order
propagate to an internal point (c = 1/5 or 3/5) without extra RHS
evaluations.  The adaptive ``twiddle``/``quit`` factors are state
fields.  Stiffness detection and the second-order controller are
disabled by design (cash.py:246-248).
"""
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .._config import RUNNING, FINISHED, TOO_SMALL_STEP, OVERFLOW
from ..core.hstart import h_start
from ..core.numerics import (calculate_scale, norm, dtype_constants,
                             matmul)
from .erk import _weighted_sum

SAFETY = 0.9
MAX_FACTOR_CK = 5.0
MIN_FACTOR_CK = 0.2


class CKState(NamedTuple):
    t: Any
    y: Any
    f: Any
    h_abs: Any
    status: Any
    twiddle: Any           # (2,)
    quit_f: Any            # (2,)
    order_accepted: Any    # error order of last accepted step (4, 2, 1)
    h_previous: Any
    t_old: Any
    y_old: Any
    f_old: Any
    K: Any                 # (7, n)
    nfev: Any
    nsteps: Any
    nfailed: Any


class _CKCarry(NamedTuple):
    h_abs: Any
    rejected: Any
    order: Any          # 0 = not accepted yet
    status: Any
    twiddle: Any
    quit_f: Any
    y_new: Any
    h_used: Any
    K: Any
    nfev: Any
    nfailed: Any


class CKdiscStepper:
    family = "ckdisc"

    def __init__(self, fun, tableau, n, dtype, options=None):
        self.fun = fun
        self.tab = tableau
        self.n = n
        self.dtype = np.dtype(dtype)
        self.real_dtype = np.finfo(self.dtype).dtype
        consts = dtype_constants(self.real_dtype)
        cdiff = tableau.c_spacing()
        self.h_min_a = 10.0 * consts["epsneg"] / cdiff
        self.h_min_b = consts["sqrt_tiny"]
        # tables in real_dtype so f32 states do not silently promote
        # (a no-op for the f64 conformance path)
        rd = self.real_dtype
        self.A = np.asarray(tableau.A, rd)
        self.B = np.asarray(tableau.B, rd)
        self.C = np.asarray(tableau.C, rd)
        self.E = np.asarray(tableau.E, rd)
        self.s = tableau.n_stages
        opts = dict(options or {})
        data = opts.pop("ckdisc")
        self.B_assess = np.asarray(data["B_assess"], rd)
        self.E_assess = np.asarray(data["E_assess"], rd)
        self.C_fallback = np.asarray(data["C_fallback"], rd)
        self.B_fallback = np.asarray(data["B_fallback"], rd)
        self.E_fallback = np.asarray(data["E_fallback"], rd)
        self.options = opts

    def init(self, t0, y0, params, first_step=None):
        t0 = jnp.asarray(t0, self.real_dtype)
        y0 = jnp.asarray(y0, self.dtype)
        f0 = self.fun(t0, y0)
        nfev = 1
        if first_step is None:
            b = t0 + params.direction * jnp.minimum(
                jnp.abs(params.t_bound - t0), params.max_step)
            h_abs = jnp.abs(h_start(
                self.fun, t0, b, y0, f0, self.tab.order_secondary,
                params.rtol, params.atol))
            nfev += 1 + min(self.n + 1, 3)
        else:
            h_abs = jnp.asarray(first_step, self.real_dtype)
        z = jnp.asarray(0.0, self.real_dtype)
        i0 = jnp.asarray(0, jnp.int32)
        return CKState(
            t=t0, y=y0, f=f0, h_abs=h_abs,
            status=jnp.asarray(RUNNING, jnp.int32),
            twiddle=jnp.asarray([1.5, 1.1], self.real_dtype),
            quit_f=jnp.asarray([100.0, 100.0], self.real_dtype),
            order_accepted=jnp.asarray(4, jnp.int32),
            h_previous=z,
            t_old=t0, y_old=y0, f_old=f0,
            K=jnp.zeros((self.s + 1, self.n), self.dtype),
            nfev=jnp.asarray(nfev, jnp.int32),
            nsteps=i0, nfailed=i0)

    def _sol_err_tol(self, params, y, h, rows, B, E, i):
        sol = y + h * _weighted_sum(rows[:i], B[:i])
        err = h * _weighted_sum(rows[:i], E[:i])
        tol = calculate_scale(params.atol, params.rtol, y, sol)
        return sol, err, tol

    def reassess_stepsize(self, params, t, h_abs):
        min_step = jnp.maximum(self.h_min_a * (jnp.abs(t) + h_abs),
                               self.h_min_b)
        h_abs = jnp.minimum(params.max_step, jnp.maximum(min_step, h_abs))
        d = jnp.abs(params.t_bound - t)
        split = (d < 2.0 * h_abs) & (d > h_abs)
        h_abs = jnp.where(split, jnp.maximum(0.5 * d, min_step),
                          jnp.where(d <= h_abs, d, h_abs))
        # t_bound/max_step are strong f64; keep the carried step size
        # in the state dtype (no-op for f64 solves)
        return (jnp.asarray(h_abs, self.real_dtype),
                jnp.asarray(min_step, self.real_dtype))

    def _attempt(self, params, t, y, f, c):
        """One E1/E2/E4 cascade attempt (cash.py:253-394); shared by
        step and step_flat."""
        # params.direction is strong f64; keep h in the state's real
        # dtype so f32 solves don't promote mid-cascade (cond branches
        # must agree on E2/E4 dtypes)
        h = jnp.asarray(c.h_abs * params.direction, self.real_dtype)
        rows = [f]
        nfev = c.nfev

        # stages 0-1, first-order error E1 (cash.py:271-279)
        for i in range(1, 2):
            dy = h * _weighted_sum(rows[:i], self.A[i, :i])
            rows.append(self.fun(t + self.C[i] * h, y + dy))
            nfev += 1
        _, err1, tol1 = self._sol_err_tol(params, y, h, rows,
                                          self.B_assess[0],
                                          self.E_assess[0], 2)
        E1 = norm(err1 / tol1) ** 0.5
        go2 = E1 < c.twiddle[0] * c.quit_f[0]

        def after1(_):
            rows2 = list(rows)
            ev = 0
            for i in range(2, 4):
                dy = h * _weighted_sum(rows2[:i], self.A[i, :i])
                rows2.append(self.fun(t + self.C[i] * h, y + dy))
                ev += 1
            _, err2, tol2 = self._sol_err_tol(params, y, h, rows2,
                                              self.B_assess[1],
                                              self.E_assess[1], 4)
            E2 = norm(err2 / tol2) ** (1.0 / 3.0)
            return jnp.stack(rows2), E2, jnp.asarray(ev, jnp.int32)

        def skip1(_):
            rows2 = rows + [jnp.zeros_like(f)] * 2
            return (jnp.stack(rows2), jnp.asarray(jnp.inf,
                                                  self.real_dtype),
                    jnp.asarray(0, jnp.int32))

        K4, E2, ev = jax.lax.cond(go2, after1, skip1, operand=None)
        nfev += ev
        go4 = go2 & (E2 < c.twiddle[1] * c.quit_f[1])

        def after2(_):
            rows4 = list(K4)
            ev = 0
            for i in range(4, 6):
                dy = h * _weighted_sum(rows4[:i], self.A[i, :i])
                rows4.append(self.fun(t + self.C[i] * h, y + dy))
                ev += 1
            y5, err, tol = self._sol_err_tol(params, y, h, rows4,
                                             self.B, self.E[:6], 6)
            E4 = norm(err / tol) ** 0.2
            E4 = jnp.where(E4 == 0.0, 1e-160, E4)
            return (jnp.stack(rows4), y5, E4,
                    jnp.asarray(ev, jnp.int32))

        def skip2(_):
            rows4 = list(K4) + [jnp.zeros_like(f)] * 2
            return (jnp.stack(rows4), y,
                    jnp.asarray(jnp.inf, self.real_dtype),
                    jnp.asarray(0, jnp.int32))

        K6, y5, E4, ev = jax.lax.cond(go4, after2, skip2, operand=None)
        nfev += ev
        rows6 = list(K6)
        # pad to (s+1, n): the last row is the endpoint derivative,
        # set after acceptance
        K6 = jnp.concatenate([K6, jnp.zeros((1,) + f.shape,
                                            K6.dtype)])

        accept4 = go4 & (E4 < 1.0)
        # the inf sentinel from the skipped branch has go4 == False,
        # so a genuine overflow is exactly go4 & non-finite E4
        bad = go4 & (jnp.isnan(E4) | jnp.isinf(E4))

        # twiddle update when the 5th-order solution was rejected
        # (cash.py:330-335)
        EQ1 = E1 / c.quit_f[0]
        EQ2 = E2 / c.quit_f[1]
        tw = c.twiddle
        tw_new = jnp.stack([
            jnp.where(EQ1 < tw[0], jnp.maximum(1.1, EQ1), tw[0]),
            jnp.where(EQ2 < tw[1], jnp.maximum(1.1, EQ2), tw[1])])
        twiddle = jnp.where(go4 & ~accept4, tw_new, c.twiddle)

        # quit-factor update on acceptance (cash.py:316-322)
        q1 = E1 / jnp.maximum(E4, 1e-300)
        q2 = E2 / jnp.maximum(E4, 1e-300)
        q = jnp.stack([q1, q2])
        qf = c.quit_f
        q_adj = jnp.where(q > qf, jnp.minimum(q, 10.0 * qf),
                          jnp.maximum(q, 2.0 / 3.0 * qf))
        quit_new = jnp.clip(q_adj, 1.0, 10000.0)
        quit_f = jnp.where(accept4, quit_new, c.quit_f)

        # third-order fallback (cash.py:337-348)
        fb3_try = go4 & ~accept4 & (E2 < 1.0) & ~bad
        y3, err3, tol3 = self._sol_err_tol(params, y, h, rows6,
                                           self.B_fallback[1],
                                           self.E_fallback[1], 4)
        fb3_ok = fb3_try & (norm(err3 / tol3) < 1.0)

        # second-order fallback (cash.py:350-368)
        fb2_try = go2 & ~accept4 & ~fb3_ok & (E1 < 1.0) & ~bad
        y2, err2f, tol2f = self._sol_err_tol(params, y, h, rows6,
                                             self.B_fallback[0],
                                             self.E_fallback[0], 2)
        fb2_ok = fb2_try & (norm(err2f / tol2f) < 1.0)
        fb2_failed = fb2_try & ~fb2_ok

        accepted = accept4 | fb3_ok | fb2_ok
        order = jnp.where(accept4, 4, jnp.where(fb3_ok, 2, 1))

        # step-size update (cash.py:310-313, 346-347, 359-372)
        esttol = jnp.where(go4, E4,
                           jnp.where(go2, E2 / c.quit_f[1],
                                     E1 / c.quit_f[0]))
        factor_acc4 = jnp.minimum(MAX_FACTOR_CK,
                                  SAFETY / jnp.maximum(E4, 1e-300))
        factor_acc4 = jnp.where(c.rejected,
                                jnp.minimum(1.0, factor_acc4),
                                factor_acc4)
        h_new_abs = jnp.where(
            accept4, c.h_abs * factor_acc4,
            jnp.where(fb3_ok, c.h_abs * self.C_fallback[1],
                      jnp.where(fb2_ok | fb2_failed,
                                c.h_abs * self.C_fallback[0],
                                c.h_abs * jnp.maximum(
                                    MIN_FACTOR_CK,
                                    SAFETY / jnp.maximum(esttol,
                                                         1e-300)))))
        # fallback acceptance shortens THIS step too: the fallback
        # weights sum to C_fallback, so the solution lives at
        # t + C_fallback*h
        h_used = jnp.where(
            accept4, h,
            jnp.where(fb3_ok, h * self.C_fallback[1],
                      h * self.C_fallback[0]))
        y_new = jnp.where(accept4, y5, jnp.where(fb3_ok, y3, y2))
        status = jnp.where(bad, jnp.asarray(OVERFLOW, jnp.int32),
                           c.status)
        return _CKCarry(
            h_abs=h_new_abs,
            rejected=c.rejected | ~accepted,
            order=jnp.where(accepted, order, c.order),
            status=status,
            twiddle=twiddle, quit_f=quit_f,
            y_new=jnp.where(accepted, y_new, c.y_new),
            h_used=jnp.where(accepted, h_used, c.h_used),
            K=jnp.where(accepted, K6, c.K),
            nfev=nfev,
            nfailed=c.nfailed + jnp.where(accepted, 0, 1))

    def step(self, params, state):
        t, y, f = state.t, state.y, state.f
        h_abs, min_step = self.reassess_stepsize(params, t, state.h_abs)

        def attempt(c):
            return self._attempt(params, t, y, f, c)

        def cond_fn(c):
            return (c.order == 0) & (c.status == RUNNING)

        def body_fn(c):
            c = c._replace(status=jnp.where(
                c.h_abs < min_step,
                jnp.asarray(TOO_SMALL_STEP, jnp.int32), c.status))
            return jax.lax.cond(cond_fn(c), attempt, lambda x: x, c)

        c0 = _CKCarry(
            h_abs=h_abs, rejected=jnp.asarray(False),
            order=jnp.asarray(0, jnp.int32), status=state.status,
            twiddle=state.twiddle, quit_f=state.quit_f,
            y_new=y, h_used=jnp.zeros_like(state.h_previous),
            K=jnp.zeros_like(state.K),
            nfev=state.nfev, nfailed=state.nfailed)
        c = jax.lax.while_loop(cond_fn, body_fn, c0)
        ok = c.order > 0

        d = jnp.abs(params.t_bound - t)
        is_last = ok & (jnp.abs(c.h_used) >= d)
        t_new = jnp.asarray(
            jnp.where(is_last, params.t_bound, t + c.h_used),
            self.real_dtype)

        # endpoint derivative for the next step / interpolation
        f_new = jax.lax.cond(
            ok, lambda _: self.fun(t_new, c.y_new), lambda _: f,
            operand=None)
        K_final = c.K.at[self.s].set(f_new)
        nfev = c.nfev + jnp.where(ok, 1, 0)

        status = jnp.where((c.status == RUNNING) & is_last,
                           jnp.asarray(FINISHED, jnp.int32), c.status)
        return CKState(
            t=jnp.where(ok, t_new, state.t),
            y=jnp.where(ok, c.y_new, state.y),
            f=jnp.where(ok, f_new, state.f),
            h_abs=jnp.where(ok, c.h_abs, state.h_abs),
            status=status,
            twiddle=c.twiddle, quit_f=c.quit_f,
            order_accepted=jnp.where(ok, c.order, state.order_accepted),
            h_previous=jnp.where(ok, c.h_used, state.h_previous),
            t_old=jnp.where(ok, t, state.t_old),
            y_old=jnp.where(ok, y, state.y_old),
            f_old=jnp.where(ok, f, state.f_old),
            K=jnp.where(ok, K_final, state.K),
            nfev=nfev,
            nsteps=state.nsteps + jnp.where(ok, 1, 0),
            nfailed=c.nfailed)

    # -- flat (attempt-level) stepping for the device driver -------------------

    def flat_init_aux(self, state):
        """(fresh_step, min_step, rejected_this_step)."""
        z = jnp.asarray(0.0, self.real_dtype)
        return (jnp.asarray(True), z, jnp.asarray(False))

    def step_flat(self, params, state, aux):
        """Exactly ONE cascade attempt; state advances when accepted
        (at 5th, 3rd or 2nd order).  Semantically equivalent to
        :meth:`step`'s nested loop: reassess_stepsize runs only on a
        fresh step, and the twiddle/quit factors and reduced h of a
        rejected attempt persist through the state."""
        fresh, min_step_c, rejected = aux
        t, y, f = state.t, state.y, state.f
        h_abs_r, min_step_r = self.reassess_stepsize(params, t,
                                                     state.h_abs)
        h_abs = jnp.where(fresh, h_abs_r, state.h_abs)
        min_step = jnp.where(fresh, min_step_r, min_step_c)

        status0 = jnp.where((h_abs < min_step)
                            & (state.status == RUNNING),
                            jnp.asarray(TOO_SMALL_STEP, jnp.int32),
                            state.status)
        c0 = _CKCarry(
            h_abs=h_abs, rejected=rejected,
            order=jnp.asarray(0, jnp.int32), status=status0,
            twiddle=state.twiddle, quit_f=state.quit_f,
            y_new=y, h_used=jnp.zeros_like(state.h_previous),
            K=jnp.zeros_like(state.K),
            nfev=state.nfev, nfailed=state.nfailed)
        c = jax.lax.cond(
            status0 == RUNNING,
            lambda cc: self._attempt(params, t, y, f, cc),
            lambda cc: cc, c0)
        ok = c.order > 0

        d = jnp.abs(params.t_bound - t)
        is_last = ok & (jnp.abs(c.h_used) >= d)
        t_new = jnp.asarray(
            jnp.where(is_last, params.t_bound, t + c.h_used),
            self.real_dtype)

        f_new = jax.lax.cond(
            ok, lambda _: self.fun(t_new, c.y_new), lambda _: f,
            operand=None)
        K_final = c.K.at[self.s].set(f_new)
        nfev = c.nfev + jnp.where(ok, 1, 0)

        status = jnp.where((c.status == RUNNING) & is_last,
                           jnp.asarray(FINISHED, jnp.int32), c.status)
        new_state = CKState(
            t=jnp.where(ok, t_new, state.t),
            y=jnp.where(ok, c.y_new, state.y),
            f=jnp.where(ok, f_new, state.f),
            h_abs=c.h_abs,
            status=status,
            twiddle=c.twiddle, quit_f=c.quit_f,
            order_accepted=jnp.where(ok, c.order,
                                     state.order_accepted),
            h_previous=jnp.where(ok, c.h_used, state.h_previous),
            t_old=jnp.where(ok, t, state.t_old),
            y_old=jnp.where(ok, y, state.y_old),
            f_old=jnp.where(ok, f, state.f_old),
            K=jnp.where(ok, K_final, state.K),
            nfev=nfev,
            nsteps=state.nsteps + jnp.where(ok, 1, 0),
            nfailed=c.nfailed)
        aux_new = (ok | (status != RUNNING), min_step,
                   c.rejected & ~ok)
        return new_state, aux_new, ok

    # -- dense output ----------------------------------------------------------

    def record_coefficients(self, state):
        """Order-aware free interpolant (cash.py:408-416): 4th-order P
        polynomial for 5th-order steps, cubic Hermite otherwise —
        selected per state with jnp.where (vmap-safe)."""
        from ..core.interpolate import hermite_cubic_coefficients
        h = state.h_previous
        P = np.asarray(self.tab.P)
        Qp = matmul(state.K.T, jnp.asarray(P)) * h
        Qc = hermite_cubic_coefficients(h, state.y_old, state.y,
                                        state.K[0], state.K[self.s])
        Qc = jnp.pad(Qc, ((0, 0), (0, Qp.shape[1] - Qc.shape[1])))
        return jnp.where(state.order_accepted == 4, Qp, Qc)

    def dense_segments(self, state, interpolant=None):
        return [(state.t_old, state.h_previous, state.y_old,
                 self.record_coefficients(state))], 0
