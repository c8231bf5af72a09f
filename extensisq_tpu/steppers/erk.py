"""Explicit embedded Runge-Kutta stepper, jit/vmap-native.

Device-first redesign of the reference's ``RungeKutta._step_impl``
(/root/reference/extensisq/common.py:222-368) and the two-phase variants
(bogacki.py:238-346, calvo.py:152-261):

* solver state is an explicit pytree (:class:`ERKState`); ``step`` is a
  pure function ``(params, state) -> state``;
* the accept/reject loop is a bounded ``lax.while_loop`` whose body is
  one step attempt; stage loops unroll at trace time (stage counts are
  static), with zero tableau entries skipped statically;
* all branching (controller mode, pre-error rejection, overflow/abort)
  is ``jnp.where``/``lax.cond`` so the whole trajectory can live inside
  one XLA program and be vmapped over ensembles;
* counters (nfev, failed steps, ...) are state fields, not globals —
  fixing the reference's non-reentrant global counters (SURVEY.md 5.2).
"""
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .._config import RUNNING, FINISHED, TOO_SMALL_STEP, OVERFLOW
from ..core.controller import (resolve_controller, erk_accept_update,
                               reject_factor)
from ..core.hstart import h_start
from ..core.numerics import calculate_scale, norm, dtype_constants, matmul


class ERKState(NamedTuple):
    t: Any
    y: Any
    f: Any                   # derivative at (t, y)
    h_abs: Any
    status: Any              # int32 status code
    # controller state
    standard_sc: Any         # bool: use first-order controller next
    error_norm_old: Any
    h_previous: Any          # signed accepted step
    max_factor: Any
    # last accepted step (for dense output / events)
    t_old: Any
    y_old: Any
    f_old: Any
    K: Any                   # (n_stages+1, n) stages of last accepted step
    # counters
    nfev: Any
    nsteps: Any
    nfailed: Any
    jflstp: Any              # failed steps since last stiffness check
    okstp: Any               # accepted steps (stiffness bookkeeping)
    havg: Any                # exponentially averaged step size


class _Carry(NamedTuple):
    h_abs: Any
    h_used: Any              # signed h of the accepted attempt
    accepted: Any
    rejected: Any            # some rejection happened within this step
    status: Any
    standard_sc: Any
    max_factor: Any
    y_new: Any
    f_new: Any               # FSAL derivative at the accepted endpoint
    error_norm: Any
    K: Any
    nfev: Any
    nfailed: Any
    jflstp: Any


def _weighted_sum(K_rows, weights):
    """sum_j w_j * K_j with zero weights skipped at trace time."""
    acc = None
    for w, k in zip(weights, K_rows):
        if w == 0.0:
            continue
        term = w * k
        acc = term if acc is None else acc + term
    if acc is None:
        return jnp.zeros_like(K_rows[0])
    return acc


class ERKStepper:
    """init/step functions for one (fun, tableau, options) combination."""

    family = "erk"

    def __init__(self, fun, tableau, n, dtype, sc_params=None, options=None):
        self.fun = fun
        self.tab = tableau
        self.n = n
        self.dtype = np.dtype(dtype)
        self.real_dtype = np.finfo(self.dtype).dtype
        consts = dtype_constants(self.real_dtype)
        cdiff = tableau.c_spacing()
        self.h_min_a = 10.0 * consts["epsneg"] / cdiff
        self.h_min_b = consts["sqrt_tiny"]
        self.tiny_err = self.h_min_b
        err_order = min(tableau.order_secondary, tableau.order)
        self.error_exponent = -1.0 / (err_order + 1)
        self.cc = resolve_controller(sc_params, tableau.sc_params,
                                     self.error_exponent)
        # tables in real_dtype so float32 states do not promote to
        # float64 (a no-op for float64 solves)
        rd = self.real_dtype
        self.A = np.asarray(tableau.A, rd)
        self.B = np.asarray(tableau.B, rd)
        self.C = np.asarray(tableau.C, rd)
        self.E = np.asarray(tableau.E, rd)
        # two-phase error test (BS5, CFMR7osc); RKN tableaux have none
        E_pre = getattr(tableau, "E_pre", None)
        self.E_pre = None if E_pre is None else np.asarray(E_pre, rd)
        self.B_pre = (None if E_pre is None
                      else np.asarray(tableau.B_pre, rd))
        self.fsal = tableau.fsal
        self.s = tableau.n_stages
        self.options = dict(options or {})
        # large-n solves that need no dense output can skip carrying
        # the (s+1, n) stage array through the loop state
        self.carry_stages = bool(self.options.pop("carry_stages", True))

    # -- construction ------------------------------------------------------

    def init(self, t0, y0, params, first_step=None):
        """Initial state; 1 RHS eval + h_start (unless first_step given);
        mirrors RungeKutta.__init__ (common.py:187-220)."""
        t0 = jnp.asarray(t0, self.real_dtype)
        y0 = jnp.asarray(y0, self.dtype)
        f0 = self.fun(t0, y0)
        nfev = 1
        if first_step is None:
            b = t0 + params.direction * jnp.minimum(
                jnp.abs(params.t_bound - t0), params.max_step)
            h_abs = jnp.abs(h_start(
                self.fun, t0, b, y0, f0, self.tab.order_secondary,
                params.rtol, params.atol)).astype(self.real_dtype)
            nfev += 1 + min(self.n + 1, 3)
        else:
            h_abs = jnp.asarray(first_step, self.real_dtype)
        k_rows = self.s + 1 if self.carry_stages else 0
        K0 = jnp.zeros((k_rows, self.n), self.dtype)
        z = jnp.asarray(0.0, self.real_dtype)
        i0 = jnp.asarray(0, jnp.int32)
        return ERKState(
            t=t0, y=y0, f=f0, h_abs=h_abs,
            status=jnp.asarray(RUNNING, jnp.int32),
            standard_sc=jnp.asarray(True),
            error_norm_old=jnp.asarray(1.0, self.real_dtype),
            h_previous=z, max_factor=jnp.asarray(10.0, self.real_dtype),
            t_old=t0, y_old=y0, f_old=f0, K=K0,
            nfev=jnp.asarray(nfev, jnp.int32),
            nsteps=i0, nfailed=i0, jflstp=i0, okstp=i0, havg=z)

    # -- stage machinery -----------------------------------------------------

    def _run_stages(self, t, y, h, lo, hi, K_rows):
        """Evaluate stages lo..hi-1, appending to K_rows."""
        for i in range(lo, hi):
            dy = h * _weighted_sum(K_rows[:i], self.A[i, :i])
            K_rows.append(self.fun(t + self.C[i] * h, y + dy))
        return hi - lo

    def _solution_error(self, t, y, h, K_rows):
        """y_new, optional FSAL eval, raw error vector
        (common.py:333-351)."""
        y_new = y + h * _weighted_sum(K_rows[:self.s], self.B)
        nfev = 0
        if self.fsal:
            K_rows.append(self.fun(t + h, y_new))
            nfev = 1
        m = self.s + (1 if self.fsal else 0)
        err = h * _weighted_sum(K_rows[:m], self.E[:m])
        return y_new, err, nfev

    def reassess_stepsize(self, params, t, h_abs, standard_sc):
        """Step-size limits + end-of-interval look-ahead split
        (common.py:310-331)."""
        min_step = jnp.maximum(self.h_min_a * (jnp.abs(t) + h_abs),
                               self.h_min_b)
        out_of_range = (h_abs < min_step) | (h_abs > params.max_step)
        h_abs = jnp.minimum(params.max_step, jnp.maximum(min_step, h_abs))
        standard_sc = standard_sc | out_of_range

        d = jnp.abs(params.t_bound - t)
        split = (d < 2.0 * h_abs) & (d > h_abs)
        h_abs = jnp.where(split, jnp.maximum(0.5 * d, min_step),
                          jnp.where(d <= h_abs, d, h_abs))
        standard_sc = standard_sc | split
        # t_bound/max_step are strong float64: keep the carried step
        # size in the state's real dtype
        return (h_abs.astype(self.real_dtype),
                min_step.astype(self.real_dtype), standard_sc)

    # -- one attempt ---------------------------------------------------------

    def _attempt(self, params, t, y, f, state, c):
        rd = self.real_dtype
        params = params._replace(rtol=jnp.asarray(params.rtol, rd),
                                 atol=jnp.asarray(params.atol, rd))
        h = c.h_abs * jnp.asarray(params.direction, rd)
        zero_y = jnp.zeros_like(f)
        K_shape = (self.s + 1,) + f.shape
        nfev = c.nfev

        if self.E_pre is not None:
            npre = self.tab.n_pre
            K_rows = [f]
            nfev += self._run_stages(t, y, h, 1, npre, K_rows)
            # pre-error check with premature solution as scale weight
            # (bogacki.py:340-346, calvo.py:255-261)
            y_pre = y + h * _weighted_sum(K_rows[:npre], self.B_pre)
            scale_pre = calculate_scale(params.atol, params.rtol, y, y_pre)
            err_pre = h * _weighted_sum(K_rows[:npre], self.E_pre)
            pre_norm = norm(err_pre / scale_pre)
            pre_ok = ~(pre_norm > 1.0)
            K_part = jnp.stack(K_rows)

            def finish(_):
                rows = list(K_part)
                ev = self._run_stages(t, y, h, npre, self.s, rows)
                y_new, err, ev2 = self._solution_error(t, y, h, rows)
                f_last = rows[-1] if self.fsal else zero_y
                while len(rows) < self.s + 1:
                    rows.append(zero_y)
                scale = calculate_scale(params.atol, params.rtol, y, y_new)
                err_norm = norm(err / scale)
                Kf = jnp.stack(rows) if self.carry_stages \
                    else jnp.zeros((0,) + f.shape, self.dtype)
                return (Kf, y_new, f_last, err_norm,
                        jnp.asarray(ev + ev2, jnp.int32))

            def skip(_):
                if self.carry_stages:
                    Kf = jnp.zeros(K_shape, self.dtype)
                    Kf = jax.lax.dynamic_update_slice(Kf, K_part, (0, 0))
                else:
                    Kf = jnp.zeros((0,) + f.shape, self.dtype)
                return (Kf, y, zero_y,
                        jnp.asarray(jnp.inf, self.real_dtype),
                        jnp.asarray(0, jnp.int32))

            K_full, y_new, f_last, error_norm, ev = jax.lax.cond(
                pre_ok, finish, skip, operand=None)
            nfev = nfev + ev
            err_for_reject = jnp.where(pre_ok, error_norm, pre_norm)
            accepted = pre_ok & (error_norm < 1.0)
            bad = pre_ok & (jnp.isnan(error_norm) | jnp.isinf(error_norm))
        else:
            K_rows = [f]
            nfev += self._run_stages(t, y, h, 1, self.s, K_rows)
            y_new, err, ev2 = self._solution_error(t, y, h, K_rows)
            nfev += ev2
            f_last = K_rows[-1] if self.fsal else zero_y
            while len(K_rows) < self.s + 1:
                K_rows.append(zero_y)
            K_full = (jnp.stack(K_rows) if self.carry_stages
                      else jnp.zeros((0,) + f.shape, self.dtype))
            scale = calculate_scale(params.atol, params.rtol, y, y_new)
            error_norm = norm(err / scale)
            err_for_reject = error_norm
            accepted = error_norm < 1.0
            bad = jnp.isnan(error_norm) | jnp.isinf(error_norm)

        # controller: accepted branch (common.py:249-277)
        h_ratio = h / jnp.where(state.h_previous == 0.0, h,
                                state.h_previous)
        factor_acc, sc_acc, mf_acc = erk_accept_update(
            self.cc, self.tiny_err, error_norm, state.error_norm_old,
            h_ratio, c.rejected, c.standard_sc, c.max_factor)
        # rejected branch (common.py:278-287)
        factor_rej = reject_factor(self.cc, err_for_reject)

        h_abs_new = c.h_abs * jnp.where(accepted, factor_acc, factor_rej)
        status = jnp.where(bad & ~accepted,
                           jnp.asarray(OVERFLOW, jnp.int32), c.status)
        one = jnp.asarray(1, jnp.int32)
        zero = jnp.asarray(0, jnp.int32)
        return _Carry(
            h_abs=h_abs_new,
            h_used=jnp.where(accepted, h, c.h_used),
            accepted=accepted,
            rejected=c.rejected | ~accepted,
            status=status,
            standard_sc=jnp.where(accepted, sc_acc, c.standard_sc),
            max_factor=jnp.where(accepted, mf_acc, c.max_factor),
            y_new=jnp.where(accepted, y_new, c.y_new),
            f_new=jnp.where(accepted, f_last, c.f_new),
            error_norm=jnp.where(accepted, error_norm, c.error_norm),
            K=jnp.where(accepted, K_full, c.K),
            nfev=nfev,
            nfailed=c.nfailed + jnp.where(accepted, zero, one),
            jflstp=c.jflstp + jnp.where(accepted, zero, one),
        )

    # -- one step ------------------------------------------------------------

    def step(self, params, state):
        """Advance by one accepted step, or set a terminal failure
        status; pure and jittable."""
        t, y, f = state.t, state.y, state.f
        h_abs, min_step, standard_sc = self.reassess_stepsize(
            params, t, state.h_abs, state.standard_sc)

        def cond_fn(c):
            return (~c.accepted) & (c.status == RUNNING)

        def body_fn(c):
            too_small = c.h_abs < min_step
            c = c._replace(status=jnp.where(
                too_small, jnp.asarray(TOO_SMALL_STEP, jnp.int32),
                c.status))
            return jax.lax.cond(
                cond_fn(c), lambda cc: self._attempt(params, t, y, f,
                                                     state, cc),
                lambda cc: cc, c)

        c0 = _Carry(
            h_abs=h_abs,
            h_used=jnp.zeros_like(state.h_previous),
            accepted=jnp.asarray(False),
            rejected=jnp.asarray(False),
            status=state.status,
            standard_sc=standard_sc,
            max_factor=state.max_factor,
            y_new=y,
            f_new=jnp.zeros_like(f),
            error_norm=state.error_norm_old,
            K=jnp.zeros_like(state.K),
            nfev=state.nfev,
            nfailed=state.nfailed,
            jflstp=state.jflstp,
        )
        c = jax.lax.while_loop(cond_fn, body_fn, c0)
        ok = c.accepted

        # exact endpoint landing: reassess clamps h_abs <= |t_bound - t|,
        # with equality only on the final step
        d = jnp.abs(params.t_bound - t)
        is_last = ok & (jnp.abs(c.h_used) >= d)
        t_new = jnp.where(is_last, jnp.asarray(params.t_bound, t.dtype),
                          t + c.h_used)

        # non-FSAL endpoint evaluation for interpolation and next step
        # (common.py:289-291)
        if self.fsal:
            K_final = c.K
            f_new = c.f_new
            nfev = c.nfev
        else:
            f_new = jax.lax.cond(
                ok, lambda _: self.fun(t_new, c.y_new),
                lambda _: f, operand=None)
            K_final = (c.K.at[self.s].set(f_new) if self.carry_stages
                       else c.K)
            nfev = c.nfev + jnp.where(ok, 1, 0)

        status = jnp.where(
            (c.status == RUNNING) & is_last,
            jnp.asarray(FINISHED, jnp.int32), c.status)

        # stiffness bookkeeping (common.py:384-393); diagnosis is host-side
        okstp = state.okstp + jnp.where(ok, 1, 0)
        havg = jnp.where(ok, 0.9 * state.havg + 0.1 * c.h_used, state.havg)
        reset = ok & (okstp == 20)
        havg = jnp.where(reset, c.h_used, havg)
        jflstp = jnp.where(reset, 0, c.jflstp)
        # 40-step window reset handled by the host-side diagnosis

        return ERKState(
            t=jnp.where(ok, t_new, state.t),
            y=jnp.where(ok, c.y_new, state.y),
            f=jnp.where(ok, f_new, state.f),
            h_abs=jnp.where(ok, c.h_abs, state.h_abs),
            status=status,
            standard_sc=jnp.where(ok, c.standard_sc, state.standard_sc),
            error_norm_old=jnp.where(ok, c.error_norm,
                                     state.error_norm_old),
            h_previous=jnp.where(ok, c.h_used, state.h_previous),
            max_factor=jnp.where(ok, c.max_factor, state.max_factor),
            t_old=jnp.where(ok, t, state.t_old),
            y_old=jnp.where(ok, y, state.y_old),
            f_old=jnp.where(ok, f, state.f_old),
            K=jnp.where(ok, K_final, state.K),
            nfev=nfev,
            nsteps=state.nsteps + jnp.where(ok, 1, 0),
            nfailed=c.nfailed,
            jflstp=jflstp,
            okstp=okstp,
            havg=havg)

    # -- flat (attempt-level) stepping for the device driver -------------------

    def flat_init_aux(self, state):
        """Auxiliary carry for attempt-level looping: (fresh, min_step,
        rejected_this_step)."""
        z = jnp.asarray(0.0, self.real_dtype)
        return (jnp.asarray(True), z, jnp.asarray(False))

    def step_flat(self, params, state, aux):
        """Exactly ONE step attempt; state advances when it is accepted.

        Semantically equivalent to :meth:`step`'s nested accept/reject
        loop, but flattened so the device driver can run a single
        unnested ``lax.while_loop`` over attempts — far fewer kernels
        per iteration.  Returns (state', aux', accepted).
        """
        fresh, min_step_c, rejected = aux
        t, y, f = state.t, state.y, state.f

        # per-STEP preparation only on a fresh step (reference computes
        # min_step and the end-of-interval lookahead once per step)
        h_abs_r, min_step_r, sc_r = self.reassess_stepsize(
            params, t, state.h_abs, state.standard_sc)
        h_abs = jnp.where(fresh, h_abs_r, state.h_abs)
        min_step = jnp.where(fresh, min_step_r, min_step_c)
        standard_sc = jnp.where(fresh, sc_r, state.standard_sc)

        too_small = h_abs < min_step
        c = _Carry(
            h_abs=h_abs,
            h_used=jnp.zeros_like(state.h_previous),
            accepted=jnp.asarray(False),
            rejected=rejected,
            status=state.status,
            standard_sc=standard_sc,
            max_factor=state.max_factor,
            y_new=y, f_new=jnp.zeros_like(f),
            error_norm=state.error_norm_old,
            K=state.K,
            nfev=state.nfev, nfailed=state.nfailed,
            jflstp=state.jflstp)
        # gate the attempt exactly like step(): a too-small step or an
        # already-terminal status must not evaluate the RHS, or
        # nfev/nfailed diverge from the host path (esdirk.py does the
        # same; step/step_flat bit-exactness is a test invariant)
        c = jax.lax.cond(
            ~too_small & (state.status == RUNNING),
            lambda cc: self._attempt(params, t, y, f, state, cc),
            lambda cc: cc, c)
        ok = c.accepted & ~too_small
        status = jnp.where(
            too_small & (state.status == RUNNING),
            jnp.asarray(TOO_SMALL_STEP, jnp.int32), c.status)

        d = jnp.abs(params.t_bound - t)
        is_last = ok & (jnp.abs(c.h_used) >= d)
        t_new = jnp.where(is_last, jnp.asarray(params.t_bound, t.dtype),
                          t + c.h_used)

        if self.fsal:
            K_final = c.K
            f_new = c.f_new
            nfev = c.nfev
        else:
            f_new = jnp.where(ok, self.fun(t_new, c.y_new), f)
            K_final = (c.K.at[self.s].set(f_new) if self.carry_stages
                       else c.K)
            nfev = c.nfev + jnp.where(ok, 1, 0)

        status = jnp.where((status == RUNNING) & is_last,
                           jnp.asarray(FINISHED, jnp.int32), status)

        okstp = state.okstp + jnp.where(ok, 1, 0)
        havg = jnp.where(ok, 0.9 * state.havg + 0.1 * c.h_used,
                         state.havg)
        reset = ok & (okstp == 20)
        havg = jnp.where(reset, c.h_used, havg)
        jflstp = jnp.where(reset, 0, c.jflstp)

        new_state = ERKState(
            t=jnp.where(ok, t_new, state.t),
            y=jnp.where(ok, c.y_new, state.y),
            f=jnp.where(ok, f_new, state.f),
            h_abs=c.h_abs,
            status=status,
            standard_sc=jnp.where(ok, c.standard_sc, standard_sc),
            error_norm_old=jnp.where(ok, c.error_norm,
                                     state.error_norm_old),
            h_previous=jnp.where(ok, c.h_used, state.h_previous),
            max_factor=jnp.where(ok, c.max_factor, state.max_factor),
            t_old=jnp.where(ok, t, state.t_old),
            y_old=jnp.where(ok, y, state.y_old),
            f_old=jnp.where(ok, f, state.f_old),
            K=jnp.where(ok, K_final, state.K),
            nfev=nfev,
            nsteps=state.nsteps + jnp.where(ok, 1, 0),
            nfailed=c.nfailed,
            jflstp=jflstp, okstp=okstp, havg=havg)
        aux_new = (ok | (status != RUNNING), min_step, c.rejected & ~ok)
        return new_state, aux_new, ok

    # -- dense output ----------------------------------------------------------

    def error_estimate(self, state):
        """Raw embedded error estimate of the last accepted step
        (common.py:333-336); used as the stiffness-detection
        perturbation vector."""
        m = self.s + (1 if self.fsal else 0)
        return state.h_previous * _weighted_sum(list(state.K)[:m],
                                                self.E[:m])

    def record_coefficients(self, state):
        """Free-interpolant Q of the last accepted step, for on-device
        trajectory recording (no extra RHS evals)."""
        h = state.h_previous
        if self.tab.P is not None:
            return matmul(state.K.T, jnp.asarray(np.asarray(self.tab.P))) * h
        from ..core.interpolate import hermite_cubic_coefficients
        return hermite_cubic_coefficients(h, state.y_old, state.y,
                                          state.f_old, state.f)

    def dense_segments(self, state, interpolant=None):
        """Dense-output segment(s) for the last accepted step.

        Returns ([(t_anchor, h, y_anchor, Q)], nfev_extra) with
        y(u) = y_anchor + sum_k Q[:, k] u**(k+1), u = (t - t_anchor)/h.

        Extra-stage interpolants ('low'/'best' for BS5) evaluate their
        extra stages here — only at steps where dense output is actually
        requested, like the reference (bogacki.py:348-393).
        """
        name = interpolant if interpolant is not None else \
            self.options.get("interpolant", "free")
        h = state.h_previous
        spec = None
        if self.tab.interpolants:
            spec = self.tab.interpolants.get(name)
        if spec is None:
            if self.tab.P is None:
                # cubic Hermite fallback (common.py:358-368)
                from ..core.interpolate import hermite_cubic_coefficients
                Q = hermite_cubic_coefficients(
                    h, state.y_old, state.y, state.f_old, state.f)
                return [(state.t_old, h, state.y_old, Q)], 0
            Q = matmul(state.K.T, jnp.asarray(self.tab.P)) * h
            return [(state.t_old, h, state.y_old, Q)], 0

        # extra-stage interpolant
        C_extra = np.asarray(spec["C_extra"])
        A_extra = np.asarray(spec["A_extra"])
        P = np.asarray(spec["P"])
        rows = list(state.K)
        t_old, y_old = state.t_old, state.y_old
        nfev = 0
        for j, cx in enumerate(C_extra):
            sx = self.s + 1 + j
            dy = h * _weighted_sum(rows[:sx], A_extra[j, :sx])
            rows.append(self.fun(t_old + cx * h, y_old + dy))
            nfev += 1
        K_ext = jnp.stack(rows)
        Q = matmul(K_ext.T, jnp.asarray(P)) * h
        if spec.get("anchor") == "end":
            # RKSuite convention: polynomial looks back from the step end
            # (bogacki.py:390-393)
            return [(state.t, h, state.y, Q)], nfev
        return [(t_old, h, y_old, Q)], nfev
