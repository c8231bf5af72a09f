"""Whole-trajectory-on-device solver: the device performance path.

``solve`` compiles an entire adaptive integration — h_start, the
accept/reject loop, step-size control, t_eval interpolation — into one
XLA program (``lax.while_loop`` over the shared per-step kernel).  It is
a pure function of its traced arguments, so

    jax.vmap(lambda y0: solve(fun, (t0, tf), y0, method=BS5))(Y0)

integrates an ensemble of initial conditions as one program: each member
keeps its own adaptive step size; finished members become masked no-ops
until the slowest member completes (SURVEY.md section 2.4, item 1).
Parameters can be batched the same way through ``args``.

This is the rebuild's replacement for looping scipy's driver over
ensemble members — there is no per-step host round-trip.
"""
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ._config import RUNNING, MAX_STEPS_REACHED, TERMINAL_EVENT, PAUSED
from .core.interpolate import horner
from .steppers import build_stepper
from .types import IVPParams, Method


class Solution(NamedTuple):
    """Result of a device solve (pytree; all leaves device arrays)."""
    t: Any                 # final time reached
    y: Any                 # final state
    status: Any            # int32 status code (1 = finished)
    nfev: Any
    nsteps: Any
    nfailed: Any
    # optional trajectory record (None unless save_steps / t_eval)
    ts: Any = None         # (max_steps,) step end times, padded
    ys: Any = None         # (max_steps, n) step end states, padded
    t_eval: Any = None
    y_eval: Any = None     # (len(t_eval), n)
    record: Any = None     # raw segment buffers {t_lo,t_hi,h,y_anchor,Q}
    t_events: Any = None   # (n_events, max_events), nan-padded
    y_events: Any = None   # (n_events, max_events, n)
    n_events: Any = None   # (n_events,) int32 counts
    stiffness: Any = None  # int32 diagnosis code (core.stiffness.STIFF_*)
                           # when solve(..., nfev_stiff_detect=N) is on
    nfesig: Any = None     # RKC: f-evals spent on spectral-radius power
    maxm: Any = None       # iterations / max stage count incl. rejected
                           # attempts (reference sommeijer.py:12-14)
    final_state: Any = None  # stepper-state pytree (return_state=True);
                             # feed back via solve(resume_state=...)

    @property
    def success(self):
        return (self.status == 1) | (self.status == TERMINAL_EVENT)

    def ode_solution(self):
        """Build a device-evaluable OdeSolution from the recorded
        segments (requires save_steps=True or t_eval; host-side: it
        concretizes the step count)."""
        if self.record is None:
            raise ValueError(
                "no trajectory record: run solve(..., save_steps=True)")
        from .core.interpolate import OdeSolution
        k = int(self.nsteps)
        r = self.record
        ts = jnp.concatenate([r["t_lo"][:1], r["t_hi"][:k]])
        return OdeSolution(ts=ts, t_anchor=r["t_lo"][:k], h=r["h"][:k],
                           y_anchor=r["y_anchor"][:k], Q=r["Q"][:k])


def _record_segment(stepper, state):
    """Free-interpolant coefficients of the last accepted step."""
    return (state.t_old, state.h_previous, state.y_old,
            stepper.record_coefficients(state))


def _make_event_handler(stepper, events, max_events, n, direction):
    """On-device event handling: sign-change detection + 60-iteration
    bisection on the step's free interpolant, terminal truncation.
    Returns (ev_state0, handle(new_state, accepted, ev_state))."""
    events = (events,) if callable(events) else tuple(events)
    n_ev = len(events)
    terminal = np.array([bool(getattr(e, "terminal", False))
                         for e in events])
    ev_dir = np.array([float(getattr(e, "direction", 0.0))
                       for e in events])

    def init(t0, y0):
        g0 = jnp.stack([jnp.asarray(e(t0, y0), jnp.float64).reshape(())
                        for e in events])
        return {
            "g": g0,
            "t_ev": jnp.full((n_ev, max_events), jnp.nan),
            "y_ev": jnp.full((n_ev, max_events, n), jnp.nan,
                             y0.dtype),
            "count": jnp.zeros((n_ev,), jnp.int32),
        }

    def handle(new, accepted, ev):
        t_old, t_new = new.t_old, new.t
        h = new.h_previous
        ta, ya = t_old, new.y_old
        Q = stepper.record_coefficients(new)

        def interp(tq):
            return horner((tq - ta) / h, Q, ya)

        g_new = jnp.stack([
            jnp.asarray(e(t_new, new.y), jnp.float64).reshape(())
            for e in events])
        g = ev["g"]
        up = (g <= 0) & (g_new >= 0)
        down = (g >= 0) & (g_new <= 0)
        fired = jnp.where(jnp.asarray(ev_dir) > 0, up,
                          jnp.where(jnp.asarray(ev_dir) < 0, down,
                                    up | down)) & accepted

        # bisection per event (n_ev is small and static)
        roots = []
        for i, e in enumerate(events):
            def phi(tq, e=e):
                return jnp.asarray(e(tq, interp(tq)),
                                   jnp.float64).reshape(())

            def bisect_body(_, ab):
                a, b, fa = ab
                mid = 0.5 * (a + b)
                fm = phi(mid)
                left = fa * fm <= 0.0
                return (jnp.where(left, a, mid),
                        jnp.where(left, mid, b),
                        jnp.where(left, fa, fm))

            a, b, _ = jax.lax.fori_loop(
                0, 60, bisect_body, (t_old, t_new, g[i]))
            roots.append(0.5 * (a + b))
        roots = jnp.stack(roots)

        # terminal truncation: earliest terminal root in direction
        term_mask = jnp.asarray(terminal) & fired
        any_term = jnp.any(term_mask)
        dir_roots = direction * roots
        te_dir = jnp.min(jnp.where(term_mask, dir_roots, jnp.inf))
        te = direction * te_dir
        keep = fired & (~any_term | (dir_roots <= te_dir))

        # record kept roots; once the buffer is full the first
        # max_events roots are kept and the count saturates (no
        # overwrite of the last slot, no unbounded count)
        keep = keep & (ev["count"] < max_events)
        idx = jnp.minimum(ev["count"], max_events - 1)
        y_roots = jax.vmap(interp)(roots)
        t_ev = ev["t_ev"]
        y_ev = ev["y_ev"]
        for i in range(n_ev):
            t_ev = t_ev.at[i, idx[i]].set(
                jnp.where(keep[i], roots[i], t_ev[i, idx[i]]))
            y_ev = y_ev.at[i, idx[i]].set(
                jnp.where(keep[i], y_roots[i], y_ev[i, idx[i]]))
        count = ev["count"] + keep.astype(jnp.int32)

        # truncate the state at the terminal root
        y_te = interp(te)
        new = new._replace(
            t=jnp.where(any_term, te, new.t),
            y=jnp.where(any_term, y_te, new.y),
            status=jnp.where(any_term,
                             jnp.asarray(TERMINAL_EVENT, jnp.int32),
                             new.status))
        ev_new = {"g": jnp.where(accepted, g_new, g),
                  "t_ev": t_ev, "y_ev": y_ev, "count": count}
        return new, ev_new

    return init, handle


def solve(fun, t_span, y0, method=None, rtol=1e-3, atol=1e-6,
          max_step=np.inf, first_step=None, max_steps=10_000,
          t_eval=None, save_steps=False, args=None, events=None,
          max_events=8, pause_at=None, resume_state=None,
          return_state=False, **options):
    """Integrate an IVP fully on device; jittable and vmappable.

    ``t_span``, ``y0``, ``rtol``, ``atol``, ``t_eval`` values may be
    traced; ``method``, ``max_steps``, shapes and option strings are
    static.  Integration direction is traced (sign of ``tf - t0``), so
    traced/vmapped spans may point either way, per member.

    ``pause_at``/``resume_state``/``return_state`` implement
    warm-started windowing (solve_windowed): the loop pauses once
    ``t`` passes ``pause_at`` (status ``PAUSED``, state resumable),
    and a later call continues from ``resume_state`` — the stepper's
    memory (SWAG phi history, RKC spectral-radius eigenvector, ESDIRK
    Jacobian/LU ladder) and the counters carry over, so the chunked
    solve is IDENTICAL to the single-shot solve, step for step.
    """
    if method is None:
        from .methods import BS5 as method
    if isinstance(method, str):
        from .methods import METHODS_BY_NAME
        method = METHODS_BY_NAME[method]
    if not isinstance(method, Method):
        raise ValueError(f"unknown method {method!r}")

    t0, tf = t_span
    y0 = jnp.atleast_1d(jnp.asarray(y0))
    if not jnp.issubdtype(y0.dtype, jnp.inexact):
        y0 = y0.astype(jnp.float64)
    n = y0.shape[0]

    if args is not None:
        base = fun
        fun = lambda t, y: base(t, y, *args)                 # noqa: E731

    # traced-safe direction: t_span may be jit arguments (e.g. the
    # window edges in solve_windowed), so the sign must be computed in
    # the traced graph — a concrete fallback of +1.0 silently integrated
    # backward solves forward (round-1 advisor finding)
    sgn = jnp.sign(jnp.asarray(tf, jnp.float64)
                   - jnp.asarray(t0, jnp.float64))
    direction = jnp.where(sgn == 0, 1.0, sgn)

    record = save_steps or (t_eval is not None)
    nsd = int(options.get("nfev_stiff_detect", 0) or 0)
    if (not record and events is None and nsd == 0
            and method.family in ("erk", "rkn")
            and "carry_stages" not in options):
        # final-state-only solves don't need the (s+1, n) stage array
        # in the loop carry (big win for large-n states)
        options = dict(options, carry_stages=False)
    stepper = build_stepper(method, lambda t, y: jnp.asarray(fun(t, y),
                                                             y0.dtype),
                            n, y0.dtype, **options)
    params = IVPParams(
        t_bound=jnp.asarray(tf, jnp.float64),
        direction=jnp.asarray(direction),
        rtol=jnp.asarray(rtol), atol=jnp.asarray(atol),
        max_step=jnp.asarray(max_step, jnp.float64))

    if resume_state is not None:
        state0 = resume_state
    else:
        state0 = stepper.init(t0, y0, params, first_step=first_step)

    if pause_at is not None:
        pause_t = jnp.asarray(pause_at, jnp.float64)

        def not_paused(st):
            return params.direction * (st.t - pause_t) < 0
    else:
        def not_paused(st):
            return jnp.asarray(True)

    if record:
        seg0 = _record_segment(stepper, state0)
        p = seg0[3].shape[1]
        bufs0 = {
            "t_lo": jnp.full((max_steps,), jnp.asarray(t0, jnp.float64)),
            "t_hi": jnp.full((max_steps,), jnp.asarray(t0, jnp.float64)),
            "h": jnp.ones((max_steps,), jnp.float64),
            "y_anchor": jnp.zeros((max_steps, n), y0.dtype),
            "Q": jnp.zeros((max_steps, n, p), y0.dtype),
        }
    else:
        bufs0 = {}

    flat = hasattr(stepper, "step_flat")

    # optional on-device stiffness diagnosis (RKSuite power iteration,
    # vmap-safe; VERDICT r1 #7).  Off by default: enabling adds a few
    # masked kernels per step.  Reference: common.py:370-516.
    stiff_check = None
    if (nsd > 0 and method.family in ("erk", "rkn")
            and not jnp.issubdtype(y0.dtype, jnp.complexfloating)):
        from .core.stiffness import make_device_diagnosis
        tab = stepper.tab
        if method.family == "erk" and tab.stbrad is not None:
            stiff_check = make_device_diagnosis(
                stepper.fun, stepper.s, nsd, stbrad=tab.stbrad,
                tanang=tab.tanang)
            fxy_of = lambda st: st.f                      # noqa: E731
        elif method.family == "rkn" and tab.stbre is not None:
            m = stepper.m
            stiff_check = make_device_diagnosis(
                stepper.fun_first_order, stepper.s, nsd,
                stbre=tab.stbre, stbim=tab.stbim, tanang=tab.tanang)
            fxy_of = lambda st: jnp.concatenate(          # noqa: E731
                [st.y[m:], st.f])

    def run_stiff_check(new, accepted, carry):
        code_prev, extra_nfev = carry
        code, dnfev, jreset = stiff_check(
            new, stepper.error_estimate(new), fxy_of(new),
            params.t_bound, accepted)
        new = new._replace(jflstp=jnp.where(jreset, 0, new.jflstp))
        return new, (jnp.maximum(code_prev, code),
                     extra_nfev + dnfev)

    stiff0 = (jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))

    if events is not None:
        ev_init, ev_handle = _make_event_handler(
            stepper, events, max_events, n, params.direction)
        ev0 = ev_init(state0.t, state0.y)
    else:
        ev_handle = None
        ev0 = {}

    def record_bufs(bufs, stepper, new, accepted, prev_nsteps):
        ta, h, ya, Q = _record_segment(stepper, new)
        i = jnp.minimum(prev_nsteps, max_steps - 1)

        def upd(buf, val):
            return jnp.where(accepted, buf.at[i].set(val), buf)

        return {
            "t_lo": upd(bufs["t_lo"], new.t_old),
            "t_hi": upd(bufs["t_hi"], new.t),
            "h": upd(bufs["h"], h),
            "y_anchor": upd(bufs["y_anchor"], ya),
            "Q": upd(bufs["Q"], Q),
        }

    # max_steps budgets THIS call: under resume_state the carried
    # counter keeps accumulating, so the cap is relative to the
    # window's starting count
    nsteps_start = state0.nsteps

    def cap(new):
        hit_cap = ((new.nsteps - nsteps_start >= max_steps)
                   & (new.status == RUNNING))
        return new._replace(status=jnp.where(
            hit_cap, jnp.asarray(MAX_STEPS_REACHED, jnp.int32),
            new.status))

    if flat:
        # attempt-level loop: one unnested while body => far fewer
        # kernels per iteration than the nested accept/reject loop
        def cond(carry):
            state, aux, _, _, _ = carry
            return (state.status == RUNNING) & not_paused(state)

        def body(carry):
            state, aux, bufs, ev, sc = carry
            new, aux, accepted = stepper.step_flat(params, state, aux)
            if record:
                bufs = record_bufs(bufs, stepper, new, accepted,
                                   state.nsteps)
            if ev_handle is not None:
                new, ev = ev_handle(new, accepted, ev)
            if stiff_check is not None:
                new, sc = run_stiff_check(new, accepted, sc)
            return cap(new), aux, bufs, ev, sc

        state, _, bufs, ev, sc = jax.lax.while_loop(
            cond, body,
            (state0, stepper.flat_init_aux(state0), bufs0, ev0,
             stiff0))
    else:
        def cond(carry):
            state, _, _, _ = carry
            return (state.status == RUNNING) & not_paused(state)

        def body(carry):
            state, bufs, ev, sc = carry
            new = stepper.step(params, state)
            accepted = new.nsteps > state.nsteps
            if record:
                bufs = record_bufs(bufs, stepper, new, accepted,
                                   state.nsteps)
            if ev_handle is not None:
                new, ev = ev_handle(new, accepted, ev)
            if stiff_check is not None:
                new, sc = run_stiff_check(new, accepted, sc)
            return cap(new), bufs, ev, sc

        state, bufs, ev, sc = jax.lax.while_loop(
            cond, body, (state0, bufs0, ev0, stiff0))

    status_out = state.status
    if pause_at is not None:
        # the only way the loop exits with RUNNING is the pause gate
        status_out = jnp.where(status_out == RUNNING,
                               jnp.asarray(PAUSED, jnp.int32),
                               status_out)
    out = Solution(
        t=state.t, y=state.y, status=status_out,
        nfev=state.nfev + (sc[1] if stiff_check is not None else 0),
        nsteps=state.nsteps, nfailed=state.nfailed,
        nfesig=getattr(state, "nfesig", None),
        maxm=getattr(state, "maxm", None))
    if return_state:
        out = out._replace(final_state=state)
    if stiff_check is not None:
        out = out._replace(stiffness=sc[0])
    if events is not None:
        out = out._replace(t_events=ev["t_ev"], y_events=ev["y_ev"],
                           n_events=ev["count"])

    if record:
        nseg = state.nsteps
        out = out._replace(record=bufs)
        if save_steps:
            mask = jnp.arange(max_steps) < nseg
            # step-end states: evaluate each segment at u = 1
            ys = jax.vmap(
                lambda ya, Q: horner(jnp.asarray(1.0), Q, ya))(
                bufs["y_anchor"], bufs["Q"])
            out = out._replace(
                ts=jnp.where(mask, bufs["t_hi"], jnp.nan),
                ys=jnp.where(mask[:, None], ys, jnp.nan))
        if t_eval is not None:
            t_eval = jnp.asarray(t_eval)
            sgn = params.direction
            grid = jnp.where(jnp.arange(max_steps) < nseg,
                             sgn * bufs["t_hi"], jnp.inf)

            def eval_one(tq):
                idx = jnp.clip(jnp.searchsorted(grid, sgn * tq,
                                                side="left"),
                               0, jnp.maximum(nseg - 1, 0))
                u = (tq - bufs["t_lo"][idx]) / bufs["h"][idx]
                return horner(u, bufs["Q"][idx], bufs["y_anchor"][idx])

            y_eval = jax.vmap(eval_one)(t_eval)
            out = out._replace(t_eval=t_eval, y_eval=y_eval)
    return out


def solve_ensemble(fun, t_span, y0_batch, params_batch=None, method=None,
                   **kwargs):
    """Convenience vmap wrapper: integrate a batch of initial states
    (and optionally per-member parameters) as one XLA program.

    ``fun(t, y)`` or ``fun(t, y, p)`` with ``p`` a pytree whose leaves
    have a leading ensemble axis in ``params_batch``.
    """
    if params_batch is None:
        run = lambda y0: solve(fun, t_span, y0, method=method,   # noqa
                               **kwargs)
        return jax.vmap(run)(y0_batch)
    run = lambda y0, p: solve(                                   # noqa
        lambda t, y: fun(t, y, p), t_span, y0, method=method, **kwargs)
    return jax.vmap(run)(y0_batch, params_batch)


_WINDOW_CACHE = {}


def solve_windowed(fun, t_span, y0, n_windows, method=None,
                   ensemble=False, params_batch=None, **kwargs):
    """Integrate a long horizon as ``n_windows`` jit-compiled chunks,
    feeding the full solver state forward between chunks on the host.

    One XLA program that runs for minutes can exceed accelerator
    runtime limits (and pins the chip for the whole solve); windowing
    is the standard long-horizon pattern: the window boundaries are
    jit arguments, so two compilations (first window, resume window)
    serve every chunk.  Each window WARM-STARTS from the previous
    window's terminal stepper state — step size, controller memory,
    SWAG phi history, RKC spectral-radius eigenvector, ESDIRK
    Jacobian/LU ladder — and the loop merely pauses at each boundary
    (no end-of-interval step clamping), so the chunked solve takes
    exactly the same steps as the single-shot solve: terminal state
    and all counters are bit-identical (tested in
    test_solve_device.py::test_solve_windowed).

    ``ensemble=True`` vmaps over a leading axis of ``y0`` (with
    optional per-member ``params_batch``).  Trajectory recording and
    events are per-window concepts and are not supported here; use
    :func:`solve` on the individual windows if they are needed.

    Returns the last window's :class:`Solution`; counters live in the
    carried state, so they already cover the whole horizon.
    """
    if (kwargs.get("save_steps") or kwargs.get("t_eval") is not None
            or kwargs.get("events") is not None):
        raise ValueError(
            "solve_windowed does not support save_steps/t_eval/events; "
            "call solve() per window instead.")
    t0, tf = t_span
    edges = np.linspace(float(t0), float(tf), int(n_windows) + 1)

    def one(y, a, b, pb, st):
        f = fun if pb is None else (lambda t, yy: fun(t, yy, pb))
        return solve(f, (a, tf), y, method=method, pause_at=b,
                     resume_state=st, return_state=True, **kwargs)

    def first(y, a, b, pb):
        if ensemble:
            ax = None if params_batch is None else 0
            return jax.vmap(one, in_axes=(0, None, None, ax, None))(
                y, a, b, pb, None)
        return one(y, a, b, pb, None)

    def resume(st, a, b, pb):
        if ensemble:
            ax = None if params_batch is None else 0
            return jax.vmap(
                lambda s, p: one(s.y, a, b, p, s),
                in_axes=(0, ax))(st, pb)
        return one(st.y, a, b, pb, st)

    # cache the jitted runners so repeated solve_windowed calls with
    # the same (fun, method, options) reuse the two compilations;
    # params_batch and the edges are traced arguments
    key = (fun, getattr(method, "name", method), bool(ensemble),
           params_batch is not None,
           tuple(sorted((k, repr(v)) for k, v in kwargs.items())))
    runners = _WINDOW_CACHE.get(key)
    if runners is None:
        runners = (jax.jit(first), jax.jit(resume))
        _WINDOW_CACHE[key] = runners
        if len(_WINDOW_CACHE) > 64:
            _WINDOW_CACHE.pop(next(iter(_WINDOW_CACHE)))
    run_first, run_resume = runners

    out = run_first(y0, edges[0], edges[1], params_batch)
    for a, b in zip(edges[1:-1], edges[2:]):
        ok = np.asarray(out.status)
        if not np.all((ok == 1) | (ok == TERMINAL_EVENT)
                      | (ok == PAUSED)):
            break
        out = run_resume(out.final_state, a, b, params_batch)
    return out._replace(final_state=None)
