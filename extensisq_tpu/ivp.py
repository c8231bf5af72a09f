"""Host driver: scipy-semantics ``solve_ivp`` on top of the jitted steppers.

The reference delegates the outer loop (t_eval interpolation, event
root-finding, result assembly) to scipy's driver (SURVEY.md section 1,
L0).  There is no scipy on the device path, so this module re-owns L0: a
thin Python loop around a jit-compiled ``step(params, state) -> state``
kernel, preserving the semantics exercised by
/root/reference/tests/test_ivp.py (backward integration, event
direction/terminal handling, t_eval ordering, degenerate intervals,
stepwise-solver protocol).

For whole-trajectory-on-device ensemble solving, see
:mod:`extensisq_tpu.solve` — same steppers, ``lax.while_loop`` outer
loop, vmap over members.
"""
from warnings import warn

import jax
import jax.numpy as jnp
import numpy as np

from ._config import (RUNNING, FINISHED, TOO_SMALL_STEP, STATUS_MESSAGES)
from .core.numerics import validate_tol
from .core.rootfind import brentq
from .core.interpolate import stack_segments
from .steppers import build_stepper
from .types import IVPParams, Method


class OdeResult(dict):
    """Attribute-accessible result bunch (scipy-compatible surface)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    __setattr__ = dict.__setitem__

    def __repr__(self):
        keys = ", ".join(sorted(self.keys()))
        return f"OdeResult({keys})"


_FAMILY_OPTIONS = {
    "erk": {"first_step", "max_step", "rtol", "atol", "sc_params",
            "nfev_stiff_detect", "interpolant"},
    "ckdisc": {"first_step", "max_step", "rtol", "atol"},
    "rkn": {"first_step", "max_step", "rtol", "atol", "sc_params",
            "nfev_stiff_detect", "interpolant", "scale_embedded"},
    "esdirk": {"first_step", "max_step", "rtol", "atol", "sc_params",
               "jac", "jac_sparsity", "M", "jac_each_step", "interpolant",
               "bands"},
    "adams": {"first_step", "max_step", "rtol", "atol", "k_max"},
    "rkc": {"first_step", "max_step", "rtol", "atol", "const_jac",
            "rho_jac"},
}


class StepInterpolant:
    """Dense output of a single accepted step: host-side evaluation of
    one or more polynomial segments in the unified anchor form."""

    def __init__(self, t_old, t, segments):
        self.t_old = float(t_old)
        self.t = float(t)
        self.segments = [(float(ta), float(h), np.asarray(ya),
                          np.asarray(Q)) for ta, h, ya, Q in segments]

    def _eval_one(self, t):
        segs = self.segments
        if len(segs) > 1:
            # pick the sub-segment containing t (piecewise output)
            for ta, h, ya, Q in segs:
                lo, hi = sorted((ta, ta + h))
                if lo <= t <= hi:
                    break
        else:
            ta, h, ya, Q = segs[0]
        u = (t - ta) / h
        p = Q.shape[1]
        acc = Q[:, p - 1]
        for k in range(p - 2, -1, -1):
            acc = acc * u + Q[:, k]
        return ya + u * acc

    def __call__(self, t):
        t = np.asarray(t, dtype=float)
        if t.ndim == 0:
            return self._eval_one(float(t))
        return np.stack([self._eval_one(float(ti)) for ti in t], axis=1)


_STEPPER_CACHE = {}


def _get_stepper(method, fun_wrapped, cache_key, n, dtype, options):
    if cache_key is not None and cache_key in _STEPPER_CACHE:
        return _STEPPER_CACHE[cache_key]
    impl = build_stepper(method, fun_wrapped, n, dtype, **options)
    impl._step_jit = jax.jit(impl.step)
    impl._dense_jit = jax.jit(impl.dense_segments)
    impl._init_jit = jax.jit(lambda t0, y0, p: impl.init(t0, y0, p))
    impl._init_fs_jit = jax.jit(
        lambda t0, y0, p, fs: impl.init(t0, y0, p, first_step=fs))
    if cache_key is not None:
        _STEPPER_CACHE[cache_key] = impl
    return impl


class Stepper:
    """Stepwise solver with the scipy ``OdeSolver`` surface
    (constructed via ``Method.__call__``, e.g. ``BS5(fun, t0, y0, tf)``;
    direct stepping as in /root/reference/tests/test_ivp.py:838-868)."""

    TOO_SMALL_STEP = STATUS_MESSAGES[TOO_SMALL_STEP]

    def __init__(self, method, fun, t0, y0, t_bound, rtol=1e-3, atol=1e-6,
                 max_step=np.inf, first_step=None, vectorized=False,
                 args=None, _fun_is_traced=False, **options):
        if isinstance(method, str):
            from .methods import METHODS_BY_NAME
            method = METHODS_BY_NAME[method]
        y0 = np.asarray(y0)
        if not np.issubdtype(y0.dtype, np.complexfloating):
            y0 = y0.astype(np.float64)
        self.y0 = y0
        self.n = y0.size
        self.t_bound = float(t_bound)
        t0 = float(t0)
        self.direction = float(np.sign(self.t_bound - t0) or 1.0)

        # ignore-and-warn options that don't apply to this family,
        # matching scipy's warn_extraneous behaviour.  `vectorized` is
        # accepted silently everywhere for drop-in compatibility: the
        # reference uses it only to speed up finite-difference
        # Jacobians (hosea.py:132-146), which autodiff replaces here.
        options.pop("vectorized", None)
        allowed = _FAMILY_OPTIONS[method.family] | {"interpolant"}
        extraneous = {k: v for k, v in options.items() if k not in allowed}
        if extraneous:
            warn("The following arguments have no effect for a chosen "
                 f"solver: {', '.join(f'`{k}`' for k in extraneous)}.")
            for k in extraneous:
                options.pop(k)

        rtol, atol = validate_tol(rtol, atol, y0)
        if first_step is not None:
            first_step = float(first_step)
            if first_step <= 0:
                raise ValueError("`first_step` must be positive.")
            if first_step > abs(t_bound - t0):
                raise ValueError(
                    "`first_step` exceeds bounds.")
        if max_step <= 0:
            raise ValueError("`max_step` must be positive.")

        if args is not None:
            _fun = fun
            fun = lambda t, y: _fun(t, y, *args)                  # noqa: E731
        dtype = y0.dtype
        if vectorized:
            base = fun
            fun_wrapped = lambda t, y: jnp.asarray(          # noqa: E731
                base(t, y[:, None]), dtype=dtype)[:, 0]
        else:
            base = fun
            fun_wrapped = lambda t, y: jnp.asarray(          # noqa: E731
                base(t, y), dtype=dtype)

        try:
            cache_key = (method.name, base, vectorized, self.n, dtype.str,
                         tuple(sorted(
                             (k, v) for k, v in options.items()
                             if isinstance(v, (str, int, float, bool,
                                               type(None))))),
                         len(options))
            hash(cache_key)
        except TypeError:
            cache_key = None
        if any(not isinstance(v, (str, int, float, bool, type(None)))
               for v in options.values()):
            cache_key = None            # unhashable option (array/callable)

        self._impl = _get_stepper(method, fun_wrapped, cache_key, self.n,
                                  dtype, options)
        if hasattr(self._impl, "validate_problem"):
            # host-side structural probes (uncounted RHS evals, like the
            # reference's raw-fun probes at common.py:1248-1267)
            self._impl.validate_problem(
                lambda t, y: np.asarray(fun_wrapped(t, jnp.asarray(y))),
                t0, y0)
        self.params = IVPParams(
            t_bound=jnp.asarray(self.t_bound),
            direction=jnp.asarray(self.direction),
            rtol=jnp.asarray(rtol), atol=jnp.asarray(atol),
            max_step=jnp.asarray(float(max_step)))
        if first_step is None:
            self.state = self._impl._init_jit(t0, y0, self.params)
        else:
            self.state = self._impl._init_fs_jit(t0, y0, self.params,
                                                 first_step)
        if getattr(self._impl, "isDAE", False):
            y0c = np.asarray(self.state.y)
            if not np.allclose(y0c, y0, rtol=rtol, atol=np.max(atol)):
                warn(f"\nInitial conditions are changed to y0 = {y0c} to"
                     "\nmake them consistent with the algebraic "
                     "constraints.")
        self._nfev_extra = 0
        self._status_code = RUNNING
        self._message = None
        self._stiff_warned = False

    # -- scipy OdeSolver surface ------------------------------------------

    @property
    def t(self):
        return float(self.state.t)

    @property
    def t_old(self):
        return float(self.state.t_old)

    @property
    def y(self):
        return np.asarray(self.state.y)

    @property
    def f(self):
        return np.asarray(self.state.f)

    @property
    def nfev(self):
        return int(self.state.nfev) + self._nfev_extra

    @property
    def njev(self):
        return int(getattr(self.state, "njev", 0))

    @property
    def nlu(self):
        return int(getattr(self.state, "nlu", 0))

    @property
    def nfailed(self):
        return int(self.state.nfailed)

    @property
    def step_size(self):
        h = float(self.state.h_previous)
        return abs(h) if h != 0.0 else None

    @property
    def status(self):
        if self._status_code == RUNNING:
            return "running"
        if self._status_code == FINISHED:
            return "finished"
        return "failed"

    def step(self):
        """Advance one accepted step; returns None or failure message."""
        if self._status_code != RUNNING:
            raise RuntimeError(
                "Attempt to step on a failed or finished solver.")
        if self.n == 0 or self.t == self.t_bound:
            # degenerate problems finish immediately (scipy semantics)
            self.state = self.state._replace(
                t_old=self.state.t, y_old=self.state.y,
                t=jnp.asarray(self.t_bound), status=jnp.asarray(FINISHED))
            self._status_code = FINISHED
            return None
        self.state = self._impl._step_jit(self.params, self.state)
        code = int(self.state.status)
        self._status_code = code
        if code in (RUNNING, FINISHED):
            self._maybe_diagnose_stiffness()
            return None
        self._message = STATUS_MESSAGES.get(code, "failed")
        return self._message

    def _maybe_diagnose_stiffness(self):
        """RKSuite stiffness check between steps (host-side; mirrors
        _diagnose_stiffness triggers at common.py:381-410), plus the
        crude per-family stiffness hints (SWAG: 50 consecutive
        low-order steps, shampine.py:198-207; SSV2stab: 15 consecutive
        steps at the stage cap, sommeijer.py:199-201)."""
        impl = self._impl
        if impl.family == "adams":
            if bool(self.state.stiff_flag) and not self._stiff_warned:
                self._stiff_warned = True
                warn("Your problem appears to be stiff (for this "
                     "tolerance).")
            return
        if impl.family == "rkc":
            if int(getattr(self.state, "mlim", 0)) >= 15 \
                    and not self._stiff_warned:
                self._stiff_warned = True
                warn("Your problem is too stiff for this method.")
            return
        if impl.family not in ("erk", "rkn"):
            return
        tab = impl.tab
        nsd = impl.options.get("nfev_stiff_detect", 5000)
        if not nsd:
            return
        if impl.family == "erk" and tab.stbrad is None:
            return
        if impl.family == "rkn" and tab.stbre is None:
            return
        st = self.state
        okstp = int(st.okstp)
        lotsfl = False
        if okstp % 40 == 39:
            lotsfl = int(st.jflstp) >= 10
            self.state = st._replace(jflstp=jnp.asarray(0, jnp.int32))
        many = max(nsd // impl.s, 1)
        toomch = okstp % many == many - 1
        if not (lotsfl or toomch):
            return

        from .core.stiffness import diagnose
        st = self.state
        v0 = np.asarray(impl.error_estimate(st))
        if impl.family == "rkn":
            m = impl.m
            y = np.asarray(st.y)
            fxy = np.concatenate([y[m:], np.asarray(st.f)])
            fun_h = lambda t, yy: np.asarray(              # noqa: E731
                impl.fun_first_order(t, jnp.asarray(yy)))
            kwargs = {"stbre": tab.stbre, "stbim": tab.stbim}
        else:
            fxy = np.asarray(st.f)
            fun_h = lambda t, yy: np.asarray(              # noqa: E731
                impl.fun(t, jnp.asarray(yy)))
            kwargs = {"stbrad": tab.stbrad}
        _, nfev = diagnose(
            fun_h, st, self.t_bound, nsd, impl.s,
            tanang=tab.tanang, estimate_error=v0, fxy=fxy,
            lotsfl=lotsfl, **kwargs)
        self._nfev_extra += nfev

    def dense_output(self, **opts):
        """Interpolant for the last accepted step."""
        if float(self.state.h_previous) == 0.0:
            # no step taken (degenerate interval): constant segment
            seg = [(self.t_old, self.t - self.t_old or 1.0, self.y,
                    np.zeros((self.n, 1)))]
            return StepInterpolant(self.t_old, self.t, seg)
        if opts:
            segments, nfev_extra = self._impl.dense_segments(
                self.state, **opts)
        else:
            segments, nfev_extra = self._impl._dense_jit(self.state)
        self._nfev_extra += int(nfev_extra)
        return StepInterpolant(self.t_old, self.t, segments)


def _prepare_events(events, args):
    if events is None:
        return None, None, None
    if callable(events):
        events = (events,)
    wrapped = []
    is_terminal = []
    direction = []
    for ev in events:
        if args is not None:
            base = ev
            wrapped.append(lambda t, y, base=base: base(t, y, *args))
        else:
            wrapped.append(ev)
        is_terminal.append(bool(getattr(ev, "terminal", False)))
        direction.append(float(getattr(ev, "direction", 0)))
    return wrapped, np.asarray(is_terminal), np.asarray(direction)


def _active_events(g, g_new, direction):
    g = np.asarray(g, dtype=float)
    g_new = np.asarray(g_new, dtype=float)
    up = (g <= 0) & (g_new >= 0)
    down = (g >= 0) & (g_new <= 0)
    either = up | down
    mask = (up & (direction > 0)) | (down & (direction < 0)) \
        | (either & (direction == 0))
    return np.nonzero(mask)[0]


def solve_ivp(fun, t_span, y0, method=None, t_eval=None, dense_output=False,
              events=None, vectorized=False, args=None, **options):
    """Solve an IVP with scipy-compatible semantics on the device steppers.

    ``fun(t, y[, *args])`` must be jax-traceable (jnp operations); it is
    compiled once per (method, fun, shape) and reused across calls.
    ``method`` is a Method handle (e.g. ``BS5``) or its name.
    """
    if method is None:
        from .methods import BS5 as method
    if isinstance(method, str):
        from .methods import METHODS_BY_NAME
        method = METHODS_BY_NAME[method]
    if not isinstance(method, Method):
        raise ValueError(f"unknown method {method!r}")

    t0, tf = map(float, t_span)
    y0 = np.asarray(y0)
    if y0.ndim != 1:
        raise ValueError("`y0` must be 1-dimensional.")
    if y0.size and not np.all(np.isfinite(
            y0 if not np.iscomplexobj(y0) else np.abs(y0))):
        raise ValueError(
            "All components of the initial state `y0` must be finite.")
    if args is not None:
        try:
            (lambda *a: None)(*args)
        except TypeError as exc:
            raise TypeError(
                "Supplied 'args' cannot be unpacked. Please supply "
                "`args` as a tuple (e.g. `args=(arg,)`)") from exc

    if t_eval is not None:
        t_eval = np.asarray(t_eval, dtype=float)
        if t_eval.ndim != 1:
            raise ValueError("`t_eval` must be 1-dimensional.")
        if np.any(t_eval < min(t0, tf)) or np.any(t_eval > max(t0, tf)):
            raise ValueError("Values in `t_eval` are not within `t_span`.")
        d = np.diff(t_eval)
        if tf > t0 and np.any(d <= 0) or tf < t0 and np.any(d >= 0):
            raise ValueError("Values in `t_eval` are not properly sorted.")

    solver = Stepper(method, fun, t0, y0, tf, vectorized=vectorized,
                     args=args, **options)
    direction = solver.direction

    events, is_terminal, event_dir = _prepare_events(events, args)
    if events is not None:
        g = [float(np.asarray(ev(t0, solver.y)).item()) for ev in events]
        t_events = [[] for _ in events]
        y_events = [[] for _ in events]
    else:
        t_events = y_events = None

    ts, ys = [t0], [solver.y]
    ts_eval, ys_eval = [], []
    eval_ptr = 0
    all_segments = []
    status = None

    while status is None:
        message = solver.step()
        if solver.status == "finished":
            status = 0
        elif solver.status == "failed":
            status = -1
            break
        t_old, t, y = solver.t_old, solver.t, solver.y
        sol_step = None

        if dense_output:
            sol_step = solver.dense_output()
            segs = sol_step.segments
            if len(segs) == 1:
                a, h, ya, Q = segs[0]
                all_segments.append((t_old, t, a, h, ya, Q))
            else:
                # piecewise step output (HS ESDIRK): each sub-segment
                # covers [anchor, anchor+h]
                for a, h, ya, Q in segs:
                    all_segments.append((a, a + h, a, h, ya, Q))

        if events is not None:
            g_new = [float(np.asarray(ev(t, y)).item()) for ev in events]
            active = _active_events(g, g_new, event_dir)
            if active.size:
                if sol_step is None:
                    sol_step = solver.dense_output()
                roots = []
                for e in active:
                    ev = events[e]
                    root = brentq(
                        lambda x: float(np.asarray(
                            ev(x, sol_step(x))).item()), t_old, t)
                    roots.append(root)
                roots = np.asarray(roots)
                if np.any(is_terminal[active]):
                    term_roots = roots[is_terminal[active]]
                    t_term = (np.min(term_roots) if direction > 0
                              else np.max(term_roots))
                    keep = direction * (roots - t_term) <= 0
                    active, roots = active[keep], roots[keep]
                    terminate = True
                else:
                    t_term = None
                    terminate = False
                order = np.argsort(direction * roots)
                for e, te in zip(active[order], roots[order]):
                    t_events[e].append(te)
                    y_events[e].append(np.asarray(sol_step(te)))
                if terminate:
                    status = 1
                    t = float(t_term)
                    y = np.asarray(sol_step(t))
            g = g_new

        if t_eval is None:
            ts.append(t)
            ys.append(y)
        else:
            new_ptr = eval_ptr
            m = t_eval.shape[0]
            while new_ptr < m and direction * (t_eval[new_ptr] - t) <= 0:
                new_ptr += 1
            if new_ptr > eval_ptr:
                if sol_step is None:
                    sol_step = solver.dense_output()
                for p in t_eval[eval_ptr:new_ptr]:
                    ts_eval.append(float(p))
                    ys_eval.append(np.asarray(sol_step(float(p))))
                eval_ptr = new_ptr

    if t_eval is None:
        t_out = np.asarray(ts)
        y_out = (np.stack(ys, axis=1) if ys
                 else np.empty((solver.n, 0), dtype=solver.y0.dtype))
    else:
        t_out = np.asarray(ts_eval)
        y_out = (np.stack(ys_eval, axis=1) if ys_eval
                 else np.empty((solver.n, 0), dtype=solver.y0.dtype))

    sol = None
    if dense_output and all_segments:
        sol = stack_segments(
            [(s[0], s[1], s[2], s[3], s[4], s[5]) for s in all_segments])

    if events is not None:
        t_events = [np.asarray(te) for te in t_events]
        y_events = [(np.stack(ye) if ye else np.empty((0,)))
                    for ye in y_events]

    if status == 0:
        message = STATUS_MESSAGES[FINISHED]
    elif status == 1:
        message = "A termination event occurred."

    return OdeResult(
        t=t_out, y=y_out, sol=sol,
        t_events=t_events, y_events=y_events,
        nfev=solver.nfev, njev=solver.njev, nlu=solver.nlu,
        nsteps=int(solver.state.nsteps), nfailed=solver.nfailed,
        nls=int(getattr(solver.state, "nls", 0)),
        nfi=int(getattr(solver.state, "nfi", 0)),
        # RKC diagnostics (the reference exposes these as module
        # globals, sommeijer.py:12-14)
        nfesig=int(getattr(solver.state, "nfesig", 0)),
        maxm=int(getattr(solver.state, "maxm", 0)),
        status=status, message=message, success=status >= 0)
