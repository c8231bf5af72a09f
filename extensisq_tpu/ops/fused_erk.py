"""Whole-solve explicit Runge-Kutta ensemble kernel (Pallas, Triton route).

The XLA device driver (:func:`extensisq_tpu.solve_ensemble`) runs one
``lax.while_loop`` iteration per step attempt, and each iteration is
many small kernels plus a loop predicate read by the host.  Here one
Pallas program integrates a block of members from ``t0`` to ``tf``:
the starting step, the stages, the error estimate, the accept/reject
controller and the adaptive loop all run inside the kernel, so a solve
is one launch.

Layout.  Each state component is a vector over the block's members (a
"row"); the state is a tuple of ``n`` rows.  XLA transposes the
``(B, n)`` batch to rows outside the kernel.  Members that finish early
idle until their block completes.

RHS convention.  ``fun(t, y)`` reads components as ``y[i]`` and returns
a tuple or list of ``n`` components, e.g.
``lambda t, y: (y[1], mu * (1 - y[0] ** 2) * y[1] - y[0])``.  Inside the
kernel ``t`` and each ``y[i]`` are member vectors; on the XLA path
(``solve``/``solve_ensemble``) the same function gets an ``(n,)`` array
and the driver turns the tuple into one.  Do not build the result with
``jnp.stack``: Triton lowers no concatenation along a leading axis.

The arithmetic is that of ``steppers/erk.py`` (``step_flat``) and
``core/hstart.py`` in the same order, in the dtype of ``y0`` (float32
or float64), so a float64 solve takes the steps the XLA path takes.
"""
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .._config import (RUNNING, FINISHED, TOO_SMALL_STEP, OVERFLOW,
                       MAX_STEPS_REACHED, MAX_FACTOR, MAX_FACTOR0)
from ..core.controller import resolve_controller
from ._hstart_tile import hstart_rows, rows_norm


class _Carry(NamedTuple):
    t: Any
    y: Any                  # tuple of n rows
    f: Any                  # tuple of n rows: derivative at (t, y)
    h_abs: Any
    status: Any
    standard_sc: Any
    err_old: Any
    h_prev: Any
    max_factor: Any
    fresh: Any              # next attempt starts a new step
    min_step: Any
    rejected: Any           # an attempt of the current step was rejected
    nfev: Any
    nsteps: Any


def _wsum(stages, w, like):
    """sum_j w_j * stages[j] over row tuples, zero weights skipped."""
    acc = None
    for wj, K in zip(w, stages):
        if wj == 0.0:
            continue
        term = [float(wj) * k for k in K]
        acc = term if acc is None else [a + b for a, b in zip(acc, term)]
    return [jnp.zeros_like(r) for r in like] if acc is None else acc


def _axpy(h, x, y):
    return [yi + h * xi for xi, yi in zip(x, y)]


def _scaled_norm(err, y, y_new, rtol, atol):
    return rows_norm([e / (atol + rtol * jnp.maximum(jnp.abs(a), jnp.abs(b)))
                      for e, a, b in zip(err, y, y_new)])


def _integrate_block(fun, tab, cc, consts, max_steps, max_step, first_step,
                     t0, tf, direction, rtol, atol, y0):
    """The whole adaptive integration of one block; returns the final
    carry.  ``t0``...``atol`` are member vectors, ``y0`` a row tuple."""
    h_min_a, h_min_b, tiny_err = consts
    s, fsal = tab.n_stages, tab.fsal
    A, B, C, E = tab.A, tab.B, tab.C, tab.E
    npre = tab.n_pre if tab.E_pre is not None else 0
    m = s + (1 if fsal else 0)
    izero = jnp.zeros(t0.shape, jnp.int32)

    def rhs(t, y):
        out = fun(t, tuple(y))
        if len(out) != len(y):
            raise ValueError(
                f"fun returned {len(out)} components for a state of "
                f"{len(y)}; return a tuple or list of rows")
        return [jnp.broadcast_to(jnp.asarray(o, t.dtype), t.shape)
                for o in out]

    f0 = rhs(t0, y0)
    if first_step is None:
        b = t0 + direction * jnp.minimum(jnp.abs(tf - t0), max_step)
        h_abs0 = jnp.abs(hstart_rows(rhs, t0, b, y0, f0, tab.order_secondary,
                                     rtol, atol))
        nfev0 = 2 + min(len(y0) + 1, 3)
    else:
        h_abs0 = jnp.full(t0.shape, first_step, t0.dtype)
        nfev0 = 1

    def cond(c):
        return jnp.max(jnp.where(c.status == RUNNING, 1, 0)) > 0

    def body(c):
        t, y, f = c.t, list(c.y), list(c.f)
        running = c.status == RUNNING

        # per-step preparation, on a fresh step only
        # (ERKStepper.reassess_stepsize)
        ms = jnp.maximum(h_min_a * (jnp.abs(t) + c.h_abs), h_min_b)
        out_of_range = (c.h_abs < ms) | (c.h_abs > max_step)
        hr = jnp.minimum(max_step, jnp.maximum(ms, c.h_abs))
        d = jnp.abs(tf - t)
        split = (d < 2.0 * hr) & (d > hr)
        hr = jnp.where(split, jnp.maximum(0.5 * d, ms),
                       jnp.where(d <= hr, d, hr))
        sc_r = c.standard_sc | out_of_range | split
        h_abs = jnp.where(c.fresh, hr, c.h_abs)
        min_step = jnp.where(c.fresh, ms, c.min_step)
        standard_sc = jnp.where(c.fresh, sc_r, c.standard_sc)

        too_small = h_abs < min_step
        live = ~too_small & running
        h = h_abs * direction

        # one attempt (ERKStepper._attempt); members that must not
        # attempt compute it anyway and keep their carry
        K = [f]
        for i in range(1, npre or s):
            dy = _wsum(K[:i], A[i, :i], y)
            K.append(rhs(t + float(C[i]) * h, _axpy(h, dy, y)))
        if npre:
            y_pre = _axpy(h, _wsum(K, tab.B_pre, y), y)
            err_pre = [h * e for e in _wsum(K, tab.E_pre, y)]
            pre_norm = _scaled_norm(err_pre, y, y_pre, rtol, atol)
            pre_ok = ~(pre_norm > 1.0)
            for i in range(npre, s):
                dy = _wsum(K[:i], A[i, :i], y)
                K.append(rhs(t + float(C[i]) * h, _axpy(h, dy, y)))
        y_new = _axpy(h, _wsum(K[:s], B, y), y)
        if fsal:
            K.append(rhs(t + h, y_new))
        err = [h * e for e in _wsum(K[:m], E[:m], y)]
        err_norm = _scaled_norm(err, y, y_new, rtol, atol)
        dfev = s - 1 + (1 if fsal else 0)
        if npre:
            dfev = jnp.where(pre_ok, dfev, npre - 1)
            err_norm = jnp.where(pre_ok, err_norm, jnp.inf)
            err_rej = jnp.where(pre_ok, err_norm, pre_norm)
            accepted = pre_ok & (err_norm < 1.0)
        else:
            err_rej = err_norm
            accepted = err_norm < 1.0
        bad = jnp.isnan(err_norm) | jnp.isinf(err_norm)
        if npre:
            bad = pre_ok & bad

        # controller (core.controller.erk_accept_update / reject_factor)
        h_ratio = h / jnp.where(c.h_prev == 0.0, h, c.h_prev)
        e = jnp.maximum(err_norm, 1e-300)
        fac_std = cc.safety * e ** cc.error_exponent
        e_old = jnp.maximum(c.err_old, 1e-300)
        hrat = jnp.where(h_ratio == 0.0, 1.0, h_ratio)
        fac_2nd = jnp.clip(
            cc.safety_sc * (e ** cc.minbeta1 * e_old ** cc.minbeta2
                            * hrat ** cc.minalpha),
            cc.min_factor, c.max_factor)
        is_tiny = err_norm < tiny_err
        fac_acc = jnp.where(is_tiny, c.max_factor,
                            jnp.where(standard_sc, fac_std, fac_2nd))
        fac_acc = jnp.where(c.rejected, jnp.minimum(1.0, fac_acc), fac_acc)
        mf_acc = jnp.where(fac_acc < MAX_FACTOR, MAX_FACTOR, c.max_factor)
        fac_rej = jnp.maximum(
            cc.min_factor,
            cc.safety * jnp.maximum(err_rej, 1e-300) ** cc.error_exponent)

        accepted = accepted & live
        h_abs_next = jnp.where(
            live, h_abs * jnp.where(accepted, fac_acc, fac_rej), h_abs)
        status = jnp.where(live & bad & ~accepted, OVERFLOW, c.status)
        status = jnp.where(too_small & running, TOO_SMALL_STEP, status)
        nfev = c.nfev + jnp.where(live, dfev, 0)

        ok = accepted
        is_last = ok & (h_abs >= d)
        t_new = jnp.where(is_last, tf, t + h)
        if fsal:
            f_new = K[s]
        else:
            f_new = rhs(t_new, y_new)
            nfev = nfev + jnp.where(ok, 1, 0)
        status = jnp.where((status == RUNNING) & is_last, FINISHED, status)
        nsteps = c.nsteps + jnp.where(ok, 1, 0)
        status = jnp.where((nsteps >= max_steps) & (status == RUNNING),
                           MAX_STEPS_REACHED, status)

        return _Carry(
            t=jnp.where(ok, t_new, t),
            y=tuple(jnp.where(ok, a, b) for a, b in zip(y_new, y)),
            f=tuple(jnp.where(ok, a, b) for a, b in zip(f_new, f)),
            h_abs=h_abs_next,
            status=status,
            standard_sc=jnp.where(ok, is_tiny, standard_sc),
            err_old=jnp.where(ok, err_norm, c.err_old),
            h_prev=jnp.where(ok, h, c.h_prev),
            max_factor=jnp.where(ok, mf_acc, c.max_factor),
            fresh=ok | (status != RUNNING),
            min_step=min_step,
            rejected=(c.rejected | (live & ~accepted)) & ~ok,
            nfev=nfev,
            nsteps=nsteps)

    zero = jnp.zeros_like(t0)
    c0 = _Carry(
        t=t0, y=tuple(y0), f=tuple(f0), h_abs=h_abs0,
        status=izero + RUNNING, standard_sc=izero == 0,
        err_old=zero + 1.0, h_prev=zero, max_factor=zero + MAX_FACTOR0,
        fresh=izero == 0, min_step=zero, rejected=izero != 0,
        nfev=izero + nfev0, nsteps=izero)
    return jax.lax.while_loop(cond, body, c0)


def solve_fused_erk(fun, t_span, y0_batch, method=None, rtol=1e-3,
                    atol=1e-6, first_step=None, max_step=np.inf,
                    max_steps=10_000, params=None, block_members=128,
                    interpret=False):
    """Integrate an ensemble of small ODE systems in one Pallas kernel.

    ``y0_batch``: ``(B, n)`` float32 or float64 initial states; the
    kernel computes in that dtype.  ``method``: an explicit pair
    (family ``'erk'``, default BS5).  ``rtol``, ``atol``,
    ``first_step``, ``max_step`` and ``max_steps`` mean what they mean
    for :func:`extensisq_tpu.solve`.

    ``params``: optional ``(B, k)`` per-member parameters.  ``fun`` is
    then called as ``fun(t, y, p)`` with ``p`` a ``k``-tuple (one
    member vector each); on the XLA path
    ``solve_ensemble(fun, ..., params_batch=params)`` passes the same
    function a ``(k,)`` array, so ``p[j]`` works in both.

    ``block_members``: members per program, a power of two; the
    program gets one thread per member (at most 8 warps).
    ``interpret=True`` runs the kernel in the Pallas interpreter on any
    backend, for tests.

    Returns ``(y (B, n), status (B,), nsteps (B,), nfev (B,))`` with the
    status codes of :class:`extensisq_tpu.Solution`.
    """
    if method is None:
        from ..methods import BS5 as method
    if method.family != "erk":
        raise ValueError(
            f"solve_fused_erk takes explicit Runge-Kutta pairs "
            f"(family 'erk'), not {method.name} ({method.family!r})")
    tab = method.tableau
    bm = int(block_members)
    if bm < 1 or bm & (bm - 1):
        raise ValueError("block_members must be a power of two")

    y0_batch = jnp.asarray(y0_batch)
    if not jnp.issubdtype(y0_batch.dtype, jnp.floating):
        y0_batch = y0_batch.astype(jnp.float64)
    dtype = y0_batch.dtype
    if y0_batch.ndim != 2:
        raise ValueError("y0_batch must be (B, n)")
    n_total, n = y0_batch.shape
    pad = (-n_total) % bm
    grid = (n_total + pad) // bm

    def rows_of(x):
        # (B, k) -> k padded member vectors; padding repeats the last
        # member so that padded lanes take its steps
        x = jnp.concatenate([x, jnp.repeat(x[-1:], pad, axis=0)]) \
            if pad else x
        return list(x.T)

    rows = rows_of(y0_batch)
    if params is not None:
        params = jnp.asarray(params, dtype)
        if params.ndim != 2 or params.shape[0] != n_total:
            raise ValueError("params must be (B, k)")
        rows += rows_of(params)
        n_par = params.shape[1]
    else:
        n_par = 0

    t0, tf = t_span
    t0 = jnp.asarray(t0, dtype)
    tf = jnp.asarray(tf, dtype)
    sgn = jnp.sign(tf - t0)
    direction = jnp.where(sgn == 0, 1.0, sgn).astype(dtype)
    # padded to 8 entries: a Triton block is a power of two
    scalars = jnp.stack([t0, tf, jnp.asarray(rtol, dtype),
                         jnp.asarray(atol, dtype), direction,
                         jnp.zeros((), dtype), jnp.zeros((), dtype),
                         jnp.zeros((), dtype)])

    err_order = min(tab.order_secondary, tab.order)
    cc = resolve_controller(None, tab.sc_params, -1.0 / (err_order + 1))
    finfo = np.finfo(dtype)
    # (h_min_a, h_min_b, tiny_err) as in ERKStepper; Python floats, so
    # that they do not promote a float32 kernel
    sqrt_tiny = float(np.sqrt(finfo.tiny))
    consts = (float(10.0 * finfo.epsneg / tab.c_spacing()), sqrt_tiny,
              sqrt_tiny)
    max_step = float(max_step)
    first_step = None if first_step is None else float(first_step)

    def kernel(sc_ref, *refs):
        in_refs, out_refs = refs[:n + n_par], refs[n + n_par:]
        y0 = [r[...] for r in in_refs[:n]]
        vec = lambda k: jnp.full((bm,), sc_ref[k], dtype)  # noqa: E731
        if n_par:
            p = tuple(r[...] for r in in_refs[n:])
            f = lambda t, y: fun(t, y, p)                   # noqa: E731
        else:
            f = fun
        c = _integrate_block(
            f, tab, cc, consts, max_steps, max_step, first_step,
            vec(0), vec(1), vec(4), vec(2), vec(3), y0)
        for r, v in zip(out_refs[:n], c.y):
            r[...] = v
        out_refs[n][...] = c.status
        out_refs[n + 1][...] = c.nsteps
        out_refs[n + 2][...] = c.nfev

    row = pl.BlockSpec((bm,), lambda i: (i,))
    n_pad = n_total + pad
    outs = pl.pallas_call(
        kernel,
        grid=(grid,),
        in_specs=[pl.BlockSpec((8,), lambda i: (0,))] + [row] * len(rows),
        out_specs=[row] * (n + 3),
        out_shape=([jax.ShapeDtypeStruct((n_pad,), dtype)] * n
                   + [jax.ShapeDtypeStruct((n_pad,), jnp.int32)] * 3),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=min(max(bm // 32, 1), 8), num_stages=1),
        interpret=interpret,
        name=f"fused_erk_{tab.name}",
    )(scalars, *rows)
    y = jnp.stack(outs[:n], axis=1)[:n_total]
    return (y,) + tuple(o[:n_total] for o in outs[n:])
