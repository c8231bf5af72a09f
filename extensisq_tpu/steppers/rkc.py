"""SSV2stab: stabilized second-order Runge-Kutta-Chebyshev stepper.

JAX-native rewrite of the reference's translation of netlib rkc.f
(/root/reference/extensisq/sommeijer.py).  The per-step stage count m
stretches the real-axis stability interval quadratically, making this
the method for large semi-discretized parabolic PDEs — exactly the
state vectors that shard across devices (SURVEY.md section 2.4).

Design:
* the Chebyshev three-term stage recurrence is a ``lax.fori_loop`` with
  a data-dependent trip count m (sommeijer.py:273-329);
* the nonlinear power iteration for the spectral radius is a bounded
  ``lax.while_loop`` (sommeijer.py:331-398) whose evaluations count in
  ``nfesig`` (not nfev), matching the reference's convention;
* the H220 dead-beat step controller (sommeijer.py:253-266) is
  where-masked; all diagnostics are status codes / counters in state.
"""
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .._config import RUNNING, FINISHED, TOO_SMALL_STEP, OVERFLOW, RHO_FAIL
from ..core.numerics import calculate_scale, norm, dtype_constants
from ..core.interpolate import hermite_cubic_coefficients


class RKCState(NamedTuple):
    t: Any
    y: Any                 # yn
    f: Any                 # fn = fun(t, yn)
    h_abs: Any             # negative sentinel = "not yet initialized"
    status: Any
    sprad: Any
    V: Any                 # eigenvector warm start for the power method
    newspc: Any            # bool: re-estimate spectral radius
    jacatt: Any            # bool: current spectral radius is up to date
    h_previous: Any        # previous signed h (0 = none)
    errold: Any
    nstsig: Any            # steps since last rho refresh (mod 25)
    mlim: Any              # consecutive steps at the m cap
    # last accepted step, for cubic Hermite dense output
    t_old: Any
    y_old: Any
    f_old: Any
    # counters
    nfev: Any
    nfesig: Any
    nsteps: Any
    nfailed: Any
    maxm: Any
    # derived limits (computed at init from t0/t_bound)
    max_step_eff: Any
    hmin0: Any


class RKCStepper:
    family = "rkc"

    def __init__(self, fun, n, dtype, options=None):
        self.fun = fun
        self.n = n
        self.dtype = np.dtype(dtype)
        if np.issubdtype(self.dtype, np.complexfloating):
            raise ValueError("SSV2stab does not support complex problems.")
        self.real_dtype = self.dtype
        consts = dtype_constants(self.dtype)
        self.uround = consts["uround"]
        self.sqrtu = np.sqrt(self.uround)
        self.sqrtmin = consts["sqrt_tiny"]
        self.sqrtmax = np.sqrt(np.finfo(self.dtype).max)
        opts = dict(options or {})
        self.const_jac = bool(opts.pop("const_jac", False))
        self.rho_jac = opts.pop("rho_jac", None)
        self.options = opts

    # -- spectral radius ----------------------------------------------------

    def _rho(self, t, yn, fn, V, max_step_eff):
        """Nonlinear power iteration (sommeijer.py:331-398).

        Returns (sprad, V_new, n_evals, converged).
        """
        small = 1.0 / max_step_eff
        ynrm = jnp.linalg.norm(yn)
        vnrm = jnp.linalg.norm(V)

        both = (ynrm != 0.0) & (vnrm != 0.0)
        only_y = (ynrm != 0.0) & (vnrm == 0.0)
        only_v = (ynrm == 0.0) & (vnrm != 0.0)
        dynrm = jnp.where(both | only_y, ynrm * self.sqrtu, self.uround)
        v0 = jnp.where(
            both, yn + V * (dynrm / jnp.where(vnrm == 0, 1.0, vnrm)),
            jnp.where(only_y, V * (1.0 + self.sqrtu),
                      jnp.where(only_v,
                                V * (dynrm / jnp.where(vnrm == 0, 1.0,
                                                       vnrm)),
                                jnp.full_like(V, dynrm))))

        itmax = 50

        def cond(c):
            i, v, sigma, sprad, done, nev = c
            return (~done) & (i < itmax)

        def body(c):
            i, v, sigma, sprad, done, nev = c
            fv = self.fun(t, v)
            nev = nev + 1
            dfnrm = jnp.linalg.norm(fv - fn)
            sigma_new = dfnrm / dynrm
            sprad_new = 1.2 * sigma_new
            conv = (i > 0) & (jnp.abs(sigma_new - sigma)
                              <= jnp.maximum(sigma_new, small) * 0.01)
            # next iterate: change in f scaled to dynrm, or a sign flip
            # of one component in the degenerate case
            v_next = jnp.where(
                dfnrm != 0.0,
                yn + (fv - fn) * (dynrm / jnp.where(dfnrm == 0.0, 1.0,
                                                    dfnrm)),
                v.at[jnp.mod(i, self.n)].multiply(-1.0))
            return (i + 1, jnp.where(conv, v, v_next), sigma_new,
                    jnp.where(conv, sprad_new, sprad), done | conv, nev)

        i, v, sigma, sprad, done, nev = jax.lax.while_loop(
            cond, body,
            (jnp.asarray(0, jnp.int32), v0, jnp.asarray(0.0, self.dtype),
             jnp.asarray(0.0, self.dtype), jnp.asarray(False),
             jnp.asarray(0, jnp.int32)))
        V_new = jnp.where(done, v - yn, V)
        return sprad, V_new, nev, done

    # -- construction --------------------------------------------------------

    def init(self, t0, y0, params, first_step=None):
        t0 = jnp.asarray(t0, self.dtype)
        y0 = jnp.asarray(y0, self.dtype)
        f0 = self.fun(t0, y0)

        max_step_eff = jnp.minimum(
            jnp.minimum(params.max_step, jnp.abs(params.t_bound - t0)),
            self.sqrtmax)
        hmin = jnp.abs(t0)
        hmin = jnp.maximum(hmin, jnp.abs(max_step_eff))
        hmin0 = jnp.maximum(self.sqrtmin, 10.0 * self.uround * hmin)

        h_abs = (jnp.asarray(-1.0, self.dtype) if first_step is None
                 else jnp.asarray(first_step, self.dtype))
        z = jnp.asarray(0.0, self.dtype)
        i0 = jnp.asarray(0, jnp.int32)
        return RKCState(
            t=t0, y=y0, f=f0, h_abs=h_abs,
            status=jnp.asarray(RUNNING, jnp.int32),
            sprad=z, V=f0 * 1.0, newspc=jnp.asarray(True),
            jacatt=jnp.asarray(False), h_previous=z, errold=jnp.asarray(1.0,
                                                                  self.dtype),
            nstsig=i0, mlim=i0,
            t_old=t0, y_old=y0, f_old=f0,
            nfev=jnp.asarray(1, jnp.int32), nfesig=i0, nsteps=i0,
            nfailed=i0, maxm=i0,
            max_step_eff=max_step_eff, hmin0=hmin0)

    # -- stages (sommeijer.py:273-329) ----------------------------------------

    def _stages(self, t, yn, fn, h, m):
        mf = m.astype(self.dtype)
        w0 = 1.0 + 2.0 / (13.0 * mf * mf)
        temp1 = w0 * w0 - 1.0
        temp2 = jnp.sqrt(temp1)
        arg = mf * jnp.log(w0 + temp2)
        sinh_a, cosh_a = jnp.sinh(arg), jnp.cosh(arg)
        w1 = sinh_a * temp1 / (cosh_a * mf * temp2 - w0 * sinh_a)
        bj0 = 1.0 / (2.0 * w0) ** 2

        mus0 = w1 * bj0
        carry0 = dict(
            yjm2=yn, yjm1=yn + h * mus0 * fn, y=yn,
            thjm2=jnp.asarray(0.0, self.dtype), thjm1=mus0,
            zjm2=jnp.asarray(1.0, self.dtype), zjm1=w0,
            dzjm2=jnp.asarray(0.0, self.dtype),
            dzjm1=jnp.asarray(1.0, self.dtype),
            d2zjm2=jnp.asarray(0.0, self.dtype),
            d2zjm1=jnp.asarray(0.0, self.dtype),
            bjm2=bj0, bjm1=bj0)

        def body(j, c):
            zj = 2.0 * w0 * c["zjm1"] - c["zjm2"]
            dzj = 2.0 * w0 * c["dzjm1"] - c["dzjm2"] + 2.0 * c["zjm1"]
            d2zj = 2.0 * w0 * c["d2zjm1"] - c["d2zjm2"] + 4.0 * c["dzjm1"]
            bj = d2zj / (dzj * dzj)
            ajm1 = 1.0 - c["zjm1"] * c["bjm1"]
            mu = 2.0 * w0 * bj / c["bjm1"]
            nu = -bj / c["bjm2"]
            mus = mu * w1 / w0

            fj = self.fun(t + h * c["thjm1"], c["yjm1"])
            yj = (mu * c["yjm1"] + nu * c["yjm2"]
                  + (1.0 - mu - nu) * yn + h * mus * (fj - ajm1 * fn))
            thj = mu * c["thjm1"] + nu * c["thjm2"] + mus * (1.0 - ajm1)

            return dict(
                yjm2=c["yjm1"], yjm1=yj, y=yj,
                thjm2=c["thjm1"], thjm1=thj,
                zjm2=c["zjm1"], zjm1=zj,
                dzjm2=c["dzjm1"], dzjm1=dzj,
                d2zjm2=c["d2zjm1"], d2zjm1=d2zj,
                bjm2=c["bjm1"], bjm1=bj)

        c = jax.lax.fori_loop(2, m + 1, body, carry0)
        return c["y"], m - 1          # m-1 RHS evals in the loop

    # -- one step --------------------------------------------------------------

    def step(self, params, state):
        t, yn, fn = state.t, state.y, state.f

        class Carry(NamedTuple):
            h_abs: Any
            sprad: Any
            V: Any
            newspc: Any
            jacatt: Any
            accepted: Any
            status: Any
            y_new: Any
            f_new: Any
            err: Any
            h_used: Any
            m_used: Any
            maxm: Any
            nfev: Any
            nfesig: Any
            nfailed: Any
            mlim: Any

        def attempt(c):
            # spectral radius refresh
            if self.rho_jac is not None:
                sprad = jnp.where(c.newspc,
                                  jnp.asarray(self.rho_jac(t, yn),
                                              self.dtype),
                                  c.sprad)
                V, nfesig, rho_ok = c.V, c.nfesig, jnp.asarray(True)
            else:
                def do_rho(_):
                    return self._rho(t, yn, fn, c.V, state.max_step_eff)

                def no_rho(_):
                    return (c.sprad, c.V, jnp.asarray(0, jnp.int32),
                            jnp.asarray(True))

                sprad, V, nev, rho_ok = jax.lax.cond(
                    c.newspc, do_rho, no_rho, operand=None)
                nfesig = c.nfesig + nev
            jacatt = jnp.where(c.newspc, True, c.jacatt)
            status = jnp.where(~rho_ok, jnp.asarray(RHO_FAIL, jnp.int32),
                               c.status)

            # initial step size on the very first attempt
            def init_absh(_):
                absh0 = jnp.where(sprad * state.max_step_eff > 1.0,
                                  1.0 / sprad, state.max_step_eff)
                absh0 = jnp.maximum(absh0, state.hmin0)
                vtemp1 = yn + absh0 * fn
                vtemp2 = self.fun(t + absh0, vtemp1)
                wt = params.atol + params.rtol * jnp.abs(yn) \
                    * jnp.ones_like(yn)
                est = absh0 * norm((vtemp2 - fn) / wt)
                absh1 = jnp.where(
                    0.1 * absh0 < state.max_step_eff * jnp.sqrt(est),
                    jnp.maximum(0.1 * absh0 / jnp.sqrt(est), state.hmin0),
                    state.max_step_eff)
                return absh1, jnp.asarray(1, jnp.int32)

            def keep_absh(_):
                return c.h_abs, jnp.asarray(0, jnp.int32)

            absh, ev0 = jax.lax.cond(c.h_abs < 0.0, init_absh, keep_absh,
                                     operand=None)
            nfev = c.nfev + ev0

            # stage count and the m cap (sommeijer.py:190-204)
            d = jnp.abs(params.t_bound - t)
            absh = jnp.where(1.1 * absh >= d, d, absh)
            m = 1 + jnp.sqrt(1.54 * absh * sprad + 1.0).astype(jnp.int32)
            mmax = jnp.maximum(
                jnp.round(jnp.sqrt(params.rtol / (10.0 * self.uround))),
                2.0).astype(jnp.int32)
            hit_cap = m > mmax
            m = jnp.where(hit_cap, mmax, m)
            absh = jnp.where(hit_cap,
                             (m.astype(self.dtype) ** 2 - 1.0)
                             / (1.54 * sprad), absh)
            mlim = jnp.where(hit_cap, c.mlim + 1, 0)

            h = params.direction * absh
            mf = m.astype(self.dtype)
            hmin = jnp.maximum(
                self.sqrtmin,
                13.3 * self.uround * (jnp.abs(t) + absh) * (mf * mf - 1.0))

            y, n_st = self._stages(t, yn, fn, h, m)
            f_new = self.fun(t + h, y)
            nfev = nfev + n_st + 1

            wt = calculate_scale(params.atol, params.rtol, y, yn)
            est = 0.8 * (yn - y) + 0.4 * h * (fn + f_new)
            err = norm(est / wt)

            accepted = err < 1.0
            bad = jnp.isnan(err) | jnp.isinf(err)
            absh_rej = 0.8 * absh / jnp.maximum(err, 1e-300) ** (1.0 / 3.0)
            too_small = (~accepted) & (absh_rej < hmin)
            status = jnp.where(
                bad, jnp.asarray(OVERFLOW, jnp.int32),
                jnp.where(too_small & (status == RUNNING),
                          jnp.asarray(TOO_SMALL_STEP, jnp.int32), status))

            return Carry(
                h_abs=jnp.where(accepted, absh, absh_rej),
                sprad=sprad, V=V,
                newspc=jnp.where(accepted, c.newspc, ~jacatt),
                jacatt=jacatt,
                accepted=accepted,
                status=status,
                y_new=jnp.where(accepted, y, c.y_new),
                f_new=jnp.where(accepted, f_new, c.f_new),
                err=jnp.where(accepted, err, c.err),
                h_used=jnp.where(accepted, h, c.h_used),
                m_used=jnp.where(accepted, m, c.m_used),
                # the reference records maxm on every ATTEMPT, rejected
                # ones included (sommeijer.py:204, inside the step loop)
                maxm=jnp.maximum(c.maxm, m),
                nfev=nfev, nfesig=nfesig,
                nfailed=c.nfailed + jnp.where(accepted, 0, 1),
                mlim=mlim)

        def cond_fn(c):
            return (~c.accepted) & (c.status == RUNNING)

        c0 = Carry(
            h_abs=state.h_abs, sprad=state.sprad, V=state.V,
            newspc=state.newspc, jacatt=state.jacatt,
            accepted=jnp.asarray(False), status=state.status,
            y_new=yn, f_new=fn, err=state.errold,
            h_used=jnp.zeros_like(state.h_previous),
            m_used=jnp.asarray(0, jnp.int32),
            maxm=state.maxm,
            nfev=state.nfev, nfesig=state.nfesig, nfailed=state.nfailed,
            mlim=state.mlim)
        c = jax.lax.while_loop(
            cond_fn, lambda cc: jax.lax.cond(cond_fn(cc), attempt,
                                             lambda x: x, cc), c0)
        ok = c.accepted

        d = jnp.abs(params.t_bound - t)
        is_last = ok & (jnp.abs(c.h_used) >= d)
        t_new = jnp.where(is_last, params.t_bound, t + c.h_used)
        status = jnp.where((c.status == RUNNING) & is_last,
                           jnp.asarray(FINISHED, jnp.int32), c.status)

        # post-acceptance bookkeeping (sommeijer.py:238-266)
        jacatt = jnp.where(ok, self.const_jac, c.jacatt)
        nstsig = jnp.where(ok, jnp.mod(state.nstsig + 1, 25), state.nstsig)
        refresh = (self.rho_jac is not None) | (nstsig == 0)
        newspc = jnp.where(ok, refresh & ~jacatt, c.newspc)

        # H220 dead-beat controller for the next step size
        err = c.err
        fac = jnp.asarray(10.0, self.dtype)
        t2_first = jnp.maximum(err, 1e-300) ** (1.0 / 3.0)
        fac_first = jnp.where(0.8 < fac * t2_first, 0.8 / t2_first, fac)
        temp1 = 0.8 * c.h_abs * jnp.maximum(state.errold,
                                            1e-300) ** (1.0 / 3.0)
        temp2 = jnp.abs(state.h_previous) * jnp.maximum(err,
                                                  1e-300) ** (2.0 / 3.0)
        fac_next = jnp.where(temp1 < fac * temp2,
                             temp1 / jnp.maximum(temp2, 1e-300), fac)
        fac = jnp.where(state.h_previous == 0.0, fac_first, fac_next)
        absh_new = jnp.maximum(0.1, fac) * c.h_abs
        mf = c.m_used.astype(self.dtype)
        hmin = jnp.maximum(
            self.sqrtmin,
            13.3 * self.uround * (jnp.abs(t) + c.h_abs) * (mf * mf - 1.0))
        absh_new = jnp.maximum(hmin, jnp.minimum(state.max_step_eff,
                                                 absh_new))

        return RKCState(
            t=jnp.where(ok, t_new, state.t),
            y=jnp.where(ok, c.y_new, state.y),
            f=jnp.where(ok, c.f_new, state.f),
            h_abs=jnp.where(ok, absh_new, c.h_abs),
            status=status,
            sprad=c.sprad, V=c.V,
            newspc=newspc, jacatt=jacatt,
            h_previous=jnp.where(ok, c.h_used, state.h_previous),
            errold=jnp.where(ok, err, state.errold),
            nstsig=nstsig,
            mlim=c.mlim,
            t_old=jnp.where(ok, t, state.t_old),
            y_old=jnp.where(ok, yn, state.y_old),
            f_old=jnp.where(ok, fn, state.f_old),
            nfev=c.nfev, nfesig=c.nfesig,
            nsteps=state.nsteps + jnp.where(ok, 1, 0),
            nfailed=c.nfailed,
            maxm=c.maxm,
            max_step_eff=state.max_step_eff, hmin0=state.hmin0)

    # -- flat (attempt-level) stepping for the device driver -------------------

    def flat_init_aux(self, state):
        return ()

    def step_flat(self, params, state, aux):
        """Exactly ONE step attempt (state advances when accepted).

        Semantically equivalent to :meth:`step`'s nested accept/reject
        loop; all attempt-to-attempt carry (h_abs, sprad, V, newspc,
        jacatt, counters) already lives in the state, so ``aux`` is
        empty.  Returns (state', aux, accepted).
        """
        t, yn, fn = state.t, state.y, state.f

        # spectral-radius refresh (sommeijer.py:174-189)
        if self.rho_jac is not None:
            sprad = jnp.where(state.newspc,
                              jnp.asarray(self.rho_jac(t, yn), self.dtype),
                              state.sprad)
            V, nfesig, rho_ok = state.V, state.nfesig, jnp.asarray(True)
        else:
            def do_rho(_):
                return self._rho(t, yn, fn, state.V, state.max_step_eff)

            def no_rho(_):
                return (state.sprad, state.V, jnp.asarray(0, jnp.int32),
                        jnp.asarray(True))

            sprad, V, nev, rho_ok = jax.lax.cond(
                state.newspc, do_rho, no_rho, operand=None)
            nfesig = state.nfesig + nev
        jacatt = jnp.where(state.newspc, True, state.jacatt)
        status = jnp.where(~rho_ok, jnp.asarray(RHO_FAIL, jnp.int32),
                           state.status)

        # initial step size on the very first attempt
        def init_absh(_):
            absh0 = jnp.where(sprad * state.max_step_eff > 1.0,
                              1.0 / sprad, state.max_step_eff)
            absh0 = jnp.maximum(absh0, state.hmin0)
            vtemp1 = yn + absh0 * fn
            vtemp2 = self.fun(t + absh0, vtemp1)
            wt = params.atol + params.rtol * jnp.abs(yn) \
                * jnp.ones_like(yn)
            est = absh0 * norm((vtemp2 - fn) / wt)
            absh1 = jnp.where(
                0.1 * absh0 < state.max_step_eff * jnp.sqrt(est),
                jnp.maximum(0.1 * absh0 / jnp.sqrt(est), state.hmin0),
                state.max_step_eff)
            return absh1, jnp.asarray(1, jnp.int32)

        def keep_absh(_):
            return state.h_abs, jnp.asarray(0, jnp.int32)

        absh, ev0 = jax.lax.cond(state.h_abs < 0.0, init_absh, keep_absh,
                                 operand=None)
        nfev = state.nfev + ev0

        # stage count and the m cap (sommeijer.py:190-204)
        d = jnp.abs(params.t_bound - t)
        absh = jnp.where(1.1 * absh >= d, d, absh)
        m = 1 + jnp.sqrt(1.54 * absh * sprad + 1.0).astype(jnp.int32)
        mmax = jnp.maximum(
            jnp.round(jnp.sqrt(params.rtol / (10.0 * self.uround))),
            2.0).astype(jnp.int32)
        hit_cap = m > mmax
        m = jnp.where(hit_cap, mmax, m)
        absh = jnp.where(hit_cap,
                         (m.astype(self.dtype) ** 2 - 1.0)
                         / (1.54 * sprad), absh)
        mlim = jnp.where(hit_cap, state.mlim + 1, 0)

        h = params.direction * absh
        mf = m.astype(self.dtype)
        hmin = jnp.maximum(
            self.sqrtmin,
            13.3 * self.uround * (jnp.abs(t) + absh) * (mf * mf - 1.0))

        y, n_st = self._stages(t, yn, fn, h, m)
        f_new = self.fun(t + h, y)
        nfev = nfev + n_st + 1

        wt = calculate_scale(params.atol, params.rtol, y, yn)
        est = 0.8 * (yn - y) + 0.4 * h * (fn + f_new)
        err = norm(est / wt)

        accepted = err < 1.0
        bad = jnp.isnan(err) | jnp.isinf(err)
        absh_rej = 0.8 * absh / jnp.maximum(err, 1e-300) ** (1.0 / 3.0)
        too_small = (~accepted) & (absh_rej < hmin)
        status = jnp.where(
            bad, jnp.asarray(OVERFLOW, jnp.int32),
            jnp.where(too_small & (status == RUNNING),
                      jnp.asarray(TOO_SMALL_STEP, jnp.int32), status))
        ok = accepted & ~bad

        is_last = ok & (absh >= d)
        t_new = jnp.where(is_last, params.t_bound, t + h)
        status = jnp.where((status == RUNNING) & is_last,
                           jnp.asarray(FINISHED, jnp.int32), status)

        # post-acceptance bookkeeping (sommeijer.py:238-266)
        jacatt_acc = jnp.asarray(self.const_jac)
        nstsig = jnp.where(ok, jnp.mod(state.nstsig + 1, 25),
                           state.nstsig)
        refresh = (self.rho_jac is not None) | (nstsig == 0)
        newspc = jnp.where(ok, refresh & ~jacatt_acc, ~jacatt)

        # H220 dead-beat controller for the next step size
        fac = jnp.asarray(10.0, self.dtype)
        t2_first = jnp.maximum(err, 1e-300) ** (1.0 / 3.0)
        fac_first = jnp.where(0.8 < fac * t2_first, 0.8 / t2_first, fac)
        temp1 = 0.8 * absh * jnp.maximum(state.errold,
                                         1e-300) ** (1.0 / 3.0)
        temp2 = jnp.abs(state.h_previous) * jnp.maximum(err,
                                                  1e-300) ** (2.0 / 3.0)
        fac_next = jnp.where(temp1 < fac * temp2,
                             temp1 / jnp.maximum(temp2, 1e-300), fac)
        fac = jnp.where(state.h_previous == 0.0, fac_first, fac_next)
        absh_acc = jnp.maximum(0.1, fac) * absh
        absh_acc = jnp.maximum(hmin, jnp.minimum(state.max_step_eff,
                                                 absh_acc))

        new_state = RKCState(
            t=jnp.where(ok, t_new, state.t),
            y=jnp.where(ok, y, state.y),
            f=jnp.where(ok, f_new, state.f),
            h_abs=jnp.where(ok, absh_acc, absh_rej),
            status=status,
            sprad=sprad, V=V,
            newspc=newspc,
            jacatt=jnp.where(ok, jacatt_acc, jacatt),
            h_previous=jnp.where(ok, h, state.h_previous),
            errold=jnp.where(ok, err, state.errold),
            nstsig=nstsig,
            mlim=mlim,
            t_old=jnp.where(ok, t, state.t_old),
            y_old=jnp.where(ok, yn, state.y_old),
            f_old=jnp.where(ok, fn, state.f_old),
            nfev=nfev, nfesig=nfesig,
            nsteps=state.nsteps + jnp.where(ok, 1, 0),
            nfailed=state.nfailed + jnp.where(ok, 0, 1),
            # maxm counts rejected attempts too (sommeijer.py:204)
            maxm=jnp.maximum(state.maxm, m),
            max_step_eff=state.max_step_eff, hmin0=state.hmin0)
        return new_state, aux, ok

    # -- dense output ------------------------------------------------------------

    def record_coefficients(self, state):
        h = state.t - state.t_old
        return hermite_cubic_coefficients(h, state.y_old, state.y,
                                          state.f_old, state.f)

    def dense_segments(self, state, interpolant=None):
        h = state.t - state.t_old
        Q = hermite_cubic_coefficients(h, state.y_old, state.y,
                                       state.f_old, state.f)
        return [(state.t_old, h, state.y_old, Q)], 0
