"""SWAG: variable-order Adams-Bashforth-Moulton PECE stepper.

JAX-native rewrite of the reference's SLATEC DDEABM/dsteps.f translation
(/root/reference/extensisq/shampine.py:99-480).  The dsteps machinery is
the most state-entangled code in the reference: variable order k <= 12,
scaled divided differences ``phi``, and coefficient recurrences over
index ranges [ns-1, k) that change every step.

Here every array has the static shape of its k_max bound and the
dynamic index ranges become masks: vectorized recurrences (psi/alpha/
beta/sig) are masked cumprods, the sequential v/w/g recurrences are
``lax.fori_loop``s over the static bound with per-iteration activity
masks.  That makes the whole stepper one jittable pure function —
variable order included — so Adams ensembles vmap like everything else.

The small helpers below (int32-expanded masks, boolean-algebra selects,
unrolled cumprod/cumsum, one-hot take/put) were first written so that
the stepper could be traced inside a kernel that lowered neither bool
broadcasts nor gathers.  They are value-identical to the plain jnp
forms and fuse well under XLA, so they stayed.
"""
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .._config import (RUNNING, FINISHED, TOO_SMALL_STEP, TOL_TOO_TIGHT)
from ..core.hstart import h_start
from ..core.numerics import (calculate_scale, norm, dtype_constants,
                             einsum)

K_MAX_LIMIT = 12

# Adams error constants (dsteps gstr) and the doubling thresholds
_GSTR = np.array([0.5, 0.0833, 0.0417, 0.0264, 0.0188, 0.0143, 0.0114,
                  0.00936, 0.00789, 0.00679, 0.00592, 0.00524, 0.00468])


def _mask2(mask, n):
    """(rows,) bool mask -> (rows, n) bool via int32 (value-identical
    to ``mask[:, None]`` broadcast)."""
    return (mask.astype(jnp.int32)[:, None]
            + jnp.zeros((1, n), jnp.int32)) != 0


def _where(c, a, b):
    """``jnp.where`` with the condition expanded through int32 to the
    full output shape, and bool-valued selects routed through boolean
    algebra.  Value-identical to jnp.where everywhere."""
    a_arr = jnp.asarray(a)
    b_arr = jnp.asarray(b)
    shp = jnp.broadcast_shapes(jnp.shape(c), a_arr.shape, b_arr.shape)
    if jnp.shape(c) != shp:
        c = (jnp.asarray(c).astype(jnp.int32)
             + jnp.zeros(shp, jnp.int32)) != 0
    if a_arr.dtype == jnp.bool_ or b_arr.dtype == jnp.bool_:
        return _bwhere(c, a_arr, b_arr)
    return jnp.where(c, a, b)


def _band(*ms):
    """Elementwise AND of bool masks with MIXED shapes; broadcasting
    happens in int32."""
    shp = jnp.broadcast_shapes(*[jnp.shape(m) for m in ms])
    acc = None
    for m in ms:
        mi = jnp.asarray(m).astype(jnp.int32)
        acc = mi if acc is None else acc * mi
    return (acc + jnp.zeros(shp, jnp.int32)) != 0


def _bwhere(c, a, b):
    """``jnp.where`` for BOOL operands as pure boolean algebra.

    (c & a) | (~c & b) is value-identical and made of plain mask
    ops."""
    a = jnp.asarray(a, bool)
    b = jnp.asarray(b, bool)
    return (c & a) | (~c & b)


def _cumprod(x):
    """Sequential cumulative product along the leading axis, unrolled.

    The leading axis is the tiny static k_max bound; unrolling gives a
    deterministic sequential evaluation order (jnp.cumprod may lower to
    a log-step scan) from plain multiplies and static slices (jnp.split
    rather than row indexing, so no gathers)."""
    parts = jnp.split(x, x.shape[0], axis=0)       # (1, ...) slices
    rows = [parts[0]]
    for i in range(1, len(parts)):
        rows.append(rows[-1] * parts[i])
    return jnp.concatenate(rows, axis=0)


def _cumsum_rev(x):
    """Reverse cumulative sum along the leading axis, unrolled
    (jnp.cumsum(x[::-1], 0)[::-1] with sequential order)."""
    parts = jnp.split(x, x.shape[0], axis=0)
    rows = [None] * len(parts)
    acc = parts[-1]
    rows[-1] = acc
    for i in range(len(parts) - 2, -1, -1):
        acc = acc + parts[i]
        rows[i] = acc
    return jnp.concatenate(rows, axis=0)


def _take(arr, i):
    """``arr[i]`` for a traced scalar index as a one-hot masked sum.

    Dynamic-slice gathers break XLA fusion and dominate the dispatch
    count of the Adams step body; a masked sum of one element plus
    exact zeros is arithmetic-identical and fuses.  ``i`` must already
    be clipped into range.
    """
    idx = jnp.arange(arr.shape[0])
    if arr.ndim == 1:
        # anchor the mask on arr's VALUES so a STATIC index still
        # yields a batched i32-expanded mask under vmap (zeros_like is
        # constant-folded by the batching rule; x.astype(i32)*0 is not,
        # and saturating float->int conversion makes inf/nan safe)
        m = ((idx == i).astype(jnp.int32)
             + arr.astype(jnp.int32) * 0) != 0
        return jnp.sum(jnp.where(m, arr, 0))
    return jnp.sum(jnp.where(_mask2(idx == i, arr.shape[1]), arr, 0),
                   axis=0)


def _put(arr, i, val):
    """``arr.at[i].set(val)`` for a traced scalar index as a where."""
    idx = jnp.arange(arr.shape[0])
    if arr.ndim == 1:
        m = ((idx == i).astype(jnp.int32)
             + arr.astype(jnp.int32) * 0) != 0
        return jnp.where(m, val, arr)
    return jnp.where(_mask2(idx == i, arr.shape[1]), val, arr)


class AdamsState(NamedTuple):
    t: Any
    y: Any
    yp: Any
    h: Any                  # signed current step proposal
    hold: Any
    wt: Any                 # (n,) error weights, updated each step
    k: Any                  # current order
    kold: Any
    kprev: Any
    ns: Any                 # steps taken at this h
    phase1: Any             # bool: initial order-raising phase
    ivc: Any
    kgi: Any
    iv: Any                 # (k_max-2,) int32
    gi: Any                 # (k_max-1,)
    phi: Any                # (k_max+2, n) scaled divided differences
    psi: Any                # (k_max,)
    alpha: Any              # (k_max,)
    beta: Any               # (k_max,)
    sig: Any                # (k_max+1,)
    v: Any                  # (k_max,)
    w: Any                  # (k_max,)
    g: Any                  # (k_max+1,)
    status: Any
    extrapolated: Any       # bool: last step was a linear extrapolation
    kle4: Any               # consecutive low-order steps (stiffness hint)
    stiff_flag: Any         # bool diagnostic (vmap-safe "warning")
    t_old: Any
    y_old: Any
    yp_old: Any
    h_previous: Any
    nfev: Any
    nsteps: Any
    nfailed: Any


class _Carry(NamedTuple):
    h: Any
    k: Any
    ns: Any
    kprev: Any
    ifail: Any
    phase1: Any
    phi: Any
    psi: Any
    alpha: Any
    beta: Any
    sig: Any
    v: Any
    w: Any
    g: Any
    gi: Any
    iv: Any
    ivc: Any
    kgi: Any
    success: Any
    status: Any
    p: Any                 # predicted solution
    yp_pred: Any
    wt: Any
    erk: Any
    erkm1: Any
    erkm2: Any
    knew: Any
    nfev: Any
    nfailed: Any


class AdamsStepper:
    family = "adams"

    def __init__(self, fun, n, dtype, options=None):
        self.fun = fun
        self.n = n
        self.dtype = np.dtype(dtype)
        self.real_dtype = np.finfo(self.dtype).dtype
        consts = dtype_constants(self.real_dtype)
        small = consts["uround"]
        self.twou = 2.0 * small
        self.fouru = 4.0 * small
        opts = dict(options or {})
        k_max = int(opts.pop("k_max", 12))
        if not (0 < k_max < 13):
            raise ValueError(
                "`k_max` should be an integer between 1 and 12.")
        self.k_max = k_max
        self.options = opts
        km = k_max
        self.iq = np.arange(1, km + 2, dtype=float)
        self.iqq = 1.0 / (self.iq * (self.iq + 1.0))
        self.gstr = _GSTR
        self.two = 2.0 ** np.arange(1, km + 3)   # two[k] = 2^(k+1)
        self.eps = 1.0
        self.p5eps = 0.5

    # -- construction --------------------------------------------------------

    def init(self, t0, y0, params, first_step=None):
        t0 = jnp.asarray(t0, self.real_dtype)
        y0 = jnp.asarray(y0, self.dtype)
        yp0 = self.fun(t0, y0)
        nfev = 1
        if first_step is None:
            b = t0 + params.direction * jnp.minimum(
                jnp.abs(params.t_bound - t0), params.max_step)
            h = h_start(self.fun, t0, b, y0, yp0, 1, params.rtol,
                        params.atol)
            nfev += 1 + min(self.n + 1, 3)
        else:
            h = jnp.asarray(first_step, self.real_dtype) * params.direction
        km = self.k_max
        wt = calculate_scale(params.atol, params.rtol, y0, y0 - h * yp0)

        phi = jnp.zeros((km + 2, self.n), self.dtype)
        phi = phi.at[0].set(yp0)
        g = jnp.zeros((km + 1,), self.real_dtype)
        g = g.at[0].set(1.0).at[1].set(0.5)
        sig = jnp.zeros((km + 1,), self.real_dtype).at[0].set(1.0)
        z = jnp.asarray(0.0, self.real_dtype)
        i0 = jnp.asarray(0, jnp.int32)
        return AdamsState(
            t=t0, y=y0, yp=yp0, h=h, hold=z, wt=wt,
            k=jnp.asarray(1, jnp.int32), kold=i0, kprev=i0, ns=i0,
            phase1=jnp.asarray(True), ivc=i0, kgi=i0,
            iv=jnp.zeros((max(km - 2, 1),), jnp.int32),
            gi=jnp.zeros((km - 1,), self.real_dtype),
            phi=phi,
            psi=jnp.zeros((km,), self.real_dtype),
            alpha=jnp.zeros((km,), self.real_dtype),
            beta=jnp.zeros((km,), self.real_dtype),
            sig=sig,
            v=jnp.zeros((km,), self.real_dtype),
            w=jnp.zeros((km,), self.real_dtype),
            g=g,
            status=jnp.asarray(RUNNING, jnp.int32),
            extrapolated=jnp.asarray(False),
            kle4=i0, stiff_flag=jnp.asarray(False),
            t_old=t0, y_old=y0, yp_old=yp0, h_previous=z,
            nfev=jnp.asarray(nfev, jnp.int32), nsteps=i0, nfailed=i0)

    # -- block 1: coefficient recurrences (shampine.py:246-317) ---------------

    def _coefficients(self, c, h, kold):
        km = self.k_max
        idx = jnp.arange(km)
        k, ns = c.k, c.ns
        kp1, km1 = k + 1, k - 1
        nsm1 = ns - 1

        recompute = k >= ns

        psi_old = c.psi
        # psi[nsm1] = h*ns ; psi[i] = h + psi_old[i-1] for i in [ns, k)
        psi_shift = jnp.concatenate([jnp.zeros(1, psi_old.dtype),
                                     psi_old[:-1]])
        psi = _where(idx == nsm1, h * ns,
                        _where((idx >= ns) & (idx < k),
                                  h + psi_shift, psi_old))
        psi = _where(recompute, psi, psi_old)

        alpha = _where(idx == nsm1, 1.0 / ns,
                          _where((idx >= ns) & (idx < k),
                                    h / _where(psi == 0, 1.0, psi),
                                    c.alpha))
        alpha = _where(recompute, alpha, c.alpha)

        # beta[i] = prod_{j=ns..i} psi[j-1]/psi_old[j-1]
        ratio = _where((idx >= ns) & (idx < k),
                          psi_shift * 0.0
                          + jnp.concatenate([jnp.ones(1, psi.dtype),
                                             psi[:-1]])
                          / _where(psi_shift == 0, 1.0, psi_shift),
                          1.0)
        beta = _where(idx == nsm1, 1.0,
                         _where((idx >= ns) & (idx < k),
                                   _cumprod(ratio), c.beta))
        beta = _where(recompute, beta, c.beta)

        # sig[j+1] = sig[nsm1-ish base] * prod_{i=nsm1..j} (i+1)*alpha[i]
        factor = _where((idx >= nsm1) & (idx < k),
                           jnp.asarray(self.iq[:km]) * alpha, 1.0)
        cp = _cumprod(factor)
        s_base = _take(c.sig, jnp.clip(nsm1, 0, km))
        s_base = _where(nsm1 == 0, 1.0, s_base)
        sig_tail = s_base * cp                      # value for index j+1
        midx = jnp.arange(km + 1)
        # sig_tail[clip(midx-1)] for midx = 0..km is the static
        # shift [sig_tail[0], sig_tail[0:km]]
        sig_tail_sh = jnp.concatenate([sig_tail[:1], sig_tail[:km]])
        sig = _where(_band(midx >= ns, midx <= k, recompute),
                        sig_tail_sh, c.sig)

        # ---- v, w, g ----
        iqq = jnp.asarray(self.iqq[:km])
        v, w, gi, iv = c.v, c.w, c.gi, c.iv
        ivc, kgi = c.ivc, c.kgi
        g = c.g

        first_ns = ns == 1

        # ns == 1 branch (shampine.py:275-280)
        v1 = _where(idx < k, iqq, v)
        w1 = v1
        ivc1 = jnp.asarray(0, jnp.int32)
        kgi1 = _where(k != 1, 1, 0).astype(jnp.int32)
        gi1 = _where(_band(jnp.arange(km - 1) == 0, k != 1), w1[1], gi)

        # ns > 1 branch (shampine.py:282-309)
        raised = k > c.kprev
        use_iv = raised & (ivc != 0)
        ivc2 = _where(raised, _where(use_iv, ivc - 1, ivc), ivc)
        jv = _where(use_iv,
                       kp1 - _take(iv, jnp.clip(ivc - 1, 0,
                                                iv.shape[0] - 1)),
                       1).astype(jnp.int32)
        # fresh diagonal entry when the order was raised without a
        # stored iv pointer
        fresh = raised & (ivc == 0)
        v2 = _where(_band(fresh, idx == km1),
                       _take(iqq, jnp.clip(km1, 0, km - 1)), v)
        w2 = _where(_band(fresh, idx == km1),
                       _take(v2, jnp.clip(km1, 0, km - 1)), w)
        kgi2 = _where(fresh & (k == 2), 1, kgi).astype(jnp.int32)
        gi2 = _where(_band(jnp.arange(km - 1) == 0, fresh, k == 2),
                        w2[1], gi)

        # sequential diagonal update: j = jv .. nsm1-1 (shampine.py:295-299)
        # unrolled (km is static and small): straight-line vector code
        # for these tiny trip counts
        for j in range(km):
            active = raised & (j >= jv) & (j < nsm1)
            i = jnp.clip(km1 - j, 0, km - 1)
            v2_i = _take(v2, i)
            newval = v2_i - alpha[min(j, km - 1)] \
                * _take(v2, jnp.clip(i + 1, 0, km - 1))
            v2 = _put(v2, i, _where(active, newval, v2_i))
        w2 = _where(_band(raised,
                          idx >= jnp.maximum(km1 - nsm1 + 1, 0),
                          idx <= km1 - jv), v2, w2)
        cond_kgi = raised & (k == ns) & (jv < nsm1)
        kgi2 = _where(cond_kgi, nsm1, kgi2).astype(jnp.int32)
        gi2 = _where(_band(jnp.arange(km - 1)
                           == jnp.clip(nsm1 - 1, 0, km - 2),
                           cond_kgi), v2[1], gi2)

        # main v update and w copy (shampine.py:301-309)
        limit1 = kp1 - ns
        v_shift = jnp.concatenate([v2[1:], jnp.zeros(1, v2.dtype)])
        v2 = _where(idx < limit1,
                       v2 - _take(alpha, jnp.clip(nsm1, 0, km - 1))
                       * v_shift, v2)
        w2 = _where(idx < limit1 + 1, v2, w2)
        g2 = _put(g, jnp.clip(ns, 0, km), v2[0])
        kgi2 = _where(limit1 != 1, ns, kgi2).astype(jnp.int32)
        gi2 = _where(_band(jnp.arange(km - 1)
                           == jnp.clip(nsm1, 0, km - 2), limit1 != 1),
                        v2[1], gi2)
        lower = k < kold
        iv2 = _where(_band(jnp.arange(iv.shape[0])
                           == jnp.clip(ivc2, 0, iv.shape[0] - 1),
                           lower),
                        (limit1 + 2).astype(jnp.int32), iv)
        ivc3 = _where(lower, ivc2 + 1, ivc2).astype(jnp.int32)

        # select ns==1 vs ns>1 results
        v = _where(first_ns, v1, v2)
        w = _where(first_ns, w1, w2)
        gi = _where(first_ns, gi1, gi2)
        iv = _where(first_ns, iv, iv2)
        ivc = _where(first_ns, ivc1, ivc3)
        kgi = _where(first_ns, kgi1, kgi2)
        g = _where(first_ns, g, g2)

        # compute the g coefficients in w (shampine.py:311-316)
        for i in range(km):
            active = (i >= ns) & (i < k)
            limit2 = k - i
            w_shift = jnp.concatenate([w[1:], jnp.zeros(1, w.dtype)])
            w = _where(_band(idx < limit2, active),
                          w - alpha[min(i, km - 1)] * w_shift, w)
            # where-based static write instead of an .at[].set scatter;
            # arithmetic-identical
            g = _put(g, min(i + 1, km),
                     _where(active, w[0], g[min(i + 1, km)]))

        def keep(x_new, x_old):
            return _where(recompute, x_new, x_old)

        return (psi, alpha, beta, sig, keep(v, c.v), keep(w, c.w),
                keep(g, c.g), keep(gi, c.gi),
                _where(recompute, iv, c.iv),
                _where(recompute, ivc, c.ivc).astype(jnp.int32),
                _where(recompute, kgi, c.kgi).astype(jnp.int32))

    # -- one step --------------------------------------------------------------

    def _attempt(self, params, state, min_step, c):
        """One predict+error attempt (dsteps blocks 1-3,
        shampine.py:246-398); shared by step and step_flat."""
        km = self.k_max
        x0, y0 = state.t, state.y
        h, k = c.h, c.k
        kp1, km1, km2 = k + 1, k - 1, k - 2
        # ns counts steps taken at this h (shampine.py:251-256):
        # reset when h differs from the last successful step's h
        ns = _where(h != state.hold, jnp.asarray(0, jnp.int32),
                       c.ns)
        ns = _where(ns <= state.kold, ns + 1, ns)

        cc = c._replace(ns=ns)
        (psi, alpha, beta, sig, v, w, g, gi, iv, ivc, kgi) = \
            self._coefficients(cc, h, state.kold)

        # block 2: predict (shampine.py:320-364)
        idx_r = jnp.arange(km + 2)
        phi = c.phi
        # beta[clip(idx_r)] / g[clip(idx_r)] over idx_r = 0..km+1 are
        # static pad-with-last-entry extensions (fusable; the dynamic
        # gathers break XLA fusion)
        beta_ext = jnp.concatenate([beta, beta[km - 1:km],
                                    beta[km - 1:km]])
        g_ext = jnp.concatenate([g, g[km:km + 1]])
        phi = _where(_mask2((idx_r >= ns) & (idx_r < k),
                               phi.shape[1]),
                        phi * beta_ext[:, None], phi)
        phi_k = _take(phi, jnp.clip(k, 0, km + 1))
        phi = _put(phi, jnp.clip(kp1, 0, km + 1), phi_k)
        phi = _put(phi, jnp.clip(k, 0, km + 1), jnp.zeros_like(phi_k))
        gw = _where(idx_r < k, g_ext, 0.0)
        p = h * einsum("s,sn->n", gw.astype(self.real_dtype),
                           phi.astype(self.dtype)) + y0
        # reverse cumulative sum over rows < k
        masked = _where(_mask2(idx_r < k, phi.shape[1]), phi,
                           jnp.zeros_like(phi))
        rev = _cumsum_rev(masked)
        phi = _where(_mask2(idx_r < k, phi.shape[1]), rev, phi)

        x = x0 + h
        yp_pred = self.fun(x, p)
        nfev = c.nfev + 1

        wt = calculate_scale(params.atol, params.rtol, p, y0,
                             _mean=True)
        inv_wt = 1.0 / wt
        temp4 = yp_pred - phi[0]
        absh = jnp.abs(h)
        gstr = jnp.asarray(self.gstr)
        sigj = sig

        erk = absh * norm(temp4 * inv_wt)
        erkm1 = absh * norm((_take(phi, jnp.clip(km1, 0, km + 1))
                             + temp4) * inv_wt) \
            * _take(sigj, jnp.clip(km1, 0, km)) \
            * _take(gstr, jnp.clip(km2, 0, 12))
        erkm2 = absh * norm((_take(phi, jnp.clip(km2, 0, km + 1))
                             + temp4) * inv_wt) \
            * _take(sigj, jnp.clip(km2, 0, km)) \
            * _take(gstr, jnp.clip(km2 - 1, 0, 12))
        err = erk * (_take(g, jnp.clip(km1, 0, km))
                     - _take(g, jnp.clip(k, 0, km)))
        erk = erk * _take(sigj, jnp.clip(k, 0, km)) \
            * _take(gstr, jnp.clip(km1, 0, 12))

        knew = _where(
            (k > 2) & (jnp.maximum(erkm1, erkm2) < erk), km1,
            _where((k == 2) & (erkm1 < 0.5 * erk), km1, k))

        success = err <= self.eps

        # block 3: failure restore (shampine.py:369-398)
        phi_up = jnp.concatenate([phi[1:], phi[km + 1:km + 2]])
        phi_r = _where(_mask2(idx_r < k, phi.shape[1]),
                          phi - phi_up, phi)
        phi_r = _where(
            _mask2(idx_r < k, phi.shape[1]),
            phi_r / _where(beta_ext[:, None] == 0, 1.0,
                              beta_ext[:, None]), phi_r)
        psi_up = jnp.concatenate([psi[1:], psi[km - 1:km]])
        idx_k = jnp.arange(km)
        psi_r = _where(idx_k < km1, psi_up - h, psi)

        ifail = c.ifail + 1
        temp2 = _where((ifail >= 4) & (self.p5eps < 0.25 * erk),
                          jnp.sqrt(self.p5eps / erk), 0.5)
        knew_fail = _where(ifail >= 3, 1, knew).astype(jnp.int32)
        h_fail = h * temp2
        status = _where((~success)
                           & (jnp.abs(h_fail) < min_step),
                           jnp.asarray(TOO_SMALL_STEP, jnp.int32),
                           c.status)

        return _Carry(
            h=_where(success, h, h_fail),
            k=_where(success, k, knew_fail),
            # dsteps sets ns=0 on EVERY rejection (shampine.py:394);
            # relying on h != hold misses the h_fail == hold case
            # (rejected doubled step: 0.5*2*hold is bit-exact hold)
            ns=_where(success, ns, jnp.asarray(0, jnp.int32)),
            kprev=k,
            ifail=_where(success, c.ifail, ifail),
            phase1=_bwhere(success, c.phase1, False),
            phi=_where(success, phi, phi_r),
            psi=_where(success, psi, psi_r),
            alpha=alpha, beta=beta, sig=sig, v=v, w=w, g=g,
            gi=gi, iv=iv, ivc=ivc, kgi=kgi,
            success=success,
            status=status,
            p=_where(success, p, c.p),
            yp_pred=_where(success, yp_pred, c.yp_pred),
            wt=_where(success, wt, c.wt),
            erk=erk, erkm1=erkm1, erkm2=erkm2,
            knew=knew.astype(jnp.int32),
            nfev=nfev,
            nfailed=c.nfailed + _where(success, 0, 1))

    def step(self, params, state):
        x0, y0, yp0 = state.t, state.y, state.yp
        min_step = self.fouru * jnp.abs(x0)

        # stiffness hint (shampine.py:198-207)
        kle4 = _where(state.kold > 4, 0, state.kle4 + 1)
        stiff_flag = state.stiff_flag | ((kle4 > 50) & (self.k_max > 4))
        kle4 = _where(kle4 > 50, 0, kle4)

        d = params.t_bound - x0
        near_end = jnp.abs(d) <= min_step

        # --- normal path ---
        h_in = state.h
        h_in = _where(params.direction * (h_in - d) > 0, d, h_in)
        h_in = jnp.sign(h_in) * jnp.minimum(params.max_step,
                                            jnp.abs(h_in))

        round_ = self.twou * norm(y0 / state.wt)
        tol_tight = self.p5eps < round_

        def cond_fn(c):
            return (~c.success) & (c.status == RUNNING)

        def body_fn(c):
            return jax.lax.cond(
                cond_fn(c),
                lambda cc: self._attempt(params, state, min_step, cc),
                lambda x: x, c)

        c0 = _Carry(
            h=h_in, k=state.k, ns=state.ns, kprev=state.kprev,
            ifail=jnp.asarray(0, jnp.int32), phase1=state.phase1,
            phi=state.phi, psi=state.psi, alpha=state.alpha,
            beta=state.beta, sig=state.sig, v=state.v, w=state.w,
            g=state.g, gi=state.gi, iv=state.iv, ivc=state.ivc,
            kgi=state.kgi,
            success=near_end,        # skip the loop on extrapolation
            status=_where(
                tol_tight & ~near_end,
                jnp.asarray(TOL_TOO_TIGHT, jnp.int32),
                _where((jnp.abs(h_in) < min_step) & ~near_end,
                          jnp.asarray(TOO_SMALL_STEP, jnp.int32),
                          state.status)),
            p=y0, yp_pred=yp0, wt=state.wt,
            erk=jnp.asarray(0.0, self.real_dtype),
            erkm1=jnp.asarray(0.0, self.real_dtype),
            erkm2=jnp.asarray(0.0, self.real_dtype),
            knew=state.k, nfev=state.nfev, nfailed=state.nfailed)
        c = jax.lax.while_loop(cond_fn, body_fn, c0)
        return self._finalize(params, state, c, near_end, d, min_step,
                              kle4, stiff_flag, flat=False)

    def _finalize(self, params, state, c, near_end, d, min_step,
                  kle4, stiff_flag, flat):
        """Block 4 (correct, evaluate, order selection,
        shampine.py:402-468) plus the state writeback.

        ``flat``: the attempt-to-attempt carry persists through the
        state (step_flat), so rejected-attempt values (phi/psi restore,
        reduced h/k, ns) are written back instead of kept."""
        km = self.k_max
        x0, y0, yp0 = state.t, state.y, state.yp
        ok = c.success & ~near_end
        h, k = c.h, c.k
        kp1, km1 = k + 1, k - 1
        x = x0 + h
        g_k = _take(c.g, jnp.clip(k, 0, km))
        y_corr = h * g_k * (c.yp_pred - c.phi[0]) + c.p
        yp_new = jax.lax.cond(
            ok, lambda _: self.fun(x, y_corr), lambda _: yp0,
            operand=None)
        nfev = c.nfev + _where(ok, 1, 0)

        idx_r = jnp.arange(km + 2)
        phi = c.phi
        phi_k_new = yp_new - phi[0]
        phi = _put(phi, jnp.clip(k, 0, km + 1), phi_k_new)
        phi = _put(phi, jnp.clip(kp1, 0, km + 1),
                   phi_k_new - _take(phi, jnp.clip(kp1, 0, km + 1)))
        phi = _where(_mask2(idx_r < k, phi.shape[1]),
                        phi + phi_k_new[None, :],
                        phi)

        # order selection for the next step (shampine.py:420-455)
        phase1 = c.phase1 & ~((c.knew == km1) | (k == self.k_max))
        erkp1 = self.gstr[np.minimum(self.k_max, 12)] * 0.0
        erkp1 = _take(jnp.asarray(self.gstr), jnp.clip(k, 0, 12)) \
            * jnp.abs(h) * norm(_take(phi, jnp.clip(kp1, 0, km + 1))
                                / c.wt)
        can_est = (~phase1) & (c.knew != km1) & (k < c.ns)

        raise1 = (k == 1) & (erkp1 < 0.5 * c.erk) & (k < self.k_max)
        lower = (k != 1) & (c.erkm1 <= jnp.minimum(c.erk, erkp1))
        raise2 = (k != 1) & ~lower & ~((erkp1 > c.erk)
                                       | (k == self.k_max))

        k_next = _where(
            phase1, kp1,
            _where(c.knew == km1, km1,
                      _where(can_est & raise1, kp1,
                                _where(can_est & lower, km1,
                                          _where(can_est & raise2,
                                                    kp1, k)))))
        erk_next = _where(
            phase1, erkp1,
            _where(c.knew == km1, c.erkm1,
                      _where(can_est & raise1, erkp1,
                                _where(can_est & lower, c.erkm1,
                                          _where(can_est & raise2,
                                                    erkp1, c.erk)))))

        two_next = _take(jnp.asarray(self.two),
                         jnp.clip(k_next, 0, self.two.size - 1))
        double = phase1 | (self.p5eps >= erk_next * two_next)
        keep_h = self.p5eps >= erk_next
        r = (self.p5eps / jnp.maximum(erk_next, 1e-300)) \
            ** (1.0 / (k_next.astype(self.real_dtype) + 1.0))
        h_red = jnp.abs(h) * jnp.clip(r, 0.5, 0.9)
        h_red = jnp.sign(h) * jnp.maximum(h_red, min_step)
        h_next = _where(double, h + h, _where(keep_h, h, h_red))

        is_last = ok & (x == params.t_bound)
        # h was clamped to d upfront; landing detection via remaining gap
        is_last = ok & (jnp.abs(params.t_bound - x)
                        <= self.fouru * jnp.abs(x))
        t_new = _where(is_last, params.t_bound, x)

        # --- near-end linear extrapolation (shampine.py:209-217) ---
        y_ext = y0 + d * yp0

        ok_any = ok | near_end
        status = _where(
            (c.status == RUNNING) & (is_last | near_end),
            jnp.asarray(FINISHED, jnp.int32), c.status)

        # in flat mode a rejected attempt's restore (phi/psi back-out,
        # reduced h/k, ns) must persist through the state
        fb_phi = c.phi if flat else state.phi
        fb_psi = c.psi if flat else state.psi
        fb_alpha = c.alpha if flat else state.alpha
        fb_beta = c.beta if flat else state.beta
        fb_sig = c.sig if flat else state.sig
        fb_v = c.v if flat else state.v
        fb_w = c.w if flat else state.w
        fb_g = c.g if flat else state.g
        fb_ns = c.ns if flat else state.ns
        fb_kprev = c.kprev if flat else state.kprev

        return AdamsState(
            t=_where(near_end, params.t_bound,
                        _where(ok, t_new, state.t)),
            y=_where(near_end, y_ext, _where(ok, y_corr, state.y)),
            yp=_where(ok, yp_new, state.yp),
            h=_where(ok, h_next, _where(near_end, state.h, c.h)),
            hold=_where(ok, h, state.hold),
            wt=_where(ok, c.wt, state.wt),
            k=_where(ok, k_next, _where(near_end, state.k, c.k))
            .astype(jnp.int32),
            kold=_where(near_end, 0, _where(ok, k, state.kold))
            .astype(jnp.int32),
            kprev=_where(ok, c.kprev, fb_kprev).astype(jnp.int32),
            ns=_where(ok, c.ns, fb_ns).astype(jnp.int32),
            phase1=_bwhere(ok, phase1, c.phase1),
            ivc=c.ivc, kgi=c.kgi, iv=c.iv, gi=c.gi,
            phi=_where(ok, phi, fb_phi),
            psi=_where(ok, c.psi, fb_psi),
            alpha=_where(ok, c.alpha, fb_alpha),
            beta=_where(ok, c.beta, fb_beta),
            sig=_where(ok, c.sig, fb_sig),
            v=_where(ok, c.v, fb_v),
            w=_where(ok, c.w, fb_w),
            g=_where(ok, c.g, fb_g),
            status=status,
            extrapolated=near_end,
            kle4=kle4, stiff_flag=stiff_flag,
            t_old=_where(ok_any, x0, state.t_old),
            y_old=_where(ok_any, y0, state.y_old),
            yp_old=_where(ok_any, yp0, state.yp_old),
            h_previous=_where(near_end, d,
                                 _where(ok, h, state.h_previous)),
            nfev=nfev,
            nsteps=state.nsteps + _where(ok_any, 1, 0),
            nfailed=c.nfailed)

    # -- flat (attempt-level) stepping for the device driver -------------------

    def flat_init_aux(self, state):
        """(fresh_step, failures_this_step)."""
        return (jnp.asarray(True), jnp.asarray(0, jnp.int32))

    def step_flat(self, params, state, aux):
        """Exactly ONE predict+error attempt; state advances when it is
        accepted (or the near-end extrapolation fires).

        Semantically equivalent to :meth:`step`'s nested loop: per-STEP
        work (stiffness hint, end-of-interval clamp, tolerance check)
        runs only on a fresh step; a rejected attempt's restore
        (phi/psi back-out, reduced h and k, ns) persists through the
        state.  Returns (state', aux', accepted).
        """
        fresh, ifail = aux
        x0, y0 = state.t, state.y
        min_step = self.fouru * jnp.abs(x0)

        # stiffness hint (shampine.py:198-207), once per step
        kle4_f = _where(state.kold > 4, 0, state.kle4 + 1)
        stiff_f = state.stiff_flag | ((kle4_f > 50) & (self.k_max > 4))
        kle4_f = _where(kle4_f > 50, 0, kle4_f)
        kle4 = _where(fresh, kle4_f, state.kle4)
        stiff_flag = _bwhere(fresh, stiff_f, state.stiff_flag)

        d = params.t_bound - x0
        near_end = jnp.abs(d) <= min_step

        h_clamped = state.h
        h_clamped = _where(params.direction * (h_clamped - d) > 0,
                              d, h_clamped)
        h_clamped = jnp.sign(h_clamped) * jnp.minimum(
            params.max_step, jnp.abs(h_clamped))
        h_in = _where(fresh, h_clamped, state.h)

        round_ = self.twou * norm(y0 / state.wt)
        tol_tight = self.p5eps < round_

        status0 = _where(
            fresh & tol_tight & ~near_end,
            jnp.asarray(TOL_TOO_TIGHT, jnp.int32),
            _where(fresh & (jnp.abs(h_in) < min_step) & ~near_end,
                      jnp.asarray(TOO_SMALL_STEP, jnp.int32),
                      state.status))

        c0 = _Carry(
            h=h_in, k=state.k, ns=state.ns, kprev=state.kprev,
            ifail=_where(fresh, 0, ifail), phase1=state.phase1,
            phi=state.phi, psi=state.psi, alpha=state.alpha,
            beta=state.beta, sig=state.sig, v=state.v, w=state.w,
            g=state.g, gi=state.gi, iv=state.iv, ivc=state.ivc,
            kgi=state.kgi,
            success=near_end,        # extrapolation skips the attempt
            status=status0,
            p=y0, yp_pred=state.yp, wt=state.wt,
            erk=jnp.asarray(0.0, self.real_dtype),
            erkm1=jnp.asarray(0.0, self.real_dtype),
            erkm2=jnp.asarray(0.0, self.real_dtype),
            knew=state.k, nfev=state.nfev, nfailed=state.nfailed)

        # attempt + explicit per-leaf merge.  (lax.cond batches to a
        # select over the whole carry; the merge is value-identical and
        # routes bool leaves through boolean algebra.)
        do = (~c0.success) & (c0.status == RUNNING)
        c1 = self._attempt(params, state, min_step, c0)
        c = jax.tree.map(
            lambda a, b: (_bwhere(do, a, b)
                          if jnp.asarray(a).dtype == jnp.bool_
                          else _where(do, a, b)), c1, c0)

        new_state = self._finalize(params, state, c, near_end, d,
                                   min_step, kle4, stiff_flag, flat=True)
        accepted = c.success
        aux_new = (accepted | (new_state.status != RUNNING), c.ifail)
        return new_state, aux_new, accepted

    # -- dense output -----------------------------------------------------------

    def record_coefficients(self, state):
        from .adams_dense import dintp_coefficients
        return dintp_coefficients(self, state)

    def dense_segments(self, state, interpolant=None):
        Q = self.record_coefficients(state)
        return [(state.t_old, state.h_previous, state.y_old, Q)], 0
