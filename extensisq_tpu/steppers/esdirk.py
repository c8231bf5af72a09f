"""ESDIRK implicit stepper with index-1 DAE (mass matrix) support.

JAX-native redesign of the reference ESDIRK base class
(/root/reference/extensisq/common.py:1616-2255):

* modified-Newton stage solves are bounded ``lax.while_loop``s with the
  reference's convergence-rate tracking and early divergence exit
  (common.py:2183-2232);
* the Jacobian/LU reuse strategy (preemptive refresh from predicted
  rates, failure ladder: fresh J then h reduction; common.py:2063-2077,
  2110-2127) becomes per-state flags, so under vmap every ensemble
  member manages its own factorization staleness;
* dense LU is ``jax.scipy.linalg.lu_factor/lu_solve`` — batched getrf
  under vmap (replacing LAPACK/SuperLU, SURVEY.md 2.4 item 3);
* the Jacobian defaults to ``jax.jacfwd`` of the RHS (the reference
  finite-differences; autodiff replaces num_jac, SURVEY.md 2.3 note);
  with ``jac_sparsity`` it becomes a colored forward sweep — one JVP
  per column group (core/linalg.colored_jacfwd; the reference's
  group_columns+num_jac analog, common.py:1706-1754);
* constant-``jac`` linear-ODE fast path: refactor per h change, a
  single direct solve per stage (common.py:1966, 2203-2207);
* constant-mass-matrix DAE: host-side SVD splits differential/algebraic
  parts, algebraic rows rescaled by 1/(h d) (common.py:1778-1821,
  2038-2044); consistent ICs by damped Newton (common.py:1823-1920).
"""
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .._config import (RUNNING, FINISHED, TOO_SMALL_STEP, OVERFLOW,
                       NEWTON_MAXITER, MAX_RATE, MAX_FACTOR_NRF, MIN_FACTOR)
from ..core.controller import (resolve_controller, esdirk_accept_update,
                               reject_factor)
from ..core.hstart import h_start
from ..core.linalg import gauss_solve
from ..core.numerics import (calculate_scale, norm, dtype_constants,
                             matmul)


class ESDIRKState(NamedTuple):
    t: Any
    y: Any
    yp: Any                 # smoothed derivative (first stage of next step)
    h_abs: Any
    status: Any
    # controller
    standard_sc: Any
    error_norm_old: Any
    h_previous: Any
    max_factor: Any
    # Newton / linear algebra bookkeeping
    J: Any                  # (n, n) current Jacobian
    current_J: Any          # bool: J evaluated at the current (t, y)
    LU: Any                 # (n, n) packed LU factors
    piv: Any                # (n,) pivots
    LU_valid: Any           # bool
    h_LU: Any               # signed h the LU was built for
    Rate: Any               # max Newton rate of last step
    Niter: Any              # max Newton iterations of last step
    # last accepted step
    t_old: Any
    y_old: Any
    yp_old: Any
    K: Any                  # (n_stages, n)
    # counters
    nfev: Any
    njev: Any
    nlu: Any
    nls: Any                # linear solves (reference NLS)
    nfi: Any                # failed Newton iterations (reference NFI)
    nsteps: Any
    nfailed: Any


def _wsum(rows, w):
    acc = None
    for wi, r in zip(w, rows):
        if wi == 0.0:
            continue
        term = wi * r
        acc = term if acc is None else acc + term
    return jnp.zeros_like(rows[0]) if acc is None else acc


class _ECarry(NamedTuple):
    """Attempt-to-attempt carry of the accept/reject loop."""
    h_abs: Any
    h_used: Any
    accepted: Any
    rejected: Any
    status: Any
    standard_sc: Any
    max_factor: Any
    J: Any
    current_J: Any
    LU: Any
    piv: Any
    LU_valid: Any
    h_LU: Any
    Rate: Any
    Niter: Any
    y_new: Any
    error_norm: Any
    K: Any
    nfev: Any
    njev: Any
    nlu: Any
    nls: Any
    nfi: Any
    nfailed: Any


class ESDIRKStepper:
    family = "esdirk"

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
        # looser Newton/controller floor (common.py:1935)
        self.tiny_err = np.sqrt(n) * consts["eps"] ** 0.8 if n else 1e-12
        err_order = min(tableau.order_secondary, tableau.order)
        self.error_exponent = -1.0 / (err_order + 1)
        self.cc = resolve_controller(sc_params, tableau.sc_params,
                                     self.error_exponent, implicit=True)
        self.A = np.asarray(tableau.A)
        self.B = np.asarray(tableau.B)
        self.C = np.asarray(tableau.C)
        self.E = np.asarray(tableau.E)
        self.Az = np.asarray(tableau.Az)
        self.d = float(tableau.d)
        self.kappa = float(tableau.kappa)
        self.s = tableau.n_stages
        self.filter_error = tableau.filter_error
        opts = dict(options or {})
        self.jac_each_step = bool(opts.pop("jac_each_step", False))
        sparsity = opts.pop("jac_sparsity", None)
        jac = opts.pop("jac", None)
        M = opts.pop("M", None)
        bands = opts.pop("bands", None)
        self.options = opts

        # Banded mode: the reference scales large sparse systems by
        # switching its LU to SuperLU (common.py:1756-1776); here
        # ``bands=(kl, ku)`` (or ``bands=True`` with ``jac_sparsity``)
        # switches the Newton linear algebra to block-tridiagonal
        # cyclic reduction (core/banded.py) — O(n b^2) per solve in
        # log2(n/b) batched levels, full working precision.
        self.banded = bands is not None
        self.perm = None
        self.iperm = None
        if self.banded:
            from ..core import banded as _bd
            self._bd = _bd
            want_rcm = isinstance(bands, str) and bands == "rcm"
            if bands is True or want_rcm:
                if sparsity is None:
                    raise ValueError(
                        "bands=True requires jac_sparsity to derive "
                        "the bandwidths; pass bands=(kl, ku) directly "
                        "otherwise.")
                S = (sparsity.toarray()
                     if hasattr(sparsity, "toarray")
                     else np.asarray(sparsity))
                nat = _bd.bands_of_sparsity(S)
                if want_rcm:
                    # bandwidth-reducing reordering: irregular
                    # patterns ride the BCR after a host-side reverse
                    # Cuthill-McKee permutation (the device-native
                    # answer to the reference's any-sparsity splu,
                    # common.py:1756-1776).  The permutation is an
                    # internal linear-algebra detail: the RHS, states,
                    # outputs and counters all stay in user order.
                    p = _bd.rcm_order(S)
                    red = _bd.bands_of_sparsity(S[p][:, p])
                    if red[0] + red[1] < nat[0] + nat[1]:
                        self.perm = p
                        self.iperm = np.argsort(p)
                        bands = red
                    else:
                        bands = nat
                else:
                    bands = nat
            self.kl, self.ku = int(bands[0]), int(bands[1])
            if not (0 <= self.kl < n and 0 <= self.ku < n):
                raise ValueError(
                    f"bands=({self.kl}, {self.ku}) out of range for "
                    f"an {n}-state system.")
            # non-diagonal M rides banded mode when M itself is banded
            # and NONSINGULAR (FEM-style mass): W = M - h d J keeps the
            # union bandwidths.  Singular (hidden-M DAE) stays on the
            # dense path — its SVD rotation densifies a banded J
            # (cf. common.py:1778-1821).
            self._M_band = None
            if M is not None:
                Mp = np.asarray(
                    M.toarray() if hasattr(M, "toarray") else M,
                    dtype=float)
                if Mp.ndim == 2 and np.any(Mp != np.diag(np.diag(Mp))):
                    if self.perm is not None:
                        raise ValueError(
                            "bands='rcm' supports diagonal mass "
                            "matrices only; for banded non-diagonal M "
                            "pass bands=(kl, ku) in an order where "
                            "both J and M are banded.")
                    sv = np.linalg.svd(Mp, compute_uv=False)
                    if sv[-1] < sv[0] * n ** 2 * np.finfo(
                            self.real_dtype).eps:
                        raise ValueError(
                            "banded mode with a non-diagonal M "
                            "requires M nonsingular (the hidden-M DAE "
                            "rotation densifies a banded Jacobian; "
                            "use the dense path).")
                    klm, kum = _bd.bands_of_sparsity(Mp != 0)
                    self.kl = max(self.kl, int(klm))
                    self.ku = max(self.ku, int(kum))
                    self._M_band = np.asarray(_bd.banded_from_dense(
                        jnp.asarray(Mp), self.kl, self.ku))
            self._nbr = self.kl + self.ku + 1      # band rows

        # Jacobian setup (cf. _validate_jac, common.py:1706-1754)
        if jac is None:
            if self.banded:
                # banded coloring is exact with kl+ku+1 tangents and
                # scatters straight into banded storage
                if self.perm is not None:
                    # differentiate the PERMUTED map g(yp) =
                    # P f(P^T yp): its Jacobian P J P^T is the
                    # narrow-banded one; called with user-order y
                    p, ip = self.perm, self.iperm
                    g = (lambda t, yp:
                         jnp.asarray(fun(t, yp[ip]))[p])
                    bj = self._bd.banded_colored_jacfwd(
                        g, self.kl, self.ku, n, self.dtype)
                    self.jac = lambda t, y: bj(t, y[p])
                else:
                    self.jac = self._bd.banded_colored_jacfwd(
                        fun, self.kl, self.ku, n, self.dtype)
            elif sparsity is not None:
                # colored forward-mode: O(colors) JVPs instead of O(n)
                # (the reference's group_columns + num_jac FD analog)
                from ..core.linalg import colored_jacfwd
                self.jac = colored_jacfwd(fun, sparsity, n, self.dtype)
            else:
                self.jac = jax.jacfwd(fun, argnums=1,
                                      holomorphic=np.issubdtype(
                                          self.dtype,
                                          np.complexfloating))
            self.linear = False
        elif callable(jac):
            if self.banded:
                # a user jac may return dense (n, n) or banded
                # (kl+ku+1, n) storage; normalize to banded
                def _jac_banded(t, y, _jac=jac):
                    Jr = jnp.asarray(_jac(t, y), self.dtype)
                    if self.perm is not None:
                        if Jr.shape != (n, n):
                            raise ValueError(
                                "bands='rcm' requires jac to return "
                                "the dense (n, n) matrix: banded "
                                "storage would be in the internal "
                                "permuted order")
                        Jr = Jr[self.perm][:, self.perm]
                        return self._bd.banded_from_dense(
                            Jr, self.kl, self.ku)
                    if Jr.shape == (n, n):
                        return self._bd.banded_from_dense(
                            Jr, self.kl, self.ku)
                    if Jr.shape != (self._nbr, n):
                        raise ValueError(
                            f"banded jac must return ({n}, {n}) dense "
                            f"or ({self._nbr}, {n}) banded storage, "
                            f"got {Jr.shape}")
                    return Jr
                self.jac = _jac_banded
            else:
                self.jac = lambda t, y: jnp.asarray(jac(t, y), self.dtype)
            self.linear = False
        else:
            Jc = np.asarray(
                jac.toarray() if hasattr(jac, "toarray") else jac,
                dtype=self.dtype)
            if self.banded and Jc.shape == (n, n):
                if self.perm is not None:
                    Jc = Jc[self.perm][:, self.perm]
                Jc = np.asarray(self._bd.banded_from_dense(
                    jnp.asarray(Jc), self.kl, self.ku))
            expect = (self._nbr, n) if self.banded else (n, n)
            if Jc.shape != expect:
                raise ValueError(
                    f"`jac` is expected to have shape {expect}, but "
                    f"actually has {Jc.shape}.")
            self.J_const = Jc
            self.jac = None
            self.linear = True

        # Mass matrix / DAE setup (cf. _handle_M, common.py:1778-1821)
        self.isDAE = False
        self.mvec = None
        if M is None:
            self.M = None
        else:
            if hasattr(M, "toarray"):
                M = M.toarray()
            M = np.asarray(M, dtype=float)
            if M.ndim == 1:
                M = np.diag(M)
            if M.shape != (n, n):
                raise ValueError("M should have shape (n,) or (n, n)")
            self.M = M
            if self.banded and self._M_band is None:
                self.mvec = np.diag(M).copy()
            U, sv, Vh = np.linalg.svd(M)
            cond_lim = sv[0] * n ** 2 * np.finfo(self.real_dtype).eps
            nAE = int(np.sum(sv < cond_lim))
            self.isDAE = nAE > 0
            if self.isDAE:
                self.U, self.sv, self.Vh, self.nAE = U, sv, Vh, nAE
                if self.banded:
                    # for diagonal M the zero-singular-value subspace
                    # is axis-aligned, so U diag(sc) U^T collapses to
                    # a diagonal row scaling on exactly these rows
                    self.alg_mask = np.abs(self.mvec) < cond_lim

    # -- small helpers -------------------------------------------------------

    def _M_mul(self, z):
        if self.M is None:
            return z
        if self.banded:
            if self._M_band is not None:
                return self._bd.banded_matvec(
                    jnp.asarray(self._M_band, self.dtype), self.kl,
                    self.ku, z)
            return jnp.asarray(self.mvec, self.dtype) * z
        return matmul(jnp.asarray(self.M), z)

    def _sc_vec(self, h):
        """Diagonal of U diag(sc) U^T for diagonal M: the 1/(h d)
        rescale lands exactly on the algebraic (zero-mass) rows."""
        alg = jnp.asarray(self.alg_mask)
        return jnp.where(alg, 1.0 / (h * self.d),
                         jnp.ones((), self.real_dtype))

    def _Sc_mul(self, h, v):
        """Scale algebraic rows by 1/(h d): Sc = U diag(sc) U^T
        (common.py:2038-2044)."""
        if not self.isDAE:
            return v
        if self.banded:
            return self._sc_vec(h) * v
        U = jnp.asarray(self.U)
        sc = jnp.concatenate([
            jnp.ones(self.n - self.nAE, self.real_dtype),
            jnp.full((self.nAE,), 1.0, self.real_dtype) / (h * self.d)])
        return matmul(U, sc * matmul(U.T, v))

    def _factor(self, h, J):
        """LU of Sc (M - h d J)."""
        if self.banded:
            # J is (kl+ku+1, n) banded storage; M is diagonal or I.
            # In rcm mode J and W live in the PERMUTED order, so the
            # mass diagonal and DAE row scaling get permuted here too.
            W = -(h * self.d) * J
            if self._M_band is not None:
                W = W + jnp.asarray(self._M_band, self.dtype)
            else:
                mdiag = (jnp.ones((self.n,), self.dtype)
                         if self.M is None
                         else jnp.asarray(self.mvec, self.dtype))
                if self.perm is not None and self.M is not None:
                    mdiag = mdiag[self.perm]
                W = W.at[self.ku].add(mdiag)
            if self.isDAE:
                # row scaling in banded storage: entry (d, j) is
                # matrix row j + d - ku
                jj = np.arange(self.n)[None, :]
                row = np.clip(jj + np.arange(self._nbr)[:, None]
                              - self.ku, 0, self.n - 1)
                sc = self._sc_vec(h)
                if self.perm is not None:
                    sc = sc[self.perm]
                W = W * sc[row].astype(self.dtype)
            fact = self._bd.banded_factor(W, self.kl, self.ku, self.n)
            return fact, jnp.zeros((0,), jnp.int32)
        A = (jnp.eye(self.n, dtype=self.dtype) if self.M is None
             else jnp.asarray(self.M).astype(self.dtype))
        W = A - (h * self.d) * J
        if self.isDAE:
            U = jnp.asarray(self.U)
            sc = jnp.concatenate([
                jnp.ones(self.n - self.nAE, self.real_dtype),
                jnp.full((self.nAE,), 1.0, self.real_dtype)
                / (h * self.d)])
            W = matmul(U, sc[:, None] * matmul(U.T, W))
        lu, piv = jax.scipy.linalg.lu_factor(W)
        return lu, piv

    def _solve(self, LU, piv, b):
        if self.banded:
            if self.perm is not None:
                # (P W P^T)(P x) = P b: permute the rhs in, the
                # solution back out
                return self._bd.banded_solve(
                    LU, b[self.perm], self.n, self.kl,
                    self.ku)[self.iperm]
            return self._bd.banded_solve(LU, b, self.n, self.kl,
                                         self.ku)
        return jax.scipy.linalg.lu_solve((LU, piv), b)

    def _jac_dense(self):
        """A dense-J view of the (possibly banded) Jacobian for the
        one-time init/validation paths; the per-step Newton machinery
        never goes through this."""
        def _unperm(D):
            if self.perm is not None:
                return D[self.iperm][:, self.iperm]
            return D

        if self.jac is None:
            Jc = jnp.asarray(self.J_const)
            if self.banded:
                Jc = _unperm(self._bd.dense_from_banded(
                    Jc, self.kl, self.ku, self.n))
            return lambda t, y: Jc
        if self.banded:
            return lambda t, y: _unperm(self._bd.dense_from_banded(
                self.jac(t, y), self.kl, self.ku, self.n))
        return self.jac

    def validate_problem(self, fun_np, t0, y0):
        """Host-side DAE index check (common.py:1845-1853)."""
        if not self.isDAE:
            return
        if self.jac is not None or self.banded:
            J = np.asarray(self._jac_dense()(jnp.asarray(t0),
                                             jnp.asarray(y0)))
        else:
            J = np.asarray(self.J_const)
        G = self.U.T @ J @ self.Vh.T
        Gvv = G[self.n - self.nAE:, self.n - self.nAE:]
        if np.linalg.matrix_rank(Gvv) != Gvv.shape[1]:
            raise ValueError(
                "The index of the DAE seems to be larger than 1."
                " This method is not suitable for solving it.")

    # -- DAE consistent initial conditions (host/device hybrid) --------------

    def consistent_ics(self, t0, y0, params):
        """Project y0 onto the constraint manifold and compute a
        consistent derivative (common.py:1823-1920).  Pure jax (bounded
        Newton), so it also works under vmap; the index-1 check is a
        host-side probe in the driver."""
        U = jnp.asarray(self.U)
        Vh = jnp.asarray(self.Vh)
        sv = jnp.asarray(self.sv)
        nd = self.n - self.nAE

        jac = self._jac_dense()

        f0 = self.fun(t0, y0)
        z0 = matmul(Vh, y0)
        u = z0[:nd]

        def G(t, y):
            return matmul(matmul(U.T, jac(t, y)), Vh.T)

        def newton_body(i, carry):
            v, _ = carry
            y = matmul(Vh.T, jnp.concatenate([u, v]))
            gv = matmul(U.T, self.fun(t0, y))[nd:]
            Gvv = G(t0, y)[nd:, nd:]
            dv = gauss_solve(Gvv, gv)
            return v - dv, jnp.max(jnp.abs(dv))

        v0 = z0[nd:]
        v, dvn = jax.lax.fori_loop(0, 10, newton_body,
                                   (v0, jnp.asarray(jnp.inf)))
        y = matmul(Vh.T, jnp.concatenate([u, v]))
        f = self.fun(t0, y)
        J = jac(t0, y)

        # consistent derivative from df/dt and the constraint
        b = t0 + params.direction * jnp.minimum(
            jnp.abs(params.t_bound - t0), params.max_step)
        fdot = h_start(self.fun, t0, b, y, f, None, params.rtol,
                       params.atol, returnT=True)
        gdot = matmul(U.T, fdot)
        g = matmul(U.T, f)
        Gm = matmul(matmul(U.T, J), Vh.T)
        Guu, Guv = Gm[:nd, :nd], Gm[:nd, nd:]
        Gvu, Gvv = Gm[nd:, :nd], Gm[nd:, nd:]
        udot = g[:nd] / sv[:nd]
        vdot = -gauss_solve(Gvv, gdot[nd:] + matmul(Gvu, udot))
        ydot = matmul(Vh.T, jnp.concatenate([udot, vdot]))
        # reduced ODE data for h_start (common.py:1913-1916)
        S = matmul(Guv, gauss_solve(Gvv, Gvu))
        Tr = (gdot[:nd] + matmul(Guv, vdot)) / sv[:nd]
        Jr = (Guu + S) / sv[:nd, None]
        return y, ydot, J, {"y": u, "yprime": udot, "J": Jr, "T": Tr}

    # -- construction ---------------------------------------------------------

    def init(self, t0, y0, params, first_step=None):
        t0 = jnp.asarray(t0, self.real_dtype)
        y0 = jnp.asarray(y0, self.dtype)
        f0 = self.fun(t0, y0)
        nfev = 1
        njev = 0

        if self.isDAE:
            y0, yp0, J, hs_kwargs = self.consistent_ics(t0, y0, params)
            njev += 1
            if self.banded:
                J = self._bd.banded_from_dense(J, self.kl, self.ku)
            if first_step is None:
                h_abs = jnp.abs(h_start(
                    self.fun, t0,
                    t0 + params.direction * jnp.minimum(
                        jnp.abs(params.t_bound - t0), params.max_step),
                    morder=min(self.tab.order_secondary, self.tab.order),
                    rtol=params.rtol, atol=params.atol, **hs_kwargs))
            else:
                h_abs = jnp.asarray(first_step, self.real_dtype)
        else:
            if self.M is None:
                yp0 = f0
                fun_ext = self.fun
            elif self.banded:
                if self._M_band is not None:
                    MB = jnp.asarray(self._M_band, self.dtype)
                    mf = self._bd.banded_factor(MB, self.kl, self.ku,
                                                self.n)
                    minv = (lambda v: self._bd.banded_solve(
                        mf, v, self.n, self.kl, self.ku))
                    yp0 = minv(f0)
                    fun_ext = lambda t, y: minv(   # noqa: E731
                        self.fun(t, y))
                else:
                    mv = jnp.asarray(self.mvec, self.dtype)
                    yp0 = f0 / mv
                    fun_ext = lambda t, y: self.fun(t, y) / mv  # noqa: E731
            else:
                M_j = jnp.asarray(self.M).astype(self.dtype)
                yp0 = gauss_solve(M_j, f0)
                fun_ext = lambda t, y: gauss_solve(  # noqa: E731
                    M_j, self.fun(t, y))
            if self.linear:
                J = jnp.asarray(self.J_const)
            else:
                J = self.jac(t0, y0)
                njev += 1
            if first_step is None:
                b = t0 + params.direction * jnp.minimum(
                    jnp.abs(params.t_bound - t0), params.max_step)
                # h_start evals go through the raw fun (uncounted, like
                # the reference's fun_single at common.py:1998-2006)
                h_abs = jnp.abs(h_start(
                    fun_ext, t0, b, y0, yp0,
                    min(self.tab.order_secondary, self.tab.order),
                    params.rtol, params.atol))
            else:
                h_abs = jnp.asarray(first_step, self.real_dtype)

        z = jnp.asarray(0.0, self.real_dtype)
        i0 = jnp.asarray(0, jnp.int32)
        if self.banded:
            LU0 = self._bd.bcr_zero_factor(self.n, self.kl, self.ku,
                                           self.dtype)
            piv0 = jnp.zeros((0,), jnp.int32)
        else:
            LU0 = jnp.zeros((self.n, self.n), self.dtype)
            piv0 = jnp.zeros((self.n,), jnp.int32)
        return ESDIRKState(
            t=t0, y=y0, yp=yp0, h_abs=h_abs,
            status=jnp.asarray(RUNNING, jnp.int32),
            standard_sc=jnp.asarray(True),
            error_norm_old=jnp.asarray(1.0, self.real_dtype),
            h_previous=z, max_factor=jnp.asarray(10.0, self.real_dtype),
            J=J, current_J=jnp.asarray(True),
            LU=LU0,
            piv=piv0,
            LU_valid=jnp.asarray(False), h_LU=z,
            Rate=jnp.asarray(-jnp.inf, self.real_dtype),
            Niter=i0,
            t_old=t0, y_old=y0, yp_old=yp0,
            K=jnp.zeros((self.s, self.n), self.dtype),
            nfev=jnp.asarray(nfev, jnp.int32),
            njev=jnp.asarray(njev, jnp.int32),
            nlu=i0, nls=i0, nfi=i0, nsteps=i0, nfailed=i0)

    # -- Newton stage solve (common.py:2183-2232) ------------------------------

    def _stage_newton(self, params, t_stage, z_predict, h, psi, y, LU, piv):
        if self.linear:
            # direct solve: one iteration (common.py:2203-2207)
            y_predict = psi + self.d * z_predict
            f = self.fun(t_stage, y_predict)
            res = h * f - self._M_mul(z_predict)
            z = z_predict + self._solve(LU, piv, self._Sc_mul(h, res))
            finite = jnp.all(jnp.isfinite(jnp.real(f)))
            return (finite, z, jnp.asarray(-jnp.inf, self.real_dtype),
                    jnp.asarray(1, jnp.int32), jnp.asarray(1, jnp.int32),
                    jnp.asarray(1, jnp.int32))

        class C(NamedTuple):
            k: Any
            z: Any
            rate: Any
            dz_old: Any
            converged: Any
            stop: Any
            nfev: Any
            nls: Any

        def cond(c):
            return (~c.stop) & (c.k < NEWTON_MAXITER)

        def body(c):
            y_predict = psi + self.d * c.z
            f = self.fun(t_stage, y_predict)
            nfev = c.nfev + 1
            bad = ~jnp.all(jnp.isfinite(jnp.real(f))
                           & jnp.isfinite(jnp.imag(f))
                           if jnp.iscomplexobj(f)
                           else jnp.isfinite(f))
            res = h * f - self._M_mul(c.z)
            dz = self._solve(LU, piv, self._Sc_mul(h, res))
            nls = c.nls + 1
            z = c.z + dz
            scale = calculate_scale(params.atol, params.rtol, y, y_predict)
            dz_norm = norm(dz / scale)

            tiny_ok = dz_norm <= self.tiny_err
            evaluate = c.k > 0
            rate_new = jnp.where(
                evaluate & ((c.rate < 0) | (c.dz_old > self.kappa)),
                jnp.maximum(c.rate, dz_norm
                            / jnp.maximum(c.dz_old, 1e-300)),
                c.rate)
            remaining = NEWTON_MAXITER - c.k
            diverged = evaluate & (
                (rate_new >= 1.0)
                | (dz_norm * rate_new ** remaining
                   >= self.kappa * (1.0 - rate_new)))
            conv_normal = evaluate & (
                dz_norm * rate_new < self.kappa * (1.0 - rate_new))
            converged = tiny_ok | (conv_normal & ~diverged)
            stop = bad | tiny_ok | diverged | conv_normal
            return C(k=c.k + 1, z=jnp.where(bad, c.z, z),
                     rate=rate_new,
                     dz_old=dz_norm,
                     converged=converged & ~bad,
                     stop=stop, nfev=nfev, nls=nls)

        c = jax.lax.while_loop(cond, body, C(
            k=jnp.asarray(0, jnp.int32), z=z_predict,
            rate=jnp.asarray(-jnp.inf, self.real_dtype),
            dz_old=jnp.asarray(0.0, self.real_dtype),
            converged=jnp.asarray(False), stop=jnp.asarray(False),
            nfev=jnp.asarray(0, jnp.int32),
            nls=jnp.asarray(0, jnp.int32)))
        return c.converged, c.z, c.rate, c.k, c.nfev, c.nls

    # -- one step ---------------------------------------------------------------

    def reassess_stepsize(self, params, t, h_abs, standard_sc):
        """(common.py:2168-2181)"""
        min_step = jnp.maximum(self.h_min_a * (jnp.abs(t) + h_abs),
                               self.h_min_b)
        out = (h_abs < min_step) | (h_abs > params.max_step)
        h_abs = jnp.minimum(params.max_step, jnp.maximum(min_step, h_abs))
        standard_sc = standard_sc | out
        d = jnp.abs(params.t_bound - t)
        h_abs = jnp.where((jnp.abs(d / h_abs - 1.0) < 1e-2) | (d < h_abs),
                          d, h_abs)
        return h_abs, min_step, standard_sc

    def _preamble(self, params, t, y, state, h_abs, gate):
        """Preemptive J/LU refresh, once per step (common.py:2110-2127).

        ``gate`` masks the block off (used by step_flat on attempts
        that continue a rejected step)."""
        J, current_J, LU_valid = state.J, state.current_J, state.LU_valid
        njev = state.njev
        if self.jac_each_step and not self.linear:
            def refresh(_):
                return self.jac(t, y), jnp.asarray(True), njev + 1
            J, current_J, njev = jax.lax.cond(
                gate & ~current_J, refresh,
                lambda _: (J, current_J, njev), operand=None)
            LU_valid = LU_valid & ~gate
        else:
            h = h_abs * params.direction
            h_prev = jnp.where(state.h_previous == 0.0, h,
                               state.h_previous)
            h_LU = jnp.where(state.h_LU == 0.0, h, state.h_LU)
            rate_predict = state.Rate * (h / h_prev)
            rate_predict_LU = jnp.abs(h / h_LU - 1.0)
            rate_predict_JAC = rate_predict - rate_predict_LU
            has_rate = state.Rate > 0.0
            want_jac = (gate & has_rate & (state.Niter > 2)
                        & (rate_predict_JAC > MAX_RATE)
                        & ~jnp.asarray(self.linear))

            def refresh(_):
                return self.jac(t, y) if self.jac is not None else J, \
                    jnp.asarray(True), njev + 1
            J, current_J, njev = jax.lax.cond(
                want_jac, refresh, lambda _: (J, current_J, njev),
                operand=None)
            want_lu = gate & has_rate \
                & (want_jac | (rate_predict_LU > MAX_RATE))
            LU_valid = LU_valid & ~want_lu
        return J, current_J, LU_valid, njev

    def _attempt(self, params, t, y, yp, error_norm_old, h_previous, c):
        """One step attempt (the body of the reference's accept/reject
        loop, common.py:2008-2108); shared by step and step_flat."""
        h = c.h_abs * params.direction

        # (re)factor LU when needed (common.py:2032-2044)
        need_lu = (~c.LU_valid) | self.jac_each_step \
            | (jnp.asarray(self.linear) & (h != c.h_LU))

        def factor(_):
            lu, piv = self._factor(h, c.J)
            return lu, piv, c.nlu + 1, h
        LU, piv, nlu, h_LU = jax.lax.cond(
            need_lu, factor,
            lambda _: (c.LU, c.piv, c.nlu, c.h_LU), operand=None)

        # stages
        K = c.K.at[0].set(yp)
        ok = jnp.asarray(True)
        Rate = jnp.asarray(-jnp.inf, self.real_dtype)
        Niter = jnp.asarray(0, jnp.int32)
        nfev, nls = c.nfev, c.nls
        psi_last = y
        z_last = jnp.zeros_like(y)
        K_rows = [yp]
        for s in range(1, self.s):
            t_stage = t + self.C[s] * h
            psi = y + h * _wsum(K_rows, self.A[s, :s])
            z_pred = h * _wsum(K_rows, self.Az[s, :s])

            def do_stage(_):
                return self._stage_newton(params, t_stage, z_pred, h,
                                          psi, y, LU, piv)

            def skip(_):
                return (jnp.asarray(False), z_pred,
                        jnp.asarray(-jnp.inf, self.real_dtype),
                        jnp.asarray(0, jnp.int32),
                        jnp.asarray(0, jnp.int32),
                        jnp.asarray(0, jnp.int32))

            conv, z, rate, niter, dfe, dls = jax.lax.cond(
                ok, do_stage, skip, operand=None)
            nfev = nfev + dfe
            nls = nls + dls
            Rate = jnp.maximum(Rate, rate)
            Niter = jnp.maximum(Niter, niter)
            Kz = z / h
            K = K.at[s].set(jnp.where(ok & conv, Kz, K[s]))
            K_rows.append(jnp.where(ok & conv, Kz,
                                    jnp.zeros_like(Kz)))
            psi_last = jnp.where(ok, psi, psi_last)
            z_last = jnp.where(ok & conv, z, z_last)
            ok = ok & conv

        converged = ok

        # Newton failure ladder (common.py:2063-2077)
        nfi = c.nfi + jnp.where(converged, 0, 1)
        retry_with_new_jac = (~converged) & (~c.current_J) \
            & ~jnp.asarray(self.linear)

        def newjac(_):
            return ((self.jac(t, y) if self.jac is not None else c.J),
                    c.njev + 1)
        J2, njev2 = jax.lax.cond(
            retry_with_new_jac, newjac,
            lambda _: (c.J, c.njev), operand=None)
        factor_nrf = jnp.clip(
            jnp.where(Rate > 0.0, MAX_RATE / jnp.maximum(Rate, 1e-300),
                      MIN_FACTOR),
            MIN_FACTOR, MAX_FACTOR_NRF)
        h_abs_fail = jnp.where(retry_with_new_jac, c.h_abs,
                               c.h_abs * factor_nrf)

        # solution + error (common.py:2079-2087)
        y_new = psi_last + self.d * z_last
        scale = calculate_scale(params.atol, params.rtol, y, y_new)
        err = h * _wsum(list(K), self.E)
        if self.filter_error:
            err = self._M_mul(self._solve(LU, piv,
                                          self._Sc_mul(h, err)))
            # the reference `continue`s on Newton failure BEFORE the
            # filter solve (common.py:2063-2087): count it only on
            # converged attempts (round-1 hosea nls drift, +1 per
            # iteration failure)
            nls = nls + jnp.where(converged, 1, 0)
        error_norm = norm(err / scale)

        facc, sc_acc, mf_acc = esdirk_accept_update(
            self.cc, self.tiny_err, error_norm, error_norm_old,
            c.h_abs * params.direction
            / jnp.where(h_previous == 0.0,
                        c.h_abs * params.direction,
                        h_previous),
            c.rejected, c.standard_sc, c.max_factor)
        frej = reject_factor(self.cc, error_norm)

        accepted = converged & (error_norm < 1.0)
        err_rejected = converged & ~accepted
        bad = converged & (jnp.isnan(error_norm)
                           | jnp.isinf(error_norm))
        status = jnp.where(bad, jnp.asarray(OVERFLOW, jnp.int32),
                           c.status)

        h_abs_new = jnp.where(
            converged,
            c.h_abs * jnp.where(accepted, facc, frej),
            h_abs_fail)
        # a convergence failure invalidates the LU and resets the
        # controller (common.py:2068-2077); an error rejection also
        # resets the controller mode.  A retry with a FRESH Jacobian
        # is NOT a rejection (common.py:2065-2069): it neither caps
        # the next growth factor nor resets the controller.
        LU_valid_new = jnp.where(converged, need_lu | c.LU_valid,
                                 jnp.asarray(False))
        standard_sc_new = jnp.where(
            accepted, sc_acc,
            jnp.where(retry_with_new_jac, c.standard_sc,
                      jnp.asarray(True)))
        return _ECarry(
            h_abs=h_abs_new,
            h_used=jnp.where(accepted, h, c.h_used),
            accepted=accepted,
            rejected=c.rejected | (err_rejected
                                   | ((~converged)
                                      & ~retry_with_new_jac)),
            status=status,
            standard_sc=standard_sc_new,
            max_factor=jnp.where(accepted, mf_acc, c.max_factor),
            J=J2,
            current_J=c.current_J | retry_with_new_jac,
            LU=LU, piv=piv, LU_valid=LU_valid_new, h_LU=h_LU,
            Rate=Rate, Niter=Niter,
            y_new=jnp.where(accepted, y_new, c.y_new),
            error_norm=jnp.where(accepted, error_norm, c.error_norm),
            K=jnp.where(accepted, K, c.K),
            nfev=nfev, njev=njev2, nlu=nlu, nls=nls, nfi=nfi,
            nfailed=c.nfailed + jnp.where(err_rejected, 1, 0))

    def step(self, params, state):
        t, y, yp = state.t, state.y, state.yp
        h_abs, min_step, standard_sc = self.reassess_stepsize(
            params, t, state.h_abs, state.standard_sc)

        J, current_J, LU_valid, njev = self._preamble(
            params, t, y, state, h_abs, jnp.asarray(True))

        def attempt(c):
            return self._attempt(params, t, y, yp,
                                 state.error_norm_old, state.h_previous,
                                 c)

        def cond_fn(c):
            return (~c.accepted) & (c.status == RUNNING)

        def body_fn(c):
            too_small = c.h_abs < min_step
            c = c._replace(status=jnp.where(
                too_small, jnp.asarray(TOO_SMALL_STEP, jnp.int32),
                c.status))
            return jax.lax.cond(cond_fn(c), attempt, lambda x: x, c)

        c0 = _ECarry(
            h_abs=h_abs, h_used=jnp.zeros_like(state.h_previous),
            accepted=jnp.asarray(False), rejected=jnp.asarray(False),
            status=state.status, standard_sc=standard_sc,
            max_factor=state.max_factor,
            J=J, current_J=current_J, LU=state.LU, piv=state.piv,
            LU_valid=LU_valid, h_LU=state.h_LU,
            Rate=state.Rate, Niter=state.Niter,
            y_new=y, error_norm=state.error_norm_old,
            K=state.K,
            nfev=state.nfev, njev=njev, nlu=state.nlu, nls=state.nls,
            nfi=state.nfi, nfailed=state.nfailed)
        c = jax.lax.while_loop(cond_fn, body_fn, c0)
        ok = c.accepted

        d = jnp.abs(params.t_bound - t)
        is_last = ok & (jnp.abs(c.h_used) >= d)
        t_new = jnp.where(is_last, params.t_bound, t + c.h_used)
        status = jnp.where((c.status == RUNNING) & is_last,
                           jnp.asarray(FINISHED, jnp.int32), c.status)

        return ESDIRKState(
            t=jnp.where(ok, t_new, state.t),
            y=jnp.where(ok, c.y_new, state.y),
            yp=jnp.where(ok, c.K[-1], state.yp),
            h_abs=jnp.where(ok, c.h_abs, state.h_abs),
            status=status,
            standard_sc=jnp.where(ok, c.standard_sc, state.standard_sc),
            error_norm_old=jnp.where(ok, c.error_norm,
                                     state.error_norm_old),
            h_previous=jnp.where(ok, c.h_used, state.h_previous),
            max_factor=jnp.where(ok, c.max_factor, state.max_factor),
            J=c.J,
            # J considered stale at the next step unless constant
            current_J=jnp.where(ok, jnp.asarray(self.linear),
                                c.current_J),
            LU=c.LU, piv=c.piv, LU_valid=c.LU_valid, h_LU=c.h_LU,
            Rate=c.Rate, Niter=c.Niter,
            t_old=jnp.where(ok, t, state.t_old),
            y_old=jnp.where(ok, y, state.y_old),
            yp_old=jnp.where(ok, yp, state.yp_old),
            K=jnp.where(ok, c.K, state.K),
            nfev=c.nfev, njev=c.njev, nlu=c.nlu, nls=c.nls, nfi=c.nfi,
            nsteps=state.nsteps + jnp.where(ok, 1, 0),
            nfailed=c.nfailed)

    # -- flat (attempt-level) stepping for the device driver -------------------

    def flat_init_aux(self, state):
        """(fresh_step, min_step, rejected_this_step)."""
        z = jnp.asarray(0.0, self.real_dtype)
        return (jnp.asarray(True), z, jnp.asarray(False))

    def step_flat(self, params, state, aux):
        """Exactly ONE step attempt; state advances when accepted.

        Semantically equivalent to :meth:`step`'s nested accept/reject
        loop: per-STEP work (reassess_stepsize, the preemptive J/LU
        refresh) runs only on a fresh step, and the attempt-to-attempt
        carry (h_abs, J, LU, controller mode, counters) is written back
        into the state between calls.  Returns (state', aux', accepted).
        """
        fresh, min_step_c, rejected = aux
        t, y, yp = state.t, state.y, state.yp

        h_abs_r, min_step_r, sc_r = self.reassess_stepsize(
            params, t, state.h_abs, state.standard_sc)
        h_abs = jnp.where(fresh, h_abs_r, state.h_abs)
        min_step = jnp.where(fresh, min_step_r, min_step_c)
        standard_sc = jnp.where(fresh, sc_r, state.standard_sc)

        J, current_J, LU_valid, njev = self._preamble(
            params, t, y, state, h_abs, fresh)

        too_small = h_abs < min_step
        status0 = jnp.where(too_small & (state.status == RUNNING),
                            jnp.asarray(TOO_SMALL_STEP, jnp.int32),
                            state.status)
        c0 = _ECarry(
            h_abs=h_abs, h_used=jnp.zeros_like(state.h_previous),
            accepted=jnp.asarray(False), rejected=rejected,
            status=status0, standard_sc=standard_sc,
            max_factor=state.max_factor,
            J=J, current_J=current_J, LU=state.LU, piv=state.piv,
            LU_valid=LU_valid, h_LU=state.h_LU,
            Rate=state.Rate, Niter=state.Niter,
            y_new=y, error_norm=state.error_norm_old,
            K=state.K,
            nfev=state.nfev, njev=njev, nlu=state.nlu, nls=state.nls,
            nfi=state.nfi, nfailed=state.nfailed)

        c = jax.lax.cond(
            status0 == RUNNING,
            lambda cc: self._attempt(params, t, y, yp,
                                     state.error_norm_old,
                                     state.h_previous, cc),
            lambda cc: cc, c0)
        ok = c.accepted

        d = jnp.abs(params.t_bound - t)
        is_last = ok & (jnp.abs(c.h_used) >= d)
        t_new = jnp.where(is_last, params.t_bound, t + c.h_used)
        status = jnp.where((c.status == RUNNING) & is_last,
                           jnp.asarray(FINISHED, jnp.int32), c.status)

        new_state = ESDIRKState(
            t=jnp.where(ok, t_new, state.t),
            y=jnp.where(ok, c.y_new, state.y),
            yp=jnp.where(ok, c.K[-1], state.yp),
            h_abs=c.h_abs,
            status=status,
            standard_sc=c.standard_sc,
            error_norm_old=jnp.where(ok, c.error_norm,
                                     state.error_norm_old),
            h_previous=jnp.where(ok, c.h_used, state.h_previous),
            max_factor=c.max_factor,
            J=c.J,
            # J considered stale at the next step unless constant
            current_J=jnp.where(ok, jnp.asarray(self.linear),
                                c.current_J),
            LU=c.LU, piv=c.piv, LU_valid=c.LU_valid, h_LU=c.h_LU,
            Rate=c.Rate, Niter=c.Niter,
            t_old=jnp.where(ok, t, state.t_old),
            y_old=jnp.where(ok, y, state.y_old),
            yp_old=jnp.where(ok, yp, state.yp_old),
            K=jnp.where(ok, c.K, state.K),
            nfev=c.nfev, njev=c.njev, nlu=c.nlu, nls=c.nls, nfi=c.nfi,
            nsteps=state.nsteps + jnp.where(ok, 1, 0),
            nfailed=c.nfailed)
        aux_new = (ok | (status != RUNNING), min_step, c.rejected & ~ok)
        return new_state, aux_new, ok

    # -- dense output -------------------------------------------------------------

    def record_coefficients(self, state):
        h = state.h_previous
        if self.tab.P is not None:
            P = np.asarray(self.tab.P)
            return matmul(state.K.T, jnp.asarray(P)) * h
        from ..core.interpolate import hermite_cubic_coefficients
        return hermite_cubic_coefficients(h, state.y_old, state.y,
                                          state.yp_old, state.yp)

    def dense_segments(self, state, interpolant=None):
        h = state.h_previous
        if self.tab.piecewise_cubic_dense:
            # HS methods: piecewise cubic through the midpoint
            # (hosea.py:15-26)
            c1 = self.C[1]
            t_mid = state.t_old + c1 * h
            y_mid = state.y_old + h * _wsum(list(state.K), self.A[1])
            from ..core.interpolate import hermite_cubic_coefficients
            Q1 = hermite_cubic_coefficients(
                c1 * h, state.y_old, y_mid, state.K[0], state.K[1])
            Q2 = hermite_cubic_coefficients(
                (1 - c1) * h, y_mid, state.y, state.K[1], state.K[2])
            return [(state.t_old, c1 * h, state.y_old, Q1),
                    (t_mid, (1 - c1) * h, y_mid, Q2)], 0
        name = interpolant if interpolant is not None else \
            self.options.get("interpolant", None)
        P = None
        if self.tab.interpolants and name in (self.tab.interpolants or {}):
            P = np.asarray(self.tab.interpolants[name])
        elif self.tab.P is not None:
            P = np.asarray(self.tab.P)
        if P is None:
            from ..core.interpolate import hermite_cubic_coefficients
            Q = hermite_cubic_coefficients(h, state.y_old, state.y,
                                           state.yp_old, state.yp)
            return [(state.t_old, h, state.y_old, Q)], 0
        Q = matmul(state.K.T, jnp.asarray(P)) * h
        return [(state.t_old, h, state.y_old, Q)], 0
