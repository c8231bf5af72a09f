"""Banded Newton linear algebra (block-tridiagonal cyclic reduction).

Device-native counterpart of the reference's sparse SuperLU route
(/root/reference/extensisq/common.py:1756-1776), exercised there by
the Medazko problem (/root/reference/tests/test_ivp.py:262-291).  The
contract tested here: switching ESDIRK to ``bands=`` changes the
linear-algebra *implementation*, not the integration — work counters
must match the dense-LU solve exactly and solutions to round-off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from extensisq_tpu import solve_ivp, TRBDF2, KC4I, Kv3I
from extensisq_tpu.core import banded as bd
from extensisq_tpu.problems import medazko
from extensisq_tpu.solve import solve


# -- core BCR machinery ------------------------------------------------------

@pytest.mark.parametrize("n,kl,ku", [(7, 1, 1), (13, 2, 3), (64, 4, 4),
                                     (5, 0, 2), (1, 1, 1), (3, 2, 2),
                                     (400, 2, 2)])
def test_bcr_solves_banded_system(n, kl, ku):
    rng = np.random.default_rng(n + 10 * kl + ku)
    i, j = np.indices((n, n))
    mask = (i - j <= kl) & (j - i <= ku)
    A = rng.standard_normal((n, n)) * mask + np.eye(n) * (kl + ku + 2)
    x_true = rng.standard_normal(n)
    AB = bd.banded_from_dense(jnp.asarray(A), kl, ku)
    assert np.allclose(np.asarray(bd.dense_from_banded(AB, kl, ku, n)), A)
    assert np.allclose(
        np.asarray(bd.banded_matvec(AB, kl, ku, jnp.asarray(x_true))),
        A @ x_true)
    fact = bd.banded_factor(AB, kl, ku, n)
    x = bd.banded_solve(fact, jnp.asarray(A @ x_true), n, kl, ku)
    np.testing.assert_allclose(np.asarray(x), x_true, atol=1e-9)


def test_bcr_complex():
    n, kl, ku = 17, 2, 1
    rng = np.random.default_rng(5)
    i, j = np.indices((n, n))
    mask = (i - j <= kl) & (j - i <= ku)
    A = (rng.standard_normal((n, n))
         + 1j * rng.standard_normal((n, n))) * mask
    A += np.eye(n) * (3 + 1j)
    x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    AB = bd.banded_from_dense(jnp.asarray(A), kl, ku)
    fact = bd.banded_factor(AB, kl, ku, n)
    x = bd.banded_solve(fact, jnp.asarray(A @ x_true), n, kl, ku)
    np.testing.assert_allclose(np.asarray(x), x_true, atol=1e-9)


def test_bcr_vmapped():
    n, kl, ku, B = 32, 2, 2, 5
    rng = np.random.default_rng(7)
    i, j = np.indices((n, n))
    mask = (i - j <= kl) & (j - i <= ku)
    As = rng.standard_normal((B, n, n)) * mask + np.eye(n) * 6
    xs = rng.standard_normal((B, n))
    bs = np.einsum("bij,bj->bi", As, xs)

    def one(A, b):
        AB = bd.banded_from_dense(A, kl, ku)
        return bd.banded_solve(bd.banded_factor(AB, kl, ku, n),
                               b, n, kl, ku)

    out = jax.vmap(one)(jnp.asarray(As), jnp.asarray(bs))
    np.testing.assert_allclose(np.asarray(out), xs, atol=1e-9)


def test_banded_colored_jacfwd_matches_dense():
    P = medazko(50)
    y0 = jnp.asarray(P.y0)
    kl, ku = bd.bands_of_sparsity(P.jac_sparsity)
    jacb = bd.banded_colored_jacfwd(P.rhs, kl, ku, y0.size, np.float64)
    AB = jacb(1.3, y0)
    Jd = jax.jacfwd(P.rhs, argnums=1)(1.3, y0)
    np.testing.assert_array_equal(
        np.asarray(bd.dense_from_banded(AB, kl, ku, y0.size)),
        np.asarray(Jd))


def test_bands_of_sparsity():
    S = np.zeros((6, 6))
    S[np.arange(6), np.arange(6)] = 1
    S[3, 1] = 1    # kl = 2
    S[0, 3] = 1    # ku = 3
    assert bd.bands_of_sparsity(S) == (2, 3)


# -- ESDIRK bands= route: counters identical to the dense path ---------------

@pytest.mark.parametrize("method", [TRBDF2, KC4I], ids=lambda m: m.name)
def test_medazko_banded_counts_match_dense(method):
    P = medazko(50)   # n = 100
    rd = solve_ivp(P.rhs, P.t_span, P.y0, method=method,
                   jac_sparsity=P.jac_sparsity)
    rb = solve_ivp(P.rhs, P.t_span, P.y0, method=method, bands=True,
                   jac_sparsity=P.jac_sparsity)
    assert rb.success
    assert (rb.nfev, rb.njev, rb.nlu, len(rb.t)) == \
        (rd.nfev, rd.njev, rd.nlu, len(rd.t))
    np.testing.assert_allclose(rb.y[:, -1], rd.y[:, -1],
                               rtol=0, atol=1e-9)


def test_banded_explicit_bands_tuple():
    P = medazko(40)
    kl, ku = bd.bands_of_sparsity(P.jac_sparsity)
    rb = solve_ivp(P.rhs, P.t_span, P.y0, method=TRBDF2, bands=(kl, ku))
    rd = solve_ivp(P.rhs, P.t_span, P.y0, method=TRBDF2)
    assert rb.success
    assert (rb.nfev, rb.nlu, len(rb.t)) == (rd.nfev, rd.nlu, len(rd.t))


def test_banded_requires_sparsity_for_bands_true():
    P = medazko(10)
    with pytest.raises(ValueError, match="bands=True requires"):
        solve_ivp(P.rhs, P.t_span, P.y0, method=TRBDF2, bands=True)


def test_banded_callable_jac():
    P = medazko(40)
    n = P.y0.size
    kl, ku = bd.bands_of_sparsity(P.jac_sparsity)
    jac_dense = jax.jacfwd(P.rhs, argnums=1)
    # user jac returning dense (n, n) is converted
    r1 = solve_ivp(P.rhs, P.t_span, P.y0, method=TRBDF2,
                   bands=(kl, ku), jac=jac_dense)
    # user jac returning banded storage is used directly
    jac_banded = bd.banded_colored_jacfwd(P.rhs, kl, ku, n, np.float64)
    r2 = solve_ivp(P.rhs, P.t_span, P.y0, method=TRBDF2,
                   bands=(kl, ku), jac=jac_banded)
    assert r1.success and r2.success
    assert (r1.nfev, r1.nlu, len(r1.t)) == (r2.nfev, r2.nlu, len(r2.t))
    np.testing.assert_allclose(r1.y[:, -1], r2.y[:, -1],
                               rtol=0, atol=1e-12)


def test_banded_const_jac_linear_path():
    # 1-D heat equation: constant tridiagonal Jacobian
    n = 64
    main = np.full(n, -2.0) * n ** 2
    off = np.full(n - 1, 1.0) * n ** 2
    J = np.diag(main) + np.diag(off, 1) + np.diag(off, -1)
    y0 = np.sin(np.pi * (np.arange(n) + 1) / (n + 1))

    def rhs(t, y):
        return jnp.asarray(J) @ y

    rd = solve_ivp(rhs, (0.0, 0.1), y0, method=Kv3I, jac=J)
    rb = solve_ivp(rhs, (0.0, 0.1), y0, method=Kv3I, jac=J,
                   bands=(1, 1))
    assert rb.success
    assert (rb.nfev, rb.nlu, len(rb.t)) == (rd.nfev, rd.nlu, len(rd.t))
    np.testing.assert_allclose(rb.y[:, -1], rd.y[:, -1],
                               rtol=0, atol=1e-10)


def test_banded_device_driver():
    """bands= rides the flat device path (the BCR factor pytree lives
    inside the solve while_loop carry)."""
    P = medazko(40)
    rb_host = solve_ivp(P.rhs, P.t_span, P.y0, method=TRBDF2,
                        bands=True, jac_sparsity=P.jac_sparsity)
    sol = solve(P.rhs, P.t_span, jnp.asarray(P.y0), method=TRBDF2,
                bands=True, jac_sparsity=P.jac_sparsity)
    assert int(sol.status) == 1        # FINISHED
    assert int(sol.nsteps) == len(rb_host.t) - 1
    assert int(sol.nfev) == rb_host.nfev
    np.testing.assert_allclose(np.asarray(sol.y), rb_host.y[:, -1],
                               rtol=0, atol=1e-12)


# -- banded DAE (diagonal mass matrix) ---------------------------------------

def _banded_dae(nc):
    """1-D reaction-diffusion with an interleaved algebraic variable:
    u_t = u_xx - v,  0 = v - u^2  (index 1, M = diag(1,0,1,0,...)).
    Banded with (kl, ku) = (2, 2) in the interleaved ordering."""
    n = 2 * nc
    h2 = (nc + 1) ** 2

    def rhs(t, y):
        u = y[0::2]
        v = y[1::2]
        lap = (jnp.concatenate([u[1:], jnp.zeros(1, y.dtype)])
               - 2 * u
               + jnp.concatenate([jnp.zeros(1, y.dtype), u[:-1]])) * h2
        fu = lap - v
        fv = v - u ** 2
        return jnp.stack([fu, fv], axis=1).reshape(n)

    M = np.zeros(n)
    M[0::2] = 1.0
    x = np.linspace(0, 1, nc + 2)[1:-1]
    u0 = np.sin(np.pi * x)
    y0 = np.stack([u0, u0 ** 2], axis=1).reshape(n)
    return rhs, M, y0


@pytest.mark.parametrize("method", [TRBDF2, KC4I], ids=lambda m: m.name)
def test_banded_dae_counts_match_dense(method):
    rhs, M, y0 = _banded_dae(24)
    rd = solve_ivp(rhs, (0.0, 0.2), y0, method=method, M=M)
    rb = solve_ivp(rhs, (0.0, 0.2), y0, method=method, M=M,
                   bands=(2, 2))
    assert rb.success
    assert (rb.nfev, rb.njev, rb.nlu, len(rb.t)) == \
        (rd.nfev, rd.njev, rd.nlu, len(rd.t))
    np.testing.assert_allclose(rb.y[:, -1], rd.y[:, -1],
                               rtol=0, atol=1e-9)
    # the algebraic constraint holds at the endpoint
    u, v = rb.y[0::2, -1], rb.y[1::2, -1]
    np.testing.assert_allclose(v, u ** 2, rtol=0, atol=1e-6)


def test_banded_rejects_singular_nondiagonal_M():
    """Non-diagonal SINGULAR M (hidden-M DAE) stays on the dense
    path: its SVD rotation densifies a banded Jacobian."""
    rhs, M, y0 = _banded_dae(8)
    Mfull = np.diag(M)                 # has zero (algebraic) rows
    Mfull[0, 2] = 0.5
    with pytest.raises(ValueError, match="nonsingular"):
        solve_ivp(rhs, (0.0, 0.1), y0, method=TRBDF2, M=Mfull,
                  bands=(2, 2))


def test_banded_nondiagonal_fem_mass():
    """Non-diagonal NONSINGULAR banded M (FEM-style tridiagonal mass)
    rides banded mode: W = M - h d J keeps the union bandwidths, and
    counters match the dense-path solve exactly (the reference path:
    common.py:1778-1821 handles any M; here banded+nonsingular is the
    banded cell, singular stays dense)."""
    n = 40
    x = np.arange(n)
    # 1-D FEM lumped-ish mass: tridiag(1/6, 2/3, 1/6)
    M = (np.diag(np.full(n, 2.0 / 3.0))
         + np.diag(np.full(n - 1, 1.0 / 6.0), 1)
         + np.diag(np.full(n - 1, 1.0 / 6.0), -1))

    def rhs(t, y):
        left = jnp.concatenate([y[:1], y[:-1]])
        right = jnp.concatenate([y[1:], y[-1:]])
        return 20.0 * (left - 2.0 * y + right) - y ** 3

    y0 = 1.0 + 0.5 * np.sin(2 * np.pi * x / n)
    rd = solve_ivp(rhs, (0.0, 0.5), y0, method=TRBDF2, M=M)
    rb = solve_ivp(rhs, (0.0, 0.5), y0, method=TRBDF2, M=M,
                   bands=(1, 1))
    assert rb.success
    assert (rb.nfev, rb.njev, rb.nlu, len(rb.t)) == \
        (rd.nfev, rd.njev, rd.nlu, len(rd.t))
    np.testing.assert_allclose(rb.y[:, -1], rd.y[:, -1],
                               rtol=0, atol=1e-9)


# -- bands="rcm": irregular sparsity reordered to bands (round 5) -------------

def test_rcm_order_recovers_path_graph():
    """RCM on a randomly relabeled path graph recovers bandwidth 1."""
    n = 50
    rng = np.random.RandomState(11)
    sig = rng.permutation(n)
    pos = np.argsort(sig)
    Sc = (np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= 1)
    S = Sc[np.ix_(pos, pos)].astype(int)
    assert sum(bd.bands_of_sparsity(S)) > 20     # irregular as given
    p = bd.rcm_order(S)
    assert sorted(p) == list(range(n))
    red = bd.bands_of_sparsity(S[p][:, p])
    assert red[0] <= 1 and red[1] <= 1


def test_rcm_irregular_counts_match_dense():
    """bands='rcm': an IRREGULAR pattern (randomly relabeled diffusion
    chain, natural bandwidths ~n) auto-reorders to a narrow band and
    matches the dense solve's counters exactly — the reference's
    any-sparsity splu route (common.py:1756-1776) on device."""
    n = 60
    rng = np.random.RandomState(3)
    sig = np.asarray(rng.permutation(n))
    pos = np.argsort(sig)
    lam = 1.0 + np.linspace(0.0, 1.0, n)

    def rhs(t, y):
        w = y[sig]                               # chain-ordered
        left = jnp.concatenate([w[:1], w[:-1]])
        right = jnp.concatenate([w[1:], w[-1:]])
        gw = 30.0 * (left - 2.0 * w + right) - jnp.asarray(lam) * w
        return gw[pos]

    Sc = (np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= 1)
    S = Sc[np.ix_(pos, pos)].astype(int)

    y0 = 1.0 + 0.1 * np.sin(np.arange(n))
    rd = solve_ivp(rhs, (0.0, 0.5), y0, method=TRBDF2)
    rr = solve_ivp(rhs, (0.0, 0.5), y0, method=TRBDF2, bands="rcm",
                   jac_sparsity=S)
    assert rr.success
    assert (rr.nfev, rr.njev, rr.nlu, len(rr.t)) == \
        (rd.nfev, rd.njev, rd.nlu, len(rd.t))
    np.testing.assert_allclose(rr.y[:, -1], rd.y[:, -1],
                               rtol=0, atol=1e-9)


def test_rcm_already_banded_equals_bands_true():
    """bands='rcm' on an already-banded pattern (Medazko) keeps the
    natural order (no permutation can narrow it) and reproduces the
    bands=True run exactly."""
    P = medazko(40)
    rt = solve_ivp(P.rhs, P.t_span, P.y0, method=TRBDF2, bands=True,
                   jac_sparsity=P.jac_sparsity)
    rr = solve_ivp(P.rhs, P.t_span, P.y0, method=TRBDF2, bands="rcm",
                   jac_sparsity=P.jac_sparsity)
    assert rr.success
    assert (rr.nfev, rr.njev, rr.nlu, len(rr.t)) == \
        (rt.nfev, rt.njev, rt.nlu, len(rt.t))
    np.testing.assert_array_equal(rr.y[:, -1], rt.y[:, -1])
