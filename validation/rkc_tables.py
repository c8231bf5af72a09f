"""RKC-paper tables (SSV2stab on 3-D PDE problems) — exact parity gate.

Counterpart of /root/reference/docs/Demo_SSV2stab.ipynb cells 9 & 15,
which reproduce Tables 3 and 1 of Sommeijer, Shampine & Verwer, "RKC:
An explicit solver for parabolic PDEs" (1998):

* 3-D combustion, N = 40^3 grid, 2 species => 128,000 states
* 3-D heat problem with source, N = 39^3, rho_jac callback (nfesig = 0)

Unlike the notebook (whose hard-coded counts depend on its historical
numpy/scipy environment), this harness runs the reference
implementation LIVE on the identical problems and demands EXACT
equality of steps / failed steps / f-evals / power-method evals / max
stage count at every tolerance — the same criterion as
validation/hosea_tables.py.  Exits nonzero on any mismatch.

Run: python validation/rkc_tables.py [cpu]     (cpu: force the CPU backend)
"""
import os
import sys
from time import perf_counter

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, "/root/reference")

import numpy as np
import jax

if len(sys.argv) > 1 and sys.argv[1] == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from extensisq_tpu import Stepper, SSV2stab  # noqa: E402

try:
    from extensisq import SSV2stab as RefSSV  # noqa: E402
    import extensisq.sommeijer as _somm  # noqa: E402
    HAVE_REF = True
except ImportError:  # pragma: no cover - reference checkout not present
    HAVE_REF = False

FAILURES = []


def lap(np_, A, h):
    return (1.0 / h ** 2) * (
        -6 * A[1:-1, 1:-1, 1:-1]
        + A[:-2, 1:-1, 1:-1] + A[2:, 1:-1, 1:-1]
        + A[1:-1, :-2, 1:-1] + A[1:-1, 2:, 1:-1]
        + A[1:-1, 1:-1, :-2] + A[1:-1, 1:-1, 2:])


def run_to_end(fun, t0, y0, tf, tol, **opts):
    solver = Stepper(SSV2stab, fun, t0, y0, tf, rtol=tol, atol=tol,
                     **opts)
    t_start = perf_counter()
    while solver.status == "running":
        msg = solver.step()
        assert msg is None, msg
    wall = perf_counter() - t_start
    st = solver.state
    return (np.asarray(st.y), int(st.nsteps), int(st.nfailed),
            int(st.nfev), int(st.nfesig), int(st.maxm), wall)


def run_reference(fun, t0, y0, tf, tol, **opts):
    solver = RefSSV(fun, t0, y0.copy(), tf, rtol=tol, atol=tol, **opts)
    nacc = 0
    while solver.status == "running":
        msg = solver.step()
        assert msg is None, msg
        nacc += 1
    return (solver.y, nacc, int(_somm.nrejct[()]), solver.nfev,
            int(_somm.nfesig[()]), int(_somm.maxm[()]))


def check(tol, ours, ref):
    """Exact-equality gate on (steps, failed, nfev, nfesig, maxm)."""
    labels = ("steps", "failed", "nfev", "nfesig", "maxm")
    deltas = []
    for lab, a, b in zip(labels, ours, ref):
        deltas.append(f"{a - b:+d}")
        if a != b:
            FAILURES.append(f"tol={tol:.0e}: {lab} ours={a} ref={b}")
    return " ".join(deltas)


def combustion_table():
    from extensisq_tpu.problems import combustion_3d

    N = 40
    P = combustion_3d(N)
    fun, y0 = P.rhs, np.asarray(P.y0)
    m = N ** 3

    # reference-side numpy twin of the same problem
    L, alpha_c, delta, R = 0.9, 1.0, 20.0, 5.0
    D = R * np.exp(delta) / (alpha_c * delta)
    h = 1.0 / (N + 0.5)

    def expand(A):
        A = np.pad(A, 1, constant_values=1.0)
        A[0, :, :] = A[1, :, :]
        A[:, 0, :] = A[:, 1, :]
        A[:, :, 0] = A[:, :, 1]
        return A

    def fun_np(t, y):
        c = expand(y[:m].reshape(N, N, N))
        T = expand(y[m:].reshape(N, N, N))
        Dce = D * c[1:-1, 1:-1, 1:-1] * np.exp(-delta / T[1:-1, 1:-1, 1:-1])
        dc = lap(np, c, h) - Dce
        dT = (lap(np, T, h) + alpha_c * Dce) / L
        return np.concatenate([dc.reshape(-1), dT.reshape(-1)])

    print("combustion N=40^3 (128,000 states), t in [0, 0.3]")
    print("computing tol=1e-8 reference solution ...")
    ref_y, *_ = run_to_end(fun, 0.0, y0, 0.30, 1e-8)

    print(" Tol   Error  Steps  f-evals  avg  f-sigma  wall   s-max  "
          "| delta vs live reference run")
    for tol in (1e-4, 1e-5, 1e-6, 1e-7):
        y, nst, nfs, nfev, nfesig, maxm, wall = run_to_end(
            fun, 0.0, y0, 0.30, tol)
        err = np.abs(y - ref_y).max()
        steps = nst + nfs
        if HAVE_REF:
            ry, rnst, rnfs, rnfev, rnfesig, rmaxm = run_reference(
                fun_np, 0.0, y0, 0.30, tol)
            d = check(tol, (steps, nfs, nfev, nfesig, maxm),
                      (rnst + rnfs, rnfs, rnfev, rnfesig, rmaxm))
        else:
            d = "(reference not importable)"
        print(f"{tol:.0e}  {err:6.2g}  {steps:>4}({nfs})  {nfev:>5}  "
              f"{nfev / steps:4.1f}  {nfesig:>5}  {wall:5.1f}s  {maxm:>4}"
              f"  | {d}")


def heat_table():
    N = 39
    grid = np.linspace(0.0, 1.0, N + 2)
    X, Y, Z = np.meshgrid(grid, grid, grid)
    h = 1.0 / (N + 1.0)

    def solution(x, y, z, t):
        return np.tanh(5 * x + 10 * y + 7.5 * z - (2.5 + 5 * t))

    Xj, Yj, Zj = map(jnp.asarray, (X, Y, Z))

    def fun(t, y):
        s = jnp.tanh(5 * Xj + 10 * Yj + 7.5 * Zj - (2.5 + 5 * t))
        W = s.at[1:-1, 1:-1, 1:-1].set(y.reshape(N, N, N))
        src = 362.5 * (s - s ** 3) + 5 * s ** 2 - 5
        dy = lap(jnp, W, h) + src[1:-1, 1:-1, 1:-1]
        return dy.reshape(-1)

    def fun_np(t, y):
        s = solution(X, Y, Z, t)
        W = s.copy()
        W[1:-1, 1:-1, 1:-1] = y.reshape(N, N, N)
        src = 362.5 * (s - s ** 3) + 5 * s ** 2 - 5
        dy = lap(np, W, h) + src[1:-1, 1:-1, 1:-1]
        return dy.reshape(-1)

    rho = 12.0 / h ** 2
    y0 = solution(X, Y, Z, 0.0)[1:-1, 1:-1, 1:-1].reshape(-1)
    print("\nheat N=39^3, rho_jac supplied (no power iterations)")
    print("computing tol=1e-8 reference solution ...")
    ref_y, *_ = run_to_end(fun, 0.0, y0, 0.7, 1e-8, const_jac=True,
                           rho_jac=lambda t, y: rho)

    solc = solution(X, Y, Z, 0.7)[1:-1, 1:-1, 1:-1].reshape(-1)
    print(" Tol   Error   Steps  f-evals  avg  wall   s-max  error-c  "
          "| delta vs live reference run")
    for tol in (1e-1, 1e-2, 1e-3, 1e-4, 1e-5, 1e-6):
        y, nst, nfs, nfev, nfesig, maxm, wall = run_to_end(
            fun, 0.0, y0, 0.7, tol, const_jac=True,
            rho_jac=lambda t, yy: rho)
        assert nfesig == 0
        err = np.abs(y - ref_y).max()
        errc = np.abs(y - solc).max()
        steps = nst + nfs
        if HAVE_REF:
            ry, rnst, rnfs, rnfev, rnfesig, rmaxm = run_reference(
                fun_np, 0.0, y0, 0.7, tol, const_jac=True,
                rho_jac=lambda t, yy: rho)
            d = check(tol, (steps, nfs, nfev, nfesig, maxm),
                      (rnst + rnfs, rnfs, rnfev, rnfesig, rmaxm))
        else:
            d = "(reference not importable)"
        print(f"{tol:.0e}  {err:7.2g}  {steps:>4}({nfs})  {nfev:>5}  "
              f"{nfev / steps:4.1f}  {wall:5.1f}s  {maxm:>4}  {errc:7.2g}"
              f"  | {d}")


if __name__ == "__main__":
    combustion_table()
    heat_table()
    if HAVE_REF:
        if FAILURES:
            print("\nFAIL — mismatches vs the reference implementation:")
            for f in FAILURES:
                print(" ", f)
            sys.exit(1)
        print("\nPASS — exact count parity (steps/failed/nfev/nfesig/maxm) "
              "with the reference implementation at every tolerance")
    else:
        print("\n(no PASS/FAIL: reference implementation not importable)")
