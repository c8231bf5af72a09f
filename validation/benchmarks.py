"""The BASELINE.json benchmark configurations on the XLA device path.

Each config times a warm solve through the public entry points on one
GPU and checks its answer; it fails when JAX finds no GPU.  The numbers
it prints are device wall times of this run, nothing more.

Run: python validation/benchmarks.py [--json]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import card_line, device_check  # noqa: E402
from extensisq_tpu import (solve, solve_ensemble, solve_final,  # noqa: E402
                           solve_windowed, BS5, SWAG, Fi5N, Kv3I, SSV2stab,
                           CFMR7osc)
from extensisq_tpu.parallel import (brusselator_2d_rhs,  # noqa: E402
                                    brusselator_rho_bound)
from extensisq_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)


def time_device(run, *args, reps=5):
    """Warm wall time of ``run(*args)``, each call ending in
    block_until_ready; the first two calls compile and warm up."""
    for _ in range(2):
        out = jax.block_until_ready(run(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(run(*args))
    return (time.perf_counter() - t0) / reps, out


def config1():
    """exponential decay, 3 states, BS5, 4096 members"""
    B = 4096
    A = np.array([-0.5, -1.0, -2.0])

    def f(t, y):
        return jnp.asarray(A) * y

    Y0 = jnp.asarray(1.0 + 0.5 * np.random.RandomState(0).rand(B, 3))
    run = jax.jit(lambda Y: solve_ensemble(f, (0.0, 10.0), Y, method=BS5,
                                           rtol=1e-6, atol=1e-9))
    dt, out = time_device(run, Y0)
    assert bool(jnp.all(out.status == 1))
    exact = np.asarray(Y0) * np.exp(A * 10.0)
    err = float(np.max(np.abs(np.asarray(out.y) - exact)))
    assert err < 1e-6, f"exp-decay endpoint error {err}"
    print(f"1 exp-decay BS5 x{B}: {dt*1e3:9.3f} ms, endpoint |d| {err:.1e}")
    return {"1_ms": dt * 1e3}


def config2():
    """Van der Pol mu=1000, SWAG (ode113 analog), 256 members, the
    horizon integrated in warm-started windows (solve_windowed)."""
    B = 256
    mu = 1000.0
    window = 5.0
    n_windows = 4

    def f(t, y):
        return jnp.stack([y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]])

    Y0 = jnp.stack([jnp.linspace(1.9, 2.1, B), jnp.zeros(B)], axis=1)

    def full(Y):
        out = solve_windowed(f, (0.0, n_windows * window), Y, n_windows,
                             method=SWAG, ensemble=True, rtol=1e-6,
                             atol=1e-9, max_steps=120_000)
        assert bool(jnp.all(out.status == 1))
        return out

    dt, out = time_device(full, Y0, reps=1)
    steps = int(out.nsteps.max())
    print(f"2 VdP mu=1e3 SWAG x{B} (t=20): {dt:9.3f} s "
          f"(~{steps} steps/member)")
    return {"2_windowed_s": dt, "2_steps": steps}


def config3():
    """Kepler orbits, Fi5N RKN, 2048 members; Pleiades CFMR7osc, 512"""
    B = 2048
    ecc = np.linspace(0.1, 0.7, B)
    y0 = np.stack([1 - ecc, np.zeros(B), np.zeros(B),
                   np.sqrt((1 + ecc) / (1 - ecc))], axis=1)

    def f(t, y):
        r2 = y[0] ** 2 + y[1] ** 2
        a = -r2 ** -1.5
        return jnp.stack([y[2], y[3], a * y[0], a * y[1]])

    run = jax.jit(lambda Y: solve_ensemble(
        f, (0.0, 2 * np.pi), Y, method=Fi5N, rtol=1e-9, atol=1e-12))
    dt3, out = time_device(run, jnp.asarray(y0))
    assert bool(jnp.all(out.status == 1))
    # one full period: back where it started
    err = float(np.max(np.abs(np.asarray(out.y) - y0)))
    assert err < 1e-5, f"Kepler period error {err}"
    print(f"3 Kepler Fi5N x{B}: {dt3*1e3:9.3f} ms, period |d| {err:.1e}")

    # Pleiades: 7 bodies, 28 states, perturbed-IC ensemble; the
    # oscillatory-problem method CFMR7osc on the first-order form
    Bp = 512
    masses = jnp.arange(1.0, 8.0)
    q0 = np.array([3, 3, -1, -3, 2, -2, 2,
                   3, -3, 2, 0, 0, -4, 4], dtype=float)
    v0 = np.array([0, 0, 0, 0, 0, 1.75, -1.5,
                   0, 0, 0, -1.25, 1, 0, 0], dtype=float)

    def accel(q):
        x, ya = q[:7], q[7:]
        dx = x[None, :] - x[:, None]
        dy = ya[None, :] - ya[:, None]
        r2 = dx * dx + dy * dy + jnp.eye(7)
        w = masses[None, :] * r2 ** -1.5 * (1.0 - jnp.eye(7))
        return jnp.concatenate([(w * dx).sum(1), (w * dy).sum(1)])

    def fpl(t, y):
        return jnp.concatenate([y[14:], accel(y[:14])])

    rng = np.random.RandomState(1)
    Y0p = jnp.asarray(np.concatenate([q0, v0])[None, :]
                      + 1e-3 * rng.randn(Bp, 28))
    runp = jax.jit(lambda Y: solve_ensemble(
        fpl, (0.0, 3.0), Y, method=CFMR7osc, rtol=1e-9, atol=1e-12))
    dt, out = time_device(runp, Y0p, reps=2)
    assert bool(jnp.all(out.status == 1))
    print(f"3b Pleiades CFMR7osc x{Bp}: {dt*1e3:9.3f} ms "
          f"({int(out.nsteps.max())} steps max)")
    return {"3_kepler_ms": dt3 * 1e3, "3b_pleiades_ms": dt * 1e3}


def config4():
    """Robertson stiff, Kv3I ESDIRK with batched Newton, 512 members;
    index-1 pendulum DAE, 256 members"""
    B = 512

    def f(t, y, k1):
        return jnp.stack([-k1 * y[0] + 1e4 * y[1] * y[2],
                          k1 * y[0] - 1e4 * y[1] * y[2]
                          - 3e7 * y[1] ** 2,
                          3e7 * y[1] ** 2])

    k1s = jnp.asarray(np.linspace(0.03, 0.05, B))
    Y0 = jnp.tile(jnp.array([1.0, 0.0, 0.0]), (B, 1))
    run = jax.jit(lambda Y, K: solve_ensemble(
        f, (0.0, 1e6), Y, params_batch=K, method=Kv3I, rtol=1e-6,
        atol=1e-8))
    dt4, out = time_device(run, Y0, k1s, reps=2)
    assert bool(jnp.all(out.status == 1))
    # mass conservation y0 + y1 + y2 = 1
    drift = float(jnp.max(jnp.abs(out.y.sum(1) - 1.0)))
    assert drift < 1e-6, f"Robertson mass drift {drift}"
    print(f"4 Robertson Kv3I x{B}: {dt4*1e3:9.3f} ms "
          f"({int(out.nsteps.max())} steps max)")

    # index-1 Cartesian pendulum DAE ensemble, Kv3I + mass matrix:
    # state (x, y, vx, vy, lam), M = diag(1,1,1,1,0); the algebraic row
    # is the twice-differentiated length constraint
    Bd = 256
    gg = 9.81
    Md = jnp.diag(jnp.array([1.0, 1.0, 1.0, 1.0, 0.0]))

    def pend(t, s, theta0):
        x, ya, vx, vy, lam = s
        return jnp.stack([
            vx, vy, -lam * x, -lam * ya - gg,
            vx ** 2 + vy ** 2 - lam * (x ** 2 + ya ** 2) - gg * ya])

    th = jnp.asarray(np.linspace(0.2, 1.2, Bd))
    Y0d = jnp.stack([jnp.sin(th), -jnp.cos(th),
                     jnp.zeros(Bd), jnp.zeros(Bd),
                     jnp.zeros(Bd)], axis=1)
    rund = jax.jit(lambda Y, T: solve_ensemble(
        pend, (0.0, 10.0), Y, params_batch=T, method=Kv3I,
        rtol=1e-6, atol=1e-8, M=Md))
    dt, out = time_device(rund, Y0d, th, reps=2)
    assert bool(jnp.all(out.status == 1))
    drift = float(jnp.abs(out.y[:, 0] ** 2 + out.y[:, 1] ** 2 - 1.0).max())
    print(f"4b pendulum DAE Kv3I x{Bd}: {dt*1e3:9.3f} ms "
          f"({int(out.nsteps.max())} steps max, |len drift| {drift:.1e})")
    return {"4_robertson_ms": dt4 * 1e3, "4b_dae_ms": dt * 1e3}


def config5():
    """2-D Brusselator: one 131k-state system + a 10k-member ensemble
    of 2k-state systems, SSV2stab"""
    shape = (256, 256)
    rhs = brusselator_2d_rhs(shape, alpha=0.02)
    rho = brusselator_rho_bound(shape, alpha=0.02)
    ny, nx = shape
    xg, yg = np.meshgrid(np.linspace(0, 1, nx, endpoint=False),
                         np.linspace(0, 1, ny, endpoint=False))
    u0 = 1.0 + 0.5 * np.sin(2 * np.pi * xg) * np.sin(2 * np.pi * yg)
    v0 = 3.0 + 0.1 * np.cos(2 * np.pi * xg)
    y0 = jnp.asarray(np.concatenate([u0.ravel(), v0.ravel()]))
    run = jax.jit(lambda y: solve(rhs, (0.0, 1.0), y, method=SSV2stab,
                                  rtol=1e-4, atol=1e-7, rho_jac=rho))
    dt5a, out = time_device(run, y0)
    assert int(out.status) == 1
    print(f"5a Brusselator {2 * ny * nx} states: {dt5a*1e3:9.3f} ms "
          f"({int(out.nsteps)} steps, {int(out.nfev)} evals)")

    # ensemble: 10k members of a 32x32 grid (20.9M states total)
    shape_s = (32, 32)
    rhs_s = brusselator_2d_rhs(shape_s, alpha=0.02)
    rho_s = brusselator_rho_bound(shape_s, alpha=0.02)
    Bm = 10_000
    xg, yg = np.meshgrid(np.linspace(0, 1, 32, endpoint=False),
                         np.linspace(0, 1, 32, endpoint=False))
    amps = np.linspace(0.1, 0.6, Bm)
    u0 = 1.0 + amps[:, None] * np.sin(2 * np.pi * xg).ravel()[None, :]
    v0 = 3.0 + 0.1 * np.cos(2 * np.pi * xg).ravel()[None, :] \
        * np.ones((Bm, 1))
    Y0 = jnp.asarray(np.concatenate([u0, v0], axis=1))
    runE = jax.jit(lambda Y: solve_ensemble(
        rhs_s, (0.0, 1.0), Y, method=SSV2stab, rtol=1e-4, atol=1e-7,
        rho_jac=rho_s))
    dt, out = time_device(runE, Y0, reps=2)
    assert bool(jnp.all(out.status == 1))
    print(f"5b Brusselator x{Bm} (2048 states each): {dt*1e3:9.3f} ms")
    return {"5a_131k_ms": dt5a * 1e3, "5b_ensemble_ms": dt * 1e3}


def config6():
    """Long-horizon mid-size ensembles through solve_windowed:
    6a advection-reaction (Fisher) n=256 BS5 x64 to t=42, 6b heat MoL
    n=256 SWAG x32 to t=6 (thousands of steps per member)."""
    ngr, cg = 256, 1.0
    nwin = 6

    def fisher(t, y):
        return -cg * (y - jnp.roll(y, 1)) * ngr + y * (1.0 - y)

    xg = np.linspace(0, 1, ngr, endpoint=False)
    Bg = 64
    amps = np.linspace(0.2, 0.8, Bg)
    YG = jnp.asarray(0.5 + 0.4 * amps[:, None]
                     * np.sin(2 * np.pi * xg)[None, :])

    def run6a(Y):
        out = solve_windowed(fisher, (0.0, 42.0), Y, nwin, method=BS5,
                             ensemble=True, rtol=1e-5, atol=1e-7,
                             max_steps=40_000)
        assert bool(jnp.all(out.status == 1))
        return out

    dta, outa = time_device(run6a, YG, reps=1)
    nsa = int(outa.nsteps.max())
    print(f"6a advec-MoL n={ngr} BS5 x{Bg} t=0..42 ({nsa} steps): "
          f"{dta*1e3:9.3f} ms")

    Dg, dxg = 0.01, 1.0 / 256

    def heat(t, y):
        return Dg * (jnp.roll(y, 1) + jnp.roll(y, -1) - 2.0 * y) / dxg ** 2

    Bh = 32
    ampsh = np.linspace(0.5, 1.5, Bh)
    YH = jnp.asarray(ampsh[:, None] * np.sin(2 * np.pi * xg)[None, :]
                     + 0.3 * np.cos(4 * np.pi * xg)[None, :])

    def run6b(Y):
        out = solve_windowed(heat, (0.0, 6.0), Y, nwin, method=SWAG,
                             ensemble=True, rtol=1e-4, atol=1e-6, k_max=6,
                             max_steps=60_000)
        assert bool(jnp.all(out.status == 1))
        return out

    dtb, outb = time_device(run6b, YH, reps=1)
    nsb = int(outb.nsteps.max())
    print(f"6b heat-MoL n={ngr} SWAG x{Bh} t=0..6 ({nsb} steps): "
          f"{dtb*1e3:9.3f} ms")
    return {"6a_ms": dta * 1e3, "6a_steps": nsa, "6b_ms": dtb * 1e3,
            "6b_steps": nsb}


def config7():
    """value_and_grad through solve_final (continuous adjoint) of a VdP
    mu-sweep, 1024 members, checked against central differences."""
    Bg = 1024

    def f(t, y, mu):
        return (y[1], mu * (1 - y[0] ** 2) * y[1] - y[0])

    def final(y0, mu, rtol=1e-6, atol=1e-9):
        return solve_final(f, (0.0, 3.0), y0, mu, BS5, rtol, atol, 4000)

    def loss(Y, M):
        return jnp.sum(jax.vmap(final)(Y, M)[:, 0])

    Y0 = jnp.stack([jnp.full(Bg, 2.0), jnp.zeros(Bg)], axis=1)
    mus = jnp.linspace(1.0, 2.0, Bg)
    rung = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))
    dt, (val, (gy0, gmu)) = time_device(rung, Y0, mus, reps=3)
    assert bool(jnp.all(jnp.isfinite(gmu)))
    eps = 1e-5
    tight = jax.jit(jax.vmap(lambda y, m: final(y, m, 1e-12, 1e-14)))
    fd = (tight(Y0[:8], mus[:8] + eps)[:, 0]
          - tight(Y0[:8], mus[:8] - eps)[:, 0]) / (2 * eps)
    d = float(jnp.max(jnp.abs(gmu[:8] - fd)))
    assert d < 1e-4, f"adjoint grad vs FD: {d}"
    print(f"7 value_and_grad VdP x{Bg}: {dt*1e3:9.3f} ms; dL/dmu vs FD "
          f"|d| {d:.1e}")
    return {"7_value_and_grad_ms": dt * 1e3}


def config8():
    """Banded vs dense ESDIRK Newton linear algebra at scale (reference
    splu route common.py:1756-1776): Medazko reaction-transport at
    n = 512/1024/2048 through the device driver, KC4I, bands=True
    (block cyclic reduction) vs the dense path."""
    from extensisq_tpu.methods import KC4I
    from extensisq_tpu.problems import medazko

    out = {}
    for N in (256, 512, 1024):
        P = medazko(N)
        n = 2 * N

        def run_one(kw):
            run = jax.jit(lambda y0: solve(
                P.rhs, (0.0, 20.0), y0, method=KC4I, rtol=1e-3,
                atol=1e-6, max_steps=400,
                jac_sparsity=P.jac_sparsity, **kw))
            return time_device(run, jnp.asarray(P.y0), reps=1)

        tb, rb = run_one(dict(bands=True))
        td, rd = run_one({})
        assert int(rb.status) == 1 and int(rd.status) == 1
        ds = abs(int(rb.nsteps) - int(rd.nsteps))
        assert ds <= (0 if n <= 512 else 1), \
            f"banded vs dense step drift at n={n}: {ds}"
        dy = float(np.max(np.abs(np.asarray(rb.y, np.float64)
                                 - np.asarray(rd.y, np.float64))))
        # BCR and dense LU round differently; with identical step
        # sequences both land within the solve tolerance (atol 1e-6)
        assert dy < 1e-5, f"banded vs dense endpoint at n={n}: {dy}"
        print(f"8 Medazko n={n} KC4I: banded {tb:9.4f} s vs dense "
              f"{td:9.4f} s; steps {int(rb.nsteps)}, endpoint |d| "
              f"{dy:.1e}")
        out[f"8_banded_n{n}_s"] = tb
        out[f"8_dense_n{n}_s"] = td
    return out


CONFIGS = (config1, config2, config3, config4, config5, config6, config7,
           config8)


def main():
    dev = device_check()[0]
    enable_compile_cache()
    print(f"device {dev.platform} {dev.device_kind} x{len(jax.devices())}"
          f"; nvidia-smi: {card_line()}")
    metrics = {}
    for cfg in CONFIGS:
        metrics.update(cfg())
    if "--json" in sys.argv:
        print(json.dumps({"device": {"platform": dev.platform,
                                     "kind": dev.device_kind,
                                     "count": len(jax.devices()),
                                     "card": card_line()},
                          "metrics": metrics}, default=float))


if __name__ == "__main__":
    main()
