"""Device-loop solver tests: full-trajectory jit, vmap ensembles,
t_eval on device, and sharded execution on the virtual CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from extensisq_tpu import solve_ivp, BS5, Ts5, CK5
from extensisq_tpu.solve import solve, solve_ensemble


def vdp(t, y):
    return jnp.stack([y[1], 3.0 * (1 - y[0] ** 2) * y[1] - y[0]])


def test_device_matches_host():
    s = jax.jit(lambda y0: solve(vdp, (0.0, 10.0), y0, method=BS5,
                                 rtol=1e-6, atol=1e-9))(
        jnp.array([2.0, 0.0]))
    r = solve_ivp(vdp, (0, 10), [2.0, 0.0], method=BS5, rtol=1e-6,
                  atol=1e-9)
    assert int(s.status) == 1
    assert int(s.nsteps) == r.nsteps
    assert int(s.nfev) == r.nfev
    np.testing.assert_allclose(np.asarray(s.y), r.y[:, -1], rtol=1e-12)


def test_device_backward():
    s = solve(lambda t, y: -y, (2.0, 0.0), jnp.array([1.0]), method=Ts5,
              rtol=1e-8, atol=1e-10)
    assert int(s.status) == 1
    np.testing.assert_allclose(float(s.y[0]), np.exp(2.0), rtol=1e-6)


def test_device_t_eval():
    te = jnp.linspace(0.0, 10.0, 9)
    s = jax.jit(lambda y0: solve(vdp, (0.0, 10.0), y0, method=BS5,
                                 rtol=1e-6, atol=1e-9, t_eval=te))(
        jnp.array([2.0, 0.0]))
    r = solve_ivp(vdp, (0, 10), [2.0, 0.0], method=BS5, rtol=1e-6,
                  atol=1e-9, t_eval=np.asarray(te), interpolant="free")
    np.testing.assert_allclose(np.asarray(s.y_eval).T, r.y, atol=1e-7)


def test_device_save_steps():
    s = solve(vdp, (0.0, 5.0), jnp.array([2.0, 0.0]), method=CK5,
              rtol=1e-6, atol=1e-9, save_steps=True)
    nst = int(s.nsteps)
    ts = np.asarray(s.ts)[:nst]
    ys = np.asarray(s.ys)[:nst]
    assert np.all(np.diff(ts) > 0)
    assert ts[-1] == 5.0
    np.testing.assert_allclose(ys[-1], np.asarray(s.y), rtol=1e-10)


def test_ensemble_vmap():
    B = 32
    Y0 = jnp.stack([jnp.linspace(1.5, 2.5, B), jnp.zeros(B)], axis=1)
    out = jax.jit(lambda Y: solve_ensemble(vdp, (0.0, 10.0), Y,
                                           method=BS5, rtol=1e-6,
                                           atol=1e-9))(Y0)
    assert bool(jnp.all(out.status == 1))
    # per-member adaptive stepping: step counts differ across members
    assert int(out.nsteps.max()) > int(out.nsteps.min())
    # spot-check one member against the host driver
    r = solve_ivp(vdp, (0, 10), np.asarray(Y0[7]), method=BS5,
                  rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(out.y[7]), r.y[:, -1],
                               rtol=1e-10, atol=1e-12)


def test_ensemble_batched_params():
    def fun(t, y, p):
        return jnp.stack([y[1], p * (1 - y[0] ** 2) * y[1] - y[0]])

    B = 8
    Y0 = jnp.tile(jnp.array([2.0, 0.0]), (B, 1))
    mus = jnp.linspace(1.0, 4.0, B)
    out = solve_ensemble(fun, (0.0, 5.0), Y0, params_batch=mus,
                         method=BS5, rtol=1e-6, atol=1e-9)
    assert bool(jnp.all(out.status == 1))
    mu3 = float(mus[3])
    r = solve_ivp(lambda t, y: fun(t, y, mu3), (0, 5),
                  [2.0, 0.0], method=BS5, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(out.y[3]), r.y[:, -1],
                               rtol=1e-10, atol=1e-12)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_ensemble_step():
    """Graft-entry style: ensemble x space sharded solver step."""
    import __graft_entry__ as g
    g.dryrun_multichip(8)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_full_solve():
    """Full device solve with ensemble axis sharded over the mesh."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    B = 64
    Y0 = jnp.stack([jnp.linspace(1.5, 2.5, B), jnp.zeros(B)], axis=1)
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("ensemble",))
    Y0s = jax.device_put(Y0, NamedSharding(mesh, P("ensemble", None)))
    out = jax.jit(lambda Y: solve_ensemble(vdp, (0.0, 10.0), Y,
                                           method=BS5, rtol=1e-6,
                                           atol=1e-9))(Y0s)
    jax.block_until_ready(out)
    assert bool(jnp.all(out.status == 1))
    ref = solve_ivp(vdp, (0, 10), np.asarray(Y0[0]), method=BS5,
                    rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(out.y[0]), ref.y[:, -1],
                               rtol=1e-9, atol=1e-12)


def test_device_events():
    def fun(t, y):
        return jnp.stack([y[1], -y[0]])

    def ev1(t, y):
        return y[0] - 0.5

    def ev2(t, y):
        return y[1]
    ev2.terminal = True

    out = jax.jit(lambda y0: solve(fun, (0.0, 10.0), y0, method=BS5,
                                   rtol=1e-9, atol=1e-12,
                                   events=(ev1, ev2)))(
        jnp.array([0.0, 1.0]))
    assert int(out.status) == 8        # terminal event
    np.testing.assert_allclose(float(out.t), np.pi / 2, rtol=1e-9)
    assert int(out.n_events[0]) == 1
    np.testing.assert_allclose(float(out.t_events[0, 0]),
                               np.arcsin(0.5), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(out.y_events[1, 0]),
                               [1.0, 0.0], atol=1e-8)


def test_device_events_direction():
    def fun(t, y):
        return jnp.stack([y[1], -y[0]])

    def crossing(t, y):
        return y[0]
    crossing.direction = -1            # only downward crossings

    out = solve(fun, (0.0, 13.0), jnp.array([0.0, 1.0]), method=BS5,
                rtol=1e-9, atol=1e-12, events=crossing)
    k = int(out.n_events[0])
    roots = np.asarray(out.t_events[0, :k])
    # sin(t) crosses downward at pi, 3pi
    np.testing.assert_allclose(roots, [np.pi, 3 * np.pi], rtol=1e-8)


def test_device_events_vmapped():
    """Per-member event roots for a whole ensemble in one program —
    something the reference's host-driven event loop cannot express."""
    def fun(t, y, w):
        return jnp.stack([y[1], -w * y[0]])

    def hit(t, y):
        return y[0]
    hit.terminal = True
    hit.direction = -1

    ws = jnp.linspace(1.0, 4.0, 8)
    out = jax.vmap(lambda w: solve(
        lambda t, y: fun(t, y, w), (0.0, 20.0),
        jnp.array([0.0, 1.0]), method=BS5, rtol=1e-9, atol=1e-12,
        events=hit))(ws)
    assert bool(jnp.all(out.status == 8))
    # sin(sqrt(w) t) first downward zero at pi/sqrt(w)
    np.testing.assert_allclose(np.asarray(out.t),
                               np.pi / np.sqrt(np.asarray(ws)),
                               rtol=1e-8)


def test_device_ode_solution():
    """OdeSolution built from the device record matches the host
    driver's dense output."""
    s = solve(vdp, (0.0, 5.0), jnp.array([2.0, 0.0]), method=BS5,
              rtol=1e-8, atol=1e-11, save_steps=True)
    sol = s.ode_solution()
    r = solve_ivp(vdp, (0, 5), [2.0, 0.0], method=BS5, rtol=1e-8,
                  atol=1e-11, dense_output=True, interpolant="free")
    tc = np.linspace(0.0, 5.0, 23)
    np.testing.assert_allclose(np.asarray(sol(tc)),
                               np.asarray(r.sol(tc)), atol=1e-10)
    # and it is traceable (usable inside jit, e.g. adjoint RHS)
    val = jax.jit(lambda t: sol(t))(jnp.asarray(2.5))
    np.testing.assert_allclose(np.asarray(val),
                               np.asarray(sol(jnp.asarray(2.5))))


def test_solve_windowed():
    """Long-horizon chunked driver: two compiles serve all windows and
    the warm-started chunked solve is BIT-IDENTICAL to the single-shot
    solve — same terminal state, same step/eval counters (the windows
    pause the loop instead of clamping steps at the edges)."""
    from extensisq_tpu import solve_windowed, SWAG

    def vdp(t, y):
        return jnp.stack([y[1], 5.0 * (1 - y[0] ** 2) * y[1] - y[0]])

    y0 = jnp.array([2.0, 0.0])
    out = solve_windowed(vdp, (0.0, 20.0), y0, 4, method=SWAG,
                         rtol=1e-8, atol=1e-10)
    single = jax.jit(lambda y: solve(vdp, (0.0, 20.0), y, method=SWAG,
                                     rtol=1e-8, atol=1e-10))(y0)
    assert int(out.status) == 1
    assert int(out.nsteps) == int(single.nsteps)
    assert int(out.nfev) == int(single.nfev)
    assert int(out.nfailed) == int(single.nfailed)
    np.testing.assert_array_equal(np.asarray(out.y),
                                  np.asarray(single.y))
    with pytest.raises(ValueError):
        solve_windowed(vdp, (0.0, 1.0), y0, 2, method=SWAG,
                       save_steps=True)
    with pytest.raises(ValueError):
        solve_windowed(vdp, (0.0, 1.0), y0, 2, method=SWAG,
                       t_eval=jnp.linspace(0.0, 1.0, 5))


def test_solve_windowed_backward():
    """Backward spans through solve_windowed must integrate backward:
    the window edges are traced jit arguments, so direction must be a
    traced value (round-1 advisor finding: the old concrete fallback
    returned exp(-t) for a backward exponential with status=success)."""
    from extensisq_tpu import solve_windowed

    out = solve_windowed(lambda t, y: y, (0.1, 0.0),
                         jnp.array([1.0]), 2, method=BS5,
                         rtol=1e-10, atol=1e-12)
    assert int(out.status) == 1
    np.testing.assert_allclose(float(out.y[0]), np.exp(-0.1),
                               rtol=1e-9)
    out2 = solve_windowed(lambda t, y: -y, (2.0, 0.0),
                          jnp.array([1.0]), 3, method=BS5,
                          rtol=1e-10, atol=1e-12)
    assert int(out2.status) == 1
    np.testing.assert_allclose(float(out2.y[0]), np.exp(2.0),
                               rtol=1e-8)


def test_solve_windowed_ensemble_bitexact():
    """Warm-started windowing composes with vmap + per-member params:
    still bit-identical to the unwindowed ensemble solve."""
    from extensisq_tpu import solve_windowed, solve_ensemble, SWAG

    def vdpp(t, y, mu):
        return jnp.stack([y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]])

    B = 8
    Y0 = jnp.stack([jnp.linspace(1.9, 2.1, B), jnp.zeros(B)], axis=1)
    mus = jnp.linspace(2.0, 6.0, B)
    out = solve_windowed(vdpp, (0.0, 40.0), Y0, 5, method=SWAG,
                         ensemble=True, params_batch=mus,
                         rtol=1e-7, atol=1e-9)
    ref = solve_ensemble(vdpp, (0.0, 40.0), Y0, params_batch=mus,
                         method=SWAG, rtol=1e-7, atol=1e-9)
    assert bool(jnp.all(out.status == 1))
    np.testing.assert_array_equal(np.asarray(out.y), np.asarray(ref.y))
    np.testing.assert_array_equal(np.asarray(out.nsteps),
                                  np.asarray(ref.nsteps))
    np.testing.assert_array_equal(np.asarray(out.nfev),
                                  np.asarray(ref.nfev))


@pytest.mark.parametrize("name", ["BS5", "Ts5", "CK5", "Me4", "Pr7", "Pr8",
                                  "Pr9", "CFMR7osc"])
def test_float32_states_stay_float32(name):
    """A float32 ensemble runs in float32 through every explicit pair
    (the two-phase BS5/CFMR7osc error test included) and lands within
    tolerance of the float64 solve."""
    from extensisq_tpu import METHODS_BY_NAME

    def vdp(t, y):
        return (y[1], 2.0 * (1 - y[0] ** 2) * y[1] - y[0])

    Y0 = jnp.stack([jnp.linspace(1.5, 2.5, 8), jnp.zeros(8)], axis=1)
    kw = dict(method=METHODS_BY_NAME[name], rtol=1e-4, atol=1e-7)
    run = jax.jit(lambda Y: solve_ensemble(vdp, (0.0, 4.0), Y, **kw))
    out32 = run(Y0.astype(jnp.float32))
    out64 = run(Y0)
    assert out32.y.dtype == jnp.float32
    assert bool(jnp.all(out32.status == 1))
    assert float(jnp.max(jnp.abs(out32.y - out64.y))) < 1e-2
