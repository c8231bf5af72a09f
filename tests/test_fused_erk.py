"""The whole-solve ERK kernel (Pallas, Triton route).

On the CPU the kernel runs in the Pallas interpreter, in float64, and
must take exactly the steps of the XLA path (``solve_ensemble``): it
mirrors ``steppers/erk.py`` operation for operation.  The lowering
tests compile each method for CUDA from this CPU-only machine, which is
where a primitive Triton cannot lower shows up.  The ``gpu`` test runs
the compiled kernel and skips where there is no card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import extensisq_tpu as ex
from extensisq_tpu._config import (FINISHED, MAX_STEPS_REACHED, OVERFLOW,
                                   TOO_SMALL_STEP)
from extensisq_tpu.methods import EXPLICIT_METHODS
from extensisq_tpu.ops import solve_fused_erk

ERK = [m.name for m in EXPLICIT_METHODS if m.family == "erk"]


def vdp(t, y):
    return (y[1], 3.0 * (1 - y[0] ** 2) * y[1] - y[0])


def vdp_p(t, y, p):
    return (y[1], p[0] * (1 - y[0] ** 2) * y[1] - y[0])


def _y0(n):
    return jnp.stack([jnp.linspace(1.5, 2.5, n), jnp.linspace(-0.5, 0.5, n)],
                     axis=1)


def _same_as_xla(out, ref, tol=1e-10):
    y, status, nsteps, nfev = out
    np.testing.assert_array_equal(np.asarray(status), np.asarray(ref.status))
    np.testing.assert_array_equal(np.asarray(nsteps), np.asarray(ref.nsteps))
    np.testing.assert_array_equal(np.asarray(nfev), np.asarray(ref.nfev))
    np.testing.assert_allclose(np.asarray(y), np.asarray(ref.y), rtol=tol,
                               atol=tol)


def test_erk_methods_listed():
    assert ERK == ["BS5", "Ts5", "CK5", "Me4", "Pr7", "Pr8", "Pr9",
                   "CFMR7osc"]


@pytest.mark.parametrize("name", ERK)
def test_interpret_matches_solve_ensemble(name):
    """float64 in the interpreter: the same steps, RHS evaluations and
    endpoint as the XLA path, for every explicit pair."""
    method = ex.METHODS_BY_NAME[name]
    Y0 = _y0(40)
    kw = dict(method=method, rtol=1e-6, atol=1e-9)
    out = solve_fused_erk(vdp, (0.0, 2.0), Y0, block_members=32,
                          interpret=True, **kw)
    ref = jax.jit(lambda Y: ex.solve_ensemble(vdp, (0.0, 2.0), Y, **kw))(Y0)
    assert np.all(np.asarray(out[1]) == FINISHED)
    _same_as_xla(out, ref)


@pytest.mark.parametrize("block", [32, 128])
@pytest.mark.parametrize("name", ERK)
def test_lowers_for_cuda(name, block):
    """Each method lowers through Triton for CUDA at two block sizes;
    this catches primitives Triton cannot lower without a card."""
    method = ex.METHODS_BY_NAME[name]
    f = jax.jit(lambda Y: solve_fused_erk(
        vdp, (0.0, 2.0), Y, method=method, rtol=1e-6, atol=1e-9,
        block_members=block))
    text = f.trace(jnp.ones((512, 2))).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "triton" in text.lower()


def test_ragged_batch_padding():
    """B not a multiple of the block: padded members repeat the last
    one and are cut off again."""
    Y0 = _y0(37)
    kw = dict(method=ex.BS5, rtol=1e-5, atol=1e-8)
    out = solve_fused_erk(vdp, (0.0, 1.0), Y0, block_members=16,
                          interpret=True, **kw)
    assert out[0].shape == (37, 2)
    assert all(o.shape == (37,) for o in out[1:])
    ref = jax.jit(lambda Y: ex.solve_ensemble(vdp, (0.0, 1.0), Y, **kw))(Y0)
    _same_as_xla(out, ref)


def test_per_member_params():
    """fun(t, y, p): the same function serves solve_ensemble's
    params_batch."""
    Y0 = _y0(24)
    P = jnp.linspace(0.5, 4.0, 24)[:, None]
    kw = dict(method=ex.CK5, rtol=1e-6, atol=1e-9)
    out = solve_fused_erk(vdp_p, (0.0, 2.0), Y0, params=P, block_members=8,
                          interpret=True, **kw)
    ref = jax.jit(lambda Y, Q: ex.solve_ensemble(
        vdp_p, (0.0, 2.0), Y, params_batch=Q, **kw))(Y0, P)
    _same_as_xla(out, ref)
    # the parameter changes the answer
    assert np.ptp(np.asarray(out[2])) > 0


def test_max_step_and_first_step():
    Y0 = _y0(16)
    kw = dict(method=ex.Ts5, rtol=1e-5, atol=1e-8, max_step=0.05,
              first_step=1e-3)
    out = solve_fused_erk(vdp, (0.0, 1.0), Y0, block_members=16,
                          interpret=True, **kw)
    ref = jax.jit(lambda Y: ex.solve_ensemble(vdp, (0.0, 1.0), Y, **kw))(Y0)
    _same_as_xla(out, ref)
    assert np.all(np.asarray(out[2]) >= 20)        # 1.0 / 0.05


def test_backward_span():
    Y0 = _y0(16)
    kw = dict(method=ex.BS5, rtol=1e-6, atol=1e-9)
    out = solve_fused_erk(vdp, (1.0, -1.0), Y0, block_members=16,
                          interpret=True, **kw)
    ref = jax.jit(lambda Y: ex.solve_ensemble(vdp, (1.0, -1.0), Y, **kw))(Y0)
    _same_as_xla(out, ref)


def test_failure_statuses_per_member():
    """A member that blows up ends with status 2 or 3 like the XLA
    path's, and its neighbours in the block still finish."""
    def blowup(t, y):
        return (y[0] * y[0], -y[1])

    Y0 = jnp.stack([jnp.array([0.1, 1.0, 0.2, 5.0]), jnp.ones(4)], axis=1)
    kw = dict(method=ex.BS5, rtol=1e-6, atol=1e-9)
    out = solve_fused_erk(blowup, (0.0, 2.0), Y0, block_members=4,
                          interpret=True, **kw)
    ref = jax.jit(lambda Y: ex.solve_ensemble(blowup, (0.0, 2.0), Y,
                                              **kw))(Y0)
    status = np.asarray(out[1])
    np.testing.assert_array_equal(status, np.asarray(ref.status))
    assert status[0] == FINISHED and status[2] == FINISHED
    assert set(status[[1, 3]]) <= {TOO_SMALL_STEP, OVERFLOW}


def test_overflow_status():
    def explode(t, y):
        return (jnp.exp(y[0]), y[1])

    Y0 = jnp.array([[0.0, 1.0], [800.0, 1.0]])
    kw = dict(method=ex.CK5, rtol=1e-6, atol=1e-9)
    out = solve_fused_erk(explode, (0.0, 0.1), Y0, block_members=2,
                          interpret=True, **kw)
    ref = jax.jit(lambda Y: ex.solve_ensemble(explode, (0.0, 0.1), Y,
                                              **kw))(Y0)
    np.testing.assert_array_equal(np.asarray(out[1]),
                                  np.asarray(ref.status))
    assert int(out[1][0]) == FINISHED and int(out[1][1]) == OVERFLOW


def test_max_steps_cap():
    Y0 = _y0(8)
    kw = dict(method=ex.BS5, rtol=1e-8, atol=1e-10, max_steps=5)
    out = solve_fused_erk(vdp, (0.0, 5.0), Y0, block_members=8,
                          interpret=True, **kw)
    ref = jax.jit(lambda Y: ex.solve_ensemble(vdp, (0.0, 5.0), Y, **kw))(Y0)
    _same_as_xla(out, ref)
    assert np.all(np.asarray(out[1]) == MAX_STEPS_REACHED)
    assert np.all(np.asarray(out[2]) == 5)


def test_float32_state():
    Y0 = _y0(16).astype(jnp.float32)
    out = solve_fused_erk(vdp, (0.0, 2.0), Y0, method=ex.BS5, rtol=1e-4,
                          atol=1e-7, block_members=16, interpret=True)
    assert out[0].dtype == jnp.float32
    assert np.all(np.asarray(out[1]) == FINISHED)
    ref = jax.jit(lambda Y: ex.solve_ensemble(
        vdp, (0.0, 2.0), Y, method=ex.BS5, rtol=1e-4, atol=1e-7))(
        Y0.astype(jnp.float64))
    assert float(jnp.max(jnp.abs(out[0] - ref.y))) < 1e-3


def test_wrapper_rejects_bad_arguments():
    Y0 = _y0(8)
    with pytest.raises(ValueError, match="power of two"):
        solve_fused_erk(vdp, (0.0, 1.0), Y0, block_members=48)
    with pytest.raises(ValueError, match="family 'erk'"):
        solve_fused_erk(vdp, (0.0, 1.0), Y0, method=ex.Kv3I)
    with pytest.raises(ValueError, match=r"\(B, k\)"):
        solve_fused_erk(vdp_p, (0.0, 1.0), Y0, params=jnp.ones(8))
    with pytest.raises(ValueError, match="components"):
        solve_fused_erk(lambda t, y: (y[1],), (0.0, 1.0), Y0,
                        block_members=8, interpret=True)


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the compiled kernel has no CPU path")
    return jax.devices()[0]


@pytest.mark.gpu
def test_compiled_kernel_on_gpu(gpu):
    Y0 = _y0(1000)
    kw = dict(method=ex.BS5, rtol=1e-6, atol=1e-9)
    out = jax.jit(lambda Y: solve_fused_erk(vdp, (0.0, 5.0), Y,
                                            block_members=64, **kw))(Y0)
    ref = jax.jit(lambda Y: ex.solve_ensemble(vdp, (0.0, 5.0), Y, **kw))(Y0)
    assert np.all(np.asarray(out[1]) == FINISHED)
    same = np.asarray(out[2]) == np.asarray(ref.nsteps)
    assert np.sum(~same) <= 3
    np.testing.assert_allclose(np.asarray(out[0])[same],
                               np.asarray(ref.y)[same], atol=1e-9)
