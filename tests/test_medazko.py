"""Medazko 400-state reaction-transport problem: endpoint-digit
conformance for implicit methods (test_ivp.py:262-291).

The reference uses a sparse finite-difference Jacobian; here the dense
Jacobian comes from jax.jacfwd (one batched JVP sweep — no sparsity
bookkeeping needed on device)."""
import numpy as np
import pytest

from extensisq_tpu import solve_ivp, TRBDF2, KC3I, Kv3I
from extensisq_tpu.problems import medazko

N = 200
fun_medazko = medazko(N).rhs


@pytest.mark.parametrize("method", [TRBDF2, KC3I, Kv3I],
                         ids=lambda m: m.name)
def test_medazko_endpoint_digits(method):
    y0 = np.zeros(2 * N)
    y0[1::2] = 1.0
    res = solve_ivp(fun_medazko, [0, 20], y0, method=method)
    assert res.success
    f = 5.0 if method is TRBDF2 else 3.0
    np.testing.assert_allclose(res.y[78, -1], 0.233994e-3, rtol=f * 1e-2)
    np.testing.assert_allclose(res.y[79, -1], 0, atol=f * 1e-3)
    np.testing.assert_allclose(res.y[148, -1], 0.359561e-3, rtol=f * 1e-2)
    np.testing.assert_allclose(res.y[149, -1], 0, atol=f * 1e-3)
    np.testing.assert_allclose(res.y[198, -1], 0.117374129e-3,
                               rtol=f * 1e-2)
    np.testing.assert_allclose(res.y[199, -1], 0.6190807e-5, atol=f * 1e-3)
    np.testing.assert_allclose(res.y[238, -1], 0, atol=f * 1e-3)
    np.testing.assert_allclose(res.y[239, -1], 0.9999997, rtol=f * 1e-2)
