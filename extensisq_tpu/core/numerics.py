"""Shared scalar kernels: RMS norm, error scale, tolerance validation.

JAX-native counterparts of the L2 kernels in
/root/reference/extensisq/common.py:30-66.  All device functions are pure
jax and work under jit/vmap for real and complex dtypes.
"""
from math import sqrt

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST


def matmul(a, b):
    """``a @ b`` at full precision: float32 products must not drop to
    TF32 on GPUs (a no-op for float64)."""
    return jnp.matmul(a, b, precision=_HIGHEST)


def einsum(spec, *ops):
    """``jnp.einsum`` at full precision (see :func:`matmul`)."""
    return jnp.einsum(spec, *ops, precision=_HIGHEST)


def norm(x):
    """Weighted-free RMS norm, complex-safe.

    Matches ``norm`` at /root/reference/extensisq/common.py:64-66:
    ``sqrt(real(x . conj(x)) / n)``.
    """
    x = jnp.asarray(x)
    if x.size == 0:
        return jnp.asarray(0.0)
    # multiply+reduce rather than jnp.vdot: identical arithmetic, and
    # no dot_general, so no TF32 question for float32 states
    if jnp.iscomplexobj(x):
        return jnp.sqrt(jnp.sum(jnp.real(x * jnp.conj(x))) / x.size)
    return jnp.sqrt(jnp.sum(x * x) / x.size)


def calculate_scale(atol, rtol, y, y_new, _mean=False):
    """Error-scale vector ``atol + rtol * max(|y|, |y_new|)``.

    The ``_mean`` variant (average of magnitudes) is what the Adams
    solver uses; cf. /root/reference/extensisq/common.py:57-61.
    """
    if _mean:
        return atol + rtol * 0.5 * (jnp.abs(y) + jnp.abs(y_new))
    return atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y_new))


def validate_tol(rtol, atol, y):
    """Host-side tolerance validation with RKSuite-style silent clipping.

    Bounds follow /root/reference/extensisq/common.py:30-54:
    ``atol >= sqrt(tiny)`` and ``10*epsneg <= rtol <= 0.1``.
    Returns numpy values (this runs at solver-construction time).
    """
    y = np.asarray(y)
    atol = np.asarray(atol, dtype=float)
    if atol.ndim > 0 and atol.shape != (y.size,):
        raise ValueError("`atol` has wrong shape.")
    if np.any(atol < 0):
        raise ValueError("`atol` must be positive.")
    rtol = float(rtol)
    if rtol < 0:
        raise ValueError("`rtol` must be positive.")

    finfo = np.finfo(y.dtype)
    atol = np.maximum(atol, sqrt(finfo.tiny))
    rtol = min(max(rtol, 10.0 * finfo.epsneg), 0.1)
    return rtol, atol


def dtype_constants(dtype):
    """Machine constants used by the steppers, resolved at build time."""
    finfo = np.finfo(np.dtype(dtype))
    return {
        "tiny": float(finfo.tiny),
        "epsneg": float(finfo.epsneg),
        "eps": float(finfo.eps),
        "big": sqrt(float(finfo.max)),
        "sqrt_tiny": sqrt(float(finfo.tiny)),
        # smallest u with (1 + u) > 1, as used by SLATEC translations
        "uround": float(np.nextafter(finfo.epsneg, 1.0)),
    }
