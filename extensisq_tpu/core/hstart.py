"""Watts' starting-step-size estimator, jit/vmap-native.

JAX-native rewrite of ``h_start`` (/root/reference/extensisq/common.py:519-763,
itself a translation of SLATEC dstrt.f).  Data-dependent branches of the
Fortran/numpy original become ``jnp.where`` masks; the Lipschitz sampling
loop has a static trip count ``min(neq+1, 3)`` so it unrolls at trace
time.  Evaluation count matches the reference (1 + min(neq+1, 3) RHS
evaluations) except in the rare overflow early-exit, where this version
keeps (masked) evaluating.
"""
import jax.numpy as jnp
import numpy as np

from .numerics import norm


def _copysign_like(mag, sign_src):
    """copysign for real parts with complex support like the reference's
    use of np.copysign/np.where at common.py:703-715."""
    return jnp.abs(mag) * jnp.where(sign_src >= 0, 1.0, -1.0)


def h_start(df, a, b, y, yprime, morder, rtol, atol, J=None, T=None,
            returnT=False):
    """Estimate a starting step size (signed, direction of ``b - a``).

    ``df`` must be jax-traceable.  ``J`` (optional dense Jacobian) and
    ``T`` (df/dt estimate) short-circuit the sampling, as used by the DAE
    consistent-IC path (common.py:716-718, 629-630).
    """
    y = jnp.asarray(y)
    yprime = jnp.asarray(yprime)
    neq = y.size
    if neq == 0:
        return jnp.inf

    is_complex = jnp.issubdtype(y.dtype, jnp.complexfloating)
    real_dtype = jnp.finfo(y.dtype).dtype
    finfo = np.finfo(np.dtype(real_dtype))
    big = np.sqrt(finfo.max)
    small = float(np.nextafter(finfo.epsneg, 1.0))
    relper = small ** 0.375

    etol = atol + rtol * jnp.abs(y)

    dx = b - a
    absdx = jnp.abs(dx)

    # bound on d f / d t
    da = jnp.sign(dx) * jnp.maximum(
        jnp.minimum(relper * jnp.abs(a), absdx), 100.0 * small * jnp.abs(a))
    da = jnp.where(da == 0.0, relper * dx, da)
    if T is None:
        sf = df(a + da, y)                                       # evaluate
    else:
        sf = yprime + da * jnp.asarray(T)
    yp = sf - yprime
    delf = norm(yp)
    dfdxb = jnp.where(delf < big * jnp.abs(da), delf / jnp.abs(da), big)
    fbnd = norm(sf)
    if returnT:
        return yp / da

    if J is None:
        # sample a local Lipschitz constant with min(neq+1, 3) probes
        dely = relper * norm(y)
        dely = jnp.where(dely == 0.0, relper, dely)
        dely = dely * jnp.sign(dx)
        delf = norm(yprime)
        fbnd = jnp.maximum(fbnd, delf)

        have_slope = delf != 0.0
        spy = jnp.where(have_slope, yprime, jnp.zeros_like(yprime))
        yp = jnp.where(have_slope, yprime, jnp.ones_like(yprime))
        delf = jnp.where(have_slope, delf, norm(jnp.ones_like(yprime)))

        dfdub = jnp.asarray(0.0, real_dtype)
        done = jnp.asarray(False)
        lk = min(neq + 1, 3)
        for k in range(1, lk + 1):
            pv = y + dely / delf * yp
            if k == 2:
                yp = df(a + da, pv)                              # evaluate
                pv = yp - sf
            else:
                yp = df(a, pv)                                   # evaluate
                pv = yp - yprime

            fbnd = jnp.where(done, fbnd, jnp.maximum(fbnd, norm(yp)))
            delf = norm(pv)
            overflow = delf >= big * jnp.abs(dely)
            dfdub = jnp.where(
                done, dfdub,
                jnp.where(overflow, big,
                          jnp.maximum(dfdub, delf / jnp.abs(dely))))
            done = done | overflow
            if k == lk:
                break

            # next perturbation vector, signs matched to local slopes
            delf = jnp.where(delf == 0.0, 1.0, delf)
            if k == 2:
                dy = jnp.where(y != 0, y, dely / relper)
            else:
                dy = jnp.where(pv != 0, pv, delf.astype(y.dtype)
                               * jnp.ones_like(pv))
            spy = jnp.where(spy != 0, spy, yp)
            yp_new = jnp.where(spy != 0,
                               _copysign_like(jnp.real(dy), jnp.real(spy)),
                               jnp.real(dy))
            if is_complex:
                yp_new = yp_new + 1j * jnp.where(
                    spy != 0,
                    _copysign_like(jnp.imag(dy), jnp.imag(spy)),
                    jnp.imag(dy))
            yp = yp_new.astype(y.dtype)
            delf = norm(yp)
    else:
        dfdub = jnp.linalg.norm(jnp.asarray(J))

    # second-derivative bound and tolerance midpoint
    ydpb = dfdxb + dfdub * fbnd
    tolexp = jnp.log10(etol) * jnp.ones_like(jnp.real(y))
    tolsum = jnp.sum(tolexp)
    tolmin = jnp.minimum(jnp.min(tolexp), big)
    tolp = 10.0 ** (0.5 * (tolsum / neq + tolmin) / (morder + 1))

    h = absdx
    srydpb = jnp.sqrt(0.5 * jnp.maximum(ydpb, 0.0))
    h = jnp.where(
        (ydpb == 0.0) & (fbnd == 0.0),
        jnp.where(tolp < 1.0, absdx * tolp, h),
        jnp.where(ydpb == 0.0,
                  jnp.where(tolp < fbnd * absdx, tolp / fbnd, h),
                  jnp.where(tolp < srydpb * absdx, tolp / srydpb, h)))
    h = jnp.where(dfdub != 0.0, jnp.minimum(h, 1.0 / dfdub), h)
    h = jnp.maximum(h, 100.0 * small * jnp.abs(a))
    h = jnp.where(h == 0.0, small * jnp.abs(b), h)
    return h * jnp.sign(dx)
