"""Watts' starting-step estimator on row tuples, for use inside the
fused ERK kernel.

The same arithmetic as :func:`extensisq_tpu.core.hstart.h_start` (the
rewrite of SLATEC dstrt.f) in the same order, so that a fused solve
starts from the step the XLA path starts from.  A state is a tuple of
``n`` rows, each a vector over the block's members; norms and
reductions over the state run over the tuple.  Costs
``1 + min(n + 1, 3)`` RHS evaluations, the stepper's own accounting
(steppers/erk.py).
"""
import jax.numpy as jnp
import numpy as np


def rows_norm(x):
    """RMS over the state components, per member (core.numerics.norm)."""
    acc = x[0] * x[0]
    for xi in x[1:]:
        acc = acc + xi * xi
    return jnp.sqrt(acc / len(x))


def _copysign_like(mag, sign_src):
    return jnp.abs(mag) * jnp.where(sign_src >= 0, 1.0, -1.0)


def hstart_rows(df, a, b, y, f, morder, rtol, atol):
    """Signed starting step per member.

    ``df(t, rows) -> rows``; ``a``, ``b``, ``rtol``, ``atol`` are member
    vectors; ``y``, ``f`` row tuples of the block's dtype.
    """
    n = len(y)
    finfo = np.finfo(y[0].dtype)
    big = float(np.sqrt(finfo.max))
    small = float(np.nextafter(finfo.epsneg, 1.0))
    relper = small ** 0.375

    etol = [atol + rtol * jnp.abs(yi) for yi in y]

    dx = b - a
    absdx = jnp.abs(dx)

    # bound on d f / d t
    da = jnp.sign(dx) * jnp.maximum(
        jnp.minimum(relper * jnp.abs(a), absdx), 100.0 * small * jnp.abs(a))
    da = jnp.where(da == 0.0, relper * dx, da)
    sf = df(a + da, y)                                           # evaluate
    delf = rows_norm([s - fi for s, fi in zip(sf, f)])
    dfdxb = jnp.where(delf < big * jnp.abs(da), delf / jnp.abs(da), big)
    fbnd = rows_norm(sf)

    # local Lipschitz constant from min(n + 1, 3) probes
    dely = relper * rows_norm(y)
    dely = jnp.where(dely == 0.0, relper, dely)
    dely = dely * jnp.sign(dx)
    delf = rows_norm(f)
    fbnd = jnp.maximum(fbnd, delf)

    have_slope = delf != 0.0
    spy = [jnp.where(have_slope, fi, 0.0) for fi in f]
    yp = [jnp.where(have_slope, fi, 1.0) for fi in f]
    delf = jnp.where(have_slope, delf, 1.0)

    dfdub = jnp.zeros_like(delf)
    done = delf != delf                    # all-false member mask
    lk = min(n + 1, 3)
    for k in range(1, lk + 1):
        pv = [yi + dely / delf * ypi for yi, ypi in zip(y, yp)]
        if k == 2:
            yp = df(a + da, pv)                                  # evaluate
            pv = [v - s for v, s in zip(yp, sf)]
        else:
            yp = df(a, pv)                                       # evaluate
            pv = [v - fi for v, fi in zip(yp, f)]

        fbnd = jnp.where(done, fbnd, jnp.maximum(fbnd, rows_norm(yp)))
        delf = rows_norm(pv)
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
            dy = [jnp.where(yi != 0, yi, dely / relper) for yi in y]
        else:
            dy = [jnp.where(v != 0, v, delf) for v in pv]
        spy = [jnp.where(s != 0, s, v) for s, v in zip(spy, yp)]
        yp = [jnp.where(s != 0, _copysign_like(d, s), d)
              for s, d in zip(spy, dy)]
        delf = rows_norm(yp)

    # second-derivative bound and tolerance midpoint
    ydpb = dfdxb + dfdub * fbnd
    tolexp = [jnp.log10(e) for e in etol]
    tolsum = tolexp[0]
    tolmin = tolexp[0]
    for e in tolexp[1:]:
        tolsum = tolsum + e
        tolmin = jnp.minimum(tolmin, e)
    tolmin = jnp.minimum(tolmin, big)
    tolp = 10.0 ** (0.5 * (tolsum / n + tolmin) / (morder + 1))

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
