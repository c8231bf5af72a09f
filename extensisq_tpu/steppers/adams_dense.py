"""Adams (SWAG) dense output: Watts' dintp as polynomial coefficients.

The reference evaluates the smooth C1 interpolant of Watts & Shampine
point by point through g/w recurrences
(/root/reference/extensisq/shampine.py:498-587, SLATEC dintp.f).  Those
recurrences are polynomial in the normalized time xi, so here they run
once per step on *coefficient vectors* instead of scalars, producing
the framework's unified segment form
``y(xi) = y_old + sum_k Q[:, k] xi^(k+1)`` — exactly the same floating
arithmetic, vectorized over coefficients, jit/vmap-safe.

The extrapolated-final-step case (kold == 0) degenerates to the linear
interpolant (shampine.py:590-612).
"""
import jax
import jax.numpy as jnp
from ..core.numerics import einsum


def _shift_up(c):
    """multiply polynomial by xi: coefficients move up one degree."""
    return jnp.concatenate([jnp.zeros_like(c[..., :1]), c[..., :-1]],
                           axis=-1)


def dintp_coefficients(stepper, state):
    """Q (n, D-1) for the last accepted step of an Adams solve."""
    km = stepper.k_max
    D = km + 3                       # coefficients for xi^0 .. xi^{D-1}
    kold = state.kold
    alpha = state.alpha
    ow = state.w
    og = state.g
    gi = state.gi
    iv = state.iv
    ivc = state.ivc
    kgi = state.kgi
    iqq = jnp.asarray(stepper.iqq)   # (km+1,)
    real = state.h_previous.dtype

    # ---- scalar gdi (shampine.py:505-518) ----
    def gdi_direct(_):
        return gi[jnp.clip(kold - 1, 0, gi.shape[0] - 1)]

    def gdi_loop(_):
        use_iv = ivc != 0
        iw = iv[jnp.clip(ivc - 1, 0, iv.shape[0] - 1)]
        gdi0 = jnp.where(use_iv,
                         ow[jnp.clip(iw - 1, 0, ow.shape[0] - 1)],
                         iqq[jnp.clip(kold, 0, km)])
        m0 = jnp.where(use_iv, kold - iw + 2, 1)

        gdi = gdi0
        for i in range(km):
            active = (i >= m0) & (i < kold)
            val = -alpha[min(i, km - 1)] * gdi \
                + ow[jnp.clip(kold - i, 0, km - 1)]
            gdi = jnp.where(active, val, gdi)
        return gdi

    gdi = jax.lax.cond(kold <= kgi, gdi_direct, gdi_loop, operand=None)

    # gdif = diff(og[:kold+1], prepend=0) — masked full-length version
    midx = jnp.arange(km + 1)
    og_m = jnp.where(midx <= kold, og, 0.0)
    gdif = og_m - jnp.concatenate([jnp.zeros(1, og.dtype), og_m[:-1]])
    gdif = jnp.where(midx <= kold, gdif, 0.0)

    # ---- polynomial recurrences (shampine.py:540-560) ----
    # W[j] = xi^{j+2} * iqq[j], j = 0..kold  (rows > kold unused)
    jidx = jnp.arange(km + 1)
    W = jnp.zeros((km + 1, D), real)
    W = W.at[jidx, jnp.clip(jidx + 2, 0, D - 1)].set(
        jnp.where(jidx + 2 <= D - 1, iqq, 0.0))

    G = jnp.zeros((km + 1, D), real)
    G = G.at[0, 1].set(1.0)          # g_0 = xi
    G = G.at[1, 2].set(0.5)          # g_1 = xi^2 / 2

    for i in range(km):
        active = i < kold - 1
        alp = alpha[min(i + 1, km - 1)]
        lim = kold - i
        # gamma * W - alp * W_next, gamma = (1 - alp) + alp*xi
        W_next = jnp.concatenate([W[1:], jnp.zeros((1, D), real)])
        W_new = (1.0 - alp) * W + alp * _shift_up(W) - alp * W_next
        W = jnp.where(active & (jidx < lim)[:, None], W_new, W)
        G = G.at[min(i + 2, km)].set(
            jnp.where(active, W[0], G[min(i + 2, km)]))

    # sigma = (W[1] - (xi - 1) W[0]) / gdi
    sigma = (W[1] - _shift_up(W[0]) + W[0]) / gdi

    # delta-g polynomials, masked to rows <= kold
    G_m = jnp.where((midx <= kold)[:, None], G, 0.0)
    dG = G_m - jnp.concatenate([jnp.zeros((1, D), real), G_m[:-1]])
    dG = jnp.where((midx <= kold)[:, None], dG, 0.0)

    # yout = h * phi[:kold+1]^T (dG - gdif sigma) + sigma (y - oy) + oy
    h = state.h_previous
    phi = state.phi[:km + 1]         # rows 0..kold used (others masked)
    phi_m = jnp.where((midx <= kold)[:, None], phi, 0.0)
    terms = dG - gdif[:, None] * sigma[None, :]       # (km+1, D)
    Q_full = h * einsum("sn,sd->nd", phi_m.astype(state.y.dtype),
                            terms.astype(real))
    Q_full = Q_full + (state.y - state.y_old)[:, None] * sigma[None, :]

    # unified form: drop the (identically zero) constant coefficient
    Q = Q_full[:, 1:]

    # extrapolated final step -> linear interpolant
    Q_lin = jnp.zeros_like(Q)
    Q_lin = Q_lin.at[:, 0].set(state.y - state.y_old)
    return jnp.where(state.extrapolated | (kold == 0), Q_lin, Q)
