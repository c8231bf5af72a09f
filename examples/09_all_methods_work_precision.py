"""Work-precision sweep over every first-order method in one program.

Counterpart of the reference's ``all_methods.ipynb``: integrate one
problem at a tolerance ladder with ALL methods and tabulate
(RHS evaluations, achieved error).  On device the entire table is a single
batched computation per tolerance: the methods differ, so they compile
once each, but the ensemble axis of ``solve`` evaluates nothing
per-member on the host.

Run: python examples/09_all_methods_work_precision.py
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import jax
jax.config.update("jax_platforms", "cpu")   # example sized for CPU

import numpy as np
import jax.numpy as jnp                               # noqa: E402

from extensisq_tpu import (solve_ivp, BS5, Ts5, CK5, Me4, Pr7, Pr8,  # noqa
                           Pr9, CFMR7osc, CKdisc, SWAG, SSV2stab,
                           TRBDF2, TRX2, KC3I, KC4I, KC4Ia, Kv3I)
from extensisq_tpu.problems import rational           # noqa: E402

P = rational()
EXACT = np.asarray(P.solution(P.t_span[1])).ravel()

METHODS = [BS5, Ts5, CK5, Me4, Pr7, Pr8, Pr9, CFMR7osc, CKdisc, SWAG,
           SSV2stab, TRBDF2, TRX2, KC3I, KC4I, KC4Ia, Kv3I]

print(f"rational problem, t in {P.t_span}; error at t_f vs exact")
print(f"{'method':<10}" + "".join(f"  rtol=1e-{k}:  nfev     err"
                                  for k in (3, 6, 9)))
for m in METHODS:
    cells = []
    for k in (3, 6, 9):
        rtol = 10.0 ** -k
        r = solve_ivp(P.rhs, P.t_span, P.y0, method=m, rtol=rtol,
                      atol=rtol * 1e-3)
        if not r.success:
            # SSV2stab fails here exactly like the reference: the rho
            # power iteration does not converge on this problem
            cells.append(f"  {r.nfev:>10}  {'FAIL':>8}")
            continue
        err = float(np.max(np.abs(r.y[:, -1] - EXACT)))
        cells.append(f"  {r.nfev:>10}  {err:8.1e}")
    print(f"{m.name:<10}" + "".join(cells))

print("\nhigher order => flatter cost growth toward tight tolerances;"
      "\nimplicit methods pay Newton overhead on this nonstiff problem.")
