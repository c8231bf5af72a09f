"""The north-star workload: a 4096-member Van der Pol ensemble as one
XLA program (BASELINE.json).  Each member carries its own adaptive step
size; the whole adaptive integration compiles to one ``while_loop``
program.  ``bench.py`` times the same solve on the GPU.
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import time

import jax
import jax.numpy as jnp
import numpy as np

from extensisq_tpu import solve_ensemble, BS5

B = 4096


def vdp(t, y, mu):
    return jnp.stack([y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]])


y0 = jnp.stack([jnp.linspace(1.5, 2.5, B), jnp.zeros(B)], axis=1)
mus = jnp.linspace(1.0, 4.0, B)

run = jax.jit(lambda Y, M: solve_ensemble(
    vdp, (0.0, 10.0), Y, params_batch=M, method=BS5,
    rtol=1e-6, atol=1e-9))

out = run(y0, mus)                      # compile + run
np.asarray(out.y)                       # force completion
t0 = time.perf_counter()
out = run(y0, mus)
np.asarray(out.y)
dt = time.perf_counter() - t0

print(f"members: {B}, all finished: {bool(jnp.all(out.status == 1))}")
print(f"total adaptive steps: {int(out.nsteps.sum())}, "
      f"RHS evals: {int(out.nfev.sum())}")
print(f"wall: {dt * 1e3:.1f} ms  "
      f"({int(out.nsteps.sum()) / dt / 1e6:.2f} M steps/s)")
print("per-member step counts range:",
      int(out.nsteps.min()), "-", int(out.nsteps.max()))
