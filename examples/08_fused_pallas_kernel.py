"""The fused Pallas kernel: a whole adaptive ensemble solve in one GPU
kernel.

``ops.solve_fused_erk`` keeps the entire integration — the starting
step, stage evaluations, embedded error control, the accept/reject time
loop — inside a single ``pallas_call`` (Triton route).  One program
integrates a block of members; each state component is a vector over
the block.  There is no per-step kernel launch and no loop predicate
read by the host, which is what bounds the XLA device path for small
systems.

The RHS returns a tuple of components instead of ``jnp.stack`` (Triton
lowers no concatenation along a leading axis); the same function runs
on the XLA path.  In float64 the kernel takes exactly the steps
``solve_ensemble`` takes.

    python examples/08_fused_pallas_kernel.py              # on a GPU
    python examples/08_fused_pallas_kernel.py --interpret  # anywhere
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import time

import numpy as np
import jax
import jax.numpy as jnp

from extensisq_tpu import solve_ensemble, BS5
from extensisq_tpu.ops import solve_fused_erk

interpret = "--interpret" in _sys.argv


def vdp(t, y):
    return (y[1], 3.0 * (1.0 - y[0] ** 2) * y[1] - y[0])


def vdp_p(t, y, p):
    return (y[1], p[0] * (1.0 - y[0] ** 2) * y[1] - y[0])


B = 256 if interpret else 4096
rng = np.random.RandomState(0)
Y0 = jnp.asarray(np.stack([2.0 + 0.1 * rng.randn(B), np.zeros(B)], axis=1))
kw = dict(method=BS5, rtol=1e-6, atol=1e-9)

fused = jax.jit(lambda Y: solve_fused_erk(vdp, (0.0, 10.0), Y,
                                          interpret=interpret, **kw))
xla = jax.jit(lambda Y: solve_ensemble(vdp, (0.0, 10.0), Y, **kw))
yf, status, nsteps, nfev = fused(Y0)
out = xla(Y0)
print("fused:", yf.shape, "all ok:", bool(jnp.all(status == 1)),
      "mean steps:", float(nsteps.mean()))
print("same steps as solve_ensemble:",
      bool(jnp.all(nsteps == out.nsteps)),
      f"max |y_fused - y_xla| = {float(jnp.max(jnp.abs(yf - out.y))):.2e}")

if not interpret:
    for name, run in (("fused", fused), ("solve_ensemble", xla)):
        jax.block_until_ready(run(Y0))
        t0 = time.perf_counter()
        for _ in range(5):
            jax.block_until_ready(run(Y0))
        print(f"{name}: {(time.perf_counter() - t0) / 5 * 1e3:.3f} ms "
              f"on {jax.devices()[0].device_kind}")

# -- parameter sweeps: per-member params -------------------------------
# params=(B, k): the RHS gains a third argument p (a k-tuple of member
# vectors), so a mu-sweep runs as ONE kernel; each member keeps its own
# adaptive step sequence.  solve_ensemble(..., params_batch=...) takes
# the same function.
mus = jnp.linspace(0.5, 6.0, B)[:, None]
yp_, sp_, nsp, nfp = solve_fused_erk(vdp_p, (0.0, 10.0), Y0, params=mus,
                                     interpret=interpret, **kw)
print("mu sweep:", yp_.shape, "all ok:", bool(jnp.all(sp_ == 1)),
      "steps (mu=0.5 .. mu=6):", int(nsp[0]), "..", int(nsp[-1]))
