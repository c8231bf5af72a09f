"""Sharded-state PDE integration (BASELINE config 5).

A 2-D Brusselator reaction-diffusion system, semi-discretized to a big
state vector and sharded across all available devices.  The stencil RHS
is plain jnp shift ops, so GSPMD partitions it automatically: neighbor
slices become halo exchanges, and the solver's error-norm
reductions become all-reduces.

Run with 8 virtual devices on CPU:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/05_sharded_pde.py
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from extensisq_tpu import solve, SSV2stab
from extensisq_tpu.parallel import (brusselator_2d_rhs,
                                    brusselator_rho_bound, make_mesh,
                                    shard_state)

shape = (256, 256)                    # 131,072 states
rhs = brusselator_2d_rhs(shape, alpha=0.02)
rho = brusselator_rho_bound(shape, alpha=0.02)

ny, nx = shape
xg, yg = np.meshgrid(np.linspace(0, 1, nx, endpoint=False),
                     np.linspace(0, 1, ny, endpoint=False))
u0 = 1.0 + 0.5 * np.sin(2 * np.pi * xg) * np.sin(2 * np.pi * yg)
v0 = 3.0 + 0.1 * np.cos(2 * np.pi * xg)
y0 = jnp.asarray(np.concatenate([u0.ravel(), v0.ravel()]))

mesh = make_mesh(("space",))
print("mesh:", mesh)
y0s = shard_state(y0, mesh, P("space"))

run = jax.jit(lambda y: solve(rhs, (0.0, 1.0), y, method=SSV2stab,
                              rtol=1e-4, atol=1e-7, rho_jac=rho))
out = run(y0s)
np.asarray(out.y)
t0 = time.perf_counter()
out = run(y0s)
np.asarray(out.y)
dt = time.perf_counter() - t0

print(f"status={int(out.status)} steps={int(out.nsteps)} "
      f"nfev={int(out.nfev)} wall={dt:.2f}s")
print("output sharding:", out.y.sharding)
