"""Explicit shard_map halo exchange for stencil right-hand sides.

The stencil RHSs in :mod:`extensisq_tpu.parallel.pde` are written with
plain ``jnp.roll`` and rely on GSPMD to turn the shifts into halo
exchanges.  That is the recommended path.  This module provides the
manual equivalent (SURVEY.md section 5.8): the state lives sharded over
a mesh axis, each device computes its local stencil, and the halos move
as explicit ``jax.lax.ppermute`` collectives.  Use it when the
automatic partitioner's choice needs to be pinned down (or audited),
and as the template for wider-stencil kernels.

Templates provided:

* :func:`halo_exchange` — generic periodic width-``w`` halo pad along
  the leading axis of a per-device block (1 ppermute pair per call;
  any interior rank).
* :func:`heat_1d_rhs_shardmap` — 1-D heat stencil.
* :func:`brusselator_2d_rhs_shardmap` — 2-D reaction-diffusion with the
  grid's row axis sharded; the arithmetic twin of
  ``pde.brusselator_2d_rhs_interleaved`` (bit-identical results, tested
  in ``tests/test_rkc.py`` and the driver's ``dryrun_multichip``).

A 3-D stencil (the RKC paper's N=40^3 flagship) shards the same way:
keep two axes local, shard the leading one, and call
:func:`halo_exchange` on it — the pattern does not change with rank.
"""
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

try:                                   # jax>=0.4.35 spelling
    from jax import shard_map
except ImportError:                    # pragma: no cover
    from jax.experimental.shard_map import shard_map


def _ring(k):
    """Neighbor permutations on a k-device ring."""
    send_right = [(i, (i + 1) % k) for i in range(k)]   # dest i gets i-1
    send_left = [((i + 1) % k, i) for i in range(k)]    # dest i gets i+1
    return send_right, send_left


def halo_exchange(block, axis_name, k, width=1):
    """Pad a per-device block with its ring neighbors' edge slabs.

    ``block`` is the device-local shard inside a ``shard_map``; the
    leading axis is the sharded one.  Returns the block extended to
    ``block.shape[0] + 2*width`` rows: ``width`` rows received from the
    left neighbor, the local rows, ``width`` rows from the right
    neighbor (periodic).  One ``ppermute`` pair regardless of rank.
    """
    send_right, send_left = _ring(k)
    lo = jax.lax.ppermute(block[-width:], axis_name, perm=send_right)
    hi = jax.lax.ppermute(block[:width], axis_name, perm=send_left)
    return jnp.concatenate([lo, block, hi])


def heat_1d_rhs_shardmap(mesh, axis="space", kappa=1.0, n=None, dx=None):
    """Periodic 1-D heat RHS with explicit one-point halo exchange.

    Numerically identical to ``pde.heat_1d_rhs`` (same stencil, same
    dtype arithmetic); the returned function expects ``u`` sharded as
    ``P(axis)`` over ``mesh`` and is jit/vmap-compatible.
    """
    if dx is None:
        dx = 1.0 / n
    k = mesh.shape[axis]

    def local(u):
        um = halo_exchange(u, axis, k)
        return kappa * (um[:-2] - 2.0 * u + um[2:]) / dx ** 2

    inner = shard_map(local, mesh=mesh, in_specs=P(axis),
                      out_specs=P(axis))

    def rhs(t, u):
        return inner(u)

    return rhs


def heat_3d_rhs_shardmap(mesh, shape, axis="space", kappa=1.0, dx=None):
    """Periodic 3-D heat RHS, z-slabs sharded, explicit slab halos.

    The 3-D instantiation of the same pattern: shard the leading grid
    axis, keep the other two local, one :func:`halo_exchange` per eval.
    Arithmetic twin of ``pde.heat_3d_rhs`` (bit-identical).  Requires
    ``nz % mesh.shape[axis] == 0``.
    """
    nz, ny, nx = shape
    if dx is None:
        dx = 1.0 / nx
    k = mesh.shape[axis]
    if nz % k != 0:
        raise ValueError(f"nz={nz} not divisible by mesh axis size {k}")

    def local(y):
        u = y.reshape(-1, ny, nx)
        um = halo_exchange(u, axis, k)
        lap = (um[:-2] + um[2:]
               + jnp.roll(u, 1, 1) + jnp.roll(u, -1, 1)
               + jnp.roll(u, 1, 2) + jnp.roll(u, -1, 2)
               - 6.0 * u) / dx ** 2
        return (kappa * lap).reshape(-1)

    inner = shard_map(local, mesh=mesh, in_specs=P(axis),
                      out_specs=P(axis))

    def rhs(t, y):
        return inner(y)

    return rhs


def brusselator_2d_rhs_shardmap(mesh, shape, axis="space", A=1.0, B=3.0,
                                alpha=0.02, dx=None):
    """2-D Brusselator RHS, grid rows sharded, explicit row halos.

    State layout is the interleaved flat vector of
    ``pde.brusselator_2d_rhs_interleaved`` — ``(ny, nx, 2)`` raveled —
    so each device owns complete (u, v) pairs for a contiguous row
    block: the reaction terms are purely local and only the row-stencil
    halos move over the mesh (one ppermute pair per eval).  Arithmetic
    ordering matches the interleaved GSPMD twin exactly, so a sharded
    solve reproduces the unsharded one bit-for-bit.

    Requires ``ny % mesh.shape[axis] == 0`` (shard_map blocks must
    tile).  Reference workload: /root/reference/docs/Demo_SSV2stab.ipynb
    (RKC-paper reaction–diffusion problems).
    """
    ny, nx = shape
    if dx is None:
        dx = 1.0 / nx
    k = mesh.shape[axis]
    if ny % k != 0:
        raise ValueError(f"ny={ny} not divisible by mesh axis size {k}")

    def local(y):
        w = y.reshape(-1, nx, 2)                 # local row block
        wm = halo_exchange(w, axis, k)           # rows +1 each side
        lap = (wm[:-2] + wm[2:]
               + jnp.roll(w, 1, 1) + jnp.roll(w, -1, 1)
               - 4.0 * w) / dx ** 2
        u, v = w[..., 0], w[..., 1]
        uv2 = u * u * v
        du = A + uv2 - (B + 1.0) * u + alpha * lap[..., 0]
        dv = B * u - uv2 + alpha * lap[..., 1]
        return jnp.stack([du, dv], axis=-1).reshape(-1)

    inner = shard_map(local, mesh=mesh, in_specs=P(axis),
                      out_specs=P(axis))

    def rhs(t, y):
        return inner(y)

    return rhs
