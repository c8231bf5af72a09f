"""Sharded-state PDE right-hand sides and mesh helpers.

The reference's scaling story for SSV2stab is huge semi-discretized
parabolic PDEs (N = 40^3 x 2 states in the RKC paper reproduction,
/root/reference/docs/Demo_SSV2stab.ipynb).  Here the state vector shards
over devices: the stencil RHSs below are written with plain jnp shift
ops so GSPMD partitions them automatically — neighbor slices become halo
exchanges and the solver's RMS error norms become all-reduces.
No hand-written collectives are required on the compute path; the mesh
and sharding annotations are the entire "communication backend"
(SURVEY.md section 5.8).
"""
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding


def make_mesh(axis_names=("space",), shape=None, devices=None):
    """A device mesh; defaults to all devices on one axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (devices.size,)
    return Mesh(devices.reshape(shape), axis_names)


def shard_state(y, mesh, spec):
    return jax.device_put(y, NamedSharding(mesh, spec))


def heat_1d_rhs(kappa=1.0, dx=None, n=None):
    """du/dt = kappa u_xx on a periodic 1-D grid (flat state)."""
    if dx is None:
        dx = 1.0 / n

    def rhs(t, u):
        return kappa * (jnp.roll(u, 1) - 2.0 * u + jnp.roll(u, -1)) / dx**2

    return rhs


def heat_2d_rhs(kappa=1.0, shape=None, dx=None):
    """du/dt = kappa (u_xx + u_yy), periodic 2-D grid, flat state."""
    ny, nx = shape
    if dx is None:
        dx = 1.0 / nx

    def rhs(t, u_flat):
        u = u_flat.reshape(ny, nx)
        lap = (jnp.roll(u, 1, 0) + jnp.roll(u, -1, 0)
               + jnp.roll(u, 1, 1) + jnp.roll(u, -1, 1) - 4.0 * u) / dx**2
        return (kappa * lap).reshape(-1)

    return rhs


def brusselator_2d_rhs(shape, A=1.0, B=3.0, alpha=0.02, dx=None):
    """2-D reaction-diffusion Brusselator, periodic grid.

        u_t = A + u^2 v - (B+1) u + alpha lap(u)
        v_t = B u - u^2 v + alpha lap(v)

    Flat state layout [u.ravel(), v.ravel()] (BASELINE config 5).
    """
    ny, nx = shape
    m = ny * nx
    if dx is None:
        dx = 1.0 / nx

    def rhs(t, y):
        # one stacked (2, ny, nx) Laplacian: half the roll traffic of
        # two per-field Laplacians, identical arithmetic
        uv = y.reshape(2, ny, nx)
        lap = (jnp.roll(uv, 1, 1) + jnp.roll(uv, -1, 1)
               + jnp.roll(uv, 1, 2) + jnp.roll(uv, -1, 2)
               - 4.0 * uv) / dx**2
        u, v = uv[0], uv[1]
        uv2 = u * u * v
        du = A + uv2 - (B + 1.0) * u + alpha * lap[0]
        dv = B * u - uv2 + alpha * lap[1]
        return jnp.concatenate([du.reshape(-1), dv.reshape(-1)])

    return rhs


def heat_3d_rhs(shape, kappa=1.0, dx=None):
    """du/dt = kappa lap(u), periodic 3-D grid, flat state (the
    RKC-paper problems' N=40^3 scale; BCs differ there — see
    problems.combustion_3d for the exact flagship formulation).
    Arithmetic ordering matches halo.heat_3d_rhs_shardmap exactly."""
    nz, ny, nx = shape
    if dx is None:
        dx = 1.0 / nx

    def rhs(t, y):
        u = y.reshape(nz, ny, nx)
        lap = (jnp.roll(u, 1, 0) + jnp.roll(u, -1, 0)
               + jnp.roll(u, 1, 1) + jnp.roll(u, -1, 1)
               + jnp.roll(u, 1, 2) + jnp.roll(u, -1, 2)
               - 6.0 * u) / dx ** 2
        return (kappa * lap).reshape(-1)

    return rhs


def brusselator_2d_rhs_interleaved(shape, A=1.0, B=3.0, alpha=0.02,
                                   dx=None):
    """2-D Brusselator with the interleaved flat layout ``(ny, nx, 2)``.

    Same PDE as :func:`brusselator_2d_rhs` but each grid point's (u, v)
    pair is adjacent in memory, so sharding the flat vector over a mesh
    axis splits the grid by ROWS with both fields co-located — the
    layout a distributed stencil wants (reaction terms never cross
    devices).  Arithmetic ordering matches
    ``halo.brusselator_2d_rhs_shardmap`` exactly: the GSPMD and the
    explicit-ppermute solves are bit-identical.
    """
    ny, nx = shape
    if dx is None:
        dx = 1.0 / nx

    def rhs(t, y):
        w = y.reshape(ny, nx, 2)
        lap = (jnp.roll(w, 1, 0) + jnp.roll(w, -1, 0)
               + jnp.roll(w, 1, 1) + jnp.roll(w, -1, 1)
               - 4.0 * w) / dx ** 2
        u, v = w[..., 0], w[..., 1]
        uv2 = u * u * v
        du = A + uv2 - (B + 1.0) * u + alpha * lap[..., 0]
        dv = B * u - uv2 + alpha * lap[..., 1]
        return jnp.stack([du, dv], axis=-1).reshape(-1)

    return rhs


def brusselator_rho_bound(shape, A=1.0, B=3.0, alpha=0.02, dx=None):
    """Cheap spectral-radius upper bound for rho_jac: diffusion dominates
    (8 alpha / dx^2) plus a reaction-term margin."""
    ny, nx = shape
    if dx is None:
        dx = 1.0 / nx
    diff = 8.0 * alpha / dx**2

    def rho(t, y):
        return diff + 2.0 + B

    return rho
