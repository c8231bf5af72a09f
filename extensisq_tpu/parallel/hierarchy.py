"""Two-level (members x space) meshes.

An ensemble of PDE solves has two kinds of parallelism with very
different traffic, and the mesh names them after the algorithm:

* **ensemble members -> the outer ("members") axis.**  Members never
  exchange state: each carries its own error norm and controller, so a
  solve sends no bytes along this axis.
* **PDE/state grid -> the inner ("space") axis.**  Every RHS evaluation
  exchanges stencil halos, and every error norm is an all-reduce over
  the state axis.

With several processes, :func:`make_hierarchical_mesh` groups
``jax.devices()`` by ``process_index`` so that the inner axis is always
process-local (the devices of one process are contiguous along it) and
only the member axis crosses processes.  ``per_host=...`` builds the
same grouping from one process's devices, as the tests do with virtual
CPU devices.
"""
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def make_hierarchical_mesh(axis_names=("members", "space"), per_host=None,
                           devices=None):
    """Build a 2-level mesh: outer axis across processes, inner within.

    Parameters
    ----------
    axis_names : (outer, inner) names; defaults to ("members", "space").
    per_host : devices per inner axis.  Defaults to the actual
        devices-per-process grouping (``jax.local_device_count()``
        equivalent, derived from ``process_index``).  Pass explicitly
        to build the grouping from one process's devices (tests use 8
        virtual CPU devices with ``per_host=4``: 2 groups of 4).
    devices : device list; defaults to ``jax.devices()``.

    Returns a ``Mesh`` of shape (n_hosts, per_host) whose rows are
    process-contiguous, so ``PartitionSpec(inner)`` communication stays
    within a process and only ``PartitionSpec(outer)`` crosses them.
    """
    devices = list(devices if devices is not None else jax.devices())
    if per_host is None:
        # group by owning process; all groups must be equal-sized
        by_proc = {}
        for d in devices:
            by_proc.setdefault(d.process_index, []).append(d)
        sizes = {len(v) for v in by_proc.values()}
        if len(sizes) != 1:
            raise ValueError(f"unequal devices per process: {by_proc}")
        per_host = sizes.pop()
        ordered = [d for p in sorted(by_proc) for d in by_proc[p]]
    else:
        if len(devices) % per_host:
            raise ValueError(f"{len(devices)} devices do not tile into "
                             f"inner groups of {per_host}")
        ordered = devices
    grid = np.asarray(ordered).reshape(len(ordered) // per_host,
                                       per_host)
    return Mesh(grid, axis_names)


def ensemble_pde_sharding(mesh, outer=None, inner=None):
    """The canonical 2-level placement for a ``(members, n_state)``
    ensemble-of-PDEs array: members over the outer axis, each member's
    grid over the inner axis."""
    outer = outer if outer is not None else mesh.axis_names[0]
    inner = inner if inner is not None else mesh.axis_names[1]
    return NamedSharding(mesh, PartitionSpec(outer, inner))
