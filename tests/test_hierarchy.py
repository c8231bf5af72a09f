"""Two-level (members x space) mesh placement (SURVEY.md §5.8).

Ensemble members go on the outer axis (no cross-member solver
traffic), the PDE state grid on the inner axis (halos + norm
all-reduces every step).  These tests exercise the helper on the 8
virtual CPU devices as 2 groups of 4 and pin that a full adaptive
ensemble-of-PDEs solve under the 2-level sharding is numerically
identical to the unsharded run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from extensisq_tpu import SSV2stab
from extensisq_tpu.parallel import (make_hierarchical_mesh,
                                    ensemble_pde_sharding, heat_1d_rhs)
from extensisq_tpu.solve import solve_ensemble

needs8 = pytest.mark.skipif(len(jax.devices()) < 8,
                            reason="needs 8 devices")


@needs8
def test_mesh_shape_and_axes():
    mesh = make_hierarchical_mesh(per_host=4)
    assert mesh.axis_names == ("members", "space")
    assert mesh.devices.shape == (2, 4)
    # rows are contiguous device groups (process-local)
    flat = [d.id for d in mesh.devices.ravel()]
    assert flat == sorted(flat)


def test_mesh_process_grouping_default():
    # single process: every device is host-local -> one "host" row
    mesh = make_hierarchical_mesh()
    assert mesh.devices.shape == (1, len(jax.devices()))


@needs8
def test_mesh_rejects_ragged():
    with pytest.raises(ValueError):
        make_hierarchical_mesh(per_host=3)


@needs8
def test_ensemble_pde_solve_two_level():
    """(members, n_state) Brusselator-style ensemble: members over the
    outer axis, each grid split over the inner axis.  Endpoint and
    counters must match the unsharded twin exactly — the 2-level
    placement is a layout, not a numerical change."""
    mesh = make_hierarchical_mesh(per_host=4)
    sharding = ensemble_pde_sharding(mesh)
    assert sharding.spec == P("members", "space")

    n = 256
    rhs = heat_1d_rhs(kappa=1e-3, n=n)
    x = np.linspace(0, 1, n, endpoint=False)
    members = mesh.devices.shape[0] * 2
    Y0 = np.stack([np.sin(2 * np.pi * x) + 0.1 * i
                   for i in range(members)])

    run = jax.jit(lambda Y: solve_ensemble(
        rhs, (0.0, 5.0), Y, method=SSV2stab, rtol=1e-5, atol=1e-8))
    out = run(jax.device_put(jnp.asarray(Y0), sharding))
    jax.block_until_ready(out)
    assert bool(jnp.all(out.status == 1))

    out_ref = run(jnp.asarray(Y0))
    # endpoint identical up to the sharded layout's reduction
    # reassociation (measured 3.6e-12 abs on this problem)
    np.testing.assert_allclose(np.asarray(out.y), np.asarray(out_ref.y),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_array_equal(np.asarray(out.nfev),
                                  np.asarray(out_ref.nfev))
