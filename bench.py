"""Benchmark: warm wall time of a 4096-member Van der Pol ensemble.

The BASELINE.json workload: a vmapped BS5 solve of 4096 Van der Pol
members (mu = 3, t in [0, 10], rtol 1e-6, atol 1e-9) through
``solve_ensemble`` on one GPU.  Prints ONE JSON line with the device it
ran on; fails when JAX finds no GPU.
"""
import json
import time

from chip_smoke import card_line, device_check

MU = 3.0
T_END = 10.0
RTOL, ATOL = 1e-6, 1e-9
N_MEMBERS = 4096


def device_side():
    import jax
    import jax.numpy as jnp
    from extensisq_tpu.solve import solve_ensemble
    from extensisq_tpu import BS5

    def vdp(t, y):
        return (y[1], MU * (1 - y[0] ** 2) * y[1] - y[0])

    y0 = jnp.stack([jnp.linspace(1.5, 2.5, N_MEMBERS),
                    jnp.zeros(N_MEMBERS)], axis=1)
    run = jax.jit(lambda Y: solve_ensemble(
        vdp, (0.0, T_END), Y, method=BS5, rtol=RTOL, atol=ATOL))
    for _ in range(2):                    # compile + warm-up
        out = jax.block_until_ready(run(y0))
    n_rep = 10
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = jax.block_until_ready(run(y0))
    dt = (time.perf_counter() - t0) / n_rep
    assert bool(jnp.all(out.status == 1)), "ensemble did not finish"
    return dt, int(out.nsteps.sum()), int(out.nfev.sum())


def main():
    from extensisq_tpu.utils.compile_cache import enable_compile_cache
    dev = device_check()[0]
    enable_compile_cache()
    import jax
    dt, total_steps, total_fev = device_side()
    print(json.dumps({
        "metric": "vdp4096_ensemble_wall_s",
        "value": dt,
        "unit": "s",
        "detail": {
            "device_wall_s": dt,
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "card": card_line(),
            "steps_per_s": total_steps / dt,
            "rhs_evals_per_s": total_fev / dt,
            "members": N_MEMBERS,
            "rtol": RTOL, "atol": ATOL,
        },
    }))


if __name__ == "__main__":
    main()
