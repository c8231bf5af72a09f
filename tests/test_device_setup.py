"""What the move off the TPU left in plain code: the ESDIRK LU in the
state's dtype, the compile-cache helper, and chip_smoke's device
check."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from extensisq_tpu import Kv3I
from extensisq_tpu.steppers import build_stepper
from extensisq_tpu.types import IVPParams
from extensisq_tpu.utils.compile_cache import enable_compile_cache


def _rober(t, y):
    return jnp.stack([-0.04 * y[0] + 1e4 * y[1] * y[2],
                      0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
                      3e7 * y[1] ** 2])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_esdirk_lu_in_state_dtype(dtype):
    """The Newton LU is factored in the state's dtype on every backend."""
    stepper = build_stepper(Kv3I, _rober, 3, dtype)
    assert not hasattr(stepper, "_lu_dtype")
    params = IVPParams(t_bound=jnp.asarray(1.0), direction=jnp.asarray(1.0),
                       rtol=jnp.asarray(1e-4), atol=jnp.asarray(1e-7),
                       max_step=jnp.asarray(np.inf))
    st = stepper.init(0.0, jnp.asarray([1.0, 0.0, 0.0], dtype), params)
    lu, piv = stepper._factor(jnp.asarray(1e-3, dtype),
                              jnp.eye(3, dtype=dtype))
    assert st.y.dtype == dtype
    assert lu.dtype == dtype
    x = stepper._solve(lu, piv, jnp.ones(3, dtype))
    assert x.dtype == dtype


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path,
                                    restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache(root="/nonexistent") == str(tmp_path)
    # JAX reads the variable itself: the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_in_checkout(monkeypatch, tmp_path,
                                         restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache(root=str(tmp_path))
    assert path == os.path.join(str(tmp_path), ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # the default root is this checkout, a fixed path
    default = enable_compile_cache()
    assert default == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")


def test_importing_the_library_sets_no_cache():
    import subprocess
    import sys
    code = ("import jax, extensisq_tpu, extensisq_tpu.ops; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    assert out.stdout.strip() == "None"


def test_chip_smoke_device_check_raises_on_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.device_check()
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.device_check(count=4)


def test_chip_smoke_device_check_counts():
    devs = chip_smoke.device_check(allow_any=True, count=2)
    assert len(devs) == 2
    with pytest.raises(RuntimeError, match="need"):
        chip_smoke.device_check(allow_any=True, count=len(jax.devices()) + 1)
