"""extensisq_tpu: a JAX ODE integrator framework.

Rebuild of the capabilities of WRKampi/extensisq as a jit/vmap-native
library: explicit Runge-Kutta pairs of orders 4-9, variable-order Adams
PECE (SWAG), stabilized Runge-Kutta-Chebyshev (SSV2stab), explicit
Runge-Kutta-Nystrom methods, ESDIRK implicit methods with index-1 DAE
support, and forward/adjoint sensitivity analysis — each stepper a pure
function over an explicit state pytree so that ensembles of thousands of
independent integrations compile to one XLA program.

Two drivers share the steppers:

* :func:`solve_ivp` — scipy-semantics host driver (events, t_eval,
  dense output, backward integration).
* :func:`solve` — whole-trajectory-on-device driver (lax.while_loop),
  vmappable over ensemble axes; the device performance path.
"""
from . import _config  # noqa: F401  (enables x64, defines constants)

from .methods import (  # noqa: F401
    BS5, Ts5, CK5, CKdisc, Me4, Pr7, Pr8, Pr9, CFMR7osc,
    Fi4N, Fi5N, Mu5Nmb, MR6NN,
    TRBDF2, TRX2, HS2I, HS2Ia, KC3I, KC4I, KC4Ia, Kv3I,
    SWAG, SSV2stab,
    ALL_METHODS, METHODS_BY_NAME)
from .ivp import solve_ivp, Stepper, OdeResult  # noqa: F401
from .solve import (solve, solve_ensemble, solve_windowed,  # noqa: F401
                    Solution)
from .core.interpolate import OdeSolution  # noqa: F401
from .sensitivity import (  # noqa: F401
    sens_forward, sens_adjoint_end, sens_adjoint_int, solve_final)

__version__ = "0.1.0"

__all__ = [
    "solve_ivp", "Stepper", "OdeResult", "OdeSolution",
    "solve", "solve_ensemble", "solve_windowed", "Solution",
    "sens_forward", "sens_adjoint_end", "sens_adjoint_int", "solve_final",
    "BS5", "Ts5", "CK5", "CKdisc", "Me4", "Pr7", "Pr8", "Pr9", "CFMR7osc",
    "Fi4N", "Fi5N", "Mu5Nmb", "MR6NN",
    "TRBDF2", "TRX2", "HS2I", "HS2Ia", "KC3I", "KC4I", "KC4Ia", "Kv3I",
    "SWAG", "SSV2stab",
    "ALL_METHODS", "METHODS_BY_NAME",
]


def __getattr__(name):
    if name in ("NFS", "NFI", "NLS"):
        raise AttributeError(
            f"extensisq's {name} was a module-global counter; this "
            "framework is pure-functional and reentrant — read the "
            "per-solve fields instead: result.nfailed (NFS), "
            "result.nfi (NFI), result.nls (NLS).")
    raise AttributeError(
        f"module 'extensisq_tpu' has no attribute {name!r}")
