"""Global configuration for extensisq_tpu.

The library targets double precision by default, like the reference
(extensisq assumes float64 throughout: tolerance floors in
/root/reference/extensisq/common.py:45-53 are derived from double
precision).  Switch a solve to float32 by passing a float32 ``y0``.
"""
import jax

jax.config.update("jax_enable_x64", True)

# Step-size limiter constants, cf. /root/reference/extensisq/common.py:18-27
MIN_FACTOR = 0.2
MAX_FACTOR = 4.0
MAX_FACTOR0 = 10.0

# Newton iteration constants for implicit (ESDIRK) methods
NEWTON_MAXITER = 5
MAX_RATE = 0.2
MAX_FACTOR_NRF = 0.5

# Status codes carried in solver state (int32); vmap-safe replacements for
# the reference's string statuses / warnings (SURVEY.md section 5.5).
RUNNING = 0
FINISHED = 1
TOO_SMALL_STEP = 2
OVERFLOW = 3
MAX_STEPS_REACHED = 4
NEWTON_FAIL = 5
RHO_FAIL = 6
TOL_TOO_TIGHT = 7
TERMINAL_EVENT = 8
PAUSED = 9               # window boundary reached; state is resumable

STATUS_MESSAGES = {
    RUNNING: "running",
    FINISHED: "The solver successfully reached the end of the integration "
              "interval.",
    TOO_SMALL_STEP: "Required step size is less than spacing between "
                    "numbers.",
    OVERFLOW: "Overflow or underflow encountered.",
    MAX_STEPS_REACHED: "Maximum number of steps reached.",
    NEWTON_FAIL: "Newton iterations failed to converge.",
    RHO_FAIL: "The method to estimate the spectral radius of the Jacobian "
              "did not converge",
    TOL_TOO_TIGHT: "tolerance too tight.",
    TERMINAL_EVENT: "A termination event occurred.",
    PAUSED: "Paused at a window boundary; resume with resume_state.",
}
