"""Hand-written kernels.

* :func:`solve_fused_erk` — a whole adaptive explicit Runge-Kutta
  ensemble solve in one Pallas kernel (Triton route): one program per
  block of members, the adaptive loop inside.  The XLA path
  (:func:`extensisq_tpu.solve_ensemble`) stays the reference it is
  checked against.
"""
from .fused_erk import solve_fused_erk

__all__ = ["solve_fused_erk"]
