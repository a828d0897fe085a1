"""Tolerances shared by the LM parity tests (``tests/test_torch_lm_*.py``).

Mamba amplifies rounding: ``dt`` enters ``exp(dt * a)`` with ``|a|`` up to
``d_state``, so one bfloat16 ulp of ``dt`` moves the state by several
per cent, and the JAX package's XLA rounds its transcendentals (sigmoid,
softplus, exp) a bfloat16 ulp away from torch's in about a third of the
elements.  In bfloat16 the reference's own output then lies further from
its float32 run (the same bfloat16 parameters and inputs, upcast) than the
bfloat16 tolerances allow between the two packages.  Where that happens a
comparison widens its absolute tolerance to twice that distance: two
evaluations that each lie within e of the exact value lie within 2e of
each other.
"""

import numpy as np


def widened(tol: dict, want, want32) -> dict:
    """``tol`` with ``atol`` raised to twice the largest distance between
    the reference's bfloat16 result ``want`` and its float32 run ``want32``."""
    spread = float(np.abs(np.asarray(want, np.float32) - np.asarray(want32, np.float32)).max())
    return dict(tol, atol=max(tol["atol"], 2 * spread))
