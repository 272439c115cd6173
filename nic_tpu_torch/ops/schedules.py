"""Temperature annealing schedules (counterpart of nic_tpu/ops/schedules.py).

Evaluated on the host in float32 from the step number, so the optimization
loop needs no device value to pick its temperature.
"""

import numpy as np


def annealed_temperature(t, r, ub, lb=1e-8, scheme="exp", t0=700) -> float:
    """Temperature at step ``t``, clipped to [lb, ub].

    'exp':    exp(-r * t)
    'exp0':   ub * exp(-r * (t - t0))   (held at ub for t < t0)
    'linear': ub - r * (t - t0)
    """
    t = np.float32(t)
    r = np.float32(r)
    ub = np.float32(ub)
    if scheme == "exp":
        tau = np.exp(-r * t)
    elif scheme == "exp0":
        tau = ub * np.exp(-r * (t - np.float32(t0)))
    elif scheme == "linear":
        tau = -r * (t - np.float32(t0)) + ub
    else:
        raise NotImplementedError(f"Unknown annealing scheme {scheme!r}")
    return float(np.minimum(np.maximum(tau, np.float32(lb)), ub))
