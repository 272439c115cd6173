"""Temperature annealing schedule (counterpart of nic_tpu/ops/schedules.py).

Evaluated on the host in float32 from the step number, so the optimization
loop needs no device value to pick its temperature.
"""

import numpy as np


def annealed_temperature(t, r, ub, lb=1e-8, scheme="exp0", t0=700) -> float:
    """Temperature at step ``t``, clipped to [lb, ub].

    'exp0': ub * exp(-r * (t - t0)), held at ub for t < t0. The other
    schemes of nic_tpu are not ported yet (ROADMAP.md).
    """
    if scheme != "exp0":
        raise NotImplementedError(
            f"annealing scheme {scheme!r} is not ported yet (ROADMAP.md)"
        )
    t = np.float32(t)
    tau = np.float32(ub) * np.exp(np.float32(-r) * (t - np.float32(t0)))
    return float(np.minimum(np.maximum(tau, np.float32(lb)), np.float32(ub)))
