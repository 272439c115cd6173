"""Method specifications for the iterative inference (counterpart of
nic_tpu/infer/methods.py). Only SGA is ported; asking for another method
raises."""

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class MethodSpec:
    name: str
    iterations: int = 2000
    lr: float = 0.005
    annealing_scheme: str = "exp0"
    annealing_rate: float = 1e-3
    t0: int = 700
    temperature_ub: float = 0.5

    def replace(self, **kw) -> "MethodSpec":
        return replace(self, **kw)


SGA = MethodSpec(name="sga")

METHODS = {SGA.name: SGA}
UNPORTED_METHODS = ("map", "ste", "unoise", "danneal")


def get_method(name: str) -> MethodSpec:
    """The spec of a ported method; raises for one not ported yet."""
    if name in METHODS:
        return METHODS[name]
    if name in UNPORTED_METHODS:
        raise NotImplementedError(f"method {name!r} is not ported yet (ROADMAP.md)")
    raise ValueError(f"unknown method {name!r}")
