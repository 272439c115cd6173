"""Method specifications for the iterative inference (counterpart of
nic_tpu/infer/methods.py), with nic_tpu's constants:

  SGA      lr .005, 2000 its, exp0 schedule r=1e-3 t0=700 ub=.5
  MAP      lr .005, early stop on the rounded objective every 10 its
  STE      lr 1e-4, early stop on the relaxed objective every 10 its
  UNOISE   lr .005, fresh U(-.5, .5) noise each step
  DANNEAL  lr .005, plain exp schedule r=4e-3 ub=.2
"""

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
    early_stop: bool = False
    probe_interval: int = 10
    # Distortion term of the objective: "mse" (255^2 * MSE) or "msssim"
    # (1 - MS-SSIM; images >= 176 px on the short side).
    distortion: str = "mse"
    # unoise only: where the mean that quantizes the transmitted y comes
    # from. "quantized_z": h_s(quantized z), decodable; "noisy_z":
    # h_s(z + U(-.5, .5)), which no decoder can reproduce (estimate-only).
    unoise_mu_source: str = "quantized_z"

    def replace(self, **kw) -> "MethodSpec":
        return replace(self, **kw)


SGA = MethodSpec(name="sga")
MAP = MethodSpec(name="map", early_stop=True)
STE = MethodSpec(name="ste", lr=1e-4, early_stop=True)
UNOISE = MethodSpec(name="unoise")
DANNEAL = MethodSpec(
    name="danneal", annealing_scheme="exp", annealing_rate=4e-3, temperature_ub=0.2
)

METHODS = {m.name: m for m in (SGA, MAP, STE, UNOISE, DANNEAL)}


def get_method(name: str) -> MethodSpec:
    """The spec of a method; raises for an unknown name."""
    if name not in METHODS:
        raise ValueError(f"unknown method {name!r}")
    return METHODS[name]
