"""Golden rate-distortion points of the reference and checks against them
(counterpart of nic_tpu/evaluation/golden.py, numpy only).

The reference publishes its RD results as per-method CSVs
(results/{kodak,tecnick}/{mbt2018,sga,bb_sga}-psnr.csv). ``GOLDEN_RD`` holds
those values, copied from nic_tpu's module so the port never imports the
JAX package. ``check_rd_point`` asks whether a measured (bpp, PSNR) point
lands within a tolerance of the curve, or above it, and ``bd_psnr_gap``
averages a curve's PSNR deltas at equal rate.
"""

from typing import Dict, List, Tuple

import numpy as np

# (bpp, psnr_db) per lambda point, ascending rate.
GOLDEN_RD: Dict[str, Dict[str, List[Tuple[float, float]]]] = {
    "kodak": {
        "mbt2018": [
            (0.083034, 26.470), (0.163007, 28.628), (0.261276, 30.446),
            (0.404964, 32.327), (0.603352, 34.230), (0.849157, 36.332),
            (1.161125, 38.334),
        ],
        "sga": [
            (0.094722, 27.463), (0.184826, 29.838), (0.290336, 31.644),
            (0.432355, 33.417), (0.621807, 35.212), (0.882394, 37.357),
            (1.174133, 39.196),
        ],
        "bb_sga": [
            (0.095602, 27.619), (0.185259, 29.935), (0.290266, 31.731),
            (0.428426, 33.449), (0.607030, 35.180), (0.857233, 37.261),
            (1.140804, 39.072),
        ],
    },
    "tecnick": {
        "mbt2018": [
            (0.072855, 28.250), (0.128197, 30.447), (0.194221, 32.177),
            (0.283419, 33.850), (0.409085, 35.429), (0.570357, 37.072),
            (0.789225, 38.661),
        ],
        "sga": [
            (0.080770, 29.503), (0.139910, 31.773), (0.208382, 33.430),
            (0.297298, 34.970), (0.419125, 36.420), (0.600036, 38.149),
            (0.810074, 39.619),
        ],
        "bb_sga": [
            (0.081229, 29.667), (0.141492, 31.856), (0.206172, 33.513),
            (0.294728, 34.998), (0.409321, 36.387), (0.579807, 38.064),
            (0.788053, 39.540),
        ],
    },
}


def interp_psnr_at_bpp(dataset: str, method: str, bpp: float) -> float:
    """Reference PSNR at a given rate, linearly interpolated on the curve."""
    curve = GOLDEN_RD[dataset][method]
    bpps = np.array([p[0] for p in curve])
    psnrs = np.array([p[1] for p in curve])
    return float(np.interp(bpp, bpps, psnrs))


def check_rd_point(
    dataset: str,
    method: str,
    bpp: float,
    psnr: float,
    psnr_tolerance_db: float = 0.1,
) -> bool:
    """True iff (bpp, psnr) matches or beats the golden curve within
    tolerance: PSNR at this rate must be >= reference - tolerance."""
    return psnr >= interp_psnr_at_bpp(dataset, method, bpp) - psnr_tolerance_db


def bd_psnr_gap(dataset: str, method: str, points) -> float:
    """Average PSNR delta vs the golden curve over measured points
    (positive = we beat the reference)."""
    deltas = [p - interp_psnr_at_bpp(dataset, method, b) for b, p in points]
    return float(np.mean(deltas))
