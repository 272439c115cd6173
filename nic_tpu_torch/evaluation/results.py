"""RD result files with the reference's naming
(counterpart of nic_tpu/evaluation/results.py).

'rd-<script>-lmbda=<l>+<runname>-input=<file>.npz', holding per-image arrays
keyed mse/psnr/msssim/msssim_db/est_bpp/est_y_bpp/est_z_bpp.
"""

import os
from typing import Dict, Optional

import numpy as np


def rd_results_filename(
    method_name: str,
    runname: str,
    input_file: str,
    lmbda: Optional[float] = None,
    prefix: str = "rd",
) -> str:
    """Plain name when compressing with the trained script,
    'rd-<method>-lmbda=<l>+<runname>-...' otherwise."""
    input_base = os.path.basename(input_file)
    trained_script = runname.split("-")[0]
    if method_name == trained_script or lmbda is None:
        return f"{prefix}-{runname}-input={input_base}.npz"
    return f"{prefix}-{method_name}-lmbda={lmbda:g}+{runname}-input={input_base}.npz"


def save_rd_results(
    results: Dict[str, np.ndarray],
    results_dir: str,
    method_name: str,
    runname: str,
    input_file: str,
    lmbda: Optional[float] = None,
    prefix: str = "rd",
    verbose: bool = True,
) -> Optional[str]:
    if not results_dir:
        return None
    os.makedirs(results_dir, exist_ok=True)
    fname = rd_results_filename(method_name, runname, input_file, lmbda, prefix)
    path = os.path.join(results_dir, fname)
    np.savez(path, **results)
    if verbose:
        for field, arr in results.items():
            print(f"Avg {field}: {np.asarray(arr).mean():0.4f}")
    return path
