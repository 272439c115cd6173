"""Where the time of a bits-back step goes on the card: a torch.profiler
window over each phase.

  python -m nic_tpu_torch.tools.profile_bb [--steps 100] [--out profile_bb.txt]

Runs bb_sga's two phases on the lambda=0.01 bits-back checkpoint and
data_real/eval_photos.npy (3 x 384 x 512, float32 transforms, as the CLI)
through BBLatentOptimizer.optimize: phase 1 (RD, SGA on y; bb_sga with no
phase 2) and phase 2 (rate only; bb_no_sga), each warmed up, then profiled
over ``--steps`` steps, then timed over the same steps without the
profiler. Per-step device figures divide the window's totals by the step
count, so they include the window's one amortized init (g_a, h_a) and one
final evaluation. The idle share is 1 - device busy / the unprofiled loop
time (CUDA events). Prints one JSON line; with ``--out``, writes each
phase's kernel table there.
"""

import argparse
import json
import os

import numpy as np
import torch

from nic_tpu_torch.checkpoint import load_model
from nic_tpu_torch.infer.bb import BB_NO_SGA, BB_SGA, BBLatentOptimizer
from nic_tpu_torch.tools.profile_sga import kernel_table, smi, summarize, table_lines

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_phase(opt, x, spec, steps):
    """(summary, kernel table) of one phase: ``spec`` runs ``steps`` steps of
    it and none of the other."""
    opt.optimize(x, 0.01, spec)  # warm-up
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        opt.optimize(x, 0.01, spec)
    opt.optimize(x, 0.01, spec)
    t = opt.last_timing
    loop_ms = t["rd_ms"] + t["rate_ms"]
    kernels = kernel_table(prof)
    summary = dict(steps=steps, step_ms=loop_ms / steps, **summarize(kernels, steps, loop_ms))
    return summary, kernels


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--out", default=None, help="file for the kernel tables")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_bb: needs a CUDA card")

    _, model = load_model(os.path.join(ROOT, "checkpoints_synth3"),
                          "mbt2018_bb-num_filters=192-lmbda=0.01", 192, "cuda",
                          model="mbt2018_bb")
    opt = BBLatentOptimizer(model, "cuda")
    x = np.load(os.path.join(ROOT, "data_real", "eval_photos.npy")).astype(np.float32) / 255.0
    phases = {
        "phase 1 (RD)": BB_SGA.replace(rd_iterations=args.steps, rate_iterations=0),
        "phase 2 (rate)": BB_NO_SGA.replace(rate_iterations=args.steps),
    }
    summary = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi("name,power.limit"))
    lines = []
    for name, spec in phases.items():
        summary[name], kernels = profile_phase(opt, x, spec, args.steps)
        lines += [f"{name}: {json.dumps(summary[name])}", *table_lines(kernels, args.steps), ""]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
