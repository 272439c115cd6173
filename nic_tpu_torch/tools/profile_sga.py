"""Where the time of an SGA step goes on the card: a torch.profiler window.

  python -m nic_tpu_torch.tools.profile_sga [--steps 100] [--out chiprun_out/profile_sga.txt]
      [--dtype bfloat16] [--record_every N]

Runs the main path's workload (MBT2018 nf=192, the lambda=0.01 checkpoint,
data_real/eval_photos.npy: 3 x 384 x 512; transforms in float32, or in
bfloat16 with ``--dtype bfloat16``, the dtype of nic_tpu's bench) through
LatentOptimizer.optimize: a warm-up run, then a profiled run of ``--steps``
SGA steps. Device time per kernel comes from the profiler (CUPTI); the
step's wall time from CUDA events around the loop. Per-step figures divide
the window's totals by the step count, so they include the window's one
amortized init (g_a, h_a) and one final evaluation. Then, without the
profiler, the step time of a short and of a full 2000-step run, with the
card's clocks, power and temperature (nvidia-smi) before and after, to
show whether a long run slows. Prints one JSON line; writes the full kernel
table to ``--out``. The convolutions' tensor-core share is the part of their
time spent in kernels whose names mark a tensor-core implementation
(``on_tensor_cores``). ``--record_every N`` runs every loop with the
trajectory recording of ``optimize(record_every=N)`` (the SGA landscape's).
"""

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from nic_tpu_torch.checkpoint import load_model
from nic_tpu_torch.infer.engine import LatentOptimizer
from nic_tpu_torch.infer.methods import SGA

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Kernel-name fragments -> the layer they belong to (first match wins).
CATEGORIES = (
    ("K1 gdn kernel", ("gdn_tc_kernel",)),
    ("convolution (cuDNN)", ("conv", "cudnn", "dgrad", "wgrad", "fprop", "nchw", "nhwc",
                              "winograd", "fft")),
    ("matmul (cuBLAS: GDN backward, entropy model)", ("gemm", "gemv", "cublas")),
    ("copy / layout", ("copy", "cat", "pad", "transpose", "memcpy", "memset")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


# Kernel-name fragments of cuDNN's tensor-core implementations (an input
# type the tensor cores take, or their MMA shape); "ffma" marks the CUDA
# cores' fp32 FMA, which the "xmma" kernel family also uses.
TENSOR_CORE_MARKS = ("bf16", "f16", "tf32", "16816", "1688", "hmma", "gmma", "tensorop",
                     "warpgroup")


def on_tensor_cores(name):
    low = name.lower()
    return "ffma" not in low and any(k in low for k in TENSOR_CORE_MARKS)


def categorize(name):
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def kernel_table(prof):
    """{kernel name: [device ms, launches]} over a profiler window's device
    events. A user annotation (an optimizer step's range) is no kernel."""
    kernels = {}
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            k = kernels.setdefault(evt.name, [0.0, 0])
            k[0] += evt.time_range.elapsed_us() / 1e3
            k[1] += 1
    return kernels


def summarize(kernels, steps, loop_ms):
    """Per-step figures of a kernel table over ``steps`` steps that took
    ``loop_ms`` without the profiler: device busy, idle share, kernels, the
    convolutions' tensor-core share and each category's time and share."""
    device_ms = sum(v[0] for v in kernels.values())
    by_cat = {}
    for name, (ms, n) in kernels.items():
        c = by_cat.setdefault(categorize(name), [0.0, 0])
        c[0] += ms
        c[1] += n
    conv = [(n, ms) for n, (ms, _) in kernels.items()
            if categorize(n) == "convolution (cuDNN)"]
    conv_ms = sum(ms for _, ms in conv)
    return dict(
        device_busy_ms_per_step=device_ms / steps,
        device_idle_share=max(0.0, 1.0 - device_ms / loop_ms),
        kernels_per_step=sum(v[1] for v in kernels.values()) / steps,
        conv_tensor_core_share=(sum(ms for n, ms in conv if on_tensor_cores(n)) / conv_ms
                                if conv_ms else 0.0),
        categories={c: dict(ms_per_step=v[0] / steps, launches_per_step=v[1] / steps,
                            share=v[0] / device_ms)
                    for c, v in sorted(by_cat.items(), key=lambda kv: -kv[1][0])},
    )


def table_lines(kernels, steps):
    """The kernel table as lines of text, the most time first."""
    lines = [f"{'ms/step':>9} {'n/step':>7}  category | kernel"]
    lines += [f"{ms / steps:9.4f} {n / steps:7.2f}  {categorize(name)} | {name}"
              for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])]
    return lines


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="compute dtype of the transforms")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "profile_sga.txt"))
    p.add_argument("--record_every", type=int, default=0,
                   help="record the latents every N steps (0: no recording)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sga: needs a CUDA card")

    _, model = load_model(os.path.join(ROOT, "checkpoints_synth3"),
                          "mbt2018-num_filters=192-lmbda=0.01", 192, "cuda",
                          compute_dtype=getattr(torch, args.dtype))
    opt = LatentOptimizer(model, "cuda")
    x = np.load(os.path.join(ROOT, "data_real", "eval_photos.npy")).astype(np.float32) / 255.0
    rec = args.record_every
    opt.optimize(x, 0.01, method=SGA.replace(iterations=20), record_every=rec)  # warm-up
    spec = SGA.replace(iterations=args.steps)
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        opt.optimize(x, 0.01, method=spec, record_every=rec)
    loop_ms = opt.last_timing["loop_ms"]
    # Timed runs without the profiler: the profiler's own cost stays out.
    opt.optimize(x, 0.01, method=spec, record_every=rec)
    loop_ms_plain = opt.last_timing["loop_ms"]
    card_before = smi("clocks.sm,power.draw,temperature.gpu")
    opt.optimize(x, 0.01, method=SGA, record_every=rec)
    long_ms_per_step = opt.last_timing["loop_ms"] / SGA.iterations
    card_after = smi("clocks.sm,power.draw,temperature.gpu")

    kernels = kernel_table(prof)
    steps = args.steps
    summary = dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi("name,power.limit"),
        dtype=args.dtype, record_every=rec, steps=steps, step_ms_profiled=loop_ms / steps,
        step_ms=loop_ms_plain / steps,
        full_run_steps=SGA.iterations, full_run_step_ms=long_ms_per_step,
        clocks_power_temp_before_full_run=card_before,
        clocks_power_temp_after_full_run=card_after,
        # Busy time from the profiled run, against the step without the profiler.
        **summarize(kernels, steps, loop_ms_plain),
    )
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(json.dumps(summary, indent=1) + "\n\n")
        f.write("\n".join(table_lines(kernels, steps)) + "\n")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
