"""Where the time of a training step goes on the card: a torch.profiler
window over MBT2018 training steps.

  python -m nic_tpu_torch.tools.profile_train [--steps 50] [--model mbt2018]
      [--out chiprun_out/profile_train.txt]

Trains nic_tpu's default configuration, nf=192, batch 8, patch 256,
lambda 0.01, float32 (TF32 off), from a fresh init, on 256x256 crops of
data_real/eval_photos.npy sampled on the device (``DeviceDataset``), through
``Trainer.run_steps``: 10 warm-up steps, a profiled window of ``--steps``
steps, then the same steps timed with CUDA events without the profiler.
Device time per kernel comes from the profiler (CUPTI), with K1
(``gdn_tc_kernel``) and its launches per step among the kernel classes of
``profile_sga``. The idle share is 1 - device busy / the unprofiled step.
The work per step is counted from the shapes of one forward (hooks on every
convolution and GDN): 2 * MACs, and three times the forward for the step
(forward, input gradient, weight gradient). Prints one JSON line; writes the
kernel table to ``--out``.
"""

import argparse
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from nic_tpu_torch.models.layers import GDN, SignalConv
from nic_tpu_torch.ops import gdn_cuda
from nic_tpu_torch.tools.profile_sga import kernel_table, smi, summarize, table_lines
from nic_tpu_torch.train.data import DeviceDataset
from nic_tpu_torch.train.trainer import TrainConfig, Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WARMUP = 10


def forward_flops(model, x, **kwargs):
    """FLOPs (2 * multiply-adds) of the convolutions and GDNs of one
    forward of ``model`` on ``x`` (``kwargs`` go to the forward), from the
    shapes hooks see."""
    total = [0]

    def conv_hook(module, args, out):
        n, h, w, c_in = args[0].shape
        k2 = module.kernel * module.kernel
        # A transposed conv does its products per input position, a
        # strided one per output position.
        positions = n * h * w if module.transpose else out.shape[0] * out.shape[1] * out.shape[2]
        total[0] += 2 * positions * k2 * c_in * out.shape[-1]

    def gdn_hook(module, args, out):
        c = args[0].shape[-1]
        total[0] += 2 * args[0].numel() // c * c * c

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, SignalConv)]
    hooks += [m.register_forward_hook(gdn_hook) for m in model.modules() if isinstance(m, GDN)]
    try:
        with torch.no_grad():
            model(x, **kwargs)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def write_photo_corpus(directory):
    """The 3 photos of data_real/eval_photos.npy as PNGs; returns their glob."""
    from PIL import Image

    photos = np.load(os.path.join(ROOT, "data_real", "eval_photos.npy"))
    for i, img in enumerate(photos):
        Image.fromarray(img).save(os.path.join(directory, f"photo_{i}.png"))
    return os.path.join(directory, "photo_*.png")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--model", choices=("mbt2018", "mbt2018_bb"), default="mbt2018")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "profile_train.txt"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA card")

    cfg = TrainConfig(model=args.model, num_filters=192, batchsize=8, patchsize=256)
    trainer = Trainer(cfg, device="cuda")
    workdir = tempfile.mkdtemp(prefix="profile_train_")
    try:
        data = DeviceDataset(write_photo_corpus(workdir), cfg.batchsize, cfg.patchsize,
                             device="cuda")
    finally:
        shutil.rmtree(workdir)
    for _ in range(WARMUP):
        trainer.run_steps(data.sample(1)[0])
    batches = data.sample(args.steps)
    torch.cuda.synchronize()
    launches = gdn_cuda.launches
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        trainer.run_steps(batches)
        torch.cuda.synchronize()
    k1_launches = gdn_cuda.launches - launches
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    card_before = smi("clocks.sm,power.draw,temperature.gpu")
    start.record()
    trainer.run_steps(batches)
    end.record()
    end.synchronize()
    card_after = smi("clocks.sm,power.draw,temperature.gpu")
    step_ms = start.elapsed_time(end) / args.steps

    kernels = kernel_table(prof)
    steps = args.steps
    eps = {} if args.model == "mbt2018" else {
        "generator": torch.Generator(device="cuda").manual_seed(0)}
    flops_image = forward_flops(trainer.model, torch.zeros(1, 256, 256, 3, device="cuda"), **eps)
    step_flops = 3 * flops_image * cfg.batchsize
    summary = dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi("name,power.limit"),
        model=args.model, num_filters=192, batchsize=8, patchsize=256, dtype="float32",
        steps=steps, step_ms=step_ms, images_per_sec=cfg.batchsize * 1e3 / step_ms,
        clocks_power_temp_before=card_before, clocks_power_temp_after=card_after,
        forward_gflop_per_image=flops_image / 1e9, step_tflop=step_flops / 1e12,
        achieved_tflop_per_s=step_flops / (step_ms * 1e-3) / 1e12,
        k1_launches_per_step=k1_launches / steps,
        **summarize(kernels, steps, step_ms * steps),
    )
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(json.dumps(summary, indent=1) + "\n\n")
        f.write("\n".join(table_lines(kernels, steps)) + "\n")
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
