"""K2, the fused 5x5 up-conv + (I)GDN kernel, against the composite it
replaces (counterpart of scripts/exp_fused_convt.py).

  python -m nic_tpu_torch.tools.exp_fused_convt check [--device cpu]
  python -m nic_tpu_torch.tools.exp_fused_convt bench [N H W C]

``check`` runs nic_tpu's check sizes (C = 32, x (2, 24, 16, 32), parameters
drawn with numpy seed 0) in float32 and bfloat16 and compares K2 with the
composite (SAME transposed conv + bias + IGDN) and with its plain version.
``bench`` (default 4 96 64 192) runs nic_tpu's data-dependent chain,
x <- 0.1 * y[:, ::2, ::2] + 0.9 * x over 100 iterations, best of 2, in
bfloat16, timed with CUDA events, for the composite and for K2, and prints
ms per iteration and GFLOP/s.

Both run on the card unless ``--device cpu`` is given; on the CPU the
wrapper takes the plain version, so ``check`` there holds the plain version
against the composite (and ``bench`` is refused: it times the card).
"""

import argparse
import sys

import numpy as np
import torch

from nic_tpu_torch import config
from nic_tpu_torch.ops import convt_igdn
from nic_tpu_torch.ops.convt_igdn import (
    conv_transpose_igdn_up2,
    conv_transpose_igdn_up2_plain,
    conv_transpose_igdn_up2_reference,
)

# Max-norm relative tolerances of the check. Against the composite: float32
# 1e-5 (the same sums in another order); bfloat16 5e-2, nic_tpu's own bound
# (the composite rounds the conv output and gamma to bfloat16, K2 keeps
# float32 until the store). Against the plain version, which computes K2's
# own formulation: float32 1e-5, bfloat16 2e-2 (a few output ulps).
COMPOSITE_RTOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
PLAIN_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def make_params(c, co, dtype, device):
    """nic_tpu's check parameters: numpy seed 0, w in ``dtype``."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((5, 5, c, co)) * 0.05
    bias = rng.standard_normal(co) * 0.1
    beta = rng.uniform(0.5, 1.5, co)
    gamma = rng.uniform(0.0, 0.05, (co, co))

    def t(a, dt=torch.float32):
        return torch.tensor(a, dtype=torch.float32).to(dt).to(device)

    return t(w, dtype), t(bias), t(beta), t(gamma)


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def check(device) -> dict:
    """K2 (the plain version on the CPU) against the composite and the plain
    version, float32 and bfloat16. Returns the errors; raises on a miss."""
    c = co = 32
    x = torch.tensor(np.random.default_rng(1).standard_normal((2, 24, 16, c)),
                     dtype=torch.float32).to(device)
    errors = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            w, bias, beta, gamma = make_params(c, co, torch.float32, device)
            xd = x.to(dtype)
            got = conv_transpose_igdn_up2(xd, w, bias, beta, gamma)
            ref = conv_transpose_igdn_up2_reference(xd, w, bias, beta, gamma)
            plain = conv_transpose_igdn_up2_plain(xd, w, bias, beta, gamma)
            name = str(dtype).replace("torch.", "")
            e_ref, e_plain = _rel(got, ref), _rel(got, plain)
            errors[name] = dict(composite=e_ref, plain=e_plain)
            print(f"{name}: vs composite rel {e_ref:.2e} (tolerance "
                  f"{COMPOSITE_RTOL[dtype]:g}), vs plain rel {e_plain:.2e} "
                  f"(tolerance {PLAIN_RTOL[dtype]:g})")
            if got.shape != (2, 48, 32, co) or got.dtype != dtype:
                raise AssertionError(f"{name}: got {tuple(got.shape)} {got.dtype}")
            if not (e_ref <= COMPOSITE_RTOL[dtype] and e_plain <= PLAIN_RTOL[dtype]):
                raise AssertionError(f"{name}: K2 disagrees")
    print("CHECK OK")
    return errors


def bench_inputs(n=4, h=96, w_=64, c=192, device="cuda"):
    """The bench's first K2 inputs: x (numpy seed 0) and ``make_params``'s
    parameters, x and w in bfloat16."""
    dtype = torch.bfloat16
    w, bias, beta, gamma = make_params(c, c, dtype, device)
    x0 = torch.tensor(np.random.default_rng(0).standard_normal((n, h, w_, c)),
                      dtype=torch.float32).to(device, dtype)
    return x0, w, bias, beta, gamma


def bench(n=4, h=96, w_=64, c=192, iters=100, reps=2) -> dict:
    """Chained bf16 timing of the composite and K2 on the card, ms/iteration."""
    co = c
    dtype = torch.bfloat16
    x0, w, bias, beta, gamma = bench_inputs(n, h, w_, c)
    gflop_conv = 2 * n * h * w_ * 25 * c * co / 1e9
    gflop_gdn = 2 * n * 4 * h * w_ * co * co / 1e9
    gflop = gflop_conv + gflop_gdn

    def chain(fn, x):
        for _ in range(iters):
            y = fn(x)
            x = 0.1 * y[:, ::2, ::2, :].to(dtype) + 0.9 * x
        return x

    def timeit(fn):
        chain(fn, x0)
        best = float("inf")
        for i in range(reps):
            xv = x0 + 1e-3 * (i + 1)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            chain(fn, xv)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        return best / iters

    print(f"shape ({n},{h},{w_},{c}) -> ({n},{2 * h},{2 * w_},{co}), "
          f"{gflop:.2f} GFLOP/it (conv {gflop_conv:.2f} + gdn {gflop_gdn:.2f}); "
          f"{torch.cuda.get_device_name(0)}")
    with torch.no_grad():
        ms_ref = timeit(lambda xx: conv_transpose_igdn_up2_reference(
            xx, w, bias, beta, gamma))
        print(f"composite (cuDNN + plain IGDN) {ms_ref:8.3f} ms/it  "
              f"{gflop / (ms_ref * 1e-3):7.0f} GFLOP/s")
        before = convt_igdn.launches
        ms_k2 = timeit(lambda xx: conv_transpose_igdn_up2(xx, w, bias, beta, gamma))
        if convt_igdn.launches - before != (reps + 1) * iters:
            raise AssertionError("the K2 chain did not launch K2 on every iteration")
        print(f"K2 (csrc/convt_igdn.cu)        {ms_k2:8.3f} ms/it  "
              f"{gflop / (ms_k2 * 1e-3):7.0f} GFLOP/s")
    return dict(shape=(n, h, w_, c), composite_ms=ms_ref, k2_ms=ms_k2, gflop=gflop)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="exp_fused_convt")
    parser.add_argument("mode", choices=("check", "bench"), nargs="?", default="check")
    parser.add_argument("shape", type=int, nargs="*", help="bench: N H W C")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    config.set_fp32_precision()
    device = config.resolve_device(args.device)
    if args.mode == "check":
        return check(device)
    if device.type != "cuda":
        sys.exit("exp_fused_convt bench times the card; it does not run on the CPU")
    return bench(*args.shape[:4])


if __name__ == "__main__":
    main()
