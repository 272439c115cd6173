"""RD-ordering validation of a trained checkpoint
(counterpart of scripts/validate_rd.py).

  python -m nic_tpu_torch.tools.validate_rd RUNNAME EVAL_NPY
      [--checkpoint_dir D] [--lambda L] [--num_filters N] [--its K]
      [--methods amortized,sga,map,ste,unoise,danneal] [--bb]
      [--device cuda|cpu]

It runs every method on a held-out batch, with bfloat16 transforms as
nic_tpu does, and checks the paper's qualitative claims: every iterative
method improves the RD objective, lambda * 255^2 * MSE + bpp, over amortized
inference (a WARN when one does not), and SGA does (a FAIL when it does not);
it names the best iterative method. ``--bb`` validates the bits-back family
on an mbt2018_bb checkpoint instead: bb_plain, bb_no_sga and bb_sga, then
real BB-ANS streams of the amortized (bb_plain) and the optimized (bb_sga)
posterior, coded and decoded with float32 transforms; it PASSes when both
streams give their initial bits back, bb_sga's objective is below
bb_plain's and bb_no_sga's net rate is not above it.

It prints the results, writes VALIDATION.json (nic_tpu's fields) beside the
checkpoint, and exits 0 on PASS and 1 on FAIL. The lambda defaults to the
runname's. A run's parameters are its newest params-<step>.npz or
ckpt-<step>.pt (``checkpoint.latest_params``). It runs on the card unless
``--device cpu``.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from nic_tpu_torch import config
from nic_tpu_torch.checkpoint import latest_npz, latest_step, load_model
from nic_tpu_torch.coding.bb_codec import BitsBackCodec
from nic_tpu_torch.infer.bb import BB_NO_SGA, BB_PLAIN, BB_SGA, BBLatentOptimizer
from nic_tpu_torch.infer.engine import LatentOptimizer
from nic_tpu_torch.infer.methods import get_method
from nic_tpu_torch.utils import load_input, parse_lmbda_from_runname

# The bits-back specs, in the order they run.
BB_SPECS = {"bb_plain": BB_PLAIN, "bb_no_sga": BB_NO_SGA, "bb_sga": BB_SGA}


def _restore(args, device, model, compute_dtype=torch.bfloat16):
    """(save_dir, step, model) of the run's newest parameters."""
    save_dir = os.path.join(args.checkpoint_dir, args.runname)
    if latest_npz(save_dir) is None and latest_step(save_dir) is None:
        raise SystemExit(f"no checkpoint under {save_dir}")
    step, net = load_model(args.checkpoint_dir, args.runname, args.num_filters, device,
                           compute_dtype=compute_dtype, model=model)
    return save_dir, step, net


def _load_eval(args, lmbda):
    X = load_input(args.eval_npy)
    print(f"eval batch {X.shape}, lambda={lmbda}")
    return X


def rd_objective(lmbda, r, bpp):
    """lambda * 255^2 * float MSE + bpp, the objective every method optimizes
    (``r["mse"]`` is over 8-bit pixels)."""
    mse_float = np.mean(r["mse"]) / 255.0 ** 2
    return float(lmbda * 255.0 ** 2 * mse_float + bpp)


def judge(results):
    """Print the WARNs, the SGA gain and the best iterative method; True
    unless SGA is present and did not improve over amortized."""
    ok = True
    if "sga" in results and "amortized" in results:
        for name, r in results.items():
            if name in ("amortized", "sga"):
                continue
            if r["rd_loss"] > results["amortized"]["rd_loss"] + 1e-3:
                print(f"WARN: {name} did not improve over amortized")
        gain = results["amortized"]["rd_loss"] - results["sga"]["rd_loss"]
        print(f"SGA rd_loss gain over amortized: {gain:.4f}")
        if gain <= 0:
            ok = False
            print("FAIL: SGA did not improve the RD objective")
        best_iter = min((r["rd_loss"], n) for n, r in results.items() if n != "amortized")
        print(f"best iterative method: {best_iter[1]} ({best_iter[0]:.4f})")
    return ok


def _finish(save_dir, record, ok):
    out = os.path.join(save_dir, "VALIDATION.json")
    with open(out, "w") as f:
        json.dump(record, f, indent=2)
    print(("PASS" if ok else "FAIL") + f" -> {out}")
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("runname")
    ap.add_argument("eval_npy")
    ap.add_argument("--checkpoint_dir", default="./checkpoints")
    ap.add_argument("--lambda", type=float, default=-1.0, dest="lmbda")
    ap.add_argument("--num_filters", type=int, default=192)
    ap.add_argument("--its", type=int, default=2000)
    ap.add_argument("--methods", default="amortized,sga,map,ste,unoise,danneal")
    ap.add_argument(
        "--bb", action="store_true",
        help="Validate the bits-back family on an mbt2018_bb checkpoint "
        "(bb_plain/bb_no_sga/bb_sga orderings + real BB-ANS bitstream rates).",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="Where to run: the card, unless the CPU is asked for.",
    )
    args = ap.parse_args(argv)
    if args.bb:
        return bb_main(args)

    device = config.resolve_device(args.device)
    lmbda = args.lmbda if args.lmbda > 0 else parse_lmbda_from_runname(args.runname)
    save_dir, step, model = _restore(args, device, "mbt2018")
    print(f"restored step {step} from {save_dir}")
    opt = LatentOptimizer(model, device)
    X = _load_eval(args, lmbda)

    results = {}
    for name in args.methods.split(","):
        t0 = time.time()
        if name == "amortized":
            r = opt.eval_amortized(X)
        else:
            spec = get_method(name).replace(iterations=args.its)
            r = opt.optimize(X, lmbda=lmbda, method=spec, seed=0)
        bpp = float(np.mean(r["est_bpp"]))
        psnr = float(np.mean(r["psnr"]))
        rd = rd_objective(lmbda, r, bpp)
        results[name] = dict(bpp=bpp, psnr=psnr, rd_loss=rd,
                             msssim=float(np.mean(r["msssim"])), secs=time.time() - t0)
        print(f"{name:10s} bpp={bpp:.4f} psnr={psnr:6.3f} rd_loss={rd:.4f} "
              f"msssim={results[name]['msssim']:.4f} ({results[name]['secs']:.0f}s)")

    ok = judge(results)
    return _finish(save_dir, dict(step=step, lmbda=lmbda, results=results), ok)


def bb_main(args):
    """The bits-back family (the paper's bits-back rows): each method's net
    RD objective, then the real BB-ANS streams' rates beside the estimates."""
    device = config.resolve_device(args.device)
    lmbda = args.lmbda if args.lmbda > 0 else parse_lmbda_from_runname(args.runname)
    save_dir, step, model = _restore(args, device, "mbt2018_bb")
    print(f"restored step {step} from {save_dir}")
    opt = BBLatentOptimizer(model, device)
    codec = BitsBackCodec(_restore(args, device, "mbt2018_bb", torch.float32)[2], device)
    X = _load_eval(args, lmbda)

    results = {}
    last = {}
    for name, spec in BB_SPECS.items():
        t0 = time.time()
        r = opt.optimize(X, lmbda, spec=spec, seed=0)
        net_bpp = float(np.mean(r["est_bpp"]))
        psnr = float(np.mean(r["psnr"]))
        rd = rd_objective(lmbda, r, net_bpp)
        results[name] = dict(net_bpp=net_bpp, psnr=psnr, rd_loss=rd,
                             bpp_back=float(np.mean(r["est_bpp_back"])),
                             secs=time.time() - t0)
        last[name] = r
        print(f"{name:10s} net_bpp={net_bpp:.4f} psnr={psnr:6.3f} rd_loss={rd:.4f} "
              f"bpp_back={results[name]['bpp_back']:.4f} ({results[name]['secs']:.0f}s)")

    # Real streams: the amortized posterior (bb_plain) and the optimized one
    # (bb_sga, sent as coded deltas). Their net rates beside the estimates.
    blob_p, info_p = codec.compress(X, seed=0)
    _, ok_p = codec.decompress(blob_p)
    r = last["bb_sga"]
    blob_o, info_o = codec.compress_optimized(X, r["y"], r["z_mean"], r["z_logvar"], seed=0)
    _, ok_o = codec.decompress_optimized(blob_o)
    print(f"bb_plain  actual net {info_p['net_bpp']:.4f} bpp "
          f"(est {results['bb_plain']['net_bpp']:.4f}), bits recovered: {ok_p}")
    print(f"bb_sga    actual net {info_o['net_bpp']:.4f} bpp incl. "
          f"{info_o['delta_bpp']:.4f} posterior-delta overhead "
          f"(est {results['bb_sga']['net_bpp']:.4f}), bits recovered: {ok_o}")

    ok = (ok_p and ok_o
          and results["bb_sga"]["rd_loss"] < results["bb_plain"]["rd_loss"]
          and results["bb_no_sga"]["net_bpp"] < results["bb_plain"]["net_bpp"] + 1e-4)
    record = dict(step=step, lmbda=lmbda, results=results,
                  actual=dict(bb_plain_net_bpp=info_p["net_bpp"],
                              bb_sga_net_bpp=info_o["net_bpp"],
                              bb_sga_delta_bpp=info_o["delta_bpp"]))
    return _finish(save_dir, record, ok)


if __name__ == "__main__":
    raise SystemExit(main())
