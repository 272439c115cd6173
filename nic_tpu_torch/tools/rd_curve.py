"""An RD curve across every trained lambda of one model family
(counterpart of scripts/rd_curve.py).

  python -m nic_tpu_torch.tools.rd_curve EVAL_NPY [--checkpoint_dir D]
      [--out results/synth] [--methods amortized,sga] [--its 2000]
      [--num_filters N] [--model mbt2018|mbt2018_bb] [--lmbda L[,L...]]
      [--fresh] [--device cuda|cpu]

It scans a checkpoint directory for the runs of one model family (each
``<model>-num_filters=<N>-lmbda=<l>`` directory that holds a
``params-*.npz`` or a ``ckpt-*.pt``), evaluates each with bfloat16
transforms, as nic_tpu does, at amortized inference and the requested
iterative methods on a held-out ``.npy`` batch, and writes

  <out>/<method>-psnr.csv      "bpp,psnr" rows sorted by bpp (the reference's format)
  <out>/rd_curve.json          every row, with MS-SSIM and seconds
  <out>/rd_curve.png           the curves (only when matplotlib imports)

The CSV and JSON files are nic_tpu's, byte for byte, on the same rows. They
are rewritten after every run, merged with the rows already on disk (rows
keyed by runname, fresh ones winning) unless ``--fresh``; rows of another
eval set are refused. ``--model mbt2018_bb`` evaluates the bits-back family
(bb_plain, bb_no_sga, bb_sga: net rate = est. bpp - bits back, the
reference's bb_sga curves); ``--its`` replaces the RD phase's steps of a
method that has one. Batches are cut to the pixel budget of
``config.get_eval_batch_size``. It runs on the card unless ``--device cpu``.
"""

import argparse
import glob
import json
import os
import re
import time

import numpy as np
import torch

from nic_tpu_torch import config
from nic_tpu_torch.checkpoint import load_model
from nic_tpu_torch.infer.bb import BB_METHODS, BBLatentOptimizer
from nic_tpu_torch.infer.engine import LatentOptimizer
from nic_tpu_torch.infer.methods import get_method
from nic_tpu_torch.utils import load_input


def find_runs(checkpoint_dir: str, num_filters: int, model: str = "mbt2018"):
    """(runname, lmbda) for every run of ``model`` with parameters on disk:
    nic_tpu's params-*.npz or the port's ckpt-*.pt."""
    runs = []
    pat = re.compile(rf"^{model}-num_filters={num_filters}-lmbda=([0-9.eE+-]+)$")
    for d in sorted(glob.glob(os.path.join(checkpoint_dir, "*"))):
        m = pat.match(os.path.basename(d))
        if m and (glob.glob(os.path.join(d, "ckpt-*.pt"))
                  or glob.glob(os.path.join(d, "params-*.npz"))):
            runs.append((os.path.basename(d), float(m.group(1))))
    return runs


def _atomic_write(path, text):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _merge_detail(out_dir, detail):
    """This run's rows merged into the rd_curve.json already on disk, keyed
    by runname (this run's rows win, the others are kept), so that a re-run
    cut short never shrinks a curve. Rows of an eval set other than the
    one on disk are refused: one out dir holds one eval set (``--fresh``
    replaces the curve)."""
    merged = {}
    path = os.path.join(out_dir, "rd_curve.json")
    try:
        with open(path) as f:
            for row in json.load(f):
                merged[row["runname"]] = row
    except (OSError, ValueError):
        pass
    on_disk_evals = {r["eval"] for r in merged.values() if "eval" in r}
    incoming_evals = {r["eval"] for r in detail if "eval" in r}
    foreign = incoming_evals - on_disk_evals
    if on_disk_evals and foreign:
        raise SystemExit(
            f"refusing to merge rows evaluated on {sorted(foreign)} into "
            f"{path} which holds rows for {sorted(on_disk_evals)}; use a "
            "different --out or pass --fresh to replace the curve"
        )
    for row in detail:
        merged[row["runname"]] = row
    return sorted(merged.values(), key=lambda r: (r["lmbda"], r["runname"]))


def _write_artifacts(out_dir, detail, verbose=False, fresh=False):
    """Write the CSVs and rd_curve.json, each through a temporary file and a
    rename, so that a run killed mid-write leaves the last curve whole.
    Returns {method: [(bpp, psnr), ...]}."""
    os.makedirs(out_dir, exist_ok=True)
    merged = detail if fresh else _merge_detail(out_dir, detail)
    curve = {}
    for row in merged:
        for name, res in row["methods"].items():
            curve.setdefault(name, []).append((res["bpp"], res["psnr"]))
    for name, pts in curve.items():
        path = os.path.join(out_dir, f"{name}-psnr.csv")
        _atomic_write(path, "".join(f"{b:.4f},{p:.6f}\n" for b, p in sorted(pts)))
        if verbose:
            print(f"wrote {path}")
    _atomic_write(os.path.join(out_dir, "rd_curve.json"), json.dumps(merged, indent=2))
    return curve


def method_fn(opt, model: str, name: str, lmbda: float, its: int, noise_fn=None):
    """fn(x) -> per-image results of method ``name`` on a batch: amortized
    or one of the five methods (``iterations`` = its) on MBT2018; a
    bits-back method (its RD phase, if any, ``its`` steps) on mbt2018_bb.
    Seed 0; ``noise_fn`` (tests) replaces the optimizer's draws."""
    if model == "mbt2018_bb":
        spec = BB_METHODS[name]
        if spec.rd_iterations > 0:
            spec = spec.replace(rd_iterations=its)
        return lambda x: opt.optimize(x, lmbda, spec=spec, seed=0, noise_fn=noise_fn)
    if name == "amortized":
        return opt.eval_amortized
    spec = get_method(name).replace(iterations=its)
    return lambda x: opt.optimize(x, lmbda, method=spec, seed=0, noise_fn=noise_fn)


def evaluate(fn, X):
    """Mean est. bpp, PSNR and MS-SSIM of ``fn`` over X, run in batches of
    the pixel budget."""
    bs = config.get_eval_batch_size(int(np.prod(X.shape[1:3])))
    parts = [fn(X[i:i + bs]) for i in range(0, len(X), bs)]
    r = {k: np.concatenate([np.atleast_1d(np.asarray(p[k])) for p in parts])
         for k in ("est_bpp", "psnr", "msssim")}
    return dict(bpp=float(np.mean(r["est_bpp"])), psnr=float(np.mean(r["psnr"])),
                msssim=float(np.mean(r["msssim"])))


def plot_curve(curve, out_dir):
    """rd_curve.png of every method's points (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5.2, 4.2), dpi=140)
    for name, pts in curve.items():
        pts = sorted(pts)
        ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o", label=name)
    ax.set_xlabel("bits per pixel")
    ax.set_ylabel("PSNR (dB)")
    ax.set_title("RD curve (held-out eval batch)")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    path = os.path.join(out_dir, "rd_curve.png")
    fig.savefig(path)
    plt.close(fig)
    return path


def main(argv=None):
    """Evaluate the runs and write the artifacts; returns the rows of this
    run (rd_curve.json's rows, without the merged ones)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("eval_npy")
    ap.add_argument("--checkpoint_dir", default="./checkpoints")
    ap.add_argument("--out", default="./results/synth")
    ap.add_argument("--methods", default="amortized,sga")
    ap.add_argument("--its", type=int, default=2000)
    ap.add_argument("--num_filters", type=int, default=192)
    ap.add_argument(
        "--fresh", action="store_true",
        help="Do not merge with an existing rd_curve.json in --out "
        "(default merges so partial re-evals never shrink the curve).",
    )
    ap.add_argument(
        "--model", default="mbt2018", choices=("mbt2018", "mbt2018_bb"),
        help="mbt2018_bb scans bb checkpoints and evaluates the bits-back "
        "family (methods like bb_plain,bb_sga; net rate = est_bpp - "
        "bpp_back, matching the reference's bb_sga curves).",
    )
    ap.add_argument(
        "--lmbda", default=None,
        help="Evaluate only run(s) with these training lambdas (comma "
        "list; default: every run under --checkpoint_dir).",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="Where to run: the card, unless the CPU is asked for.",
    )
    args = ap.parse_args(argv)
    device = config.resolve_device(args.device)

    runs = find_runs(args.checkpoint_dir, args.num_filters, args.model)
    if args.lmbda is not None:
        wanted = [float(v) for v in str(args.lmbda).split(",")]
        runs = [r for r in runs if any(abs(r[1] - w) < 1e-12 for w in wanted)]
    if not runs:
        raise SystemExit(
            f"no {args.model}-num_filters={args.num_filters}-lmbda=* "
            f"checkpoints under {args.checkpoint_dir}"
            + (f" with lmbda={args.lmbda}" if args.lmbda is not None else "")
        )
    print(f"runs: {[r[0] for r in runs]}")

    X = load_input(args.eval_npy)
    optimizer = BBLatentOptimizer if args.model == "mbt2018_bb" else LatentOptimizer
    method_names = args.methods.split(",")
    detail = []
    fresh = args.fresh
    for runname, lmbda in runs:
        step, model = load_model(args.checkpoint_dir, runname, args.num_filters, device,
                                 compute_dtype=torch.bfloat16, model=args.model)
        opt = optimizer(model, device)
        row = dict(runname=runname, lmbda=lmbda, step=step,
                   eval=os.path.basename(args.eval_npy), methods={})
        for name in method_names:
            t0 = time.time()
            res = evaluate(method_fn(opt, args.model, name, lmbda, args.its), X)
            row["methods"][name] = dict(res, secs=time.time() - t0)
            print(f"{runname} {name:10s} step={step} bpp={res['bpp']:.4f} "
                  f"psnr={res['psnr']:6.3f} msssim={res['msssim']:.4f}")
        detail.append(row)
        _write_artifacts(args.out, detail, fresh=fresh)
        fresh = False  # after the first write, merging appends to it

    curve = _write_artifacts(args.out, detail, verbose=True, fresh=fresh)
    try:
        print(f"wrote {plot_curve(curve, args.out)}")
    except ImportError as e:  # the plot is best-effort
        print(f"plot skipped: {e}")
    return detail


if __name__ == "__main__":
    main()
