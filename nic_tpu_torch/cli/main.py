"""Command-line interface of the port (counterpart of nic_tpu/cli/main.py).

  python -m nic_tpu_torch [--device cuda|cpu] --num_filters 192 \\
      --checkpoint_dir checkpoints_synth3 \\
      sga compress mbt2018-num_filters=192-lmbda=0.01 <input.png|batch.npy>

It takes nic_tpu's command line. This slice runs ``sga compress`` with
estimated rates; every other script, subcommand or flag exits non-zero with
"not ported yet (ROADMAP.md)". It runs on the card unless ``--device cpu``
is given, and raises when there is no card.
"""

import argparse
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from nic_tpu_torch import config as cfg
from nic_tpu_torch.utils import load_input, parse_lmbda_from_runname

MODELS = ("mbt2018", "mbt2018_bb")
METHOD_SCRIPTS = ("sga", "map", "ste", "unoise", "danneal")
BB_SCRIPTS = ("bb_sga", "bb_no_sga", "bb_plain")
ALL_SCRIPTS = MODELS + METHOD_SCRIPTS + BB_SCRIPTS
FIELDS = ("mse", "psnr", "msssim", "msssim_db", "est_bpp", "est_y_bpp", "est_z_bpp")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="nic_tpu_torch", formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("script", choices=ALL_SCRIPTS, help="Model or inference method.")
    parser.add_argument("--verbose", "-V", action="store_true")
    parser.add_argument("--num_filters", type=int, default=192)
    parser.add_argument("--num_hfilters", type=int, default=-1)
    parser.add_argument("--checkpoint_dir", default=cfg.CHECKPOINT_DIR)
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="Where to run: the card, unless the CPU is asked for.",
    )
    sub = parser.add_subparsers(dest="command")
    sub.add_parser("train")
    sub.add_parser("decompress")

    compress_cmd = sub.add_parser("compress")
    compress_cmd.add_argument("runname")
    compress_cmd.add_argument("input_file")
    compress_cmd.add_argument("output_file", nargs="?")
    compress_cmd.add_argument("--results_dir", default="./results")
    compress_cmd.add_argument("--lambda", type=float, default=-1, dest="lmbda")
    compress_cmd.add_argument("--sga_its", type=int, default=2000)
    compress_cmd.add_argument("--annealing_rate", type=float, default=1e-3)
    compress_cmd.add_argument("--t0", type=int, default=700)
    compress_cmd.add_argument("--seed", type=int, default=cfg.DEFAULT_SEED)
    compress_cmd.add_argument("--distortion", choices=("mse", "msssim"), default="mse")
    compress_cmd.add_argument(
        "--save_opt_record", action="store_true",
        help="Save per-iteration loss records.",
    )
    return parser


def _not_ported(what: str):
    sys.exit(f"nic_tpu_torch: {what} is not ported yet (ROADMAP.md)")


def _check_ported(args, unknown: List[str]) -> None:
    """Exit non-zero on any part of nic_tpu's command line this slice lacks."""
    if args.command != "compress":
        _not_ported(f"{args.script} {args.command}")
    if args.script != "sga":
        _not_ported(f"{args.script} compress")
    if unknown:
        _not_ported(' '.join(unknown))
    if args.verbose:
        _not_ported("--verbose (rounded-objective probes)")
    if args.output_file:
        _not_ported("writing a bitstream (output_file)")
    if args.distortion != "mse":
        _not_ported(f"--distortion {args.distortion}")


def _resolve_lmbda(args) -> float:
    if args.lmbda < 0:
        args.lmbda = parse_lmbda_from_runname(args.runname)
        print(f"Defaulting lmbda to {args.lmbda:g} as used in model training.")
    return args.lmbda


def _batches(X):
    n = X.shape[0]
    bs = cfg.get_eval_batch_size(int(np.prod(X.shape[1:3])))
    for i in range(0, n, bs):
        yield X[i : i + bs]


def run_compress(args) -> Dict[str, Any]:
    """``sga compress``: optimize each batch's latents, save the RD results.

    Returns the saved per-image results and the device time of each batch's
    optimization loop (``loop_ms``, ``steps``).
    """
    from nic_tpu_torch.checkpoint import load_model
    from nic_tpu_torch.evaluation.results import save_rd_results
    from nic_tpu_torch.infer.engine import LatentOptimizer
    from nic_tpu_torch.infer.methods import get_method

    device = cfg.resolve_device(args.device)
    X = load_input(args.input_file)
    lmbda = _resolve_lmbda(args)
    _, model = load_model(args.checkpoint_dir, args.runname, args.num_filters, device)
    opt = LatentOptimizer(model, device)
    spec = get_method(args.script).replace(
        iterations=args.sga_its, annealing_rate=args.annealing_rate, t0=args.t0,
    )
    results = {k: [] for k in FIELDS}
    rd_losses, rounded_losses, loop_ms = [], [], []
    for batch in _batches(X):
        res = opt.optimize(batch, lmbda, method=spec, seed=args.seed)
        for k in FIELDS:
            results[k].extend(np.asarray(res[k]).tolist())
        rd_losses.append(res["losses"])
        rounded_losses.append(res["rounded_losses"])
        loop_ms.append(opt.last_timing["loop_ms"])
        print(
            f"{args.script}: {spec.iterations} steps on {batch.shape[0]} image(s) "
            f"in {loop_ms[-1]:.1f} ms ({loop_ms[-1] / max(spec.iterations, 1):.3f} "
            f"ms/step, {device.type})"
        )
    if args.save_opt_record and rd_losses:
        pack = np.stack if len(rd_losses) > 1 else (lambda ls: ls[0])
        opt_record = {
            "its": np.arange(rd_losses[0].size),
            "rd_loss": pack(rd_losses),
            "rd_loss_after_rounding": pack(rounded_losses),
        }
        save_rd_results(
            opt_record, args.results_dir, args.script, args.runname,
            args.input_file, lmbda, prefix="opt", verbose=False,
        )
    results = {k: np.asarray(v) for k, v in results.items()}
    save_rd_results(
        results, args.results_dir, args.script, args.runname, args.input_file, lmbda
    )
    return dict(results=results, loop_ms=loop_ms, steps=spec.iterations)


def main(argv: Optional[List[str]] = None):
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "learned_prior":
        _not_ported("learned_prior")
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    if args.command is None:
        parser.print_usage()
        sys.exit(2)
    _check_ported(args, unknown)
    return run_compress(args)


if __name__ == "__main__":
    main()
