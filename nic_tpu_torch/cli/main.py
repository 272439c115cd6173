"""Command-line interface of the port (counterpart of nic_tpu/cli/main.py).

  python -m nic_tpu_torch [--device cuda|cpu] [--verbose] --num_filters 192 \\
      --checkpoint_dir checkpoints_synth3 \\
      {sga,map,ste,unoise,danneal} compress mbt2018-num_filters=192-lmbda=0.01 \\
      <input.png|batch.npy> [out.ntc]
  python -m nic_tpu_torch ... mbt2018 compress <runname> <input> [out.ntc]
  python -m nic_tpu_torch ... {bb_sga,bb_no_sga,bb_plain} compress \\
      mbt2018_bb-num_filters=192-lmbda=0.01 <input> [out.ntc]
  python -m nic_tpu_torch ... <script> decompress <runname> <in.ntc> [out.png]
  python -m nic_tpu_torch ... {mbt2018,mbt2018_bb} train --train_glob 'data/*.png' \\
      --lambda 0.01 [--last_step N ...]
  python -m nic_tpu_torch learned_prior [--device cpu] --num_channels C \\
      --data_path samples.npy

It takes nic_tpu's command line. It runs ``train`` of both models (with
``--retries``, ``--init_from`` and the host or device data pipeline) and
``learned_prior``; ``compress`` of the five iterative methods (sga, map,
ste, unoise, danneal: estimated rates, and a real bitstream when an output
file is named, except for map and unoise with ``--unoise_mean_source
noisy_z``, whose latents no decoder can reproduce), of ``mbt2018``
(amortized latents, real bitstream) and of the three bits-back methods on
the ``mbt2018_bb`` model (estimated net rates, and a BB-ANS stream when an
output file is named), and their ``decompress``; a bits-back decode whose
initial bits do not come back exits non-zero. As in nic_tpu, the bits-back
scripts ignore ``--verbose``, ``--distortion``, ``--unoise_mean_source``,
``--save_opt_record`` and ``--save_reconstruction``, and a method script
refuses ``train``.

Several ranks, one process each (``parallel/mesh.py``): a method's
``compress --data_parallel`` shards each batch's images over the ranks and
``--spatial`` each image's rows (``parallel/spatial.py``, mse only); both
run one rank per visible card under NCCL, or with ``--device cpu``
``NIC_TPU_TORCH_CPU_RANKS`` gloo ranks (default 1). Rank 0 prints and
writes the results and the stream. As in nic_tpu, ``--data_parallel`` has
no effect on ``mbt2018`` and the bits-back scripts. ``train`` with
``--coordinator_address host:port --num_processes N --process_id i`` is
rank i of N data-parallel ranks: N counts ranks, one per card (nic_tpu's
processes own every chip of their host).

``compress`` and ``decompress`` of ``mbt2018`` and of the five methods take
``--quant {none,int8,int8_all}``: W8A8 int8 convolutions in g_s and h_s
(``ops/int8conv.py``), on one rank, ``--data_parallel`` (the activation
scales reduced over the ranks: the whole batch's) or ``--spatial`` (h_s in
int8 on every rank, the row-sharded g_s in float, as in nic_tpu). The
decoder recomputes mu and sigma through h_s, so a stream decodes only
under the ``--quant`` it was written with. The bits-back scripts refuse it,
as nic_tpu's do. The command line is nic_tpu's, every flag of it. It runs
on the card unless ``--device cpu`` is given, and raises when there is no
card. Streams decode with the same
code on the same device type: ``decompress`` takes the ``--device`` that
``compress`` was given. The transforms compute in float32, as nic_tpu's CLI
does; bfloat16 is reached through the library
(``load_model(..., compute_dtype=torch.bfloat16)``).
"""

import argparse
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from nic_tpu_torch import config as cfg
from nic_tpu_torch.utils import load_input, parse_lmbda_from_runname, write_png

MODELS = ("mbt2018", "mbt2018_bb")
METHOD_SCRIPTS = ("sga", "map", "ste", "unoise", "danneal")
BB_SCRIPTS = ("bb_sga", "bb_no_sga", "bb_plain")
ALL_SCRIPTS = MODELS + METHOD_SCRIPTS + BB_SCRIPTS
FIELDS = ("mse", "psnr", "msssim", "msssim_db", "est_bpp", "est_y_bpp", "est_z_bpp")
BB_FIELDS = FIELDS + ("est_bpp_back",)
# Scripts whose compress and decompress the port runs.
PORTED = ("mbt2018",) + METHOD_SCRIPTS + BB_SCRIPTS
# --verbose probes the rounded objective every this many steps.
VERBOSE_PROBE_EVERY = 100
# Bytes of decoded corpus up to which --data_pipeline auto keeps it on the device.
DEVICE_DATA_BUDGET_ENV = "NIC_TPU_TORCH_DEVICE_DATA_BUDGET"


def build_prior_parser() -> argparse.ArgumentParser:
    """The standalone prior fitter's command line."""
    p = argparse.ArgumentParser(
        prog="nic_tpu_torch learned_prior",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_channels", type=int, required=True)
    p.add_argument("--dims", nargs="*", type=int, default=[3, 3, 3])
    p.add_argument("--init_scale", default=1.0, type=float)
    p.add_argument("--data_path", required=True)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--its", type=int, default=500)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--logging_freq", type=int, default=10)
    p.add_argument("--plot", action="store_true", help="Save fitted-density plots.")
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="Where to run: the card, unless the CPU is asked for.",
    )
    return p


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

    train_cmd = sub.add_parser("train")
    train_cmd.add_argument("--train_glob", default="images/*.png")
    train_cmd.add_argument("--batchsize", type=int, default=8)
    train_cmd.add_argument("--patchsize", type=int, default=256)
    train_cmd.add_argument("--lambda", type=float, default=0.01, dest="lmbda")
    train_cmd.add_argument(
        "--distortion", choices=("mse", "msssim"), default="mse",
        help="Training distortion objective (msssim needs --patchsize >= 176).",
    )
    train_cmd.add_argument("--last_step", type=int, default=1_000_000)
    train_cmd.add_argument("--preprocess_threads", type=int, default=16)
    train_cmd.add_argument(
        "--data_pipeline", choices=("auto", "host", "device"), default="auto",
        help="'device' keeps the whole (uniformly sized) corpus on the device and "
        "samples crops there; 'host' is the threaded decode/crop pipeline; 'auto' "
        "picks 'device' when the decoded corpus fits "
        f"{DEVICE_DATA_BUDGET_ENV} (2 GiB).",
    )
    train_cmd.add_argument("--logdir", default="")
    train_cmd.add_argument("--save_checkpoint_secs", type=int, default=300)
    train_cmd.add_argument("--save_summary_secs", type=int, default=60)
    train_cmd.add_argument(
        "--steps_per_call", type=int, default=8,
        help="Train steps per call of the fit loop, their batches fetched together.",
    )
    train_cmd.add_argument("--coordinator_address", default=None)
    train_cmd.add_argument("--num_processes", type=int, default=None)
    train_cmd.add_argument("--process_id", type=int, default=None)
    train_cmd.add_argument(
        "--grad_clip", type=float, default=0.0,
        help="Global-norm gradient clip (0 = off).",
    )
    train_cmd.add_argument(
        "--divergence_threshold", type=float, default=0.0,
        help="Abort (FloatingPointError) when the logged loss exceeds this value "
        "(0 = off).",
    )
    train_cmd.add_argument(
        "--init_from", default="",
        help="Start a new run's parameters from another run's checkpoint "
        "directory (fresh optimizer, step 0); ignored once this run has "
        "checkpoints.",
    )
    train_cmd.add_argument(
        "--init_from_partial", action="store_true",
        help="With --init_from: take only the parameters whose key and shape "
        "match (e.g. mbt2018_bb from mbt2018).",
    )
    train_cmd.add_argument(
        "--retries", type=int, default=0,
        help="Re-run training in a fresh process up to N times on a crash, "
        "resuming from the latest checkpoint.",
    )

    compress_cmd = sub.add_parser("compress")
    compress_cmd.add_argument("--results_dir", default="./results")
    compress_cmd.add_argument("--lambda", type=float, default=-1, dest="lmbda")
    compress_cmd.add_argument("--sga_its", type=int, default=2000)
    compress_cmd.add_argument("--annealing_rate", type=float, default=1e-3)
    compress_cmd.add_argument("--t0", type=int, default=700)
    compress_cmd.add_argument("--seed", type=int, default=cfg.DEFAULT_SEED)
    compress_cmd.add_argument(
        "--distortion", choices=("mse", "msssim"), default="mse",
        help="Distortion term of the optimized objective (images >= 176px for msssim).",
    )
    compress_cmd.add_argument(
        "--unoise_mean_source", choices=("quantized_z", "noisy_z"), default="quantized_z",
        help="unoise only: mean used to quantize the transmitted y; noisy_z "
        "streams are estimate-only.",
    )
    compress_cmd.add_argument(
        "--save_opt_record", action="store_true",
        help="Save per-iteration loss records.",
    )
    compress_cmd.add_argument(
        "--save_reconstruction", action="store_true",
        help="Save the reconstruction PNG (single-image inputs).",
    )
    compress_cmd.add_argument(
        "--data_parallel", action="store_true",
        help="Shard each batch's images over the ranks (one per visible card; on "
        "the CPU NIC_TPU_TORCH_CPU_RANKS gloo ranks).",
    )
    compress_cmd.add_argument(
        "--spatial", action="store_true",
        help="Shard each image's rows over the ranks (halo exchange, "
        "parallel/spatial.py) instead of batching images; any size is "
        "edge-padded to the grid and metrics cover the original pixels.",
    )

    decompress_cmd = sub.add_parser("decompress")
    for c in (compress_cmd, decompress_cmd):
        c.add_argument("runname")
        c.add_argument("input_file")
        c.add_argument("output_file", nargs="?")
        c.add_argument(
            "--quant", choices=("none", "int8", "int8_all"), default="none",
            help="Dynamic-quantized int8 convolutions for the frozen-weight "
            "transforms (mbt2018 only; ops/int8conv.py). int8 quantizes the "
            "decode-side forward convs; int8_all additionally runs the "
            "input-cotangent conv of the 5x5/up2 layers in int8 during "
            "optimization. The decoder recomputes coding distributions "
            "through h_s, so compress and decompress MUST use the same "
            "--quant value.",
        )
    return parser


def _not_ported(what: str):
    sys.exit(f"nic_tpu_torch: {what} is not ported yet (ROADMAP.md)")


def _check_ported(args) -> None:
    """Exit non-zero on a command the port lacks, and, as nic_tpu does, on
    ``train`` of a method script."""
    if args.command == "train":
        if args.script not in MODELS:
            sys.exit(f"{args.script} does not support training.")
    elif args.script not in PORTED:
        _not_ported(f"{args.script} {args.command}")


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


def _load(args, device=None):
    """The device (``args.device`` unless given) and the run's model:
    MBT2018 in its ``--quant`` form, or the bits-back variant for the
    bits-back scripts, which refuse ``--quant`` as nic_tpu's do."""
    from nic_tpu_torch.checkpoint import load_model

    device = cfg.resolve_device(device or args.device)
    model = "mbt2018_bb" if args.script in BB_SCRIPTS else "mbt2018"
    quant = getattr(args, "quant", "none")
    if quant != "none" and model != "mbt2018":
        raise SystemExit("--quant supports the mbt2018 model only")
    _, net = load_model(args.checkpoint_dir, args.runname, args.num_filters, device,
                        model=model)
    if quant != "none":
        net = net.clone(quant=quant)
    return device, net


def _write(path: str, blob: bytes, num_pixels: int) -> None:
    with open(path, "wb") as f:
        f.write(blob)
    print(f"Wrote {path}: {len(blob)} bytes "
          f"({len(blob) * 8 / num_pixels:.4f} bpp actual)")


def _compress_amortized(args, X) -> Dict[str, Any]:
    """``mbt2018 compress``: estimated metrics and real range coding of the
    amortized latents. Returns the saved results, the compress side's uint8
    reconstruction of the last batch (``pixels``) and the codec's timing."""
    from nic_tpu_torch.coding.codec import HyperpriorCodec
    from nic_tpu_torch.evaluation.results import save_rd_results
    from nic_tpu_torch.infer.engine import LatentOptimizer

    device, model = _load(args)
    opt = LatentOptimizer(model, device)
    codec = HyperpriorCodec(model, device)
    results = {k: [] for k in FIELDS}
    batch_actual_bpp, batch_sizes = [], []
    num_pixels = int(np.prod(X.shape[1:3]))
    blob, out = b"", {}
    for batch in _batches(X):
        metrics = opt.eval_amortized(batch)
        for k in FIELDS:
            results[k].extend(np.asarray(metrics[k]).tolist())
        blob, out = codec.compress(batch)
        batch_actual_bpp.append(len(blob) * 8 / (num_pixels * batch.shape[0]))
        batch_sizes.append(batch.shape[0])

    if args.output_file or cfg.WRITE_BITSTREAM_FOR_EVAL:
        _write(args.output_file or (args.input_file + ".ntc"), blob,
               num_pixels * batch_sizes[-1])

    results = {k: np.asarray(v) for k, v in results.items()}
    results["batch_actual_bpp"] = np.asarray(batch_actual_bpp)
    results["batch_sizes"] = np.asarray(batch_sizes)
    results["avg_batch_actual_bpp"] = np.asarray(
        np.sum(np.asarray(batch_actual_bpp) * np.asarray(batch_sizes))
        / np.sum(batch_sizes)
    )
    save_rd_results(
        results, args.results_dir, args.script, args.runname, args.input_file,
        lmbda=None,  # trained-script naming: rd-<runname>-input=...
    )
    return dict(results=results, pixels=out.get("pixels"), timing=codec.last_timing,
                bytes=len(blob))


def _write_stream(args, model, device, res, image_hw) -> Dict[str, Any]:
    """Write the last batch's transmitted latents to ``args.output_file``:
    sga, ste and danneal transmit integer-grid latents (a mode=1 stream),
    unoise with the quantized-z mean median/mean-centered ones, which the
    amortized scheme codes exactly. map's mean comes from the continuous z
    and unoise's noisy_z mean from a noise draw; no decoder can reproduce
    either, so those write nothing and warn."""
    if args.script == "map" or (
        args.script == "unoise" and args.unoise_mean_source == "noisy_z"
    ):
        print(
            f"WARNING: not writing {args.output_file} — {args.script} transmitted "
            "latents use a quantization mean the decoder cannot reproduce; rates "
            "are estimate-only. Use unoise --unoise_mean_source quantized_z for a "
            "decodable stream.",
            file=sys.stderr,
        )
        return {}
    from nic_tpu_torch.coding.codec import HyperpriorCodec

    codec = HyperpriorCodec(model, device)
    write = codec.compress_latents if args.script == "unoise" else codec.compress_optimized
    blob = write(res["y"], res["z"], image_hw)
    _write(args.output_file, blob, int(np.prod(res["x_tilde"].shape[:3])))
    return dict(pixels=codec.last_pixels, timing=codec.last_timing, bytes=len(blob))


def run_compress(args) -> Dict[str, Any]:
    """``<method> compress``: optimize each batch's latents, save the RD
    results, and write the last batch's bitstream when an output file is
    named (see ``_write_stream``), on one rank or, with ``--data_parallel``
    or ``--spatial``, on several (rank 0's result); ``mbt2018 compress``:
    see ``_compress_amortized``; the bits-back scripts: see
    ``_compress_bits_back``.

    For a method, returns the saved per-image results, the device time of
    each batch's optimization loop (``loop_ms``) and the steps it ran
    (``steps``, one entry per batch), and, when a stream was written, the
    uint8 reconstruction of the transmitted latents (``pixels``) and the
    codec's timing.
    """
    if args.spatial and args.script not in METHOD_SCRIPTS:
        sys.exit(f"--spatial is only supported for {METHOD_SCRIPTS} (not {args.script}); "
                 "it shards the iterative-optimization loop.")
    X = load_input(args.input_file)
    lmbda = _resolve_lmbda(args)
    if args.script == "mbt2018":
        return _compress_amortized(args, X)
    if args.script in BB_SCRIPTS:
        return _compress_bits_back(args, X, lmbda)
    if args.data_parallel and args.spatial:
        sys.exit("--data_parallel and --spatial are mutually exclusive.")
    if args.spatial and args.distortion != "mse":
        sys.exit("--spatial supports the mse objective only.")
    if not (args.data_parallel or args.spatial):
        return _compress_method(args, X, lmbda, cfg.resolve_device(args.device))
    from nic_tpu_torch.parallel.mesh import spawn, visible_ranks

    ranks = visible_ranks(args.device)
    if args.data_parallel:
        print(f"Data-parallel inference over {ranks} device(s).")
    return spawn(_compress_rank, ranks, (args, X, lmbda), device=args.device)[0]


def _compress_rank(rank: int, device, args, X, lmbda: float) -> Optional[Dict[str, Any]]:
    """One rank of a data-parallel or spatial ``compress``."""
    import torch.distributed as dist

    return _compress_method(args, X, lmbda, device, dist.group.WORLD)


def _compress_method(args, X, lmbda: float, device, group=None) -> Optional[Dict[str, Any]]:
    """A method's ``compress`` on this rank; rank 0 prints, saves and
    writes, and returns the results (the other ranks None)."""
    from nic_tpu_torch.evaluation.results import save_rd_results
    from nic_tpu_torch.infer.engine import LatentOptimizer
    from nic_tpu_torch.infer.methods import get_method
    from nic_tpu_torch.parallel.spatial import SpatialLatentOptimizer

    device, model = _load(args, device)
    engine = SpatialLatentOptimizer if args.spatial else LatentOptimizer
    opt = engine(model, device, group)
    writer = opt.comm.rank == 0
    spec = get_method(args.script).replace(
        iterations=args.sga_its, annealing_rate=args.annealing_rate, t0=args.t0,
        distortion=args.distortion, unoise_mu_source=args.unoise_mean_source,
    )
    probe_every = VERBOSE_PROBE_EVERY if args.verbose else 0
    results = {k: [] for k in FIELDS}
    rd_losses, rounded_losses, loop_ms, steps = [], [], [], []
    last_res = None
    for batch in _batches(X):
        res = last_res = opt.optimize(batch, lmbda, method=spec, seed=args.seed,
                                      probe_every=probe_every)
        for k in FIELDS:
            results[k].extend(np.asarray(res[k]).tolist())
        # The early-stopping methods keep no loss history.
        if res["losses"].size:
            rd_losses.append(res["losses"])
            rounded_losses.append(res["rounded_losses"])
        loop_ms.append(opt.last_timing["loop_ms"])
        steps.append(opt.last_timing["steps"])
        if writer:
            print(
                f"{args.script}: {steps[-1]} steps on {batch.shape[0]} image(s) "
                f"in {loop_ms[-1]:.1f} ms ({loop_ms[-1] / max(steps[-1], 1):.3f} "
                f"ms/step, {device.type})"
            )
    if not writer:
        return None
    if args.save_opt_record and rd_losses:
        # [num_batches, its] for several batches; one batch stays 1-D.
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
    if args.save_reconstruction and last_res is not None and X.shape[0] == 1:
        recon_path = os.path.join(
            args.results_dir,
            f"recon-{args.script}-lmbda={lmbda:g}+{args.runname}"
            f"-input={os.path.basename(args.input_file)}.png",
        )
        os.makedirs(args.results_dir, exist_ok=True)
        write_png(recon_path, last_res["x_tilde"][0])
        print(f"Saved reconstruction to {recon_path}")
    out = dict(loop_ms=loop_ms, steps=steps)
    if args.output_file and last_res is not None:
        out.update(_write_stream(args, model, device, last_res, X.shape[1:3]))
    results = {k: np.asarray(v) for k, v in results.items()}
    save_rd_results(
        results, args.results_dir, args.script, args.runname, args.input_file, lmbda
    )
    return dict(results=results, **out)


def _compress_bits_back(args, X, lmbda: float) -> Dict[str, Any]:
    """``bb_sga``, ``bb_no_sga`` or ``bb_plain compress``: optimize each
    batch's posterior (and, for bb_sga, its latents), save the RD results
    with the bits-back term, and write one BB-ANS stream of the whole input
    when an output file is named: bb_plain against the amortized
    posterior, the others with their optimized posterior made decodable by
    quantized deltas (charged to the rate). Returns the saved results, each
    batch's phase timing (``timing``: steps and device ms of each phase),
    and, when a stream was written, its ``info``, the uint8 reconstruction
    the decoder gives (``pixels``), the codec's timing and the byte count.
    """
    from nic_tpu_torch.evaluation.results import save_rd_results
    from nic_tpu_torch.infer.bb import BB_METHODS, BBLatentOptimizer

    device, model = _load(args)
    opt = BBLatentOptimizer(model, device)
    spec = BB_METHODS[args.script]
    if args.script == "bb_sga":
        spec = spec.replace(rd_iterations=args.sga_its, annealing_rate=args.annealing_rate,
                            t0=args.t0)
    results = {k: [] for k in BB_FIELDS}
    latents = {"y": [], "z_mean": [], "z_logvar": []}
    timing = []
    for batch in _batches(X):
        res = opt.optimize(batch, lmbda, spec=spec, seed=args.seed)
        for k in BB_FIELDS:
            results[k].extend(np.asarray(res[k]).tolist())
        for k in latents:
            latents[k].append(res[k])
        t = opt.last_timing
        timing.append(t)
        print(f"{args.script}: {t['rd_steps']} RD steps in {t['rd_ms']:.1f} ms, "
              f"{t['rate_steps']} rate steps in {t['rate_ms']:.1f} ms on "
              f"{batch.shape[0]} image(s) ({device.type})")
    out = dict(timing=timing)
    if args.output_file:
        from nic_tpu_torch.coding.bb_codec import BitsBackCodec

        codec = BitsBackCodec(model, device)
        if args.script == "bb_plain":
            blob, info = codec.compress(X, seed=args.seed)
            extra = ""
        else:
            blob, info = codec.compress_optimized(
                X, *(np.concatenate(latents[k]) for k in ("y", "z_mean", "z_logvar")),
                seed=args.seed)
            extra = f", posterior deltas {info['delta_bpp']:.4f} bpp"
        with open(args.output_file, "wb") as f:
            f.write(blob)
        print(f"Wrote {args.output_file}: {len(blob)} bytes (actual "
              f"{info['actual_bpp']:.4f} bpp, net bits-back {info['net_bpp']:.4f} "
              f"bpp{extra})")
        out.update(info=info, pixels=codec.last_pixels, codec_timing=codec.last_timing,
                   bytes=len(blob))
    results = {k: np.asarray(v) for k, v in results.items()}
    save_rd_results(results, args.results_dir, args.script, args.runname,
                    args.input_file, lmbda)
    return dict(results=results, **out)


def _decompress_bits_back(args, model, device, blob: bytes):
    """A BB-ANS stream: bb_plain's through ``decompress``, the optimized
    ones through ``decompress_optimized``; exits non-zero when the initial
    bits do not come back."""
    from nic_tpu_torch.coding.bb_codec import BitsBackCodec

    codec = BitsBackCodec(model, device)
    if args.script == "bb_plain":
        x_hat, init_ok = codec.decompress(blob)
    else:
        x_hat, init_ok = codec.decompress_optimized(blob)
    if not init_ok:
        sys.exit("bits-back integrity check failed: initial bits not recovered")
    return x_hat, codec.last_timing


def run_decompress(args) -> Dict[str, Any]:
    """Decode a stream written by ``mbt2018 compress``, a method's
    ``compress`` (the codec dispatches on the stream's mode) or a bits-back
    script's ``compress``, and write the first image as a PNG. Returns the
    decoded float pixels, the PNG's path and the codec's timing."""
    from nic_tpu_torch.coding.codec import HyperpriorCodec

    with open(args.input_file, "rb") as f:
        blob = f.read()
    device, model = _load(args)
    if args.script in BB_SCRIPTS:
        x_hat, timing = _decompress_bits_back(args, model, device, blob)
    else:
        codec = HyperpriorCodec(model, device)
        x_hat, timing = codec.decompress(blob), codec.last_timing
    out = args.output_file or (args.input_file + ".png")
    write_png(out, x_hat[0])
    print(f"Wrote {out}")
    return dict(x_hat=x_hat, path=out, timing=timing)


def run_train(args, argv: Optional[List[str]] = None):
    """``<model> train``: fit from the run's latest checkpoint (or
    ``--init_from``, or a fresh init) to ``--last_step``. With ``--retries``
    the command re-runs itself in a supervised child process. With
    ``--coordinator_address`` it is one rank of a data-parallel run (see the
    module's docstring); each rank prints its step, last loss and parameter
    sum at the end, which agree when the ranks stayed in step. Returns the
    trainer (its ``losses`` and ``last_timing`` describe the run)."""
    if args.retries > 0 and argv is not None:
        from nic_tpu_torch.train.supervisor import is_supervised_child, supervise

        if not is_supervised_child():
            sys.exit(supervise(argv, args.retries))
    from nic_tpu_torch.parallel import mesh
    from nic_tpu_torch.train.trainer import TrainConfig, Trainer

    tc = TrainConfig(
        model=args.script,
        num_filters=args.num_filters,
        lmbda=args.lmbda,
        distortion=args.distortion,
        batchsize=args.batchsize,
        patchsize=args.patchsize,
        last_step=args.last_step,
        checkpoint_dir=args.checkpoint_dir,
        save_checkpoint_secs=args.save_checkpoint_secs,
        save_summary_secs=args.save_summary_secs,
        logdir=args.logdir,
        steps_per_call=args.steps_per_call,
        grad_clip=args.grad_clip,
        divergence_threshold=args.divergence_threshold,
        init_from=args.init_from,
        init_from_partial=args.init_from_partial,
    )
    device, group = args.device, None
    if args.coordinator_address:
        if args.num_processes is None or args.process_id is None:
            sys.exit("--coordinator_address needs --num_processes and --process_id.")
        if args.batchsize % args.num_processes:
            sys.exit(f"--batchsize {args.batchsize} must divide by "
                     f"{args.num_processes} processes.")
        device = mesh.initialize_multihost(args.coordinator_address, args.num_processes,
                                           args.process_id, args.device)
        import torch.distributed as dist

        group = dist.group.WORLD
    try:
        trainer = Trainer(tc, device=device, group=group)
        pipeline = _make_train_pipeline(args, trainer)
        try:
            trainer.fit(pipeline, verbose=True)
        finally:
            pipeline.close()
        if group is not None:
            total = sum(float(p.detach().double().sum()) for p in trainer.model.parameters())
            last = trainer.losses[-1] if trainer.losses else float("nan")
            print(f"rank {trainer.comm.rank} of {trainer.comm.size}: step {trainer.step}, "
                  f"loss {last!r}, parameter sum {total!r}")
    finally:
        if group is not None:
            mesh.shutdown()
    return trainer


def _device_corpus_fits(train_glob: str) -> bool:
    """Whether --data_pipeline auto keeps the corpus on the device: PNG or
    other image files (no .npy), all of one size, within the byte budget."""
    import glob as globlib

    from PIL import Image

    files = sorted(globlib.glob(train_glob))
    if not files or any(f.endswith(".npy") for f in files):
        return False
    sizes, total = set(), 0
    try:
        for f in files[:10000]:
            with Image.open(f) as im:  # reads the header only
                sizes.add(im.size)
                total += im.size[0] * im.size[1] * 3
    except OSError:
        return False
    budget = int(os.environ.get(DEVICE_DATA_BUDGET_ENV, 2 << 30))
    return len(sizes) == 1 and total <= budget


def _make_train_pipeline(args, trainer):
    """The corpus on the device with crops sampled there when it fits (or
    ``--data_pipeline device``), else the host's worker threads; under data
    parallelism, this rank's share of each batch (the host pipeline seeded
    1000 + rank on each rank, as nic_tpu seeds each host)."""
    from nic_tpu_torch.train.data import DeviceDataset, PatchPipeline

    comm, device = trainer.comm, trainer.device
    choice = args.data_pipeline
    if choice == "auto":
        choice = "device" if _device_corpus_fits(args.train_glob) else "host"
    if choice == "device":
        ds = DeviceDataset(args.train_glob, batchsize=args.batchsize,
                           patchsize=args.patchsize, seed=0, device=device,
                           rank=comm.rank, world_size=comm.size)
        print(f"Device-resident dataset: {ds.num_images} images, "
              f"{ds.nbytes / 1e6:.0f} MB on {device}; batches sampled there.")
        return ds
    return PatchPipeline(args.train_glob, batchsize=args.batchsize // comm.size,
                         patchsize=args.patchsize, num_threads=args.preprocess_threads,
                         seed=0 if comm.size == 1 else 1000 + comm.rank)


def main(argv: Optional[List[str]] = None):
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "learned_prior":
        from nic_tpu_torch.train.prior_trainer import train_prior_cli

        return train_prior_cli(build_prior_parser().parse_args(argv[1:]))
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_usage()
        sys.exit(2)
    _check_ported(args)
    if args.command == "train":
        return run_train(args, argv=list(argv))
    if args.command == "decompress":
        return run_decompress(args)
    return run_compress(args)


if __name__ == "__main__":
    main()
