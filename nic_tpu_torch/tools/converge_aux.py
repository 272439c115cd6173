"""Converge a checkpoint's factorized-prior quantiles after training
(counterpart of scripts/converge_aux.py).

  python -m nic_tpu_torch.tools.converge_aux CKPT_DIR/RUNNAME [--threshold 5]
      [--steps 20000] [--lr 1e-2] [--dry_run] [--device cuda|cpu]

The auxiliary (quantile) loss places z's coding grid: when the quantiles
are off, z's coded rate exceeds its estimate. The loss depends only on the
entropy bottleneck's density and quantiles, not on data, so it converges
apart from training: Adam on the quantile leaves alone, the density frozen
(as the reference's aux optimizer, whose var_list is the quantiles), until
the loss is at most ``--threshold``. The step size decays as nic_tpu's
``optax.exponential_decay(lr, max(1, steps // 10), 0.5)``: lr * 0.5^(t/T),
continuous. The loss is an L1 over per-channel logits, so Adam orbits the
optimum; the iterate kept is the one with the lowest loss seen (each loss
taken before its update).

It reads the run's args.json and its newest params-<step>.npz, and rewrites
that npz in place, atomically, under nic_tpu's key names with only the
quantile leaves changed; with ``--dry_run``, or when the loss does not
improve, it rewrites nothing. mbt2018_bb has no quantile loss and is
refused. It runs on the card unless ``--device cpu``.
"""

import argparse
import json
import os

import numpy as np
import torch

from nic_tpu_torch import config
from nic_tpu_torch.checkpoint import MODELS, latest_npz, load_params_npz, params_from_jax


def _positive(v):
    v = int(v)
    if v < 1:
        raise argparse.ArgumentTypeError("--steps must be >= 1")
    return v


def decayed_lr(lr: float, steps: int, t: int) -> float:
    """optax.exponential_decay(lr, max(1, steps // 10), 0.5) at update t."""
    return lr * 0.5 ** (t / max(1, steps // 10))


def main(argv=None):
    """Returns {"npz", "before", "after", "steps", "rewritten"} (``after`` and
    ``steps`` None when nothing ran)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--threshold", type=float, default=5.0)
    ap.add_argument("--steps", type=_positive, default=20000)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--dry_run", action="store_true",
                    help="Report the aux loss without rewriting the npz.")
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="Where to run: the card, unless the CPU is asked for.",
    )
    args = ap.parse_args(argv)
    device = config.resolve_device(args.device)

    with open(os.path.join(args.run_dir, "args.json")) as f:
        run_args = json.load(f)
    nf = run_args.get("num_filters", 192)
    model_name = run_args.get("model", "mbt2018")
    model = MODELS[model_name][0](nf)
    if not hasattr(type(model), "aux_loss"):
        raise SystemExit(
            f"{model_name} has no aux (quantile) loss — the bits-back "
            "hyper-latent is posterior-sampled, not grid-coded; nothing "
            "to converge"
        )

    npz_path = latest_npz(args.run_dir)
    if npz_path is None:
        raise SystemExit(f"no params-*.npz under {args.run_dir}")
    _, flat = load_params_npz(npz_path)
    qkeys = [k for k in flat if "quantiles" in k]
    if not qkeys:
        raise SystemExit("no quantile leaves found (bb models without an "
                         "entropy bottleneck have no aux loss)")
    model.load_state_dict(params_from_jax(flat, model_name))
    model.to(device).requires_grad_(False)
    leaves = [model.get_parameter(k.replace("/", ".")) for k in qkeys]
    for q in leaves:
        q.requires_grad_(True)

    with torch.no_grad():
        before = float(model.aux_loss())
    print(f"{npz_path}: aux_loss before = {before:.3f} ({len(qkeys)} quantile leaves)")
    result = dict(npz=npz_path, before=before, after=None, steps=None, rewritten=False)
    if args.dry_run or before <= args.threshold:
        print("nothing to do" if before <= args.threshold else "dry run")
        return result

    opt = torch.optim.Adam(leaves, lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    best, best_q = before, [q.detach().clone() for q in leaves]
    for it in range(args.steps):
        for group in opt.param_groups:
            group["lr"] = decayed_lr(args.lr, args.steps, it)
        opt.zero_grad(set_to_none=True)
        loss = model.aux_loss()
        value = float(loss.detach())
        if value < best:
            best, best_q = value, [q.detach().clone() for q in leaves]
        loss.backward()
        opt.step()
        if it % 2000 == 0:
            print(f"  it={it} aux={value:.4f} best={best:.4f}")
        if best <= args.threshold:
            break
    with torch.no_grad():
        for q, v in zip(leaves, best_q):
            q.copy_(v)
        after = float(model.aux_loss())
    result.update(after=after, steps=it + 1)
    print(f"aux_loss after {it + 1} steps = {after:.4f} (best iterate)")
    if after >= before:
        print("no improvement; leaving the checkpoint unchanged")
        return result

    for k, v in zip(qkeys, best_q):
        flat[k] = v.cpu().numpy()
    tmp = npz_path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **{k: np.asarray(v, np.float32) for k, v in flat.items()})
    os.replace(tmp, npz_path)
    print(f"rewrote {npz_path} (quantiles only)")
    result["rewritten"] = True
    return result


if __name__ == "__main__":
    main()
