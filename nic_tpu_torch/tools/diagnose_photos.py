"""The amortized rate of each image, split into its parts (counterpart of
scripts/diagnose_photos.py; nic_tpu's record is
results/photos/diagnose_lmbda0.01.json).

  python -m nic_tpu_torch.tools.diagnose_photos RUN_DIR EVAL.npy [--limit N]
      [--out diagnose.json] [--device cuda|cpu]

RUN_DIR holds a run's ``args.json`` (its ``num_filters``) and its
``params-*.npz`` (the newest is read). Each image of EVAL.npy (0..255),
edge-padded to multiples of 64, goes through the float32 amortized forward
alone, and gives:
  - y_bpp, z_bpp: the estimated rates of y and z (is a blow-up the
    hyper-latent's or y's?);
  - sig_lo, sig_hi: the shares of the predicted scales at the scale table's
    bounds (within 1.0001 SCALES_MIN and 0.9999 SCALES_MAX); saturation at
    the top would mean h_s predicts maximum surprise for out-of-distribution
    content;
  - psnr of the unrounded reconstruction; z_absmean, z_absmax: |z|.
It prints a line per image and the means, and with ``--out`` writes nic_tpu's
JSON: {"rows": [...], "mean": {...}, "params": npz path}. It runs on the
card unless ``--device cpu``.
"""

import argparse
import json
import os

import numpy as np
import torch

from nic_tpu_torch import config
from nic_tpu_torch.checkpoint import latest_npz, load_params_npz, params_from_jax
from nic_tpu_torch.models.mbt2018 import MeanScaleHyperprior
from nic_tpu_torch.utils import pad_to_64


def _share(mask):
    """The share of True in ``mask``, as nic_tpu's mean computes it: the
    count times float32(1 / size), exact against it."""
    return mask.sum().float() * (1.0 / mask.numel())


@torch.no_grad()
def diagnose(model, x):
    """The fields of one padded image x [1, H, W, 3] (a tensor on the
    model's device), in nic_tpu's key order (sorted)."""
    out = model(x)
    npx = x.shape[1] * x.shape[2]
    sigma, z = out["sigma"], out["z"]
    mse = torch.mean((out["x_tilde"] * 255.0 - x * 255.0) ** 2)
    fields = dict(
        y_bpp=-torch.sum(torch.log2(out["y_likelihoods"])) / npx,
        z_bpp=-torch.sum(torch.log2(out["z_likelihoods"])) / npx,
        sig_lo=_share(sigma <= config.SCALES_MIN * 1.0001),
        sig_hi=_share(sigma >= config.SCALES_MAX * 0.9999),
        psnr=10 * torch.log10(255.0 ** 2 / mse),
        z_absmean=torch.mean(torch.abs(z)),
        z_absmax=torch.max(torch.abs(z)),
    )
    return {k: float(fields[k]) for k in sorted(fields)}


def main(argv=None):
    """Diagnose the images; returns {"rows", "mean", "params"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir", help="checkpoint dir containing params-*.npz")
    ap.add_argument("eval_npy")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--out", default="", help="Optional JSON output path.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="Where to run: the card, unless the CPU is asked for.")
    args = ap.parse_args(argv)
    device = config.resolve_device(args.device)
    config.set_fp32_precision()

    with open(os.path.join(args.run_dir, "args.json")) as f:
        nf = json.load(f).get("num_filters", 192)
    npz_path = latest_npz(args.run_dir)
    if npz_path is None:
        raise SystemExit(f"no params-*.npz under {args.run_dir}")
    step, flat = load_params_npz(npz_path)
    print(f"params: {npz_path} (step {step})")
    model = MeanScaleHyperprior(nf)
    model.load_state_dict(params_from_jax(flat))
    model.to(device).eval().requires_grad_(False)

    images = np.load(args.eval_npy)
    if args.limit:
        images = images[: args.limit]
    rows = []
    for i, img in enumerate(images):
        x = pad_to_64(img[None].astype(np.float32) / 255.0)
        r = diagnose(model, torch.from_numpy(x).to(device))
        r["image"] = i
        rows.append(r)
        print(
            f"img{i}: y={r['y_bpp']:.3f} z={r['z_bpp']:.3f} bpp  "
            f"psnr={r['psnr']:.2f}  sigma@min={r['sig_lo']:.3f} "
            f"sigma@max={r['sig_hi']:.4f}  |z| mean={r['z_absmean']:.2f} "
            f"max={r['z_absmax']:.1f}"
        )
    tot = {k: float(np.mean([r[k] for r in rows])) for k in rows[0] if k != "image"}
    print("mean:", {k: round(v, 4) for k, v in tot.items()})
    record = {"rows": rows, "mean": tot, "params": npz_path}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {args.out}")
    return record


if __name__ == "__main__":
    main()
