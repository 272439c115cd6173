"""Standalone maximum-likelihood fit of the flexible factorized prior
(counterpart of nic_tpu/train/prior_trainer.py): a ``FactorizedEntropyModel``
fitted to [N, channels] samples by maximizing its log pdf with Adam over the
whole dataset each step, stopping early on a small relative change; it
saves the weights (``prior_model.npz``, nic_tpu's keys) and a record, and
with ``--plot`` each of the first 8 channels' fitted pdf beside the data's
histogram (``fitted_density.png``, matplotlib; without it ``--plot`` fails
with the import's error, as nic_tpu's does).
"""

import json
import os
from dataclasses import asdict, dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from nic_tpu_torch.config import resolve_device
from nic_tpu_torch.models.factorized_prior import FactorizedEntropyModel
from nic_tpu_torch.ops.bounds import lower_bound

PDF_LOWER_BOUND = 1e-10


@dataclass
class PriorTrainConfig:
    num_channels: int
    dims: Tuple[int, ...] = (3, 3, 3)
    init_scale: float = 1.0
    lr: float = 0.01
    its: int = 500
    tol: float = 1e-3
    logging_freq: int = 10
    seed: int = 0
    checkpoint_dir: str = "./checkpoints"

    def runname(self) -> str:
        parts = [f"dims={'_'.join(map(str, self.dims))}"]
        for key in ("init_scale", "lr", "its", "tol"):
            parts.append(f"{key}={getattr(self, key)}")
        return "-".join(["learned_prior"] + parts)


def fit_factorized_prior(data: np.ndarray, cfg: PriorTrainConfig, verbose: bool = True,
                         device="cuda", model: Optional[FactorizedEntropyModel] = None):
    """Fit the prior to ``data`` of shape [N, channels] on ``device``.

    ``model`` is the prior to fit; by default a fresh one, its biases drawn
    from ``cfg.seed``. Returns (model, record), the record one
    ``{"it", "loss"}`` every ``logging_freq`` iterations and at the last."""
    if data.ndim != 2 or data.shape[1] != cfg.num_channels:
        raise ValueError(f"data must be [N, {cfg.num_channels}], got {data.shape}")
    device = resolve_device(device)
    if model is None:
        model = FactorizedEntropyModel(cfg.num_channels, dims=cfg.dims,
                                       init_scale=cfg.init_scale)
        model.reset_parameters(generator=torch.Generator().manual_seed(cfg.seed))
    model = model.to(device)
    x = torch.as_tensor(np.asarray(data, np.float32), device=device)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr)

    record = []
    prev_loss = float("inf")
    for it in range(cfg.its):
        optimizer.zero_grad(set_to_none=True)
        loss = -torch.mean(torch.log(lower_bound(model.pdf(x), PDF_LOWER_BOUND)))
        loss.backward()
        optimizer.step()
        loss = float(loss.detach())
        if abs(prev_loss - loss) / max(abs(loss), 1e-12) < cfg.tol:
            break
        prev_loss = loss
        if it % cfg.logging_freq == 0 or it + 1 == cfg.its:
            if verbose:
                print(f"it={it},\t\tloss={loss:g}")
            record.append(dict(it=it, loss=loss))
    return model, record


def prior_params(model: FactorizedEntropyModel):
    """The prior's parameters under the keys of nic_tpu's prior_model.npz."""
    return {f"['{name}']": p.detach().cpu().numpy() for name, p in model.named_parameters()}


def train_prior_cli(args) -> str:
    """Load the .npy samples, fit, and save the weights, the config and the
    record under <checkpoint_dir>/<runname>/. Returns that directory."""
    cfg = PriorTrainConfig(
        num_channels=args.num_channels,
        dims=tuple(args.dims),
        init_scale=float(args.init_scale),
        lr=args.lr,
        its=args.its,
        tol=args.tol,
        logging_freq=args.logging_freq,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
    )
    data = np.load(args.data_path)
    save_dir = os.path.join(cfg.checkpoint_dir, cfg.runname())
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "args.json"), "w") as f:
        json.dump(asdict(cfg), f, indent=4, sort_keys=True)
    model, record = fit_factorized_prior(data, cfg, device=args.device)
    np.savez(os.path.join(save_dir, "prior_model.npz"), **prior_params(model))
    if args.plot:
        plot_fitted_density(model, data, save_dir)
    with open(os.path.join(save_dir, "record.json"), "w") as f:
        json.dump(record, f, indent=4, sort_keys=True)
    return save_dir


@torch.no_grad()
def fitted_pdf_grid(model: FactorizedEntropyModel):
    """(xs, pdf): the prior's pdf of every channel at 200 points of
    [-5, 5], pdf of shape [200, channels]."""
    xs = np.linspace(-5, 5, 200).astype(np.float32)
    grid = torch.tensor(xs, device=model.quantiles.device)[:, None].repeat(1, model.channels)
    return xs, model.pdf(grid).cpu().numpy()


def plot_fitted_density(model: FactorizedEntropyModel, data: np.ndarray, save_dir: str) -> str:
    """fitted_density.png: the first (at most 8) channels' fitted pdf beside
    the histogram of their samples. Returns its path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs, q_xs = fitted_pdf_grid(model)
    k = min(model.channels, 8)
    cols = min(k, 4)
    rows_n = -(-k // cols)
    plt.figure(figsize=(12, 8))
    for c in range(k):
        plt.subplot(rows_n, cols, c + 1)
        plt.plot(xs, q_xs[:, c], label="$q(x)$")
        plt.hist(data[:, c].ravel(), bins=31, density=True, alpha=0.4, label="data")
        plt.title(f"channel {c}")
    plt.legend()
    plt.tight_layout()
    path = os.path.join(save_dir, "fitted_density.png")
    plt.savefig(path)
    plt.close()
    return path
