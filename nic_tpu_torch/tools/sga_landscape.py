"""The SGA optimization landscape, the paper's Fig. 2 (counterpart of
scripts/sga_landscape.py; nic_tpu's figure is results/sga_landscape.png).

  python -m nic_tpu_torch.tools.sga_landscape IMAGE [--checkpoint_dir D --runname R]
      [--num_filters 192] [--lmbda 0.01] [--its 2000] [--record_every 50]
      [--grid 21] [--pad 1.2] [--out results/sga_landscape.png] [--seed 0]
      [--device cuda|cpu]

IMAGE is a PNG or an .npy batch (its first image), edge-padded to
multiples of 64. The model computes in bfloat16, as nic_tpu's script does;
its parameters come from the run's newest ``params-*.npz`` (``load_model``)
or, without a run, from a fresh init drawn from seed 0.

  1. the amortized latents y0 = g_a(x), z0 = h_a(y0);
  2. an SGA run of ``--its`` steps through ``LatentOptimizer.optimize``, its
     continuous latents recorded every ``--record_every`` steps;
  3. the two coordinates of y that SGA moved the most;
  4. Gumbel-softmax samples of those two at each recorded (y, T);
  5. the continuous (MAP) RD objective, lambda 255^2 MSE + bpp, on a grid
     over the two coordinates, every other latent frozen at SGA's final
     y* and z*: copies of y* batched GRID_CHUNK at a time, each copy its own
     objective;
  6. the figure (matplotlib; without it ``main`` fails at the import, as
     nic_tpu's script does).

``landscape`` computes 1-5 and returns them; ``main`` calls it, then draws.
It runs on the card unless ``--device cpu``.
"""

import argparse
import os
from typing import Callable, Optional

import numpy as np
import torch

from nic_tpu_torch import config
from nic_tpu_torch.checkpoint import load_model
from nic_tpu_torch.infer.engine import LatentOptimizer, Latents, rd_objective_per_image
from nic_tpu_torch.infer.methods import SGA, MethodSpec
from nic_tpu_torch.models.layers import init_parameters
from nic_tpu_torch.models.mbt2018 import MeanScaleHyperprior
from nic_tpu_torch.ops.quantize import draw_gumbel, sga_relax
from nic_tpu_torch.utils import load_input, pad_to_64

# Grid points evaluated per forward pass (nic_tpu's vmap chunk).
GRID_CHUNK = 32
# Offset of the samples' generator seed from the SGA loop's.
SAMPLE_SEED_OFFSET = 1000


def objective_at(model, x, y_star, z_star, coords, v1, v2, lmbda: float) -> np.ndarray:
    """The MAP objective of y* with its flat coordinates ``coords`` set to
    each pair (v1[i], v2[i]), z at z*: copies of y* in batches of
    GRID_CHUNK, each its own objective (as evaluated alone). x, y_star,
    z_star are tensors of one image on the model's device."""
    c1, c2 = coords
    v1 = torch.as_tensor(np.asarray(v1, np.float32), device=y_star.device)
    v2 = torch.as_tensor(np.asarray(v2, np.float32), device=y_star.device)
    out = []
    for i in range(0, v1.numel(), GRID_CHUNK):
        a, b = v1[i:i + GRID_CHUNK], v2[i:i + GRID_CHUNK]
        n = a.numel()
        y = y_star.reshape(1, -1).repeat(n, 1)
        y[:, c1] = a
        y[:, c2] = b
        latents = Latents(y.reshape((n,) + tuple(y_star.shape[1:])),
                          z_star.repeat(n, 1, 1, 1))
        out.append(rd_objective_per_image(model, latents, x.expand(n, -1, -1, -1), lmbda))
    return torch.cat(out).cpu().numpy()


def landscape(model, x, lmbda: float = 0.01, method: MethodSpec = SGA,
              record_every: int = 50, grid: int = 21, pad: float = 1.2, seed: int = 0,
              noise_fn: Optional[Callable] = None, device="cuda"):
    """Steps 1-5 of the module's docstring on one image x [1, H, W, 3]
    (multiples of 64). ``noise_fn(step, name, shape)`` may feed the draws:
    the SGA loop's ("y", "z"; see ``LatentOptimizer.optimize``) and the
    samples' ("sample", step i = the recorded row, shape (2, 2)); otherwise
    the loop draws from its generator and the samples from a CPU generator
    seeded ``seed + SAMPLE_SEED_OFFSET``.

    Returns a dict: ``result`` (optimize's, with the trajectory),
    ``trajectory`` [rows, y.size] (flat y), ``coords`` (c1, c2), ``moved``,
    ``t1``, ``t2`` (the two coordinates along the trajectory),
    ``temperatures``, ``samples`` [rows - 1, 2], ``g1``, ``g2`` (the grid's
    axes) and ``objective`` [grid, grid] (rows along g2, as np.meshgrid).
    """
    opt = LatentOptimizer(model, device)
    res = opt.optimize(x, lmbda, method=method, seed=seed, noise_fn=noise_fn,
                       record_every=record_every)
    traj = res["trajectory_y"].reshape(res["trajectory_y"].shape[0], -1)
    move = np.abs(traj[-1] - traj[0])
    c1, c2 = (int(c) for c in np.argsort(move)[-2:][::-1])
    t1, t2 = traj[:, c1], traj[:, c2]
    print(f"coords: flat {c1}, {c2}; moved {move[c1]:.2f}, {move[c2]:.2f}")

    temperatures = res["trajectory_temperatures"]
    generator = torch.Generator().manual_seed(seed + SAMPLE_SEED_OFFSET)
    samples = []
    for i in range(1, traj.shape[0]):
        if noise_fn is not None:
            gumbel = noise_fn(i, "sample", (2, 2)).float().cpu()
        else:
            gumbel = draw_gumbel((2, 2), generator, "cpu")
        pair = torch.tensor([t1[i], t2[i]], dtype=torch.float32)
        samples.append(sga_relax(pair, float(temperatures[i]), gumbel=gumbel).numpy())
    samples = np.stack(samples)

    lo1, hi1 = min(t1.min(), samples[:, 0].min()), max(t1.max(), samples[:, 0].max())
    lo2, hi2 = min(t2.min(), samples[:, 1].min()), max(t2.max(), samples[:, 1].max())
    g1 = np.linspace(lo1 - pad, hi1 + pad, grid)
    g2 = np.linspace(lo2 - pad, hi2 + pad, grid)
    vv1, vv2 = np.meshgrid(g1, g2)
    y_star, z_star, xt = (torch.as_tensor(a, dtype=torch.float32, device=opt.device)
                          for a in (res["trajectory_y"][-1], res["trajectory_z"][-1], x))
    zz = objective_at(opt.model, xt, y_star, z_star, (c1, c2), vv1.ravel(), vv2.ravel(),
                      lmbda).reshape(vv1.shape)
    return dict(result=res, trajectory=traj, coords=(c1, c2), moved=(move[c1], move[c2]),
                t1=t1, t2=t2, temperatures=temperatures, samples=samples, g1=g1, g2=g2,
                objective=zz)


def plot(land, out: str) -> str:
    """nic_tpu's figure of ``landscape``'s result, written to ``out``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    vv1, vv2 = np.meshgrid(land["g1"], land["g2"])
    t1, t2, samples = land["t1"], land["t2"], land["samples"]
    fig, ax = plt.subplots(figsize=(7.2, 4.8))
    cf = ax.contourf(vv1, vv2, land["objective"], levels=20, cmap="viridis")
    fig.colorbar(cf, ax=ax, label="RD objective (continuous relaxation)")
    order = np.linspace(0.2, 1.0, samples.shape[0])
    ax.scatter(samples[:, 0], samples[:, 1], s=14, c=order, cmap="Reds",
               zorder=3, label="SGA samples")
    ax.plot(t1, t2, color="magenta", lw=2.2, zorder=4,
            label="Trajectory of SGA parameters")
    ax.scatter([t1[0]], [t2[0]], marker="D", s=70, color="#1f77ff",
               edgecolor="white", zorder=5, label="Inference network prediction")
    ax.scatter([t1[-1]], [t2[-1]], marker="o", s=45, color="white",
               edgecolor="black", zorder=5)
    ax.set_xlabel("latent coordinate 1")
    ax.set_ylabel("latent coordinate 2")
    ax.set_title("SGA Optimization Landscape")
    ax.legend(loc="upper left", framealpha=0.9)
    ax.grid(ls="--", alpha=0.4)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    fig.savefig(out, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out


def main(argv=None):
    """Compute the landscape and draw it; returns ``landscape``'s result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("image", help="PNG or .npy (first image used)")
    ap.add_argument("--checkpoint_dir", default=None)
    ap.add_argument("--runname", default=None)
    ap.add_argument("--num_filters", type=int, default=192)
    ap.add_argument("--lmbda", type=float, default=0.01)
    ap.add_argument("--its", type=int, default=2000)
    ap.add_argument("--record_every", type=int, default=50)
    ap.add_argument("--grid", type=int, default=21)
    ap.add_argument("--pad", type=float, default=1.2,
                    help="grid margin around the trajectory's bounding box")
    ap.add_argument("--out", default="results/sga_landscape.png")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="Where to run: the card, unless the CPU is asked for.")
    args = ap.parse_args(argv)
    device = config.resolve_device(args.device)

    x = pad_to_64(load_input(args.image)[:1])
    if args.checkpoint_dir and args.runname:
        _, model = load_model(args.checkpoint_dir, args.runname, args.num_filters, device,
                              compute_dtype=torch.bfloat16)
    else:
        model = init_parameters(MeanScaleHyperprior(args.num_filters, torch.bfloat16),
                                torch.Generator().manual_seed(0))
    land = landscape(model, x, args.lmbda, SGA.replace(iterations=args.its),
                     args.record_every, args.grid, args.pad, args.seed, device=device)
    print(f"wrote {plot(land, args.out)}")
    return land


if __name__ == "__main__":
    main()
