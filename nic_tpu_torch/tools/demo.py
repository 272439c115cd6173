"""End-to-end demo on synthetic data, no dataset needed (counterpart of
scripts/demo.py).

  python -m nic_tpu_torch.tools.demo [--steps 1500] [--num_filters 16]
      [--lmbda 0.03] [--sga_its 500] [--device cuda|cpu]

Trains a small hyperprior on 64 synthetic 64x64 images (``Trainer.fit``, in
a temporary checkpoint directory that is removed at the end), then on two
held-out images: amortized compression to a real rANS stream and its
decode (``HyperpriorCodec``); SGA (``LatentOptimizer``) beside amortized in
bpp, PSNR and the RD objective; and the stream of the SGA latents and its
decode. Both decodes must reproduce the encoder's reconstruction exactly,
or the demo raises. It runs on the card unless ``--device cpu``.
"""

import argparse
import shutil
import tempfile

import numpy as np

from nic_tpu_torch import config
from nic_tpu_torch.coding.codec import HyperpriorCodec
from nic_tpu_torch.infer.engine import LatentOptimizer
from nic_tpu_torch.infer.methods import SGA
from nic_tpu_torch.train.trainer import TrainConfig, Trainer


def synthetic_images(rng, n, size=64):
    """n smooth sinusoidal test images [n, size, size, 3] in [0, 1], drawn
    from the numpy Generator ``rng`` (nic_tpu's, value for value)."""
    imgs = []
    for _ in range(n):
        xx, yy = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size))
        img = np.zeros((size, size, 3), np.float32)
        for c in range(3):
            a, b, ph = rng.uniform(0.5, 3, 3)
            img[..., c] = 0.5 + 0.4 * np.sin(a * xx * 3 + ph) * np.cos(b * yy * 3)
        imgs.append(np.clip(img, 0, 1))
    return np.stack(imgs)


def _check_exact(name, x_hat, pixels):
    """A decode must give the encoder's own reconstruction, bit for bit."""
    if not np.array_equal(np.round(x_hat * 255.0).astype(np.uint8), pixels):
        raise RuntimeError(f"{name}: the decoded image differs from the encoder's")


def main(argv=None):
    """Run the demo; returns its numbers (a dict)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=1500)
    parser.add_argument("--num_filters", type=int, default=16)
    parser.add_argument("--lmbda", type=float, default=0.03)
    parser.add_argument("--sga_its", type=int, default=500)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Where to run: the card, unless the CPU is asked for.")
    args = parser.parse_args(argv)
    device = config.resolve_device(args.device)

    rng = np.random.default_rng(0)
    train_imgs = synthetic_images(rng, 64)
    test_imgs = synthetic_images(np.random.default_rng(99), 2)
    num_pixels = test_imgs.shape[0] * test_imgs.shape[1] * test_imgs.shape[2]

    print(f"== training mbt2018 (nf={args.num_filters}, {args.steps} steps) ==")
    ckpt_dir = tempfile.mkdtemp(prefix="nic_tpu_torch_demo_")
    try:
        cfg = TrainConfig(
            model="mbt2018",
            num_filters=args.num_filters,
            lmbda=args.lmbda,
            batchsize=8,
            patchsize=64,
            last_step=args.steps,
            main_lr=4e-4,
            checkpoint_dir=ckpt_dir,
            log_every=200,
            save_checkpoint_secs=10_000,
        )
        trainer = Trainer(cfg, device)

        def batches():
            while True:
                yield train_imgs[rng.integers(0, len(train_imgs), cfg.batchsize)]

        trainer.fit(batches(), verbose=True)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    model = trainer.model

    print("\n== amortized compression with real entropy coding ==")
    codec = HyperpriorCodec(model, device)
    blob, out = codec.compress(test_imgs)
    x_hat = codec.decompress(blob)
    _check_exact("amortized stream", x_hat, out["pixels"])
    actual_bpp = len(blob) * 8 / num_pixels
    mse = np.mean((test_imgs - x_hat) ** 2) * 255 ** 2
    psnr = 10 * np.log10(255 ** 2 / mse)
    print(f"bitstream: {len(blob)} bytes -> {actual_bpp:.4f} bpp, decode PSNR {psnr:.2f} dB")

    print(f"\n== SGA iterative inference ({args.sga_its} its) ==")
    opt = LatentOptimizer(model, device)
    base = opt.eval_amortized(test_imgs)
    res = opt.optimize(test_imgs, args.lmbda, method=SGA.replace(iterations=args.sga_its))
    print(f"{'':>12} {'bpp':>8} {'PSNR':>8} {'RD loss':>9}")
    rd_b = args.lmbda * base["mse"].mean() + base["est_bpp"].mean()
    rd_o = args.lmbda * res["mse"].mean() + res["est_bpp"].mean()
    print(f"{'amortized':>12} {base['est_bpp'].mean():8.4f} {base['psnr'].mean():8.2f} "
          f"{rd_b:9.4f}")
    print(f"{'SGA':>12} {res['est_bpp'].mean():8.4f} {res['psnr'].mean():8.2f} {rd_o:9.4f}")
    improvement = (rd_b - rd_o) / rd_b * 100
    print(f"SGA improves the RD objective by {improvement:.1f}%")

    print("\n== real bitstream for the SGA latents (beyond the reference) ==")
    blob2 = codec.compress_optimized(res["y"], res["z"], test_imgs.shape[1:3])
    x_hat2 = codec.decompress_optimized(blob2)
    _check_exact("SGA latents' stream", x_hat2, codec.last_pixels)
    mse2 = np.mean((test_imgs - x_hat2) ** 2) * 255 ** 2
    psnr2 = 10 * np.log10(255 ** 2 / mse2)
    print(f"bitstream: {len(blob2)} bytes -> {len(blob2) * 8 / num_pixels:.4f} bpp, "
          f"decode PSNR {psnr2:.2f} dB")
    return dict(
        steps=trainer.step, train_losses=list(trainer.losses),
        amortized=dict(bytes=len(blob), actual_bpp=actual_bpp, decode_psnr=float(psnr),
                       est_bpp=float(base["est_bpp"].mean()),
                       psnr=float(base["psnr"].mean()), rd_objective=float(rd_b)),
        sga=dict(bytes=len(blob2), actual_bpp=len(blob2) * 8 / num_pixels,
                 decode_psnr=float(psnr2), est_bpp=float(res["est_bpp"].mean()),
                 psnr=float(res["psnr"].mean()), rd_objective=float(rd_o)),
        streams_exact=True,
    )


if __name__ == "__main__":
    main()
