#!/usr/bin/env python3
"""Smoke run of nic_tpu_torch, the PyTorch + CUDA port, on one NVIDIA card.

  python3 chip_smoke.py            (from the root of a checkout)

Phases, each printed with its elapsed seconds:
  1. device  - the card's name and count, and nvidia-smi's name and power limit;
  2. build   - nvcc builds the GDN kernel (K1) from nic_tpu_torch/csrc/gdn.cu;
  3. K1      - kernel against its plain PyTorch version (GDN and IGDN, float32
               and bfloat16, forward and dx) and its timings beside its bound,
               the plain version and cuBLAS's addmm;
  4. amortized - the fp32 amortized forward of the lambda=0.01 MBT2018
               checkpoint on data_real/eval_photos.npy against nic_tpu's
               numbers, and the card against the port's own CPU run on a crop;
  5. main path - ``python -m nic_tpu_torch ... sga compress`` in-process, with
               K1's launches counted from zero.
Then a JSON line of kernel measurements, nvidia-smi's line, and as the last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero, and with
no card the script exits non-zero before it prints any result.
"""

import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN = "mbt2018-num_filters=192-lmbda=0.01"
CKPT_DIR = os.path.join(ROOT, "checkpoints_synth3")
PHOTOS = os.path.join(ROOT, "data_real", "eval_photos.npy")
LMBDA = 0.01
SGA_ITS = 2000
CHANNELS = 192
# Rows of K1's launches on the main path: N*H*W of g_s's three IGDN layers
# at 3 x 384 x 512 input (g_a's GDN layers run the same three, reversed).
GS_ROWS = (9216, 36864, 147456)

# nic_tpu's fp32 amortized eval of the same checkpoint and photos, on the CPU:
#   JAX_PLATFORMS=cpu python -c "import numpy as np; \
#     from nic_tpu.train.trainer import TrainConfig, Trainer; \
#     from nic_tpu.infer.engine import LatentOptimizer; \
#     tr = Trainer(TrainConfig(num_filters=192, checkpoint_dir='checkpoints_synth3', \
#                              runname='mbt2018-num_filters=192-lmbda=0.01')); \
#     _, p = tr.restore_params_only(); \
#     x = np.load('data_real/eval_photos.npy').astype(np.float32) / 255.0; \
#     r = LatentOptimizer(tr.model, p).eval_amortized(x); \
#     print(float(r['est_bpp'].mean()), float(r['psnr'].mean()))"
JAX_AMORTIZED_BPP = 0.5309465527534485
JAX_AMORTIZED_PSNR = 29.16172218322754
BPP_RTOL = 0.005      # 0.5 %
PSNR_ATOL_DB = 0.05
# nic_tpu's SGA record for this checkpoint (bf16 transforms, 2000 steps),
# results/photos_synth3/rd_curve.json; printed beside the port's, not held.
JAX_SGA_RECORD = dict(est_bpp=0.5141, psnr=30.52)

# K1 against its plain version, max-norm relative: fp32 accumulation in
# another order (float32); bf16 output rounding, plain version in fp32 on
# the same bf16 inputs (bfloat16).
K1_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
# The card against the port's CPU run on a crop: latents y, z (continuous,
# fp32 convolutions summed in another order) and the eval metrics, which
# round latents and pixels, so one flipped rounding moves them a little.
CROP_LATENT_RTOL = 1e-4
CROP_BPP_RTOL = 1e-2
CROP_PSNR_ATOL_DB = 0.05

# H100 SXM peaks (NVIDIA's data sheet) for K1's bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # CUDA-core fp32; dense bf16

T0 = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


def rel_err(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max())


def time_ms(fn, iters=50, warmup=5):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def k1_bound_ms(rows, dtype):
    size = 4 if dtype == "float32" else 2
    nbytes = (2 * rows * CHANNELS + CHANNELS * CHANNELS) * size + CHANNELS * 4
    flops = 2 * rows * CHANNELS * CHANNELS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_inputs(rows, generator):
    import torch

    dev = "cuda"
    x = 2.0 * torch.randn(rows, CHANNELS, device=dev, generator=generator)
    gamma = 0.1 * torch.eye(CHANNELS, device=dev) + 0.01 * torch.rand(
        CHANNELS, CHANNELS, device=dev, generator=generator)
    beta = 1.0 + 0.1 * torch.rand(CHANNELS, device=dev, generator=generator)
    return x, beta, gamma


def check_k1():
    """K1 against gdn_reference: forward and dx. Returns the largest f32
    forward error (absolute)."""
    import torch

    from nic_tpu_torch.ops.gdn_cuda import gdn_kernel, gdn_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    max_abs = 0.0
    for rows in (147456, 9217):
        x, beta, gamma = k1_inputs(rows, gen)
        w = torch.randn(rows, CHANNELS, device="cuda", generator=gen)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            for inverse in (False, True):
                xk = x.to(dt).requires_grad_(True)
                out = gdn_kernel(xk, beta, gamma, inverse)
                (dx,) = torch.autograd.grad(torch.sum(out.float() * w), xk)
                xr = xk.detach().float().requires_grad_(True)
                ref = gdn_reference(xr, beta, gamma.to(dt).float(), inverse)
                (dx_ref,) = torch.autograd.grad(torch.sum(ref * w), xr)
                torch.cuda.synchronize()
                e_fwd, e_dx = rel_err(out, ref), rel_err(dx, dx_ref)
                tol = K1_RTOL[dtype]
                name = "IGDN" if inverse else "GDN"
                log(f"K1 {name} M={rows} {dtype}: forward rel err {e_fwd:.3e}, "
                    f"dx rel err {e_dx:.3e} (tolerance {tol:g})")
                if not (e_fwd <= tol and e_dx <= tol):
                    raise AssertionError(f"K1 {name} M={rows} {dtype} disagrees "
                                         "with its plain version")
                if dtype == "float32":
                    max_abs = max(max_abs, float((out - ref).detach().abs().max()))
    return max_abs


def time_k1():
    """K1, its plain version and addmm at the main path's shapes (IGDN)."""
    import torch

    from nic_tpu_torch.ops.gdn_cuda import gdn_forward_kernel, gdn_reference

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows_list = [(r, "float32") for r in GS_ROWS] + [(GS_ROWS[-1], "bfloat16")]
    table = []
    for rows, dtype in rows_list:
        dt = getattr(torch, dtype)
        x, beta, gamma = k1_inputs(rows, gen)
        x, gamma = x.to(dt), gamma.to(dt)
        xsq = x * x
        with torch.no_grad():
            ms = time_ms(lambda: gdn_forward_kernel(x, gamma, beta, True))
            plain_ms = time_ms(lambda: gdn_reference(x, beta, gamma, True))
            library_ms = time_ms(lambda: torch.addmm(beta.to(dt), xsq, gamma))
        bound_ms, bound_by = k1_bound_ms(rows, dtype)
        row = dict(rows=rows, dtype=dtype, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        table.append(row)
        log(f"K1 IGDN M={rows} C={CHANNELS} {dtype}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, addmm(beta, x^2, gamma) [cuBLAS] {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {HBM_BYTES_PER_S / 1e12:g} TB/s, "
            f"{PEAK_FLOPS[dtype] / 1e12:g} TFLOP/s {dtype})")
    return table


def check_amortized(model_cpu):
    """fp32 amortized eval on the card against nic_tpu's CPU numbers, and the
    card against the port's CPU run on a crop. Returns the card's metrics."""
    import numpy as np

    from nic_tpu_torch.infer.engine import LatentOptimizer

    x = np.load(PHOTOS).astype(np.float32) / 255.0
    card = LatentOptimizer(copy.deepcopy(model_cpu), "cuda")
    res = card.eval_amortized(x)
    bpp, psnr = float(res["est_bpp"].mean()), float(res["psnr"].mean())
    d_bpp = abs(bpp - JAX_AMORTIZED_BPP) / JAX_AMORTIZED_BPP
    d_psnr = abs(psnr - JAX_AMORTIZED_PSNR)
    log(f"amortized fp32 on the card: est bpp {bpp!r} (nic_tpu CPU "
        f"{JAX_AMORTIZED_BPP!r}, rel diff {d_bpp:.2e}), PSNR {psnr!r} dB "
        f"(nic_tpu CPU {JAX_AMORTIZED_PSNR!r}, diff {d_psnr:.2e} dB), "
        f"MS-SSIM {float(res['msssim'].mean())!r}")
    if not (d_bpp <= BPP_RTOL and d_psnr <= PSNR_ATOL_DB):
        raise AssertionError("amortized forward disagrees with nic_tpu")
    for k in ("est_bpp", "psnr", "mse", "msssim"):
        if not np.all(np.isfinite(res[k])):
            raise AssertionError(f"amortized {k} is not finite")

    crop = x[:, 100:164, 200:264]
    cpu = LatentOptimizer(model_cpu, "cpu")
    y_c, z_c = (t.numpy() for t in cpu.amortized_init(crop))
    y_g, z_g = (t.cpu().numpy() for t in card.amortized_init(crop))
    r_c, r_g = cpu.eval_amortized(crop), card.eval_amortized(crop)
    e_y = np.abs(y_g - y_c).max() / np.abs(y_c).max()
    e_z = np.abs(z_g - z_c).max() / np.abs(z_c).max()
    e_bpp = float(np.max(np.abs(r_g["est_bpp"] - r_c["est_bpp"]) / r_c["est_bpp"]))
    e_psnr = float(np.max(np.abs(r_g["psnr"] - r_c["psnr"])))
    log(f"64x64 crops, card vs the port on the CPU: y rel err {e_y:.2e}, z rel err "
        f"{e_z:.2e} (tolerance {CROP_LATENT_RTOL:g}); est bpp rel diff {e_bpp:.2e} "
        f"(tolerance {CROP_BPP_RTOL:g}), PSNR diff {e_psnr:.2e} dB (tolerance "
        f"{CROP_PSNR_ATOL_DB:g})")
    if not (e_y <= CROP_LATENT_RTOL and e_z <= CROP_LATENT_RTOL
            and e_bpp <= CROP_BPP_RTOL and e_psnr <= CROP_PSNR_ATOL_DB):
        raise AssertionError("the card disagrees with the port's CPU run")
    return res


def run_main_path(amortized):
    """sga compress through the CLI entry point, K1's launches counted."""
    import numpy as np

    from nic_tpu_torch.cli.main import main as cli_main
    from nic_tpu_torch.ops import gdn_cuda

    results_dir = tempfile.mkdtemp(prefix="nic_tpu_torch_smoke_")
    try:
        argv = ["--num_filters", "192", "--checkpoint_dir", CKPT_DIR, "sga",
                "compress", RUN, PHOTOS, "--sga_its", str(SGA_ITS),
                "--results_dir", results_dir]
        gdn_cuda.launches = 0
        out = cli_main(argv)
        launches = gdn_cuda.launches
        written = os.listdir(results_dir)
    finally:
        shutil.rmtree(results_dir)
    res = out["results"]
    for k, v in res.items():
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"sga compress: {k} is not finite")
    if not any(f.startswith("rd-sga-") for f in written):
        raise AssertionError(f"sga compress wrote no rd-sga-*.npz: {written}")
    ms_step = out["loop_ms"][0] / SGA_ITS
    rd_opt = float(LMBDA * res["mse"].mean() + res["est_bpp"].mean())
    rd_base = float(LMBDA * amortized["mse"].mean() + amortized["est_bpp"].mean())
    log(f"sga compress: {SGA_ITS} steps, {out['loop_ms'][0]:.1f} ms on the card "
        f"(CUDA events) = {ms_step:.3f} ms/step; K1 launches {launches} "
        f"(>= {3 * SGA_ITS} required)")
    log(f"sga compress: est bpp {float(res['est_bpp'].mean())!r}, PSNR "
        f"{float(res['psnr'].mean())!r} dB, MS-SSIM {float(res['msssim'].mean())!r} "
        f"(nic_tpu record, bf16 transforms: "
        f"{JAX_SGA_RECORD['est_bpp']} bpp, {JAX_SGA_RECORD['psnr']} dB); rounded RD "
        f"objective {rd_opt!r} vs amortized {rd_base!r}")
    if launches < 3 * SGA_ITS:
        raise AssertionError(f"K1 launched {launches} times on the main path")
    if not rd_opt < rd_base:
        raise AssertionError("SGA did not lower the RD objective below amortized")
    return launches, ms_step


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from nic_tpu_torch import config
    from nic_tpu_torch.checkpoint import load_model
    from nic_tpu_torch.ops.build import build_library

    config.set_fp32_precision()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} x{count}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t = time.perf_counter()
    lib = build_library("gdn.cu", force=True)
    log(f"build: nvcc built {os.path.relpath(lib, ROOT)} in "
        f"{time.perf_counter() - t:.2f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"build: ptxas: {line.strip()}")

    max_abs = check_k1()
    timings = time_k1()
    log("K1 checked and timed")

    _, model_cpu = load_model(CKPT_DIR, RUN, 192, "cpu")
    amortized = check_amortized(model_cpu)
    log("amortized forward checked")

    launches, ms_step = run_main_path(amortized)
    log("main path done")

    main_row = timings[len(GS_ROWS) - 1]
    kernels = [dict(
        name="gdn (K1, fused GDN/IGDN)", route="cuda",
        source="nic_tpu_torch/csrc/gdn.cu", replaces="nic_tpu/ops/pallas_gdn.py:23",
        launches=launches, max_abs_err=max_abs, ms=main_row["ms"],
        plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
        bound_by=main_row["bound_by"], library_ms=main_row["library_ms"],
        library="torch.addmm(beta, x^2, gamma), the cuBLAS product at K1's core",
        shape=f"IGDN M={main_row['rows']} C={CHANNELS} float32",
        shapes=timings, sga_ms_per_step=ms_step,
    )]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
