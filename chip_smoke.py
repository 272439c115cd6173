#!/usr/bin/env python3
"""Smoke run of nic_tpu_torch, the PyTorch + CUDA port, on one NVIDIA card.

  python3 chip_smoke.py            (from the root of a checkout)

Phases, each printed with its elapsed seconds:
  1. device  - the card's name and count, and nvidia-smi's name and power limit;
  2. build   - nvcc builds K1 (csrc/gdn.cu) and K2 (csrc/convt_igdn.cu) and g++
               the rANS coder (csrc/rans.cpp), the three compilers started
               together;
  3. K1      - kernel against its plain PyTorch version (GDN and IGDN, float32
               and bfloat16, forward and dx) and its timings, float32 and
               bfloat16 at the main path's three shapes, beside its bound, the
               plain version and cuBLAS's addmm;
  4. amortized - the fp32 amortized forward of the lambda=0.01 MBT2018
               checkpoint on data_real/eval_photos.npy against nic_tpu's
               numbers, and the card against the port's own CPU run on a crop;
  5. main path - ``python -m nic_tpu_torch ... sga compress`` in-process, with
               K1's launches counted from zero; it also writes its bitstream,
               and ``sga decompress`` reads it back exactly;
  6. K2      - the fused up-conv + (I)GDN kernel against its plain version on
               the real g_s layers (fed the photos' activations), an odd shape
               and the inputs of ``exp_fused_convt bench``, float32 and
               bfloat16, GDN and IGDN; against the model's
               own layer; fused_synthesis_layer's dx; timings (float32 and
               bfloat16 at the three real layers, float32 at the JAX bench's
               shapes) beside its bound, the plain version and cuDNN's
               conv_transpose2d; then its path,
               ``exp_fused_convt bench`` and a fused_synthesis_layer step, with
               K2's launches counted from zero;
  7. bitstreams - ``mbt2018 compress`` of the photos to a file and
               ``mbt2018 decompress`` of it: exact, actual bpp beside nic_tpu's,
               K1's launches counted from zero on each;
  8. bf16 amortized - the bf16 model (``compute_dtype=torch.bfloat16``, the
               main path's dtype) on the photos against nic_tpu's bf16 numbers
               with its Pallas GDN, and K1's bf16 route held against its plain
               version on the inputs of every GDN and IGDN of g_a and g_s;
  9. bf16 sga - 2000 SGA steps on the bf16 model through LatentOptimizer (the
               route of nic_tpu's bench), K1's launches counted from zero, ms
               per step beside phase 5's fp32 figure;
 10. methods - ``map``, ``ste``, ``unoise`` and ``danneal compress`` through the
               CLI (fp32), at most 500 steps each, K1's launches
               counted from zero on each; unoise's and danneal's streams decode
               exactly, map writes none; and the first 20 steps of each method
               on a 64x64 crop, the card against the port's CPU path.
 11. bits-back - ``bb_plain``, ``bb_sga`` (500 RD + 2000 rate steps) and
               ``bb_no_sga`` (1000 rate steps) ``compress`` of the photos to a
               BB-ANS stream and ``decompress`` of it, through the CLI (fp32) on
               the lambda=0.01 bits-back checkpoint, K1's launches counted from
               zero on each path: every stream decodes exactly with its initial
               bits back; bb_plain's PSNR against nic_tpu's, its est. net bpp
               (mean of 200 evaluation samples; and, fed one fixed evaluation
               draw, the card against the port's CPU path on the full photos)
               and its stream's actual bpp (mean
               of 32 seeds: a single stream's size is a draw, see
               BB_ACTUAL_MEAN_RTOL) against nic_tpu's; bb_sga's rounded RD
               objective and bb_no_sga's est. net bpp below bb_plain's; and the
               first 20 steps of each phase on a 64x64 crop, the card against
               the port's CPU path.
 12. training - (a) K1's forward (GDN and IGDN, fp32) against its plain
               version at the training step's three shapes (M = 131072, 32768,
               8192), and its backward, ``gdn_backward``'s dx, dgamma and dbeta
               (torch matmuls, as nic_tpu's XLA ``_gdn_bwd``), against autograd
               through the plain version at M = 131072 and 8192, and through a
               fresh GDN layer's reparameterization;
               (b) the 3 photos written as PNGs, the training corpus; (c)
               ``mbt2018 train`` in-process from a fresh init at nf=192, batch
               8, patch 256, lambda 0.01, 200 steps, K1's launches counted from
               zero (6 per step), ms per step, the losses falling, the run's
               files; (d) a resume to step 210; (e) 3 steps at batch 2, patch
               128 from the lambda=0.01 checkpoint, the card against the port's
               CPU path on the same batches and noise: the first step's
               gradients, each step's loss, the parameters; (f) 20 steps from
               that checkpoint, then ``mbt2018 compress`` -> ``decompress`` of
               the photos from the new run: exact, its rounded RD objective on
               the photos at least 5 % below the checkpoint's, where the same
               steps with zeroed or negated gradients must not reach; (g) ``mbt2018_bb train``, 20 steps from
               the bits-back checkpoint, and its card against CPU steps as (e);
               (h) ``learned_prior`` on the card, 100 iterations on the photos'
               y: its loss falls.
 13. multi-GPU on one card - (a) K1 against its plain version (GDN and IGDN,
               fp32) and timed at the rows a rank sees: 2 row-shards of a photo
               (M = 24576, 6144, 1536) and 2-rank DP training (65536, 16384,
               4096); (b) spatial: 2 gloo ranks share the card, one 384x512
               photo: the amortized latents, danneal (25 steps) and SGA (2000,
               injected global noise) against the unsharded card run, K1's
               launches per rank, each rank's ms/step and, over a timed
               window, its collectives' and device-idle shares; (c) DP
               inference, SGA 2000 with injected noise on 2 photos at NCCL
               world size 1 (y and z equal to the unsharded run) and with 2
               gloo ranks; (d) DP training
               from the lambda=0.01 checkpoint (nf=192, batch 8, patch 256,
               20 steps, injected noise) at NCCL world size 1 and with 2 gloo
               ranks: the first averaged gradients, the losses, the
               parameters against the unsharded card run, rank 0 alone
               writing; (e) ``sga compress --data_parallel`` (NCCL at world
               size 1) and ``--spatial`` through the CLI, 200 steps, each
               stream decoded exactly. The gates of (b) to (d) run both sides
               with cuDNN's deterministic algorithms, and hold the sharded
               runs tightly over their first steps (EARLY_STEPS); the
               timings use its default algorithms.
 14. evaluation - the RD tools in-process on the lambda=0.01 runs, K1's
               launches counted from zero on each: (a) ``rd_curve --lmbda 0.01
               --methods amortized,sga`` (bf16, SGA 2000 steps) against
               nic_tpu's rows in results/photos_synth3, its CSVs in the
               reference's format; (b) ``rd_curve --model mbt2018_bb`` (bb_plain,
               bb_sga with 500 RD steps) equal bit for bit to
               BBLatentOptimizer.optimize with the same spec and seed, both with
               deterministic cuDNN, and bb_sga's RD objective below bb_plain's;
               (c) ``bd_report`` of (a)'s curves, each delta the golden curve's;
               (d) ``validate_rd`` (six methods, 200 steps) PASSes with every
               method below amortized, and ``validate_rd --bb`` on the first
               photo PASSes with both streams' initial bits back; (e)
               ``converge_aux`` on a copy of the run, a dry run and then 2000
               steps: the aux loss falls, only the quantiles change, and the
               run serves ``mbt2018 compress`` -> ``decompress`` exactly.
 15. int8 and up-sampling variants - (a) each int8 up-conv of g_s and h_s
               (ops/int8conv.py: im2col and torch._int_mm, not a kernel of
               this repo) at the photos' shapes with the model's weights,
               equal bit for bit to the port's CPU path, timed beside cuDNN's
               bf16 transposed conv and its bound at the int8 peak; (b)
               ``mbt2018 compress --quant int8`` -> ``decompress --quant
               int8``: exact, its actual bpp against nic_tpu's; (c) bf16 SGA
               at --quant none, int8 and int8_all through LatentOptimizer,
               500 steps each: ms/step, below amortized, each stream decoded
               exactly, and the first 20 steps of int8 and int8_all on a
               crop, the card against the port's CPU path; (d) the phases
               and subpixel up-convs against the transposed conv at g_s's
               largest layer, float32, timed; (e) K1's launches counted from
               zero on (b) and (c).
 16. the last scripts - K1 against its plain version (GDN and IGDN) and
               timed at these paths' new shapes (the landscape grid's IGDN rows,
               32 copies of photo 0, bf16; the demo's nf=16 training step,
               float32); then in-process, K1's launches counted from zero on
               each: (a) ``tools/sga_landscape``'s ``landscape`` (the paper's Fig. 2;
               the card's machine has no matplotlib, so no figure) on photo 0
               with the bf16 model, LANDSCAPE_ITS SGA steps recorded every
               LANDSCAPE_RECORD_EVERY and a LANDSCAPE_GRID^2 grid: the
               trajectory's first row is the amortized y, the objective finite
               and not constant, a point evaluated inside a batch of 32 equal
               to it alone, SGA's rounded RD objective below amortized; and on
               a 64x64 crop with the fp32 model, fed one seeded set of Gumbel
               draws, the trajectory, the samples and the grid, the card
               against the port's CPU path; (b) ``tools/diagnose_photos`` on
               the photos: the mean est. bpp against nic_tpu's amortized one,
               the mean PSNR against nic_tpu's script's, no scale at the
               table's top; (c) ``tools/demo`` (nf=16, 64x64): training
               DEMO_STEPS steps, both streams decoded exactly, SGA below
               amortized.
Both kernels run on the tensor cores; their bounds count three TF32 products
for each float32 product (``BOUND_DEFINITION``, printed after the build).
Then a JSON line of kernel measurements (``kernels``) and of each path's own
measurements (``paths``), nvidia-smi's line, and as the last
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
# nic_tpu's actual bpp of `mbt2018 compress` of the same photos (one stream
# of the 3-image batch, 38561 bytes), on the CPU:
#   JAX_PLATFORMS=cpu python -m nic_tpu --num_filters 192 \
#     --checkpoint_dir checkpoints_synth3 mbt2018 compress --results_dir r \
#     mbt2018-num_filters=192-lmbda=0.01 data_real/eval_photos.npy photos.ntc
#   -> avg_batch_actual_bpp in r/rd-mbt2018-...-input=eval_photos.npy.npz
JAX_AMORTIZED_ACTUAL_BPP = 0.5230170355902778
PSNR_ATOL_DB = 0.05
# nic_tpu's SGA record for this checkpoint (bf16 transforms, 2000 steps),
# results/photos_synth3/rd_curve.json; printed beside the port's, not held.
JAX_SGA_RECORD = dict(est_bpp=0.5141, psnr=30.52)
# nic_tpu's bf16 amortized eval with its Pallas GDN (K1's semantics), on the
# CPU:
#   JAX_PLATFORMS=cpu python -c "import numpy as np, jax.numpy as jnp; \
#     from nic_tpu.train.trainer import TrainConfig, Trainer; \
#     from nic_tpu.models.mbt2018 import MeanScaleHyperprior; \
#     from nic_tpu.infer.engine import LatentOptimizer; \
#     tr = Trainer(TrainConfig(num_filters=192, checkpoint_dir='checkpoints_synth3', \
#                              runname='mbt2018-num_filters=192-lmbda=0.01')); \
#     _, p = tr.restore_params_only(); \
#     m = MeanScaleHyperprior(192, compute_dtype=jnp.bfloat16, use_pallas_gdn=True); \
#     x = np.load('data_real/eval_photos.npy').astype(np.float32) / 255.0; \
#     r = LatentOptimizer(m, p).eval_amortized(x); \
#     print(float(r['est_bpp'].mean()), float(r['psnr'].mean()))"
# Held with the fp32 limits (BPP_RTOL, PSNR_ATOL_DB): bf16 sums rounded in
# another order flip a few roundings of y and z, each worth a few bits.
JAX_BF16_AMORTIZED_BPP = 0.5311458706855774
JAX_BF16_AMORTIZED_PSNR = 29.18467140197754
# The four other methods, run by the CLI for at most METHOD_ITS steps (map
# and ste stop early, after 300-600). Cut from the specs' 2000 to keep the
# whole run within half its time limit: the gates (streams exact, the RD
# objective below amortized, the first steps against the CPU) hold at this
# depth.
METHODS = ("map", "ste", "unoise", "danneal")
METHOD_ITS = 500
# Each method's first steps on a 64x64 crop, the card against the port's CPU
# path (fp32; unoise fed the same uniform draws on both): the loss of every
# step, max-norm relative. fp32 sums in another order, carried through
# METHOD_STEPS Adam steps.
METHOD_STEPS = 20
METHOD_LOSS_RTOL = 1e-3

# Phase 11, bits-back, on the lambda=0.01 bits-back checkpoint; bb_sga's RD
# phase cut from 2000 steps, as METHOD_ITS (its rate phase keeps the spec's).
BB_RUN = "mbt2018_bb-num_filters=192-lmbda=0.01"
BB_SGA_RD_ITS = 500
BB_SCRIPTS = ("bb_plain", "bb_sga", "bb_no_sga")
# nic_tpu's `bb_plain compress` of the same photos, on the CPU (seed 0):
#   JAX_PLATFORMS=cpu python -m nic_tpu --num_filters 192 \
#     --checkpoint_dir checkpoints_synth3 bb_plain compress --results_dir r \
#     mbt2018_bb-num_filters=192-lmbda=0.01 data_real/eval_photos.npy photos_bb.ntc
#   -> 50265 bytes; est_bpp and psnr (means) in
#      r/rd-bb_plain-lmbda=0.01+mbt2018_bb-...-input=eval_photos.npy.npz
# Its est. net bpp is one posterior sample and its stream one draw of the
# posterior pop, so both are held as means over seeds (below); these are
# printed beside the port's. The PSNR is deterministic and held.
JAX_BB_PLAIN = dict(est_bpp=0.5444669425487518, psnr=29.0546875,
                    actual_bpp=50265 * 8 / (3 * 384 * 512))
# nic_tpu's means over seeds, on the CPU: est. net bpp over the evaluation
# samples of seeds 0..199 (one standard deviation 0.19 % of one sample, its
# mean's standard error 0.013 %), the stream's actual bpp over seeds 0..31
# (2.4 % of one stream):
#   JAX_PLATFORMS=cpu python -c "import numpy as np; \
#     from nic_tpu.train.trainer import TrainConfig, Trainer; \
#     from nic_tpu.infer.bb import BBLatentOptimizer, BB_PLAIN; \
#     from nic_tpu.coding.bb_codec import BitsBackCodec; \
#     tr = Trainer(TrainConfig(model='mbt2018_bb', num_filters=192, \
#       checkpoint_dir='checkpoints_synth3', runname='mbt2018_bb-num_filters=192-lmbda=0.01')); \
#     _, p = tr.restore_params_only(); \
#     x = np.load('data_real/eval_photos.npy').astype(np.float32) / 255.0; \
#     opt = BBLatentOptimizer(tr.model, p); codec = BitsBackCodec(tr.model, p); \
#     est = [float(opt.optimize(x, 0.01, spec=BB_PLAIN, seed=s)['est_bpp'].mean()) \
#            for s in range(200)]; \
#     act = [codec.compress(x, seed=s)[1]['actual_bpp'] for s in range(32)]; \
#     print(float(np.mean(est)), float(np.std(est)), float(np.mean(act)), float(np.std(act)))"
#   -> est mean 0.543394, sd 1.02e-3 (to 6 digits); actual 0.6670116848415799, sd
#      0.01572224405249451. (Over seeds 0..15 the est. mean reads 0.5438225641846657,
#      0.08 % above the 200-seed mean: too few samples for a reference.)
# nic_tpu's `bb_no_sga compress` of the same photos (1000 rate steps, one
# run of its draws), on the CPU: printed beside the port's, not held:
#   JAX_PLATFORMS=cpu python -m nic_tpu --num_filters 192 \
#     --checkpoint_dir checkpoints_synth3 bb_no_sga compress --results_dir r \
#     mbt2018_bb-num_filters=192-lmbda=0.01 data_real/eval_photos.npy
#   -> est_bpp (mean) in r/rd-bb_no_sga-lmbda=0.01+mbt2018_bb-...-input=eval_photos.npy.npz
JAX_BB_NO_SGA_EST = 0.46982138355573017
JAX_BB_PLAIN_EST_MEAN = 0.543394
JAX_BB_PLAIN_ACTUAL_MEAN = 0.6670116848415799
BB_EST_SEEDS = 200
BB_STREAM_SEEDS = 32
# The means of 32 streams on each side differ by 0.6 % at one standard
# deviation; 2 % is 3.3 of those (the port's CPU run: 0.06 % off).
BB_ACTUAL_MEAN_RTOL = 0.02
# The first steps of each phase on a 64x64 crop, card against CPU, fed the
# same draws: each step's loss, max-norm relative (as METHOD_LOSS_RTOL).
BB_STEPS = 20
# bb_plain on the full photos, the card against the port's CPU path, both fed
# the same evaluation draw (eps): est. net bpp per image, relative. float32
# sums in another order; a rounding of y* that the card's last bits flip
# would move it by a few bits in ~3e5.
BB_EPS_RTOL = 1e-5

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

# K2 against its plain version (its own formulation in fp32 on the same
# inputs), max-norm relative: float32 1e-5 (summation order), bfloat16 2e-2
# (output rounding, a few ulps). Against the model's own layer (cuDNN's fp32
# transposed conv, then K1's IGDN) and the composite's dx: 1e-5 (float32,
# summation order).
K2_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
K2_MODEL_RTOL = 1e-5
# K2 at an odd shape, and at the JAX bench's g_s layers at N = 24.
K2_ODD_SHAPE = (2, 13, 9, 192)
K2_BENCH_SHAPES = ((24, 48, 32, 192), (24, 96, 64, 192), (24, 192, 128, 192))

# H100 SXM peaks (NVIDIA's data sheet) for the kernels' bounds. Both kernels
# run on the tensor cores: bf16 at 989 TFLOP/s dense; fp32 as 3xTF32, three
# TF32 products (495 TFLOP/s) for each fp32-accurate product. The bound of
# the earlier CUDA-core kernels, FLOPs at 67 TFLOP/s fp32, is printed beside.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PRODUCTS_PER_FLOP = {"float32": 3, "bfloat16": 1}
CUDA_CORE_FP32_FLOPS = 67e12
BOUND_DEFINITION = (
    "bound = max(bytes / 3.35 TB/s, P * FLOPs / peak): bfloat16 P = 1 at 989 TFLOP/s; "
    "float32 (3xTF32) P = 3 at 495 TFLOP/s TF32 (for the earlier CUDA-core kernels: P = 1 "
    "at 67 TFLOP/s, the CUDA cores' fp32, printed as bound_cuda_core_ms)")

# Phase 12, training: nic_tpu's default configuration (nf=192, batch 8,
# patch 256), float32. K1's rows in a step: g_a's GDN at 8 x 128^2, 64^2 and
# 32^2, g_s's IGDN at the same three.
TRAIN_ROWS = (8192, 32768, 131072)
TRAIN_STEPS = 200
TRAIN_RESUME_STEP = 210
# Steps from a committed checkpoint before serving it (f), and of the
# bits-back model (g).
TRAIN_FT_STEPS = 20
# K1's backward (gdn_backward: torch matmuls on K1's saved inputs) against
# autograd through its plain version, each gradient's L2 error over its L2
# norm: the repo's float32 gradient tolerance (dgamma sums over M rows in
# another order). K1's forward at the training shapes: K1_RTOL.
K1_VJP_RTOL = 1e-4
# The card against the port's CPU path over TRAIN_CMP_STEPS steps: the
# first step's gradient of every parameter, its L2 error over its L2 norm
# (the CPU tests' float32 gradient tolerance); each step's loss, relative
# (float32 sums in another order through two Adam updates); the parameters
# after the steps within TRAIN_PARAM_LRS of their group's learning rate at
# most and TRAIN_PARAM_MEAN_LRS on average over each leaf (Adam moves a
# parameter by about lr whatever its gradient's size, so a near-zero
# gradient rounded the other way can move it 2 lr the other way per step;
# the mean holds the leaf as a whole, as the CPU tests do).
TRAIN_CMP_STEPS = 3
TRAIN_GRAD_RTOL = 1e-4
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_LRS = 2 * TRAIN_CMP_STEPS
TRAIN_PARAM_MEAN_LRS = 1e-2
# The quantile loss |logit - target| has no derivative where a converged
# quantile of the checkpoint sits: within this of it float32 rounding makes
# the gradient -g, 0 or g. Those quantiles (at most 5 %) are left out of the
# gradient's and the mean's comparison, as in the CPU tests; the largest
# difference holds them too.
QUANTILE_KINK = 1e-5
# The served run's 20 steps train on the photos themselves, so a working
# trainer lowers their rounded RD objective (phase 4's reading is the
# checkpoint's): by at least SERVE_RD_FALL, to a finite value. Two broken
# trainers, the same steps from the same checkpoint with every gradient
# zeroed (no parameter moves: the checkpoint's reading) or negated (ascent,
# which may diverge), must fail that gate, so it tells a working trainer
# from a broken one.
SERVE_RD_FALL = 0.05
PRIOR_ITS = 100

# Phase 13, multi-GPU on one card. K1's rows on a rank: 2 row-shards of one
# 384x512 photo (g_a's GDN and g_s's IGDN at 96x256, 48x128, 24x64 rows of
# 1 image), and 2-rank DP training at batch 4 each, patch 256.
SPATIAL_ROWS = (24576, 6144, 1536)
DP_TRAIN_ROWS = (65536, 16384, 4096)
# Spatial against the unsharded card run (nic_tpu's tests/test_spatial.py):
# the amortized latents 2e-5 absolute; after danneal's 25 steps 99.9 % of
# the rounded y equal and bpp and PSNR within 1e-3 (the halo slab's
# convolutions sum in another order, and Adam carries it).
SPATIAL_DANNEAL_ITS = 25
SPATIAL_INIT_ATOL = 2e-5
SPATIAL_Y_EQUAL = 0.999
SPATIAL_METRIC_RTOL = 1e-3
# SGA's 2000 Adam steps carry any last-bit difference into a share of the
# rounded y. On an H100 the unsharded run with cuDNN's default algorithms
# differs from the same run with its deterministic ones in 1.2 % of y, bpp
# 7e-4 and PSNR 1e-4 (one photo; two: 0.9 %, 7e-4, 9e-5), and a sharded run
# sums in another order still (other shapes, other kernels). So a sharded
# SGA run is held tightly where that chaos cannot yet mask a fault, over its
# first EARLY_STEPS steps' losses and its first step's y and z gradients
# (EARLY_RTOL, L2 relative); and after its 2000 steps at fixed limits about
# 2.5 times the largest difference measured so: LONG_Y_UNEQUAL of y unequal,
# LONG_METRIC_RTOL on bpp and PSNR.
EARLY_STEPS = 20
EARLY_RTOL = 1e-5
LONG_Y_UNEQUAL = 0.03
LONG_METRIC_RTOL = 5e-3
SPATIAL_SEED = 7
# DP inference against the unsharded card run. At NCCL world size 1 a rank
# computes the unsharded batch itself: y and z equal, bpp within 1e-6. Two
# ranks run batch 1 each against the unsharded batch 2, and cuDNN's and
# cuBLAS's kernels (chosen by shape) sum in another order at another batch
# size: held as spatial's SGA is.
DP_SEED = 8
DP_BPP_RTOL = 1e-6
# DP training against the unsharded card run: TRAIN_GRAD_RTOL on the first
# averaged gradients, the losses of DP_TRAIN_STEPS steps within 1e-5, and
# after TRAIN_CMP_STEPS steps every |dparam| within TRAIN_PARAM_LRS lr and
# each leaf's mean within TRAIN_PARAM_MEAN_LRS lr. Adam's first steps move a
# parameter by about lr whatever its gradient's size, so an element whose
# gradient alone differs (a GDN gamma below its bound, where the bound's
# gate reads the gradient's sign: the global batch's, GDN.average_grad)
# shows here and not in the gradients' norms.
DP_TRAIN_STEPS = 20
DP_LOSS_RTOL = 1e-5
# Steps of a rank's timed window (collectives synchronised, torch.profiler).
WINDOW_STEPS = 50
# SGA steps of the CLI's --data_parallel and --spatial runs in (e), which
# check the CLI and the streams; (b) to (d) hold the paths at full depth.
CLI_ITS = 200

# Phase 14, evaluation and reporting, through the tools on the lambda=0.01
# runs. nic_tpu's rows of that run (bf16 transforms, SGA 2000 steps), from
# results/photos_synth3/rd_curve.json (results/ is not in the chip copy):
JAX_RD_ROWS = {"amortized": dict(bpp=0.5314129590988159, psnr=29.180017471313477),
               "sga": dict(bpp=0.5140546560287476, psnr=30.519134521484375)}
# Amortized is held at BPP_RTOL and PSNR_ATOL_DB. SGA's Gumbel draws are
# torch's, not JAX's: bpp at BPP_RTOL, PSNR at 0.1 dB (bf16 SGA on the card
# measured 0.03 % and 0.015 dB off; a broken SGA lands at amortized's
# values, 3.4 % away in bpp).
RD_SGA_PSNR_ATOL_DB = 0.1
# rd_curve --model mbt2018_bb: bb_sga's RD phase; validate_rd's steps per
# method; converge_aux's steps.
EVAL_BB_ITS = 500
VALIDATE_ITS = 200
AUX_STEPS = 2000
# A row of a <method>-psnr.csv, the reference's format.
CSV_ROW = r"\d+\.\d{4},\d+\.\d{6}"

# Phase 15, int8 and up-sampling variants. The int8 convs at the photos'
# shapes (N, H, W, C, Co): g_s's three up-convs and h_s's two.
INT8_SHAPES = ((3, 24, 32, 192, 192), (3, 48, 64, 192, 192), (3, 96, 128, 192, 192),
               (3, 6, 8, 192, 192), (3, 12, 16, 192, 288))
INT8_LAYERS = ("synthesis.layer_0", "synthesis.layer_1", "synthesis.layer_2",
               "hyper_synthesis.layer_0", "hyper_synthesis.layer_1")
# Hopper's dense int8 tensor-core peak (NVIDIA's data sheet, H100 SXM).
PEAK_INT8_OPS = 1979e12
# nic_tpu's actual bpp of `mbt2018 compress --quant int8` of the photos
# (one stream of the 3-image batch), on the CPU:
#   JAX_PLATFORMS=cpu python -m nic_tpu --num_filters 192 \
#     --checkpoint_dir checkpoints_synth3 mbt2018 compress --quant int8 \
#     --results_dir r mbt2018-num_filters=192-lmbda=0.01 \
#     data_real/eval_photos.npy photos.ntc
#   -> avg_batch_actual_bpp in r/rd-mbt2018-...-input=eval_photos.npy.npz (38586
#      bytes); its est. bpp and PSNR (means), printed beside the port's
JAX_INT8_ACTUAL_BPP = 0.5233561197916666
JAX_INT8_EST = dict(est_bpp=0.5309748152891794, psnr=29.02895673116048)
# bf16 SGA at --quant none, int8 and int8_all through LatentOptimizer, each
# METHOD_ITS steps (cut from 2000 as phase 10's methods); the first
# QUANT_STEPS steps on a 64x64 crop, the card against the port's CPU path,
# fed the same Gumbel draws, with the CLI's float32 transforms. The first
# step's loss within QUANT_FIRST_RTOL (float32 sums in another order:
# measured 1.2e-7 on an H100). Every step's within QUANT_LOSS_RTOL: an int8
# rounding is a step function, so a float32 ulp of its input, which the two
# devices' sums in another order give, can move one element by 1/127 of its
# tensor's scale; it moved single steps' losses by up to 2.1e-3 (int8) and
# 4.7e-3 (int8_all) on an H100, where float32 without int8 stays below
# 1.5e-6. With the bf16 transforms the card and the CPU round every bf16
# conv in another order: 8.4e-4 without int8 and 4.15e-3 with it on an
# H100, so the bf16 steps are not compared.
QUANT_MODES = ("none", "int8", "int8_all")
QUANT_STEPS = 20
QUANT_FIRST_RTOL = 1e-5
QUANT_LOSS_RTOL = 1e-2
# The phases and subpixel up-convs against the transposed conv at g_s's
# largest layer, float32 (the CPU tests' value tolerance, max-norm).
VARIANT_RTOL = 1e-5

# Phase 16, the last scripts. The landscape on photo 0 (y: 24 x 32 x 192),
# SGA cut from the script's 2000 steps as METHOD_ITS; the grid point at the
# trajectory's end evaluated inside a batch of 32 against alone (bf16 convs
# at another batch size: other kernels, sums in another order). On a 64x64
# crop, fp32, the card against the port's CPU path as METHOD_LOSS_RTOL: the
# trajectory and the grid (evaluated on the card's y*, z*, coordinates and
# axes on both), max-norm relative; the samples absolute.
LANDSCAPE_ITS = 500
LANDSCAPE_RECORD_EVERY = 25
LANDSCAPE_GRID = 21
LANDSCAPE_BATCH_RTOL = 1e-3
LANDSCAPE_CROP_ITS = 20
LANDSCAPE_CROP_RECORD_EVERY = 5
LANDSCAPE_CROP_GRID = 5
# diagnose_photos: the mean y_bpp + z_bpp is the amortized est. bpp (held at
# BPP_RTOL against JAX_AMORTIZED_BPP). Its PSNR is that of the unrounded,
# unclipped reconstruction, which is not the 8-bit PSNR of
# JAX_AMORTIZED_PSNR (0.185 dB apart on these photos); it is held at
# PSNR_ATOL_DB against nic_tpu's script on the CPU:
#   JAX_PLATFORMS=cpu python scripts/diagnose_photos.py \
#     checkpoints_synth3/mbt2018-num_filters=192-lmbda=0.01 data_real/eval_photos.npy
#   -> "mean": psnr 28.976633071899414, sig_lo 0.5321519871552786, sig_hi 0.0
JAX_DIAGNOSE = dict(psnr=28.976633071899414, sig_lo=0.5321519871552786, sig_hi=0.0)
# No image may have more than this share of its scales at the table's top
# (nic_tpu: none on these photos; 6.8e-6 at most on results/photos).
SIG_HI_MAX = 1e-4
# The demo's training steps and SGA steps (its defaults: 1500 and 500).
DEMO_STEPS = 500
DEMO_SGA_ITS = 200
# K1's new shapes on these paths (rows, channels, dtype): the landscape's
# grid, g_s's IGDN of 32 copies of photo 0's latents (bf16); the demo's
# training step, g_a's GDN and g_s's IGDN at batch 8 of 64x64, nf=16 (fp32).
LAST_SCRIPTS_K1 = (("sga_landscape grid", 98304, 192, "bfloat16"),
                   ("sga_landscape grid", 393216, 192, "bfloat16"),
                   ("sga_landscape grid", 1572864, 192, "bfloat16"),
                   ("demo training", 8192, 16, "float32"),
                   ("demo training", 2048, 16, "float32"),
                   ("demo training", 512, 16, "float32"))

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


def bound_ms(nbytes, flops, dtype):
    """The bound and what sets it, and the bound of the earlier CUDA-core
    kernels (fp32 FLOPs at 67 TFLOP/s; None for bf16)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = PRODUCTS_PER_FLOP[dtype] * flops / PEAK_FLOPS[dtype] * 1e3
    old = max(t_bytes, flops / CUDA_CORE_FP32_FLOPS * 1e3) if dtype == "float32" else None
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), old


def k1_bound_ms(rows, dtype, c=CHANNELS):
    size = 4 if dtype == "float32" else 2
    nbytes = (2 * rows * c + c * c) * size + c * 4
    return bound_ms(nbytes, 2 * rows * c * c, dtype)


def k1_inputs(rows, generator, c=CHANNELS):
    import torch

    dev = "cuda"
    x = 2.0 * torch.randn(rows, c, device=dev, generator=generator)
    gamma = 0.1 * torch.eye(c, device=dev) + 0.01 * torch.rand(
        c, c, device=dev, generator=generator)
    beta = 1.0 + 0.1 * torch.rand(c, device=dev, generator=generator)
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
    """K1, its plain version and addmm at the main path's shapes and the
    training step's (IGDN)."""
    import torch

    from nic_tpu_torch.ops.gdn_cuda import gdn_forward_kernel, gdn_reference

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows_list = [(r, d) for d in ("float32", "bfloat16") for r in GS_ROWS]
    rows_list += [(r, "float32") for r in TRAIN_ROWS]
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
        bound, bound_by, bound_old = k1_bound_ms(rows, dtype)
        row = dict(rows=rows, dtype=dtype, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=bound_by, library_ms=library_ms, bound_cuda_core_ms=bound_old)
        table.append(row)
        old = "" if bound_old is None else f", CUDA-core fp32 bound {bound_old:.4f} ms"
        log(f"K1 IGDN M={rows} C={CHANNELS} {dtype}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, addmm(beta, x^2, gamma) [cuBLAS] {library_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({bound_by}){old}")
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


def read_png(path):
    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def run_main_path(amortized, workdir):
    """sga compress through the CLI entry point, K1's launches counted; it
    writes its bitstream, and sga decompress reads it back exactly."""
    import numpy as np

    from nic_tpu_torch.cli.main import main as cli_main
    from nic_tpu_torch.ops import gdn_cuda

    results_dir = os.path.join(workdir, "results_sga")
    stream = os.path.join(workdir, "photos_sga.ntc")
    common = ["--num_filters", "192", "--checkpoint_dir", CKPT_DIR, "sga"]
    gdn_cuda.launches = 0
    out = cli_main(common + ["compress", RUN, PHOTOS, stream, "--sga_its", str(SGA_ITS),
                             "--results_dir", results_dir])
    launches = gdn_cuda.launches
    written = os.listdir(results_dir)
    res = out["results"]
    for k, v in res.items():
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"sga compress: {k} is not finite")
    if not any(f.startswith("rd-sga-") for f in written):
        raise AssertionError(f"sga compress wrote no rd-sga-*.npz: {written}")
    ms_step = out["loop_ms"][0] / out["steps"][0]
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

    num_pixels = out["pixels"].size // 3
    actual = out["bytes"] * 8 / num_pixels
    log(f"sga compress: wrote {out['bytes']} bytes = {actual!r} bpp actual (est "
        f"{float(res['est_bpp'].mean())!r}); codec ms {fmt_timing(out['timing'])}")
    png = os.path.join(workdir, "photos_sga.png")
    gdn_cuda.launches = 0
    dec = cli_main(common + ["decompress", RUN, stream, png])
    decode_launches = gdn_cuda.launches
    check_exact("sga", dec, png, out["pixels"])
    log(f"sga decompress: exact; codec ms {fmt_timing(dec['timing'])}; K1 launches "
        f"on the decode path {decode_launches}")
    if decode_launches < 3:
        raise AssertionError("the decode path did not run K1 in g_s")
    return launches, dict(ms_per_step=ms_step, k1_launches_encode=launches,
                          k1_launches_decode=decode_launches, actual_bpp=actual,
                          est_bpp=float(res["est_bpp"].mean()),
                          encode_ms=out["timing"], decode_ms=dec["timing"])


def fmt_timing(timing):
    return ", ".join(f"{k} {v:.1f}" for k, v in sorted(timing.items()))


def check_exact(script, dec, png, pixels):
    """The decoded batch and the written PNG (image 0) equal the compress
    side's uint8 reconstruction exactly."""
    import numpy as np

    got = np.round(dec["x_hat"] * 255.0).astype(np.uint8)
    if got.shape != pixels.shape or not np.array_equal(got, pixels):
        n_diff = int(np.sum(got != pixels)) if got.shape == pixels.shape else -1
        raise AssertionError(f"{script} decompress differs from the compress side at "
                             f"{n_diff} values")
    if not np.array_equal(read_png(png), pixels[0]):
        raise AssertionError(f"{script} decompress: the PNG differs from the compress side")


def run_bitstreams(workdir):
    """mbt2018 compress of the photos to a file, then mbt2018 decompress of
    it, through the CLI: exact, and the actual bpp beside nic_tpu's."""
    import numpy as np

    from nic_tpu_torch.cli.main import main as cli_main
    from nic_tpu_torch.ops import gdn_cuda

    common = ["--num_filters", "192", "--checkpoint_dir", CKPT_DIR, "mbt2018"]
    stream = os.path.join(workdir, "photos.ntc")
    png = os.path.join(workdir, "photos.png")
    gdn_cuda.launches = 0
    out = cli_main(common + ["compress", RUN, PHOTOS, stream, "--results_dir",
                             os.path.join(workdir, "results_mbt2018")])
    encode_launches = gdn_cuda.launches
    gdn_cuda.launches = 0
    dec = cli_main(common + ["decompress", RUN, stream, png])
    decode_launches = gdn_cuda.launches
    check_exact("mbt2018", dec, png, out["pixels"])
    res = out["results"]
    actual = float(res["avg_batch_actual_bpp"])
    est = float(res["est_bpp"].mean())
    d_actual = abs(actual - JAX_AMORTIZED_ACTUAL_BPP) / JAX_AMORTIZED_ACTUAL_BPP
    n = out["pixels"].shape[0]
    log(f"mbt2018 compress -> decompress: exact; actual {actual!r} bpp "
        f"({out['bytes']} bytes) vs est {est!r} bpp; nic_tpu's actual "
        f"{JAX_AMORTIZED_ACTUAL_BPP!r} (rel diff {d_actual:.2e}, tolerance "
        f"{BPP_RTOL:g})")
    log(f"codec ms for {n} images, encode: {fmt_timing(out['timing'])}; decode: "
        f"{fmt_timing(dec['timing'])}")
    log(f"mbt2018: K1 launches on the encode path {encode_launches} (>= 6 required: "
        f"g_a and g_s), on the decode path {decode_launches} (>= 3 required: g_s)")
    if not np.isfinite(actual) or d_actual > BPP_RTOL:
        raise AssertionError("mbt2018 actual bpp disagrees with nic_tpu's")
    if encode_launches < 6 or decode_launches < 3:
        raise AssertionError("the mbt2018 codec path did not run K1 in every GDN")
    return dict(k1_launches_encode=encode_launches, k1_launches_decode=decode_launches,
                actual_bpp=actual, est_bpp=est, encode_ms=out["timing"],
                decode_ms=dec["timing"])


def k2_bound_ms(shape, dtype, co=CHANNELS):
    n, h, w, c = shape
    size = 4 if dtype == "float32" else 2
    nbytes = (n * h * w * c + 4 * n * h * w * co + 25 * c * co) * size + (co * co + 2 * co) * 4
    flops = 2 * n * h * w * 25 * c * co + 2 * n * 4 * h * w * co * co
    return bound_ms(nbytes, flops, dtype)


def gs_layers(model_cpu):
    """The real g_s layers of the checkpoint: for each, its input from the
    photos' amortized latents, its HWIO kernel, bias, IGDN beta and gamma,
    and the model's own output (SignalConv up, then the IGDN, on the card)."""
    import numpy as np
    import torch

    model = copy.deepcopy(model_cpu).to("cuda")
    x = torch.from_numpy(np.load(PHOTOS).astype(np.float32) / 255.0).to("cuda")
    layers = []
    with torch.no_grad():
        h = model(x)["y_tilde"]
        for i in range(3):
            conv = getattr(model.synthesis, f"layer_{i}")
            igdn = getattr(model.synthesis, f"igdn_{i}")
            beta, gamma = igdn.effective_params()
            w = conv.weight.detach().permute(2, 3, 0, 1).flip(0, 1).contiguous()
            out = igdn(conv(h))
            layers.append(dict(x=h, w=w, bias=conv.bias.detach(), beta=beta,
                               gamma=gamma, model_out=out))
            h = out
    return layers


def check_k2(layers):
    """K2 against its plain version (f32, bf16, GDN, IGDN) on the real g_s
    layers, an odd shape and the inputs that ``exp_fused_convt bench`` gives
    it; against the model's own layer; and fused_synthesis_layer's dx
    against the composite's. Returns the largest float32 error against the
    plain version (absolute)."""
    import torch

    from nic_tpu_torch.ops import convt_igdn
    from nic_tpu_torch.tools import exp_fused_convt

    gen = torch.Generator(device="cuda").manual_seed(5)
    n, h, w, c = K2_ODD_SHAPE
    odd = dict(x=torch.randn(n, h, w, c, device="cuda", generator=gen),
               w=0.05 * torch.randn(5, 5, c, c, device="cuda", generator=gen),
               bias=0.1 * torch.randn(c, device="cuda", generator=gen),
               beta=0.5 + torch.rand(c, device="cuda", generator=gen),
               gamma=0.05 * torch.rand(c, c, device="cuda", generator=gen))
    bench = dict(zip(("x", "w", "bias", "beta", "gamma"), exp_fused_convt.bench_inputs()))
    max_abs = 0.0
    with torch.no_grad():
        for case in layers + [odd, bench]:
            shape = tuple(case["x"].shape)
            for dtype in ("float32", "bfloat16"):
                dt = getattr(torch, dtype)
                xk, wk = case["x"].to(dt), case["w"].to(dt)
                for inverse in (True, False):
                    args = (xk, wk, case["bias"], case["beta"], case["gamma"], inverse)
                    out = convt_igdn.conv_transpose_igdn_up2(*args)
                    ref = convt_igdn.conv_transpose_igdn_up2_plain(*args)
                    torch.cuda.synchronize()
                    err = rel_err(out, ref)
                    name = "IGDN" if inverse else "GDN"
                    log(f"K2 {name} {shape} {dtype}: rel err {err:.3e} vs plain "
                        f"(tolerance {K2_RTOL[dtype]:g})")
                    if out.shape != ref.shape or not err <= K2_RTOL[dtype]:
                        raise AssertionError(f"K2 {name} {shape} {dtype} disagrees with "
                                             "its plain version")
                    if dtype == "float32":
                        max_abs = max(max_abs, float((out - ref).abs().max()))
                    if dtype == "float32" and inverse and "model_out" in case:
                        e_model = rel_err(out, case["model_out"])
                        log(f"K2 IGDN {shape}: rel err {e_model:.3e} vs the model's own "
                            f"layer (tolerance {K2_MODEL_RTOL:g})")
                        if not e_model <= K2_MODEL_RTOL:
                            raise AssertionError("K2 disagrees with the model's layer")

    layer = layers[1]
    args = [layer[k].clone().requires_grad_(k == "x")
            for k in ("x", "w", "bias", "beta", "gamma")]
    g = torch.randn(layer["model_out"].shape, device="cuda", generator=gen)
    (dx,) = torch.autograd.grad(convt_igdn.fused_synthesis_layer(*args), [args[0]], g)
    ref_args = [a.detach().requires_grad_(i == 0) for i, a in enumerate(args)]
    (dx_ref,) = torch.autograd.grad(
        convt_igdn.conv_transpose_igdn_up2_reference(*ref_args), [ref_args[0]], g)
    e_dx = rel_err(dx, dx_ref)
    log(f"fused_synthesis_layer {tuple(args[0].shape)}: dx rel err {e_dx:.3e} vs the "
        f"composite's (tolerance {K2_MODEL_RTOL:g})")
    if not e_dx <= K2_MODEL_RTOL:
        raise AssertionError("fused_synthesis_layer's dx disagrees with the composite")
    return max_abs


def time_k2(layers):
    """K2, its plain version and cuDNN's conv_transpose2d alone, at the main
    path's g_s shapes (float32 and bfloat16) and the JAX bench's shapes at
    N = 24 (float32). ``ms`` is the kernel on weights packed beforehand
    (``pack_weights``, ``pack_gamma``: once per set of weights);
    ``wrapper_ms`` the wrapper that packs them on every call."""
    import torch
    import torch.nn.functional as F

    from nic_tpu_torch.ops import convt_igdn

    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = [(l["x"], l, d) for d in ("float32", "bfloat16") for l in layers]
    for shape in K2_BENCH_SHAPES:
        x = torch.randn(*shape, device="cuda", generator=gen)
        cases.append((x, layers[0], "float32"))
    table = []
    for x, p, dtype in cases:
        dt = getattr(torch, dtype)
        x, w = x.to(dt).contiguous(), p["w"].to(dt).contiguous()
        args = (x, w, p["bias"], p["beta"], p["gamma"], True)
        # cuDNN's transposed conv alone, as the port's SignalConv calls it.
        weight = w.flip(0, 1).permute(2, 3, 0, 1).contiguous()
        x_nchw = x.permute(0, 3, 1, 2)
        packed = (x, convt_igdn.pack_weights(w, dt), p["bias"], p["beta"],
                  convt_igdn.pack_gamma(p["gamma"], dt), w.shape[3], True)
        with torch.no_grad():
            ms = time_ms(lambda: convt_igdn.convt_igdn_packed_forward(*packed))
            wrapper_ms = time_ms(lambda: convt_igdn.convt_igdn_forward_kernel(*args))
            plain_ms = time_ms(lambda: convt_igdn.conv_transpose_igdn_up2_plain(*args))
            library_ms = time_ms(lambda: F.conv_transpose2d(
                x_nchw, weight, p["bias"].to(dt), stride=2, padding=1))
        shape = tuple(x.shape)
        bound, bound_by, bound_old = k2_bound_ms(shape, dtype)
        table.append(dict(shape=shape, dtype=dtype, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound, bound_by=bound_by, library_ms=library_ms,
                          wrapper_ms=wrapper_ms, bound_cuda_core_ms=bound_old))
        old = "" if bound_old is None else f", CUDA-core fp32 bound {bound_old:.4f} ms"
        log(f"K2 IGDN {shape} {dtype}: kernel {ms:.4f} ms (with packing {wrapper_ms:.4f}), "
            f"plain {plain_ms:.4f} ms, conv_transpose2d [cuDNN] {library_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({bound_by}){old}")
        del x, w, args, packed, weight, x_nchw
        torch.cuda.empty_cache()
    return table


def run_k2_path(layers):
    """K2's path, its launches counted from zero: ``exp_fused_convt bench``
    at its default shape, then one fused_synthesis_layer forward and
    backward on the largest real g_s layer."""
    import torch

    from nic_tpu_torch.ops import convt_igdn
    from nic_tpu_torch.tools import exp_fused_convt

    convt_igdn.launches = 0
    bench = exp_fused_convt.main(["bench"])
    layer = layers[-1]
    x = layer["x"].clone().requires_grad_(True)
    y = convt_igdn.fused_synthesis_layer(x, layer["w"], layer["bias"], layer["beta"],
                                         layer["gamma"])
    (dx,) = torch.autograd.grad(y.square().sum(), [x])
    torch.cuda.synchronize()
    launches = convt_igdn.launches
    log(f"K2 path: exp_fused_convt bench {bench['shape']}: composite "
        f"{bench['composite_ms']:.3f} ms/it, K2 {bench['k2_ms']:.3f} ms/it; "
        f"fused_synthesis_layer fwd+bwd; K2 launches {launches}")
    if launches < 1 or not bool(torch.isfinite(dx).all()):
        raise AssertionError(f"K2's path launched K2 {launches} times")
    return launches, dict(bench, k2_launches=launches)


def gdn_inputs(model, x):
    """(name, x, beta, gamma, inverse) at every GDN and IGDN of g_a and g_s,
    recorded by hooks during one forward of ``model`` on ``x``."""
    import torch

    from nic_tpu_torch.models.layers import GDN

    seen, hooks = [], []
    for name, m in model.named_modules():
        if isinstance(m, GDN):
            def hook(module, args, name=name):
                beta, gamma = module.effective_params()
                seen.append((name, args[0].to(module.dtype), beta, gamma, module.inverse))
            hooks.append(m.register_forward_pre_hook(hook))
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


def check_bf16_amortized(model_bf16_cpu):
    """The bf16 amortized eval on the card against nic_tpu's bf16 numbers,
    and K1's bf16 route against its plain version on the model's own GDN
    inputs. Returns the card's metrics and the largest error of K1 there."""
    import numpy as np
    import torch

    from nic_tpu_torch.infer.engine import LatentOptimizer
    from nic_tpu_torch.ops.gdn_cuda import gdn_kernel, gdn_reference

    x = np.load(PHOTOS).astype(np.float32) / 255.0
    card = LatentOptimizer(copy.deepcopy(model_bf16_cpu), "cuda")
    res = card.eval_amortized(x)
    bpp, psnr = float(res["est_bpp"].mean()), float(res["psnr"].mean())
    d_bpp = abs(bpp - JAX_BF16_AMORTIZED_BPP) / JAX_BF16_AMORTIZED_BPP
    d_psnr = abs(psnr - JAX_BF16_AMORTIZED_PSNR)
    log(f"amortized bf16 on the card: est bpp {bpp!r} (nic_tpu bf16 CPU "
        f"{JAX_BF16_AMORTIZED_BPP!r}, rel diff {d_bpp:.2e}, tolerance {BPP_RTOL:g}), PSNR "
        f"{psnr!r} dB (nic_tpu bf16 CPU {JAX_BF16_AMORTIZED_PSNR!r}, diff {d_psnr:.2e} dB, "
        f"tolerance {PSNR_ATOL_DB:g}), MS-SSIM {float(res['msssim'].mean())!r}")
    if not (d_bpp <= BPP_RTOL and d_psnr <= PSNR_ATOL_DB):
        raise AssertionError("bf16 amortized forward disagrees with nic_tpu")
    for k in ("est_bpp", "psnr", "mse", "msssim"):
        if not np.all(np.isfinite(res[k])):
            raise AssertionError(f"bf16 amortized {k} is not finite")

    errs = {}
    with torch.no_grad():
        for name, xg, beta, gamma, inverse in gdn_inputs(
                card.model, torch.from_numpy(x).to("cuda")):
            if xg.dtype != torch.bfloat16:
                raise AssertionError(f"{name} ran in {xg.dtype}, not bfloat16")
            out = gdn_kernel(xg, beta, gamma, inverse)
            ref = gdn_reference(xg, beta, gamma, inverse)
            torch.cuda.synchronize()
            errs[name] = (rel_err(out, ref), float((out.float() - ref.float()).abs().max()),
                          tuple(xg.shape))
    for name, (err, _, shape) in errs.items():
        log(f"K1 bf16 on the model's {name} {shape}: rel err {err:.3e} vs plain "
            f"(tolerance {K1_RTOL['bfloat16']:g})")
    if len(errs) != 6 or not all(e <= K1_RTOL["bfloat16"] for e, _, _ in errs.values()):
        raise AssertionError("K1's bf16 route disagrees with its plain version on the model")
    return res, max(a for _, a, _ in errs.values())


def run_bf16_sga(model_bf16_cpu, amortized_bf16, fp32_ms_step):
    """2000 SGA steps on the bf16 model, nic_tpu bench's route, with K1's
    launches counted from zero."""
    import numpy as np

    from nic_tpu_torch.infer.engine import LatentOptimizer
    from nic_tpu_torch.infer.methods import SGA
    from nic_tpu_torch.ops import gdn_cuda

    x = np.load(PHOTOS).astype(np.float32) / 255.0
    opt = LatentOptimizer(copy.deepcopy(model_bf16_cpu), "cuda")
    gdn_cuda.launches = 0
    res = opt.optimize(x, LMBDA, method=SGA.replace(iterations=SGA_ITS), seed=0)
    launches = gdn_cuda.launches
    steps, loop_ms = opt.last_timing["steps"], opt.last_timing["loop_ms"]
    ms_step = loop_ms / steps
    rd_opt = float(LMBDA * res["mse"].mean() + res["est_bpp"].mean())
    rd_base = float(LMBDA * amortized_bf16["mse"].mean() + amortized_bf16["est_bpp"].mean())
    log(f"bf16 sga: {steps} steps in {loop_ms:.1f} ms (CUDA events) = {ms_step:.3f} "
        f"ms/step, fp32 {fp32_ms_step:.3f} ms/step in this call; K1 launches {launches} "
        f"(>= {3 * SGA_ITS} required)")
    log(f"bf16 sga: est bpp {float(res['est_bpp'].mean())!r}, PSNR "
        f"{float(res['psnr'].mean())!r} dB, MS-SSIM {float(res['msssim'].mean())!r} "
        f"(nic_tpu's bf16 record {JAX_SGA_RECORD['est_bpp']} bpp, "
        f"{JAX_SGA_RECORD['psnr']} dB); rounded RD objective {rd_opt!r} vs bf16 "
        f"amortized {rd_base!r}")
    for k in ("est_bpp", "psnr", "mse", "msssim", "losses"):
        if not np.all(np.isfinite(res[k])):
            raise AssertionError(f"bf16 sga: {k} is not finite")
    if steps != SGA_ITS or launches < 3 * SGA_ITS:
        raise AssertionError(f"bf16 sga ran {steps} steps with {launches} K1 launches")
    if not rd_opt < rd_base:
        raise AssertionError("bf16 SGA did not lower the RD objective below amortized")
    return launches, dict(ms_per_step=ms_step, fp32_ms_per_step=fp32_ms_step, steps=steps,
                          k1_launches=launches, est_bpp=float(res["est_bpp"].mean()),
                          psnr=float(res["psnr"].mean()), rd_objective=rd_opt,
                          rd_objective_amortized=rd_base)


def run_methods(amortized, workdir):
    """map, ste, unoise and danneal compress through the CLI, at most
    METHOD_ITS steps, K1's launches counted from zero on each. unoise
    (quantized-z mean) and danneal write streams that decompress exactly;
    map names an output file and writes none."""
    import numpy as np

    from nic_tpu_torch.cli.main import main as cli_main
    from nic_tpu_torch.ops import gdn_cuda

    rd_base = float(LMBDA * amortized["mse"].mean() + amortized["est_bpp"].mean())
    paths = {}
    for script in METHODS:
        common = ["--num_filters", "192", "--checkpoint_dir", CKPT_DIR, script]
        stream = os.path.join(workdir, f"photos_{script}.ntc")
        argv = common + ["compress", RUN, PHOTOS, "--results_dir",
                         os.path.join(workdir, f"results_{script}"), "--sga_its",
                         str(METHOD_ITS)]
        if script != "ste":
            argv.insert(len(common) + 3, stream)
        gdn_cuda.launches = 0
        out = cli_main(argv)
        launches = gdn_cuda.launches
        res = out["results"]
        steps, loop_ms = out["steps"][0], out["loop_ms"][0]
        rd = float(LMBDA * res["mse"].mean() + res["est_bpp"].mean())
        log(f"{script} compress: {steps} steps in {loop_ms:.1f} ms = "
            f"{loop_ms / steps:.3f} ms/step; K1 launches {launches}; est bpp "
            f"{float(res['est_bpp'].mean())!r}, PSNR {float(res['psnr'].mean())!r} dB, "
            f"MS-SSIM {float(res['msssim'].mean())!r}; rounded RD objective {rd!r} vs "
            f"amortized {rd_base!r}")
        for k, v in res.items():
            if not np.all(np.isfinite(v)):
                raise AssertionError(f"{script} compress: {k} is not finite")
        if not 1 <= steps <= METHOD_ITS or launches < 3 * steps:
            raise AssertionError(f"{script} ran {steps} steps with {launches} K1 launches")
        path = dict(steps=steps, ms_per_step=loop_ms / steps, k1_launches=launches,
                    est_bpp=float(res["est_bpp"].mean()), psnr=float(res["psnr"].mean()),
                    msssim=float(res["msssim"].mean()), rd_objective=rd,
                    rd_objective_amortized=rd_base)
        if script == "map":
            if os.path.exists(stream) or "bytes" in out:
                raise AssertionError("map compress wrote a stream no decoder can invert")
            log("map compress: named an output file, wrote none (warned)")
        elif script in ("unoise", "danneal"):
            png = os.path.join(workdir, f"photos_{script}.png")
            gdn_cuda.launches = 0
            dec = cli_main(common + ["decompress", RUN, stream, png])
            check_exact(script, dec, png, out["pixels"])
            actual = out["bytes"] * 8 / (out["pixels"].size // 3)
            log(f"{script} decompress: exact; {out['bytes']} bytes = {actual!r} bpp actual; "
                f"K1 launches on decode {gdn_cuda.launches}")
            path.update(actual_bpp=actual, k1_launches_decode=gdn_cuda.launches)
        paths[script] = path
    return paths


def check_methods_card_vs_cpu(model_cpu):
    """The first METHOD_STEPS steps of each method on a 64x64 crop, on the
    card and on the port's CPU path (early stop off, so that every step's
    loss is kept; unoise fed the same uniform draws on both)."""
    import numpy as np
    import torch

    from nic_tpu_torch.infer.engine import LatentOptimizer
    from nic_tpu_torch.infer.methods import get_method

    x = np.load(PHOTOS)[:2, 100:164, 200:264].astype(np.float32) / 255.0
    card = LatentOptimizer(copy.deepcopy(model_cpu), "cuda")
    cpu = LatentOptimizer(model_cpu, "cpu")
    rng = np.random.default_rng(0)
    y0, z0 = cpu.amortized_init(x)
    draws = {(it, name): torch.from_numpy(rng.uniform(-0.5, 0.5, v.shape).astype(np.float32))
             for it in range(METHOD_STEPS) for name, v in (("y", y0), ("z", z0))}

    def noise_fn(step, name, shape):
        return draws[(step, name)]

    errs = {}
    for script in METHODS:
        spec = get_method(script).replace(iterations=METHOD_STEPS, early_stop=False)
        fn = noise_fn if script == "unoise" else None
        r_g = card.optimize(x, LMBDA, method=spec, seed=0, noise_fn=fn)
        r_c = cpu.optimize(x, LMBDA, method=spec, seed=0, noise_fn=fn)
        err = float(np.max(np.abs(r_g["losses"] - r_c["losses"]) / np.abs(r_c["losses"])))
        e_bpp = float(np.max(np.abs(r_g["est_bpp"] - r_c["est_bpp"]) / r_c["est_bpp"]))
        errs[script] = err
        log(f"{script}: first {METHOD_STEPS} steps on 64x64 crops, card vs CPU: loss rel "
            f"err {err:.2e} (tolerance {METHOD_LOSS_RTOL:g}), est bpp rel diff {e_bpp:.2e}")
        if not err <= METHOD_LOSS_RTOL:
            raise AssertionError(f"{script}: the card's steps disagree with the CPU's")
    return errs


def run_bits_back(workdir):
    """bb_plain, bb_sga and bb_no_sga compress of the photos to a BB-ANS
    stream and its decompress, through the CLI, K1's launches counted from
    zero on each path. The CLI exits non-zero when a decode does not return
    its initial bits."""
    import numpy as np

    from nic_tpu_torch.cli.main import main as cli_main
    from nic_tpu_torch.ops import gdn_cuda

    paths = {}
    for script in BB_SCRIPTS:
        common = ["--num_filters", "192", "--checkpoint_dir", CKPT_DIR, script]
        stream = os.path.join(workdir, f"photos_{script}.ntc")
        png = os.path.join(workdir, f"photos_{script}.png")
        t = time.perf_counter()
        gdn_cuda.launches = 0
        out = cli_main(common + ["compress", BB_RUN, PHOTOS, stream, "--results_dir",
                                 os.path.join(workdir, f"results_{script}"),
                                 "--sga_its", str(BB_SGA_RD_ITS)])
        encode_launches = gdn_cuda.launches
        gdn_cuda.launches = 0
        dec = cli_main(common + ["decompress", BB_RUN, stream, png])
        decode_launches = gdn_cuda.launches
        check_exact(script, dec, png, out["pixels"])
        res, timing, info = out["results"], out["timing"][0], out["info"]
        for k, v in res.items():
            if not np.all(np.isfinite(v)):
                raise AssertionError(f"{script} compress: {k} is not finite")
        rd_ms = timing["rd_ms"] / max(timing["rd_steps"], 1)
        rate_ms = timing["rate_ms"] / max(timing["rate_steps"], 1)
        est = float(res["est_bpp"].mean())
        path = dict(
            rd_steps=timing["rd_steps"], rd_ms_per_step=rd_ms,
            rate_steps=timing["rate_steps"], rate_ms_per_step=rate_ms,
            est_bpp=est, est_y_bpp=float(res["est_y_bpp"].mean()),
            est_z_bpp=float(res["est_z_bpp"].mean()),
            est_bpp_back=float(res["est_bpp_back"].mean()),
            actual_bpp=info["actual_bpp"], net_bpp=info["net_bpp"],
            delta_bpp=info.get("delta_bpp"), bytes=out["bytes"],
            init_bytes=info["init_bytes"], psnr=float(res["psnr"].mean()),
            msssim=float(res["msssim"].mean()),
            rd_objective=float(LMBDA * res["mse"].mean() + est),
            k1_launches=encode_launches, k1_launches_decode=decode_launches,
            encode_ms=out["codec_timing"], decode_ms=dec["timing"],
            seconds=time.perf_counter() - t)
        log(f"{script} compress: {timing['rd_steps']} RD steps at {rd_ms:.3f} ms/step, "
            f"{timing['rate_steps']} rate steps at {rate_ms:.3f} ms/step (CUDA events); "
            f"est net bpp {est!r} (y {path['est_y_bpp']!r}, z {path['est_z_bpp']!r}, "
            f"back {path['est_bpp_back']!r}), PSNR {path['psnr']!r} dB, MS-SSIM "
            f"{path['msssim']!r}; rounded RD objective {path['rd_objective']!r}")
        log(f"{script} stream: {out['bytes']} bytes = actual {info['actual_bpp']!r} bpp, "
            f"net {info['net_bpp']!r} bpp, initial bits {info['init_bytes']} bytes"
            + (f", posterior deltas {info['delta_bpp']!r} bpp" if "delta_bpp" in info
               else "")
            + f"; decompress exact, initial bits recovered")
        log(f"{script}: codec ms encode {fmt_timing(out['codec_timing'])}; decode "
            f"{fmt_timing(dec['timing'])}; K1 launches encode path {encode_launches}, "
            f"decode path {decode_launches}; {path['seconds']:.1f} s")
        steps = timing["rd_steps"] + timing["rate_steps"]
        if encode_launches < 3 * timing["rd_steps"] + 6 or decode_launches < 9:
            raise AssertionError(f"{script}: K1 launched {encode_launches} times encoding "
                                 f"({steps} steps), {decode_launches} decoding")
        paths[script] = path

    plain = paths["bb_plain"]
    d_psnr = abs(plain["psnr"] - JAX_BB_PLAIN["psnr"])
    log(f"bb_plain against nic_tpu's CPU run (seed 0): PSNR {plain['psnr']!r} vs "
        f"{JAX_BB_PLAIN['psnr']!r} dB (diff {d_psnr:.2e}, tolerance {PSNR_ATOL_DB:g}); "
        f"one sample each: est net bpp {plain['est_bpp']!r} vs {JAX_BB_PLAIN['est_bpp']!r}, "
        f"actual bpp {plain['actual_bpp']!r} vs {JAX_BB_PLAIN['actual_bpp']!r}")
    if d_psnr > PSNR_ATOL_DB:
        raise AssertionError("bb_plain PSNR disagrees with nic_tpu's")
    if not paths["bb_sga"]["rd_objective"] < plain["rd_objective"]:
        raise AssertionError("bb_sga did not lower the RD objective below bb_plain's")
    if not paths["bb_no_sga"]["est_bpp"] < plain["est_bpp"]:
        raise AssertionError("bb_no_sga did not lower the est. net bpp below bb_plain's")
    log(f"bb_sga RD objective {paths['bb_sga']['rd_objective']!r} < bb_plain's "
        f"{plain['rd_objective']!r}; bb_no_sga est net bpp "
        f"{paths['bb_no_sga']['est_bpp']!r} < bb_plain's {plain['est_bpp']!r} (same y*; "
        f"nic_tpu's bb_no_sga on the CPU {JAX_BB_NO_SGA_EST!r})")
    plain.update(check_bb_plain_means())
    return paths


def check_bb_plain_means():
    """bb_plain on the card: the est. net bpp over BB_EST_SEEDS evaluation
    samples and the stream's actual bpp over BB_STREAM_SEEDS seeds, against
    nic_tpu's means; and, fed one fixed evaluation draw, the card against the
    port's CPU path on the full photos."""
    import numpy as np
    import torch

    from nic_tpu_torch.checkpoint import load_model
    from nic_tpu_torch.coding.bb_codec import BitsBackCodec
    from nic_tpu_torch.infer.bb import BB_PLAIN, BBLatentOptimizer

    x = np.load(PHOTOS).astype(np.float32) / 255.0
    _, model = load_model(CKPT_DIR, BB_RUN, 192, "cuda", model="mbt2018_bb")
    opt = BBLatentOptimizer(model, "cuda")
    t = time.perf_counter()
    est = [float(opt.optimize(x, LMBDA, BB_PLAIN, seed=s)["est_bpp"].mean())
           for s in range(BB_EST_SEEDS)]
    est_secs = time.perf_counter() - t
    codec = BitsBackCodec(model, "cuda")
    actual = []
    for s in range(BB_STREAM_SEEDS):
        blob, info = codec.compress(x, seed=s)
        actual.append(info["actual_bpp"])
    init_ok = codec.decompress(blob)[1]
    est_mean, actual_mean = float(np.mean(est)), float(np.mean(actual))
    d_est = (est_mean - JAX_BB_PLAIN_EST_MEAN) / JAX_BB_PLAIN_EST_MEAN
    d_act = abs(actual_mean - JAX_BB_PLAIN_ACTUAL_MEAN) / JAX_BB_PLAIN_ACTUAL_MEAN
    est_se = float(np.std(est) / np.sqrt(BB_EST_SEEDS))
    log(f"bb_plain over seeds on the card: est net bpp mean of {BB_EST_SEEDS} "
        f"{est_mean!r} (sd {np.std(est):.2e}, standard error {est_se:.2e}; {est_secs:.1f} s) "
        f"vs nic_tpu's {JAX_BB_PLAIN_EST_MEAN!r} (rel diff {d_est:+.2e} = "
        f"{d_est * JAX_BB_PLAIN_EST_MEAN / est_se:+.2f} standard errors, tolerance "
        f"{BPP_RTOL:g}); actual bpp mean of "
        f"{BB_STREAM_SEEDS} streams {actual_mean!r} (sd {np.std(actual):.2e}, min "
        f"{min(actual)!r}, max {max(actual)!r}) vs nic_tpu's {JAX_BB_PLAIN_ACTUAL_MEAN!r} "
        f"(rel diff {d_act:.2e}, tolerance {BB_ACTUAL_MEAN_RTOL:g})")
    if not init_ok:
        raise AssertionError("bb_plain: the last seed's stream did not return its bits")
    if abs(d_est) > BPP_RTOL or d_act > BB_ACTUAL_MEAN_RTOL:
        raise AssertionError("bb_plain's est. or actual bpp disagrees with nic_tpu's")

    # One evaluation draw fed to both: what is left is the forward's arithmetic.
    eps = {}

    def noise_fn(step, name, shape):
        if shape not in eps:
            eps[shape] = torch.from_numpy(
                np.random.default_rng(0).standard_normal(shape).astype(np.float32))
        return eps[shape]

    cpu = BBLatentOptimizer(load_model(CKPT_DIR, BB_RUN, 192, "cpu", model="mbt2018_bb")[1],
                            "cpu")
    r_g = opt.optimize(x, LMBDA, BB_PLAIN, seed=0, noise_fn=noise_fn)
    r_c = cpu.optimize(x, LMBDA, BB_PLAIN, seed=0, noise_fn=noise_fn)
    errs = {k: float(np.max(np.abs(r_g[k] - r_c[k]) / np.abs(r_c[k])))
            for k in ("est_bpp", "est_y_bpp", "est_z_bpp", "est_bpp_back")}
    y_flips = int(np.sum(r_g["y"] != r_c["y"]))
    e_post = max(float(np.abs(r_g[k] - r_c[k]).max() / np.abs(r_c[k]).max())
                 for k in ("z_mean", "z_logvar"))
    log(f"bb_plain on the full photos fed one eps, card vs CPU: est net bpp rel err "
        f"{errs['est_bpp']:.2e} (tolerance {BB_EPS_RTOL:g}; card {r_g['est_bpp'].tolist()}, "
        f"CPU {r_c['est_bpp'].tolist()}); y {errs['est_y_bpp']:.2e}, z {errs['est_z_bpp']:.2e}, "
        f"bits back {errs['est_bpp_back']:.2e}; y* differs in {y_flips} of {r_c['y'].size}; "
        f"posterior rel err {e_post:.2e}; PSNR diff "
        f"{float(np.abs(r_g['psnr'] - r_c['psnr']).max()):.2e} dB")
    if not errs["est_bpp"] <= BB_EPS_RTOL:
        raise AssertionError("bb_plain fed the same eps: the card disagrees with the CPU")
    return dict(est_bpp_mean=est_mean, est_bpp_sd=float(np.std(est)),
                est_bpp_seeds=BB_EST_SEEDS, est_bpp_rel_diff=d_est,
                actual_bpp_mean=actual_mean, actual_bpp_sd=float(np.std(actual)),
                stream_seeds=BB_STREAM_SEEDS, eps_fed_card_vs_cpu_rel_err=errs,
                eps_fed_y_star_flips=y_flips)


def check_bb_card_vs_cpu():
    """The first BB_STEPS steps of each bits-back phase on a 64x64 crop, on
    the card and on the port's CPU path, fed the same draws."""
    import numpy as np
    import torch

    from nic_tpu_torch.checkpoint import load_model
    from nic_tpu_torch.infer.bb import BB_SGA, BBLatentOptimizer

    x = np.load(PHOTOS)[:2, 100:164, 200:264].astype(np.float32) / 255.0
    card = BBLatentOptimizer(load_model(CKPT_DIR, BB_RUN, 192, "cpu",
                                        model="mbt2018_bb")[1], "cuda")
    cpu = BBLatentOptimizer(load_model(CKPT_DIR, BB_RUN, 192, "cpu",
                                       model="mbt2018_bb")[1], "cpu")
    rng = np.random.default_rng(0)
    draws = {}

    def noise_fn(step, name, shape):
        if (step, name) not in draws:
            a = rng.gumbel(size=shape) if name == "gumbel" else rng.standard_normal(shape)
            draws[(step, name)] = torch.from_numpy(a.astype(np.float32))
        return draws[(step, name)]

    spec = BB_SGA.replace(rd_iterations=BB_STEPS, rate_iterations=BB_STEPS)
    r_c = cpu.optimize(x, LMBDA, spec, seed=0, noise_fn=noise_fn)
    r_g = card.optimize(x, LMBDA, spec, seed=0, noise_fn=noise_fn)
    errs = {}
    for k in ("rd_losses", "rate_losses"):
        errs[k] = float(np.max(np.abs(r_g[k] - r_c[k]) / np.abs(r_c[k])))
    e_bpp = float(np.max(np.abs(r_g["est_bpp"] - r_c["est_bpp"]) / r_c["est_bpp"]))
    log(f"bits-back: first {BB_STEPS} steps of each phase on 64x64 crops, card vs CPU: "
        f"phase 1 loss rel err {errs['rd_losses']:.2e}, phase 2 {errs['rate_losses']:.2e} "
        f"(tolerance {METHOD_LOSS_RTOL:g}); est net bpp rel diff {e_bpp:.2e}; y* "
        f"{'equal' if np.array_equal(r_g['y'], r_c['y']) else 'differs'}")
    if not max(errs.values()) <= METHOD_LOSS_RTOL:
        raise AssertionError("bits-back: the card's steps disagree with the CPU's")
    return errs


def l2_rel(a, b):
    """||a - b|| / ||b||, L2 over every element."""
    import torch

    a, b = a.detach().double(), b.detach().double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def check_k1_train():
    """(a) On the card, at the training step's three shapes, GDN and IGDN,
    fp32: K1's forward against gdn_reference (max-norm relative, as
    check_k1), and its backward, gdn_backward's dx, dgamma and dbeta (torch
    matmuls on the saved inputs, as nic_tpu's XLA ``_gdn_bwd``), against
    autograd through gdn_reference (L2 relative); then both through a fresh
    GDN layer, whose gamma's off-diagonals sit exactly at their bound.
    Returns (the errors, the largest forward error, absolute)."""
    import torch

    from nic_tpu_torch.models.layers import GDN
    from nic_tpu_torch.ops.gdn_cuda import gdn_kernel, gdn_reference

    gen = torch.Generator(device="cuda").manual_seed(12)
    errs, max_abs = {}, 0.0
    fwd_tol = K1_RTOL["float32"]
    for rows in sorted(TRAIN_ROWS, reverse=True):
        x, beta, gamma = k1_inputs(rows, gen)
        w = torch.randn(rows, CHANNELS, device="cuda", generator=gen)
        for inverse in (False, True):
            args = [t.clone().requires_grad_(True) for t in (x, beta, gamma)]
            ref_args = [t.clone().requires_grad_(True) for t in (x, beta, gamma)]
            out = gdn_kernel(*args, inverse)
            ref = gdn_reference(*ref_args, inverse)
            grads = torch.autograd.grad(torch.sum(out * w), args)
            refs = torch.autograd.grad(torch.sum(ref * w), ref_args)
            e = {n: l2_rel(g, r) for n, g, r in zip(("dx", "dbeta", "dgamma"), grads, refs)}
            e["forward"] = rel_err(out, ref)
            max_abs = max(max_abs, float((out - ref).detach().abs().max()))
            name = f"{'IGDN' if inverse else 'GDN'} M={rows}"
            errs[name] = e
            log(f"K1 training {name} C={CHANNELS} float32: forward rel err {e['forward']:.2e} "
                f"(max-norm; tolerance {fwd_tol:g}); gdn_backward dx {e['dx']:.2e}, dbeta "
                f"{e['dbeta']:.2e}, dgamma {e['dgamma']:.2e} (L2 relative; tolerance "
                f"{K1_VJP_RTOL:g})")
            if not e["forward"] <= fwd_tol:
                raise AssertionError(f"K1's forward disagrees with its plain version at {name}")
            if not max(e["dx"], e["dbeta"], e["dgamma"]) <= K1_VJP_RTOL:
                raise AssertionError(f"gdn_backward disagrees with autograd at {name}")
    for inverse in (False, True):
        layer = GDN(CHANNELS, inverse=inverse).to("cuda")
        ref_layer = copy.deepcopy(layer)
        # x and w are the last rows' (M = TRAIN_ROWS' smallest).
        out = layer(x)
        torch.sum(out * w).backward()
        ref_beta, ref_gamma = ref_layer.effective_params()
        ref = gdn_reference(x, ref_beta, ref_gamma, inverse)
        torch.sum(ref * w).backward()
        off = ~torch.eye(CHANNELS, dtype=torch.bool, device="cuda")
        at_bound = bool(torch.all(layer.gamma.detach()[off] == 2.0 ** -18))
        nonzero = int(torch.count_nonzero(layer.gamma.grad[off]))
        e = dict(forward=rel_err(out, ref),
                 beta=l2_rel(layer.beta.grad, ref_layer.beta.grad),
                 gamma=l2_rel(layer.gamma.grad, ref_layer.gamma.grad))
        max_abs = max(max_abs, float((out - ref).detach().abs().max()))
        name = f"fresh {'IGDN' if inverse else 'GDN'} layer M={x.shape[0]}"
        errs[name] = e
        log(f"K1 through {name}: forward rel err {e['forward']:.2e} (tolerance {fwd_tol:g}); "
            f"raw beta grad {e['beta']:.2e}, raw gamma grad {e['gamma']:.2e} (L2 relative; "
            f"tolerance {K1_VJP_RTOL:g}); gamma's off-diagonals at the bound 2^-18: "
            f"{at_bound}, {nonzero} of {CHANNELS * (CHANNELS - 1)} with a nonzero gradient")
        if not (e["forward"] <= fwd_tol and max(e["beta"], e["gamma"]) <= K1_VJP_RTOL
                and at_bound and nonzero > 0):
            raise AssertionError(f"K1 or its parameter gradients disagree through {name}")
    return errs, max_abs


def train_argv(script, ckpt_dir, photos_glob, last_step, *extra):
    return ["--num_filters", "192", "--checkpoint_dir", ckpt_dir, script, "train",
            "--train_glob", photos_glob, "--batchsize", "8", "--patchsize", "256",
            "--lambda", str(LMBDA), "--steps_per_call", "1", "--last_step", str(last_step),
            *extra]


def run_train_cli(script, ckpt_dir, photos_glob, last_step, *extra):
    """``<script> train`` in-process, K1's launches counted from zero;
    returns (trainer, launches, ms per step, seconds)."""
    import numpy as np

    from nic_tpu_torch.cli.main import main as cli_main
    from nic_tpu_torch.ops import gdn_cuda

    t = time.perf_counter()
    gdn_cuda.launches = 0
    trainer = cli_main(train_argv(script, ckpt_dir, photos_glob, last_step, *extra))
    launches = gdn_cuda.launches
    timing = trainer.last_timing
    ms = timing["loop_ms"] / max(timing["timed_steps"], 1)
    if not np.all(np.isfinite(trainer.losses)) or len(trainer.losses) != timing["steps"]:
        raise AssertionError(f"{script} train: {len(trainer.losses)} losses for "
                             f"{timing['steps']} steps, or one not finite")
    if launches != 6 * timing["steps"]:
        raise AssertionError(f"{script} train: K1 launched {launches} times in "
                             f"{timing['steps']} steps (6 per step expected)")
    return trainer, launches, ms, time.perf_counter() - t


def run_training(workdir, photos_glob):
    """(c) mbt2018 train from a fresh init, (d) its resume."""
    import json as _json

    import numpy as np

    ckpt_dir = os.path.join(workdir, "train_ckpt")
    trainer, launches, ms, secs = run_train_cli("mbt2018", ckpt_dir, photos_glob, TRAIN_STEPS)
    losses = np.asarray(trainer.losses)
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    files = sorted(os.listdir(trainer.save_dir))
    with open(os.path.join(trainer.save_dir, "metrics.jsonl")) as f:
        logged = [_json.loads(line) for line in f]
    log(f"mbt2018 train (nf=192, batch 8, patch 256, lambda {LMBDA}, fp32) from a fresh "
        f"init: {trainer.last_timing['steps']} steps, {ms:.3f} ms/step over the last "
        f"{trainer.last_timing['timed_steps']} (CUDA events) = {8e3 / ms:.1f} images/s; "
        f"K1 launches {launches} (6 per step, no summaries' forwards); loss mean of the "
        f"first 20 steps {first!r}, of the last 20 {last!r}; logged steps "
        f"{[r['step'] for r in logged]}, losses {[r['loss'] for r in logged]}; "
        f"{secs:.1f} s; files {files}")
    expected = {"args.json", "record.txt", "metrics.jsonl", f"params-{TRAIN_STEPS}.npz",
                f"ckpt-{TRAIN_STEPS}.pt"}
    if not expected <= set(files):
        raise AssertionError(f"mbt2018 train wrote {files}")
    if trainer.step != TRAIN_STEPS or not last < first:
        raise AssertionError(f"mbt2018 train reached step {trainer.step}; losses did not "
                             f"fall ({first} -> {last})")
    if not all(np.isfinite(r["loss"]) for r in logged):
        raise AssertionError("mbt2018 train logged a loss that is not finite")

    resumed, r_launches, r_ms, _ = run_train_cli("mbt2018", ckpt_dir, photos_glob,
                                                 TRAIN_RESUME_STEP)
    files = sorted(os.listdir(resumed.save_dir))
    log(f"mbt2018 train resumed: {resumed.last_timing['steps']} steps to step "
        f"{resumed.step}, K1 launches {r_launches}, {r_ms:.3f} ms/step; files {files}")
    if (resumed.step != TRAIN_RESUME_STEP
            or resumed.last_timing["steps"] != TRAIN_RESUME_STEP - TRAIN_STEPS
            or f"params-{TRAIN_RESUME_STEP}.npz" not in files):
        raise AssertionError("the resume did not restart at step "
                             f"{TRAIN_STEPS} and end at {TRAIN_RESUME_STEP}")
    return dict(steps=TRAIN_STEPS, ms_per_step=ms, images_per_s=8e3 / ms,
                timed_steps=trainer.last_timing["timed_steps"], k1_launches=launches,
                loss_first_20=first, loss_last_20=last, logged=logged,
                resume_steps=resumed.last_timing["steps"], resume_ms_per_step=r_ms,
                resume_k1_launches=r_launches, seconds=secs)


def check_train_card_vs_cpu(model, donor, workdir):
    """TRAIN_CMP_STEPS steps at batch 2, patch 128 from ``donor``, the card
    against the port's CPU path on the same batches and noise: the first
    step's gradients before Adam, each step's loss, the parameters after."""
    import numpy as np
    import torch

    from nic_tpu_torch.train.trainer import TrainConfig, Trainer, is_aux_param

    rng = np.random.default_rng(12)
    photos = np.load(PHOTOS)
    n, h, w, _ = photos.shape
    batches, noises = [], []
    for _ in range(TRAIN_CMP_STEPS):
        crops = []
        for _ in range(2):
            i, y, x = rng.integers(n), rng.integers(h - 127), rng.integers(w - 127)
            crops.append(photos[i, y:y + 128, x:x + 128])
        batches.append(np.stack(crops))
        z_shape, y_shape = (2, 2, 2, CHANNELS), (2, 8, 8, CHANNELS)
        first = (rng.uniform(-0.5, 0.5, z_shape) if model == "mbt2018"
                 else rng.standard_normal(z_shape))
        noises.append(tuple(torch.from_numpy(a.astype(np.float32))
                            for a in (first, rng.uniform(-0.5, 0.5, y_shape))))
    runs, kink = {}, None
    for device in ("cuda", "cpu"):
        cfg = TrainConfig(model=model, num_filters=CHANNELS, batchsize=2, patchsize=128,
                          init_from=donor, checkpoint_dir=os.path.join(workdir, f"cmp_{device}"))
        trainer = Trainer(cfg, device=device)
        trainer.restore_or_init()
        if model == "mbt2018" and device == "cpu":
            prior = trainer.model.entropy_bottleneck
            with torch.no_grad():
                logits = prior._logits_cdf(prior.quantiles, stop_gradient=True)
            kink = (torch.abs(logits - prior.quantile_targets) <= QUANTILE_KINK).numpy()
            if np.count_nonzero(kink) > 0.05 * kink.size:
                raise AssertionError(f"{np.count_nonzero(kink)} quantiles at the loss's kink")
        # The first step's gradients, before any update.
        x = torch.from_numpy(batches[0]).to(trainer.device).float() / 255.0
        loss, _ = trainer.loss(x, tuple(t.to(trainer.device) for t in noises[0]))
        loss.backward()
        grads = {k: None if p.grad is None else p.grad.detach().cpu().double()
                 for k, p in trainer.model.named_parameters()}
        trainer.optimizer.zero_grad(set_to_none=True)
        losses = [float(trainer.run_steps(b, n)["loss"]) for b, n in zip(batches, noises)]
        runs[device] = (np.asarray(losses), grads, trainer.params_to_jax(), trainer.cfg)
    (l_g, g_g, p_g, cfg), (l_c, g_c, p_c, _) = runs["cuda"], runs["cpu"]
    loss_err = np.abs(l_g - l_c) / np.abs(l_c)
    grad_errs = {}
    for k, want in g_c.items():
        got = g_g[k]
        if want is None or got is None:
            grad_errs[k] = 0.0 if want is None and got is None else float("inf")
            continue
        if kink is not None and is_aux_param(k):
            want, got = want[~torch.from_numpy(kink)], got[~torch.from_numpy(kink)]
        norm = float(torch.linalg.vector_norm(want))
        diff = float(torch.linalg.vector_norm(got - want))
        grad_errs[k] = diff / norm if norm > 0 else (0.0 if diff == 0 else float("inf"))
    worst_grad = max(grad_errs, key=grad_errs.get)
    param_lrs, param_mean_lrs = {}, {}
    for k in p_c:
        lr = cfg.aux_lr if model == "mbt2018" and k.endswith("quantiles") else cfg.main_lr
        diff = np.abs(p_g[k] - p_c[k])
        param_lrs[k] = float(diff.max() / lr)
        held = diff[~kink] if kink is not None and k.endswith("quantiles") else diff
        param_mean_lrs[k] = float(held.mean() / lr)
    worst = max(param_lrs, key=param_lrs.get)
    worst_mean = max(param_mean_lrs, key=param_mean_lrs.get)
    log(f"{model}: {TRAIN_CMP_STEPS} training steps at batch 2, patch 128 from {donor}, card vs "
        f"CPU: first step's gradients ({0 if kink is None else np.count_nonzero(kink)} "
        f"quantiles at the loss's kink left out), largest L2 rel err over {len(grad_errs)} leaves "
        f"{grad_errs[worst_grad]:.2e} ({worst_grad}; tolerance {TRAIN_GRAD_RTOL:g}), median "
        f"{float(np.median(list(grad_errs.values()))):.2e}; loss rel err per step "
        f"{[float(e) for e in loss_err]} (tolerance {TRAIN_LOSS_RTOL:g}); parameters' largest "
        f"difference {param_lrs[worst]:.3f} lr ({worst}; tolerance {TRAIN_PARAM_LRS} lr), "
        f"largest mean over a leaf {param_mean_lrs[worst_mean]:.2e} lr ({worst_mean}; "
        f"tolerance {TRAIN_PARAM_MEAN_LRS:g} lr)")
    if not (grad_errs[worst_grad] <= TRAIN_GRAD_RTOL and loss_err.max() <= TRAIN_LOSS_RTOL
            and param_lrs[worst] <= TRAIN_PARAM_LRS
            and param_mean_lrs[worst_mean] <= TRAIN_PARAM_MEAN_LRS):
        raise AssertionError(f"{model} training: the card disagrees with the CPU")
    return dict(grad_l2_rel_err_max=grad_errs[worst_grad], grad_worst_leaf=worst_grad,
                quantiles_at_kink=0 if kink is None else int(np.count_nonzero(kink)),
                loss_rel_err=[float(e) for e in loss_err], param_max_diff_lr=param_lrs[worst],
                param_max_diff_leaf=worst, param_mean_diff_lr_max=param_mean_lrs[worst_mean],
                param_mean_diff_leaf=worst_mean)


def rd_after_broken_steps(workdir, photos_glob, x, name, hook):
    """A broken trainer: (f)'s TRAIN_FT_STEPS steps from the lambda=0.01
    checkpoint on the photos, each gradient passed through ``hook``; then the
    photos' rounded RD objective (as phase 4 reads the checkpoint's)."""
    from nic_tpu_torch.infer.engine import LatentOptimizer
    from nic_tpu_torch.train.data import DeviceDataset
    from nic_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(num_filters=CHANNELS, lmbda=LMBDA, batchsize=8, patchsize=256,
                      init_from=os.path.join(CKPT_DIR, RUN),
                      checkpoint_dir=os.path.join(workdir, f"broken_{name}"))
    trainer = Trainer(cfg, device="cuda")
    trainer.restore_or_init()
    for param in trainer.model.parameters():
        param.register_hook(hook)
    data = DeviceDataset(photos_glob, cfg.batchsize, cfg.patchsize, seed=0, device="cuda")
    for _ in range(TRAIN_FT_STEPS):
        trainer.run_steps(data.sample(1)[0])
    res = LatentOptimizer(trainer.model, "cuda").eval_amortized(x)
    return float(LMBDA * res["mse"].mean() + res["est_bpp"].mean())


def run_trained_serving(workdir, photos_glob, amortized, mbt2018_path):
    """(f) 20 steps from the lambda=0.01 checkpoint, then mbt2018 compress ->
    decompress of the photos from the new run; its RD objective against the
    checkpoint's and against two broken trainers' (zeroed and negated
    gradients)."""
    import numpy as np
    import torch

    from nic_tpu_torch.cli.main import main as cli_main
    from nic_tpu_torch.ops import gdn_cuda

    ckpt_dir = os.path.join(workdir, "serve_ckpt")
    trainer, launches, ms, _ = run_train_cli(
        "mbt2018", ckpt_dir, photos_glob, TRAIN_FT_STEPS, "--init_from",
        os.path.join(CKPT_DIR, RUN))
    common = ["--num_filters", "192", "--checkpoint_dir", ckpt_dir, "mbt2018"]
    stream = os.path.join(workdir, "photos_trained.ntc")
    png = os.path.join(workdir, "photos_trained.png")
    out = cli_main(common + ["compress", RUN, PHOTOS, stream, "--results_dir",
                             os.path.join(workdir, "results_trained")])
    gdn_cuda.launches = 0
    dec = cli_main(common + ["decompress", RUN, stream, png])
    check_exact("mbt2018 (trained)", dec, png, out["pixels"])
    res = out["results"]
    actual, psnr = float(res["avg_batch_actual_bpp"]), float(res["psnr"].mean())
    rd = float(LMBDA * res["mse"].mean() + res["est_bpp"].mean())
    rd_ckpt = float(LMBDA * amortized["mse"].mean() + amortized["est_bpp"].mean())
    d_rd = (rd - rd_ckpt) / rd_ckpt

    def passes(rd_rel_change):
        return bool(np.isfinite(rd_rel_change) and rd_rel_change <= -SERVE_RD_FALL)

    x = np.load(PHOTOS).astype(np.float32) / 255.0
    broken = {name: rd_after_broken_steps(workdir, photos_glob, x, name, hook)
              for name, hook in (("zeroed", torch.zeros_like), ("negated", torch.neg))}
    d_broken = {name: (v - rd_ckpt) / rd_ckpt for name, v in broken.items()}
    log(f"served the run trained {TRAIN_FT_STEPS} steps from {RUN} ({ms:.3f} ms/step, K1 "
        f"launches {launches}): mbt2018 compress -> decompress exact; actual {actual!r} bpp "
        f"({out['bytes']} bytes), PSNR {psnr!r} dB, beside phase 7's {mbt2018_path['actual_bpp']!r} "
        f"bpp and phase 4's {float(amortized['psnr'].mean())!r} dB; rounded RD objective "
        f"{rd!r} vs the checkpoint's {rd_ckpt!r} (rel change {d_rd:+.4e}; the gate: finite "
        f"and at most {-SERVE_RD_FALL:+g}); the same steps with zeroed gradients "
        f"{broken['zeroed']!r} ({d_broken['zeroed']:+.4e}), negated {broken['negated']!r} "
        f"({d_broken['negated']:+.4e}), each failing the gate")
    if not passes(d_rd):
        raise AssertionError("the trained run's RD objective did not fall")
    if any(passes(d) for d in d_broken.values()):
        raise AssertionError("a broken trainer passes the RD gate: it does not discriminate")
    return dict(steps=TRAIN_FT_STEPS, ms_per_step=ms, k1_launches=launches, actual_bpp=actual,
                psnr=psnr, rd_objective=rd, rd_objective_checkpoint=rd_ckpt,
                rd_rel_change=d_rd,
                # A diverged broken run's NaN is written as null (strict JSON).
                rd_rel_change_broken={k: float(v) if np.isfinite(v) else None
                                      for k, v in d_broken.items()})


def run_bb_training(workdir, photos_glob):
    """(g) mbt2018_bb train from the bits-back checkpoint."""
    import numpy as np

    trainer, launches, ms, secs = run_train_cli(
        "mbt2018_bb", os.path.join(workdir, "bb_ckpt"), photos_glob, TRAIN_FT_STEPS,
        "--init_from", os.path.join(CKPT_DIR, BB_RUN))
    losses = np.asarray(trainer.losses)
    log(f"mbt2018_bb train (nf=192, batch 8, patch 256) from {BB_RUN}: "
        f"{trainer.last_timing['steps']} steps, {ms:.3f} ms/step over the last "
        f"{trainer.last_timing['timed_steps']} = {8e3 / ms:.1f} images/s; K1 launches "
        f"{launches}; losses first {float(losses[0])!r}, last {float(losses[-1])!r} (all "
        f"finite); {secs:.1f} s")
    return dict(steps=TRAIN_FT_STEPS, ms_per_step=ms, images_per_s=8e3 / ms,
                k1_launches=launches, loss_first=float(losses[0]), loss_last=float(losses[-1]))


def run_learned_prior(model_cpu, workdir):
    """(h) learned_prior on the card on the photos' amortized y."""
    import numpy as np
    import torch

    from nic_tpu_torch.cli.main import main as cli_main

    model = copy.deepcopy(model_cpu).to("cuda")
    x = torch.from_numpy(np.load(PHOTOS).astype(np.float32) / 255.0).to("cuda")
    with torch.no_grad():
        y = model.analyze(x).reshape(-1, CHANNELS).cpu().numpy()
    data = os.path.join(workdir, "photos_y.npy")
    np.save(data, y)
    t = time.perf_counter()
    save_dir = cli_main(["learned_prior", "--num_channels", str(CHANNELS), "--data_path", data,
                         "--its", str(PRIOR_ITS), "--tol", "0", "--logging_freq", "10",
                         "--checkpoint_dir", os.path.join(workdir, "prior")])
    secs = time.perf_counter() - t
    with open(os.path.join(save_dir, "record.json")) as f:
        record = json.load(f)
    losses = [r["loss"] for r in record]
    log(f"learned_prior on the card: {PRIOR_ITS} iterations on y of shape {y.shape} in "
        f"{secs:.2f} s; loss {losses[0]!r} -> {losses[-1]!r} (every 10: {losses}); "
        f"wrote {sorted(os.listdir(save_dir))}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]
            and os.path.exists(os.path.join(save_dir, "prior_model.npz"))):
        raise AssertionError("learned_prior's loss did not fall")
    return dict(its=PRIOR_ITS, samples=int(y.shape[0]), loss_first=losses[0],
                loss_last=losses[-1], seconds=secs)


def deterministic(on):
    """cuDNN's deterministic algorithms on or off. Its default
    transposed-conv and weight-gradient algorithms add with atomics, so two
    runs of the same step differ in the last bits; the
    sharded-against-unsharded gates run both sides with it on."""
    import torch

    torch.backends.cudnn.deterministic = on


class CardNoise:
    """noise_fn(step, name, shape) of sga's Gumbel draws made on the card by
    a generator seeded from (seed, step, name): every rank draws the same
    global tensor as the unsharded run. It pickles, so spawned ranks take it."""

    def __init__(self, seed):
        self.seed = seed

    def __call__(self, step, name, shape):
        import numpy as np
        import torch

        from nic_tpu_torch.ops.quantize import draw_gumbel

        key = np.random.SeedSequence([self.seed, step, ("y", "z").index(name)])
        gen = torch.Generator(device="cuda").manual_seed(int(key.generate_state(1)[0]))
        return draw_gumbel(shape, gen, "cuda")


def first_temperature():
    from nic_tpu_torch.infer.methods import SGA
    from nic_tpu_torch.ops.schedules import annealed_temperature

    return annealed_temperature(0, r=SGA.annealing_rate, ub=SGA.temperature_ub,
                                scheme=SGA.annealing_scheme, t0=SGA.t0)


def dp_first_step(opt, x, seed):
    """SGA's first step under CardNoise(seed) on a LatentOptimizer's ranks
    (each its images; one rank: the unsharded run): the global RD objective
    and its gradients in y and z, gathered whole."""
    import torch

    from nic_tpu_torch.infer.engine import Latents, _amortized_init, _rd_loss

    comm, batch = opt.comm, x.shape[0]
    lo, hi = comm.shard(batch)
    x_local = opt._tensor(x)[lo:hi]
    y, z = (v.clone().requires_grad_(True) for v in _amortized_init(opt.model, x_local))
    noise = Latents(*(CardNoise(seed)(0, name, (batch,) + tuple(v.shape[1:]) + (2,))[lo:hi]
                      for name, v in (("y", y), ("z", z))))
    loss, _ = _rd_loss(opt.model, Latents(y, z), x_local, LMBDA, first_temperature(), "sga",
                       noise, "mse", batch)
    gy, gz = torch.autograd.grad(loss, (y, z))
    return dict(loss=float(comm.all_reduce(loss.detach().clone())),
                gy=comm.all_gather_cat(gy, 0).cpu().numpy(),
                gz=comm.all_gather_cat(gz, 0).cpu().numpy())


def spatial_first_step(sp, x, seed):
    """``dp_first_step`` on a SpatialLatentOptimizer's ranks, each its rows
    of the one image ``x`` (on the grid), z replicated."""
    import torch

    from nic_tpu_torch.infer.engine import Latents
    from nic_tpu_torch.parallel.spatial import _loss_local, _slice_rows

    comm = sp.comm
    x_local = sp._local_rows(x)
    y, z = (v.clone().requires_grad_(True) for v in sp._init_local(x_local))
    rows = y.shape[1]
    noise_y = CardNoise(seed)(0, "y", (1, rows * comm.size) + tuple(y.shape[2:]) + (2,))
    noise = Latents(_slice_rows(noise_y, rows, comm),
                    CardNoise(seed)(0, "z", tuple(z.shape) + (2,)))
    loss, _ = _loss_local(sp.model, Latents(y, z), x_local, LMBDA, x.shape[1] * x.shape[2],
                          first_temperature(), "sga", noise, comm)
    gy, gz = torch.autograd.grad(loss, (y, z))
    return dict(loss=float(comm.all_reduce(loss.detach().clone())),
                gy=comm.all_gather_cat(gy, 1).cpu().numpy(),
                gz=comm.all_reduce(gz).cpu().numpy())


def check_k1_multi():
    """(a) K1 against its plain version at the rows a rank's GDN and IGDN
    see on this slice's paths (fp32, GDN and IGDN), and its times beside
    the bound, the plain version and cuBLAS's addmm (IGDN)."""
    import torch

    from nic_tpu_torch.ops.gdn_cuda import gdn_forward_kernel, gdn_kernel, gdn_reference

    gen = torch.Generator(device="cuda").manual_seed(13)
    table, max_abs = [], 0.0
    tol = K1_RTOL["float32"]
    for path, rows_list in (("spatial", SPATIAL_ROWS), ("dp_train", DP_TRAIN_ROWS)):
        for rows in rows_list:
            x, beta, gamma = k1_inputs(rows, gen)
            errs = {}
            with torch.no_grad():
                for inverse in (False, True):
                    out = gdn_kernel(x, beta, gamma, inverse)
                    ref = gdn_reference(x, beta, gamma, inverse)
                    torch.cuda.synchronize()
                    errs["IGDN" if inverse else "GDN"] = rel_err(out, ref)
                    max_abs = max(max_abs, float((out - ref).abs().max()))
                xsq = x * x
                ms = time_ms(lambda: gdn_forward_kernel(x, gamma, beta, True))
                plain_ms = time_ms(lambda: gdn_reference(x, beta, gamma, True))
                library_ms = time_ms(lambda: torch.addmm(beta, xsq, gamma))
            bound, bound_by, _ = k1_bound_ms(rows, "float32")
            table.append(dict(rows=rows, path=path, dtype="float32", rel_err=errs, ms=ms,
                              plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                              library_ms=library_ms))
            log(f"K1 at {path}'s M={rows} C={CHANNELS} float32: rel err GDN "
                f"{errs['GDN']:.2e}, IGDN {errs['IGDN']:.2e} (tolerance {tol:g}); IGDN kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, addmm [cuBLAS] {library_ms:.4f} ms, "
                f"bound {bound:.4f} ms ({bound_by})")
            if not max(errs.values()) <= tol:
                raise AssertionError(f"K1 disagrees with its plain version at M={rows}")
    return table, max_abs


def rank_window(opt, run, steps):
    """A rank's step split over ``steps`` more steps of ``run``: wall ms per
    step with the collectives synchronised on both sides, their share, and
    the rank's device-busy share (torch.profiler)."""
    import torch

    from nic_tpu_torch.tools.profile_sga import kernel_table

    comm = opt.comm
    comm.timed, comm.ms = True, 0.0
    torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    comm.timed = False
    busy = sum(ms for ms, _ in kernel_table(prof).values())
    return dict(steps=steps, ms_per_step=wall / steps,
                collectives_ms_per_step=comm.ms / steps,
                device_busy_ms_per_step=busy / steps, collectives_share=comm.ms / wall,
                device_idle_share=1.0 - busy / wall)


def spatial_rank(rank, device, x, its):
    """(b) on one rank: amortized init, danneal, SGA with injected noise (K1's
    launches and the collectives counted), then a timed window."""
    import torch.distributed as dist

    from nic_tpu_torch.checkpoint import load_model
    from nic_tpu_torch.infer.methods import DANNEAL, SGA
    from nic_tpu_torch.ops import gdn_cuda
    from nic_tpu_torch.parallel.spatial import SpatialLatentOptimizer

    deterministic(True)
    _, model = load_model(CKPT_DIR, RUN, CHANNELS, device)
    sp = SpatialLatentOptimizer(model, device, dist.group.WORLD)
    y0, z0 = sp.amortized_init(x)
    out = dict(y0=y0.cpu().numpy(), z0=z0.cpu().numpy(),
               first=spatial_first_step(sp, x, SPATIAL_SEED))
    out["danneal"] = sp.optimize(x, LMBDA, DANNEAL.replace(iterations=SPATIAL_DANNEAL_ITS))
    gdn_cuda.launches, sp.comm.calls, sp.comm.bytes = 0, 0, 0
    out["sga"] = sp.optimize(x, LMBDA, SGA.replace(iterations=its),
                             noise_fn=CardNoise(SPATIAL_SEED))
    out.update(k1_launches=gdn_cuda.launches, timing=sp.last_timing,
               collectives=sp.comm.calls, collective_bytes=sp.comm.bytes)
    deterministic(False)
    out["window"] = rank_window(sp, lambda n: sp.optimize(
        x, LMBDA, SGA.replace(iterations=n), noise_fn=CardNoise(SPATIAL_SEED)), WINDOW_STEPS)
    return out


def dp_infer_rank(rank, device, x, its):
    """(c) on one rank: SGA over its slice of the photos, injected noise."""
    import torch.distributed as dist

    from nic_tpu_torch.checkpoint import load_model
    from nic_tpu_torch.infer.engine import LatentOptimizer
    from nic_tpu_torch.infer.methods import SGA
    from nic_tpu_torch.ops import gdn_cuda

    deterministic(True)
    _, model = load_model(CKPT_DIR, RUN, CHANNELS, device)
    opt = LatentOptimizer(model, device, dist.group.WORLD)
    first = dp_first_step(opt, x, DP_SEED)
    gdn_cuda.launches = 0
    res = opt.optimize(x, LMBDA, SGA.replace(iterations=its), noise_fn=CardNoise(DP_SEED))
    out = dict(res=res, first=first, k1_launches=gdn_cuda.launches, timing=opt.last_timing,
               collectives=opt.comm.calls)
    deterministic(False)
    out["window"] = rank_window(opt, lambda n: opt.optimize(
        x, LMBDA, SGA.replace(iterations=n), noise_fn=CardNoise(DP_SEED)), WINDOW_STEPS)
    return out


def dp_train_batches():
    """DP_TRAIN_STEPS global batches of 8 random 256^2 crops of the photos,
    with their uniform noise (z's, y's), from numpy seed 13."""
    import numpy as np

    rng = np.random.default_rng(13)
    photos = np.load(PHOTOS)
    n, h, w, _ = photos.shape
    batches, noises = [], []
    for _ in range(DP_TRAIN_STEPS):
        crops = [photos[rng.integers(n), i:i + 256, j:j + 256]
                 for i, j in zip(rng.integers(h - 255, size=8), rng.integers(w - 255, size=8))]
        batches.append(np.stack(crops))
        noises.append((rng.uniform(-0.5, 0.5, (8, 4, 4, CHANNELS)).astype(np.float32),
                       rng.uniform(-0.5, 0.5, (8, 16, 16, CHANNELS)).astype(np.float32)))
    return batches, noises


def dp_train_rank(rank, device, workdir):
    """(d) on one rank (or, with no group, the unsharded run): the first
    step's averaged gradients before Adam, DP_TRAIN_STEPS steps from the
    lambda=0.01 checkpoint (the parameters after TRAIN_CMP_STEPS and after
    all), K1's launches, a save on every rank, then a timed window with
    cuDNN's default algorithms."""
    import torch
    import torch.distributed as dist

    from nic_tpu_torch.ops import gdn_cuda
    from nic_tpu_torch.train.trainer import TrainConfig, Trainer

    deterministic(True)
    group = dist.group.WORLD if dist.is_initialized() else None
    cfg = TrainConfig(num_filters=CHANNELS, batchsize=8, patchsize=256,
                      init_from=os.path.join(CKPT_DIR, RUN),
                      checkpoint_dir=os.path.join(workdir, f"rank{rank}"))
    trainer = Trainer(cfg, device, group)
    trainer.restore_or_init()
    batches, noises = dp_train_batches()
    lo, hi = trainer.comm.shard(8)

    def step(i):
        b, n = batches[i % DP_TRAIN_STEPS], noises[i % DP_TRAIN_STEPS]
        trainer.train_step(torch.from_numpy(b[lo:hi]),
                           tuple(torch.from_numpy(t[lo:hi]) for t in n))

    trainer.backward(torch.from_numpy(batches[0][lo:hi]),
                     tuple(torch.from_numpy(t[lo:hi]) for t in noises[0]))
    grads = {k: p.grad.detach().cpu().double()
             for k, p in trainer.model.named_parameters()} if rank == 0 else None
    trainer.optimizer.zero_grad(set_to_none=True)
    gdn_cuda.launches = 0
    def params():
        return {k: p.detach().cpu().double() for k, p in trainer.model.named_parameters()}

    params_first = None
    for i in range(DP_TRAIN_STEPS):
        step(i)
        if i == TRAIN_CMP_STEPS - 1 and rank == 0:
            params_first = params()
    launches = gdn_cuda.launches
    trainer._flush_losses()
    out = dict(grads=grads, losses=list(trainer.losses), k1_launches=launches,
               params_first=params_first, params=params() if rank == 0 else None,
               collectives=trainer.comm.calls)
    trainer.save()
    rank_dir = os.path.join(workdir, f"rank{rank}")
    out["wrote"] = sorted(os.listdir(rank_dir)) if os.path.isdir(rank_dir) else []
    deterministic(False)
    if group is not None:
        out["window"] = rank_window(trainer, lambda n: [step(i) for i in range(n)],
                                    DP_TRAIN_STEPS)
    return out


def check_spatial(model_cpu):
    """(b) 2 gloo ranks on the card, one 384x512 photo, against the
    unsharded card run."""
    import numpy as np

    from nic_tpu_torch.infer.methods import DANNEAL, SGA
    from nic_tpu_torch.parallel.mesh import spawn

    x = np.load(PHOTOS)[:1].astype(np.float32) / 255.0
    t = time.perf_counter()
    ranks = spawn(spatial_rank, 2, (x, SGA_ITS), device="cuda", backend="gloo")
    secs = time.perf_counter() - t
    y0, z0, ref, unsharded_ms = unsharded_reference(
        model_cpu, x, SPATIAL_SEED, danneal=DANNEAL.replace(iterations=SPATIAL_DANNEAL_ITS),
        sga=SGA.replace(iterations=SGA_ITS))
    sga = ref["sga"]
    r0 = ranks[0]
    e_init = max(float(np.abs(r0["y0"] - y0).max()), float(np.abs(r0["z0"] - z0).max()))
    gates = dict(danneal=run_gates(r0["danneal"], ref["danneal"], 1.0 - SPATIAL_Y_EQUAL,
                                   SPATIAL_METRIC_RTOL),
                 sga_early=early_gates(r0["sga"], sga, r0["first"], ref["first"]),
                 sga=run_gates(r0["sga"], sga, LONG_Y_UNEQUAL, LONG_METRIC_RTOL))
    same = all(np.array_equal(r["sga"]["y"], r0["sga"]["y"]) for r in ranks)
    per_rank = [dict(k1_launches=r["k1_launches"], sga_ms_per_step=r["timing"]["loop_ms"] / SGA_ITS,
                     collectives=r["collectives"], collective_bytes=r["collective_bytes"],
                     window=r["window"]) for r in ranks]
    log(f"spatial, 2 gloo ranks on the card, one 384x512 photo: amortized y, z max abs "
        f"diff {e_init:.2e} (tolerance {SPATIAL_INIT_ATOL:g}); danneal {SPATIAL_DANNEAL_ITS} "
        f"its {gates['danneal']}; sga {SGA_ITS} its, injected noise {gates['sga']} "
        f"(each difference within its limit); est "
        f"bpp {float(r0['sga']['est_bpp'][0])!r} vs {float(sga['est_bpp'][0])!r}, PSNR "
        f"{float(r0['sga']['psnr'][0])!r} vs {float(sga['psnr'][0])!r}; ranks agree {same}; "
        f"per rank {per_rank}; unsharded, default algorithms {unsharded_ms:.3f} ms/step; "
        f"{secs:.1f} s")
    if not e_init <= SPATIAL_INIT_ATOL:
        raise AssertionError("spatial amortized init disagrees with the unsharded run")
    for name, g in gates.items():
        if not g["ok"]:
            raise AssertionError(f"spatial {name} disagrees with the unsharded run: {g}")
    if not same or any(r["k1_launches"] < 3 * SGA_ITS for r in ranks):
        raise AssertionError("spatial ranks disagree, or K1 did not run in each rank's "
                             "g_s IGDNs")
    return dict(init_max_abs_diff=e_init, gates=gates, per_rank=per_rank,
                unsharded_ms_per_step=unsharded_ms,
                est_bpp=float(r0["sga"]["est_bpp"][0]), psnr=float(r0["sga"]["psnr"][0]),
                seconds=secs)


def unsharded_reference(model_cpu, x, seed, **methods):
    """The unsharded card runs the sharded ones are held against, and SGA's
    first step, with cuDNN's deterministic algorithms, as the ranks run
    them; then WINDOW_STEPS SGA steps with its default ones for the
    unsharded step's time."""
    from nic_tpu_torch.infer.engine import LatentOptimizer

    card = LatentOptimizer(copy.deepcopy(model_cpu), "cuda")
    deterministic(True)
    y0, z0 = (v.cpu().numpy() for v in card.amortized_init(x))
    out = {name: card.optimize(x, LMBDA, spec, noise_fn=CardNoise(seed))
           for name, spec in methods.items()}
    out["first"] = dp_first_step(card, x, seed)
    deterministic(False)
    card.optimize(x, LMBDA, methods["sga"].replace(iterations=WINDOW_STEPS),
                  noise_fn=CardNoise(seed))
    return y0, z0, out, card.last_timing["loop_ms"] / card.last_timing["steps"]


def run_gates(got, ref, y_unequal, metric_rtol):
    """A sharded run against the unsharded ``ref``: y's unequal share and
    bpp's and PSNR's largest relative difference, each against its limit;
    and whether all pass."""
    import numpy as np

    g = dict(
        y_unequal=float(np.mean(got["y"] != ref["y"])),
        bpp_rel=float(np.abs(got["est_bpp"] - ref["est_bpp"]).max() / ref["est_bpp"].max()),
        psnr_rel=float(np.abs(got["psnr"] - ref["psnr"]).max() / ref["psnr"].max()),
        limits=dict(y_unequal=y_unequal, bpp_rel=metric_rtol, psnr_rel=metric_rtol))
    g["ok"] = all(g[k] <= v for k, v in g["limits"].items())
    return g


def early_gates(got, ref, got_first, ref_first):
    """A sharded SGA run against the unsharded ``ref`` over its first steps:
    the largest relative difference of the first EARLY_STEPS losses, and of
    the first step's objective and its y and z gradients (L2), each within
    EARLY_RTOL; the step from which the losses first differ by more, as a
    diagnostic."""
    import numpy as np

    def l2_rel(a, b):
        return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))

    loss_rel = np.abs(got["losses"] - ref["losses"]) / np.abs(ref["losses"])
    over = np.nonzero(loss_rel > EARLY_RTOL)[0]
    g = dict(losses_rel=float(loss_rel[:EARLY_STEPS].max()),
             first_loss_rel=abs(got_first["loss"] - ref_first["loss"]) / abs(ref_first["loss"]),
             grad_y_rel=l2_rel(got_first["gy"], ref_first["gy"]),
             grad_z_rel=l2_rel(got_first["gz"], ref_first["gz"]))
    g["ok"] = all(v <= EARLY_RTOL for v in g.values())
    g.update(limit=EARLY_RTOL, steps=EARLY_STEPS,
             losses_first_step_over_limit=int(over[0]) if over.size else None)
    return g


def check_dp_inference(model_cpu):
    """(c) SGA over 2 photos at NCCL world size 1 and with 2 gloo ranks,
    against the unsharded card run."""
    import numpy as np

    from nic_tpu_torch.infer.methods import SGA
    from nic_tpu_torch.parallel.mesh import spawn

    x = np.load(PHOTOS)[:2].astype(np.float32) / 255.0
    _, _, refs, unsharded_ms = unsharded_reference(
        model_cpu, x, DP_SEED, sga=SGA.replace(iterations=SGA_ITS))
    ref = refs["sga"]
    out = dict(unsharded_ms_per_step=unsharded_ms)
    for name, world, backend in (("nccl_1", 1, "nccl"), ("gloo_2", 2, "gloo")):
        t = time.perf_counter()
        ranks = spawn(dp_infer_rank, world, (x, SGA_ITS), device="cuda", backend=backend)
        got = ranks[0]["res"]
        y_equal = bool(np.array_equal(got["y"], ref["y"]) and np.array_equal(got["z"], ref["z"]))
        bpp_rel = float(np.abs(got["est_bpp"] - ref["est_bpp"]).max() / ref["est_bpp"].max())
        per_rank = [dict(k1_launches=r["k1_launches"],
                         sga_ms_per_step=r["timing"]["loop_ms"] / SGA_ITS,
                         collectives=r["collectives"], window=r["window"]) for r in ranks]
        out[name] = dict(y_equal=y_equal, y_equal_share=float(np.mean(got["y"] == ref["y"])),
                         bpp_rel=bpp_rel, per_rank=per_rank, seconds=time.perf_counter() - t)
        out[name]["early"] = early = early_gates(got, ref, ranks[0]["first"], refs["first"])
        if world == 1:
            gate = f"y and z equal, est bpp rel diff <= {DP_BPP_RTOL:g}, early gates"
            ok = y_equal and bpp_rel <= DP_BPP_RTOL and early["ok"]
        else:
            out[name]["gates"] = g = run_gates(got, ref, LONG_Y_UNEQUAL, LONG_METRIC_RTOL)
            gate = "each difference within its limit"
            ok = g["ok"] and early["ok"]
        log(f"DP inference {name} ({world} rank(s)) on 2 photos, sga {SGA_ITS} its, injected "
            f"noise, cuDNN deterministic: {out[name]} ({gate}); unsharded, default "
            f"algorithms {unsharded_ms:.3f} ms/step")
        if not ok:
            raise AssertionError(f"DP inference ({name}) disagrees with the unsharded run")
        if any(r["k1_launches"] < 3 * SGA_ITS for r in ranks):
            raise AssertionError(f"K1 did not run on every DP rank ({name})")
    return out


def check_dp_training(workdir):
    """(d) DP training from the lambda=0.01 checkpoint, at NCCL world size 1
    and with 2 gloo ranks, against the unsharded card run."""
    import numpy as np
    import torch

    from nic_tpu_torch.parallel.mesh import spawn
    from nic_tpu_torch.train.trainer import TrainConfig, Trainer, is_aux_param

    ref = dp_train_rank(0, "cuda", os.path.join(workdir, "dp_unsharded"))
    prior = Trainer(TrainConfig(num_filters=CHANNELS, init_from=os.path.join(CKPT_DIR, RUN),
                                checkpoint_dir=os.path.join(workdir, "dp_kink")), "cpu")
    prior.restore_or_init()
    eb = prior.model.entropy_bottleneck
    with torch.no_grad():
        logits = eb._logits_cdf(eb.quantiles, stop_gradient=True)
    kink = torch.abs(logits - eb.quantile_targets) <= QUANTILE_KINK

    def param_diffs(got, want):
        """Each leaf's largest |dparam| and its mean over all its elements
        (the quantiles off the quantile loss's kink), in units of its
        group's lr."""
        largest, mean = {}, {}
        for k, w in want.items():
            lr = 1e-3 if is_aux_param(k) else 1e-4
            diff = torch.abs(got[k] - w) / lr
            largest[k] = float(diff.max())
            mean[k] = float((diff[~kink] if is_aux_param(k) else diff).mean())
        return largest, mean

    runs = {}
    for name, world, backend in (("nccl_1", 1, "nccl"), ("gloo_2", 2, "gloo")):
        t = time.perf_counter()
        ranks = spawn(dp_train_rank, world, (os.path.join(workdir, f"dp_{name}"),),
                      device="cuda", backend=backend)
        r0 = ranks[0]
        grad_errs = {}
        for k, want in ref["grads"].items():
            got = r0["grads"][k]
            if is_aux_param(k):
                want, got = want[~kink], got[~kink]
            norm = float(torch.linalg.vector_norm(want))
            grad_errs[k] = float(torch.linalg.vector_norm(got - want)) / norm if norm else 0.0
        loss_err = float(np.max(np.abs(np.asarray(r0["losses"]) - ref["losses"])
                                / np.abs(ref["losses"])))
        largest, first = param_diffs(r0["params_first"], ref["params_first"])
        _, last = param_diffs(r0["params"], ref["params"])
        worst_g = max(grad_errs, key=grad_errs.get)
        worst_p = max(first, key=first.get)
        worst_max = max(largest, key=largest.get)
        wrote = [r["wrote"] for r in ranks]
        runs[name] = dict(grad_l2_rel_err_max=grad_errs[worst_g], grad_worst_leaf=worst_g,
                          loss_rel_err_max=loss_err, param_mean_diff_lr_max=first[worst_p],
                          param_worst_leaf=worst_p, param_max_diff_lr=largest[worst_max],
                          param_max_diff_leaf=worst_max,
                          param_mean_diff_lr_max_after_all_steps=max(last.values()),
                          wrote=wrote, k1_launches=[r["k1_launches"] for r in ranks],
                          collectives=[r["collectives"] for r in ranks],
                          window=[r["window"] for r in ranks],
                          seconds=time.perf_counter() - t)
        log(f"DP training {name} ({world} rank(s), batch {8 // world} each) vs unsharded, "
            f"{DP_TRAIN_STEPS} steps from the lambda=0.01 checkpoint, cuDNN deterministic: "
            f"{runs[name]} (gradients <= {TRAIN_GRAD_RTOL:g}, losses <= {DP_LOSS_RTOL:g}; "
            f"after {TRAIN_CMP_STEPS} steps |dparam| <= {TRAIN_PARAM_LRS} lr, and its mean "
            f"over each leaf <= {TRAIN_PARAM_MEAN_LRS:g} lr)")
        if not (grad_errs[worst_g] <= TRAIN_GRAD_RTOL and loss_err <= DP_LOSS_RTOL
                and first[worst_p] <= TRAIN_PARAM_MEAN_LRS
                and largest[worst_max] <= TRAIN_PARAM_LRS):
            raise AssertionError(f"DP training ({name}) disagrees with the unsharded run")
        if not (wrote[0] and all(not w for w in wrote[1:])):
            raise AssertionError(f"DP training ({name}): writes {wrote}, rank 0's only expected")
        if any(r["k1_launches"] != 6 * DP_TRAIN_STEPS for r in ranks):
            raise AssertionError(f"DP training ({name}): K1 did not run 6 times per step")
    return runs


def run_parallel_cli(workdir, photo0):
    """(e) sga compress --data_parallel and --spatial through the CLI on the
    card (one card: NCCL at world size 1, in this process), CLI_ITS steps;
    each stream decodes exactly."""
    from nic_tpu_torch.cli.main import main as cli_main
    from nic_tpu_torch.ops import gdn_cuda

    common = ["--num_filters", "192", "--checkpoint_dir", CKPT_DIR, "sga"]
    out = {}
    for flag, inputs in (("--data_parallel", PHOTOS), ("--spatial", photo0)):
        name = flag.strip("-")
        stream = os.path.join(workdir, f"{name}.ntc")
        png = os.path.join(workdir, f"{name}.png")
        gdn_cuda.launches = 0
        res = cli_main(common + ["compress", RUN, inputs, stream, flag, "--sga_its", str(CLI_ITS),
                                 "--results_dir", os.path.join(workdir, f"results_{name}")])
        launches = gdn_cuda.launches
        dec = cli_main(common + ["decompress", RUN, stream, png])
        check_exact(f"sga {flag}", dec, png, res["pixels"])
        name = "spatial_cli" if name == "spatial" else name
        out[name] = dict(bytes=res["bytes"], k1_launches=launches,
                         ms_per_step=res["loop_ms"][0] / res["steps"][0],
                         est_bpp=float(res["results"]["est_bpp"].mean()))
        log(f"sga compress {flag} (CLI, 1 card): {out[name]}; its stream decodes exactly")
        if launches < 3 * CLI_ITS:
            raise AssertionError(f"K1 launched {launches} times on sga {flag}")
    return out


def linked_run(ckpt_dir, runname):
    """<ckpt_dir>/<runname> holding the committed run's args.json and a link
    to its npz, so that a tool writes beside it and not into the checkout."""
    import glob

    run_dir = os.path.join(ckpt_dir, runname)
    os.makedirs(run_dir)
    src = os.path.join(CKPT_DIR, runname)
    shutil.copy(os.path.join(src, "args.json"), run_dir)
    for npz in glob.glob(os.path.join(src, "params-*.npz")):
        os.symlink(npz, os.path.join(run_dir, os.path.basename(npz)))
    return run_dir


def captured(fn, *args):
    """(fn's result, what it printed), its output printed as well."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    print(out.getvalue(), end="", flush=True)
    return result, out.getvalue()


def check_csvs(out_dir, names):
    import re

    for name in names:
        with open(os.path.join(out_dir, f"{name}-psnr.csv")) as f:
            rows = f.read().splitlines()
        if not rows or not all(re.fullmatch(CSV_ROW, r) for r in rows):
            raise AssertionError(f"{name}-psnr.csv is not in the reference format: {rows}")


def run_rd_curve(workdir):
    """(a) rd_curve of the lambda=0.01 run, amortized and SGA 2000 (bf16),
    against nic_tpu's rows."""
    from nic_tpu_torch.ops import gdn_cuda
    from nic_tpu_torch.tools import rd_curve

    out_dir = os.path.join(workdir, "rd_photos")
    t = time.perf_counter()
    gdn_cuda.launches = 0
    (row,) = rd_curve.main([PHOTOS, "--checkpoint_dir", CKPT_DIR, "--out", out_dir,
                            "--lmbda", str(LMBDA), "--methods", "amortized,sga",
                            "--its", str(SGA_ITS)])
    launches = gdn_cuda.launches
    secs = time.perf_counter() - t
    for name, ref in JAX_RD_ROWS.items():
        got = row["methods"][name]
        d_bpp = abs(got["bpp"] - ref["bpp"]) / ref["bpp"]
        d_psnr = abs(got["psnr"] - ref["psnr"])
        atol = RD_SGA_PSNR_ATOL_DB if name == "sga" else PSNR_ATOL_DB
        log(f"rd_curve {name}: {got['bpp']!r} bpp, {got['psnr']!r} dB, MS-SSIM "
            f"{got['msssim']!r}, {got['secs']:.1f} s; nic_tpu's row {ref['bpp']!r} bpp, "
            f"{ref['psnr']!r} dB (rel diff {d_bpp:.2e}, tolerance {BPP_RTOL:g}; diff "
            f"{d_psnr:.2e} dB, tolerance {atol:g})")
        if not (d_bpp <= BPP_RTOL and d_psnr <= atol):
            raise AssertionError(f"rd_curve's {name} row disagrees with nic_tpu's")
    check_csvs(out_dir, JAX_RD_ROWS)
    log(f"rd_curve: wrote {sorted(os.listdir(out_dir))}; K1 launches {launches} "
        f"(>= {3 * SGA_ITS} required); {secs:.1f} s")
    if launches < 3 * SGA_ITS:
        raise AssertionError(f"K1 launched {launches} times on rd_curve")
    return out_dir, row, dict(k1_launches=launches, rows=row["methods"], seconds=secs)


def run_rd_curve_bb(workdir):
    """(b) rd_curve --model mbt2018_bb, bb_plain and bb_sga, against
    BBLatentOptimizer.optimize called here with the same spec and seed,
    both with deterministic cuDNN."""
    import numpy as np
    import torch

    from nic_tpu_torch.checkpoint import load_model
    from nic_tpu_torch.infer.bb import BB_METHODS, BBLatentOptimizer
    from nic_tpu_torch.ops import gdn_cuda
    from nic_tpu_torch.tools import rd_curve

    names = ("bb_plain", "bb_sga")
    out_dir = os.path.join(workdir, "rd_photos_bb")
    t = time.perf_counter()
    deterministic(True)
    try:
        gdn_cuda.launches = 0
        (row,) = rd_curve.main([PHOTOS, "--checkpoint_dir", CKPT_DIR, "--out", out_dir,
                                "--model", "mbt2018_bb", "--lmbda", str(LMBDA),
                                "--methods", ",".join(names), "--its", str(EVAL_BB_ITS)])
        launches = gdn_cuda.launches
        secs = time.perf_counter() - t
        _, model = load_model(CKPT_DIR, BB_RUN, 192, "cuda", compute_dtype=torch.bfloat16,
                              model="mbt2018_bb")
        opt = BBLatentOptimizer(model, "cuda")
        x = np.load(PHOTOS).astype(np.float32) / 255.0
        ref = {}
        for name in names:
            spec = BB_METHODS[name]
            if spec.rd_iterations > 0:
                spec = spec.replace(rd_iterations=EVAL_BB_ITS)
            ref[name] = opt.optimize(x, LMBDA, spec=spec, seed=0)
    finally:
        deterministic(False)
    rd = {}
    for name in names:
        got, r = row["methods"][name], ref[name]
        want = dict(bpp=float(np.mean(r["est_bpp"])), psnr=float(np.mean(r["psnr"])),
                    msssim=float(np.mean(r["msssim"])))
        rd[name] = float(LMBDA * r["mse"].mean() + r["est_bpp"].mean())
        log(f"rd_curve_bb {name}: {got['bpp']!r} bpp, {got['psnr']!r} dB, MS-SSIM "
            f"{got['msssim']!r}, {got['secs']:.1f} s; BBLatentOptimizer.optimize "
            f"{want['bpp']!r} bpp, {want['psnr']!r} dB; RD objective {rd[name]!r}")
        if not all(np.array_equal(got[k], v, equal_nan=True) for k, v in want.items()):
            raise AssertionError(f"rd_curve_bb's {name} row differs from optimize's")
    check_csvs(out_dir, names)
    log(f"rd_curve_bb: rows equal to optimize's bit for bit; bb_sga's RD objective "
        f"{rd['bb_sga']!r} vs bb_plain's {rd['bb_plain']!r}; K1 launches {launches} "
        f"(>= {3 * EVAL_BB_ITS} required); {secs:.1f} s")
    if not rd["bb_sga"] < rd["bb_plain"]:
        raise AssertionError("rd_curve_bb: bb_sga did not lower the RD objective")
    if launches < 3 * EVAL_BB_ITS:
        raise AssertionError(f"K1 launched {launches} times on rd_curve_bb")
    return dict(k1_launches=launches, rows=row["methods"], rd_objective=rd, seconds=secs)


def run_bd_report(out_dir, row):
    """(c) bd_report of (a)'s curves: each delta is the golden curve's."""
    from nic_tpu_torch.evaluation import golden
    from nic_tpu_torch.tools import bd_report

    report = bd_report.main([out_dir])
    for csvname, gmethod in (("amortized", "mbt2018"), ("sga", "sga")):
        res = row["methods"][csvname]
        b, p = float(f"{res['bpp']:.4f}"), float(f"{res['psnr']:.6f}")
        want = p - golden.interp_psnr_at_bpp("kodak", gmethod, b)
        if report[csvname]["points"] != [(b, p)] or report[csvname]["deltas"] != [want]:
            raise AssertionError(f"bd_report's {csvname} delta is not the golden curve's")
    log(f"bd_report: deltas vs golden kodak "
        f"{ {k: v['deltas'] for k, v in report.items()} } equal the golden curves' at "
        f"(a)'s points")
    return {k: dict(deltas=v["deltas"], gap=v["gap"]) for k, v in report.items()}


def run_validate_rd(workdir):
    """(d) validate_rd on the lambda=0.01 run (six methods, VALIDATE_ITS
    steps), then --bb on the bits-back run and the first photo."""
    import numpy as np

    from nic_tpu_torch.ops import gdn_cuda
    from nic_tpu_torch.tools import validate_rd

    ckpt = os.path.join(workdir, "validate")
    paths = {}
    for key, run, extra in (("validate_rd", RUN, ["--its", str(VALIDATE_ITS)]),
                            ("validate_rd_bb", BB_RUN, ["--bb"])):
        run_dir = linked_run(ckpt, run)
        data = PHOTOS
        if key == "validate_rd_bb":
            data = os.path.join(workdir, "photo_0.npy")
            np.save(data, np.load(PHOTOS)[:1])
        t = time.perf_counter()
        gdn_cuda.launches = 0
        code, text = captured(validate_rd.main, [run, data, "--checkpoint_dir", ckpt] + extra)
        launches = gdn_cuda.launches
        secs = time.perf_counter() - t
        with open(os.path.join(run_dir, "VALIDATION.json")) as f:
            record = json.load(f)
        results = record["results"]
        log(f"{key}: exit {code}; K1 launches {launches}; {secs:.1f} s")
        if code != 0 or not text.rstrip().splitlines()[-1].startswith("PASS"):
            raise AssertionError(f"{key} did not PASS")
        if key == "validate_rd":
            worse = [n for n, r in results.items()
                     if n != "amortized" and not r["rd_loss"] < results["amortized"]["rd_loss"]]
            if worse:
                raise AssertionError(f"validate_rd: {worse} did not beat amortized")
            need = 3 * VALIDATE_ITS
        else:
            if text.count("bits recovered: True") != 2:
                raise AssertionError("validate_rd --bb: a stream did not return its bits")
            need = 3 * 2000
        if launches < need:
            raise AssertionError(f"K1 launched {launches} times on {key} (>= {need})")
        paths[key] = dict(k1_launches=launches, seconds=secs, **record)
    return paths


def run_converge_aux(workdir, mbt2018_path):
    """(e) converge_aux on a copy of the lambda=0.01 run: a dry run, then
    AUX_STEPS steps to half the loss; only the quantiles change, and the run
    then serves mbt2018 compress -> decompress exactly."""
    import numpy as np

    from nic_tpu_torch.checkpoint import latest_npz, load_params_npz
    from nic_tpu_torch.cli.main import main as cli_main
    from nic_tpu_torch.ops import gdn_cuda
    from nic_tpu_torch.tools import converge_aux

    ckpt = os.path.join(workdir, "aux")
    run_dir = os.path.join(ckpt, RUN)
    shutil.copytree(os.path.join(CKPT_DIR, RUN), run_dir)
    _, original = load_params_npz(latest_npz(run_dir))
    dry = converge_aux.main([run_dir, "--dry_run"])
    before = dry["before"]
    t = time.perf_counter()
    gdn_cuda.launches = 0
    res = converge_aux.main([run_dir, "--threshold", repr(before / 2), "--steps",
                             str(AUX_STEPS)])
    tool_launches = gdn_cuda.launches
    secs = time.perf_counter() - t
    _, repaired = load_params_npz(latest_npz(run_dir))
    changed = sorted(k for k in original if not np.array_equal(original[k], repaired[k]))
    log(f"converge_aux: aux loss {before!r} -> {res['after']!r} after {res['steps']} steps "
        f"({secs:.2f} s on the card); changed {changed}")
    if dry["rewritten"] or not (res["rewritten"] and res["after"] < before):
        raise AssertionError("converge_aux did not lower the aux loss")
    if set(repaired) != set(original) or not changed or any(
            "quantiles" not in k for k in changed):
        raise AssertionError(f"converge_aux changed {changed}, not the quantiles alone")

    common = ["--num_filters", "192", "--checkpoint_dir", ckpt, "mbt2018"]
    stream = os.path.join(workdir, "photos_aux.ntc")
    png = os.path.join(workdir, "photos_aux.png")
    gdn_cuda.launches = 0
    out = cli_main(common + ["compress", RUN, PHOTOS, stream, "--results_dir",
                             os.path.join(workdir, "results_aux")])
    dec = cli_main(common + ["decompress", RUN, stream, png])
    serve_launches = gdn_cuda.launches
    check_exact("mbt2018 (converged quantiles)", dec, png, out["pixels"])
    actual = float(out["results"]["avg_batch_actual_bpp"])
    log(f"converge_aux: the repaired run serves mbt2018 compress -> decompress exactly: "
        f"actual {actual!r} bpp (the committed run: {mbt2018_path['actual_bpp']!r}); K1 "
        f"launches {tool_launches} in the tool, {serve_launches} serving")
    if serve_launches < 9:
        raise AssertionError("the repaired run's codec path did not run K1")
    return dict(k1_launches=tool_launches + serve_launches, k1_launches_tool=tool_launches,
                aux_before=before, aux_after=res["after"], steps=res["steps"],
                seconds=secs, changed=changed, actual_bpp=actual)


def run_evaluation(workdir, mbt2018_path):
    """Phase 14: the evaluation and reporting tools on the card."""
    out_dir, row, rd_path = run_rd_curve(workdir)
    paths = dict(rd_curve=rd_path, rd_curve_bb=run_rd_curve_bb(workdir))
    paths["rd_curve"]["bd_report"] = run_bd_report(out_dir, row)
    paths.update(run_validate_rd(workdir))
    paths["converge_aux"] = run_converge_aux(workdir, mbt2018_path)
    return paths


def int8_bound_ms(n, h, w, c, co):
    """The int8 up-conv's bound: its bf16 input read, its int8 weights read
    and its bf16 output written once, over HBM's rate; its 25 multiply-adds
    per input pixel, channel and output channel over the int8 peak."""
    nbytes = n * h * w * c * 2 + 25 * c * co + 4 * n * h * w * co * 2
    ops = 2 * n * h * w * 25 * c * co
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_INT8_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_int8_convs(model_bf16_cpu):
    """(a) Each int8 up-conv of g_s and h_s at the photos' shapes, with the
    model's own weights: the card's int32 sums and bf16 outputs equal the
    port's CPU path bit for bit; timed beside cuDNN's bf16 transposed conv
    of the same shape and the bound. (d) The phases and subpixel forms at
    g_s's largest layer against the transposed conv, float32, timed."""
    import torch

    from nic_tpu_torch.models import layers
    from nic_tpu_torch.ops import int8conv

    gen = torch.Generator().manual_seed(15)
    rows = []
    for (n, h, w, c, co), name in zip(INT8_SHAPES, INT8_LAYERS):
        weight = model_bf16_cpu.get_submodule(name).hwio().detach().to(torch.bfloat16)
        x = torch.randn(n, h, w, c, generator=gen).to(torch.bfloat16)
        xq, _ = int8conv.quantize_per_tensor(x)
        wq, _ = int8conv.quantize_weight_per_cout(weight)
        want_acc = int8conv.conv_int32(xq, wq, 2, True)
        want = int8conv.int8_conv(x, weight, 2, True)
        xc, wc, xqc, wqc = x.cuda(), weight.cuda(), xq.cuda(), wq.cuda()
        got_acc = int8conv.conv_int32(xqc, wqc, 2, True)
        got = int8conv.int8_conv(xc, wc, 2, True)
        torch.cuda.synchronize()
        if not (torch.equal(got_acc.cpu(), want_acc) and torch.equal(got.cpu(), want)):
            raise AssertionError(f"int8 conv {name} {(n, h, w, c, co)}: the card differs "
                                 "from the CPU path")
        wt = wc.flip(0, 1).permute(2, 3, 0, 1).contiguous()  # conv_transpose2d's layout
        ms = time_ms(lambda: int8conv.int8_conv(xc, wc, 2, True))
        gemm_ms = time_ms(lambda: int8conv.conv_int32(xqc, wqc, 2, True))
        cudnn_ms = time_ms(lambda: layers.conv_transpose_up2(xc, wt))
        # int8_all's input cotangent: the int8 stride-2 conv of the quantized
        # cotangent (the same bound: the same products, read and write reversed).
        g = torch.randn(n, 2 * h, 2 * w, co, generator=gen).to(torch.bfloat16)
        gc = g.cuda()
        dx = int8conv.qbwd_x_up2(gc, wc)
        torch.cuda.synchronize()
        if not torch.equal(dx.cpu(), int8conv.qbwd_x_up2(g, weight)):
            raise AssertionError(f"int8 input cotangent {name}: the card differs from the CPU")
        qbwd_ms = time_ms(lambda: int8conv.qbwd_x_up2(gc, wc))
        cudnn_dx_ms = time_ms(lambda: torch.nn.functional.conv2d(
            gc.permute(0, 3, 1, 2), wt, stride=2, padding=1))
        bound, bound_by = int8_bound_ms(n, h, w, c, co)
        rows.append(dict(layer=name, shape=[n, h, w, c, co], ms=ms, int32_gemm_ms=gemm_ms,
                         cudnn_bf16_ms=cudnn_ms, qbwd_ms=qbwd_ms, cudnn_bf16_dx_ms=cudnn_dx_ms,
                         bound_ms=bound, bound_by=bound_by, exact_vs_cpu=True))
        log(f"int8 up-conv {name} x{(n, h, w, c)} -> {co}: equal to the CPU path bit for "
            f"bit (int32 sums, bf16 output, int8_all's input cotangent); {ms:.4f} ms "
            f"(quantize + im2col + _int_mm + rescale; int32 part {gemm_ms:.4f} ms), cuDNN "
            f"bf16 conv_transpose2d {cudnn_ms:.4f} ms; input cotangent {qbwd_ms:.4f} ms, "
            f"cuDNN bf16 {cudnn_dx_ms:.4f} ms; bound {bound:.4f} ms ({bound_by})")

    x = torch.randn(3, 96, 128, 192, generator=gen).cuda()
    weight = model_bf16_cpu.synthesis.layer_2.hwio().detach().float().cuda()
    wt = weight.flip(0, 1).permute(2, 3, 0, 1).contiguous()
    variants = {}
    with torch.no_grad():
        ref = layers.conv_transpose_up2(x, wt)
        forms = {"phases": lambda: layers.conv_transpose_phases_up2(x, weight),
                 "subpixel": lambda: layers.depth_to_space2(
                     layers._subpixel_conv(x, weight), weight.shape[3])}
        for form, fn in forms.items():
            err = rel_err(fn(), ref)
            # Few launches: cuDNN's default float32 algorithm for the phases'
            # 3x3 parity conv (192 -> 192) took 300-450 ms on an H100.
            variants[form] = dict(rel_err=err, ms=time_ms(fn, iters=3, warmup=1),
                                  transpose_ms=time_ms(lambda: layers.conv_transpose_up2(x, wt),
                                                       iters=3, warmup=1))
            log(f"up-conv {form} (3, 96, 128, 192) fp32: rel err {err:.2e} vs the "
                f"transposed conv (tolerance {VARIANT_RTOL:g}); {variants[form]['ms']:.4f} ms "
                f"vs {variants[form]['transpose_ms']:.4f} ms")
            if not err <= VARIANT_RTOL:
                raise AssertionError(f"the {form} up-conv disagrees with the transposed conv")
    return rows, variants


def run_quant_codec(workdir):
    """(b) mbt2018 compress --quant int8 -> decompress --quant int8 through
    the CLI: exact, its actual bpp beside nic_tpu's."""
    from nic_tpu_torch.cli.main import main as cli_main
    from nic_tpu_torch.ops import gdn_cuda

    common = ["--num_filters", "192", "--checkpoint_dir", CKPT_DIR, "mbt2018"]
    stream = os.path.join(workdir, "photos_int8.ntc")
    png = os.path.join(workdir, "photos_int8.png")
    gdn_cuda.launches = 0
    out = cli_main(common + ["compress", RUN, PHOTOS, stream, "--quant", "int8",
                             "--results_dir", os.path.join(workdir, "results_int8")])
    encode_launches = gdn_cuda.launches
    gdn_cuda.launches = 0
    dec = cli_main(common + ["decompress", RUN, stream, png, "--quant", "int8"])
    decode_launches = gdn_cuda.launches
    check_exact("mbt2018 --quant int8", dec, png, out["pixels"])
    res = out["results"]
    actual = float(res["avg_batch_actual_bpp"])
    d_actual = abs(actual - JAX_INT8_ACTUAL_BPP) / JAX_INT8_ACTUAL_BPP
    log(f"mbt2018 --quant int8 compress -> decompress: exact; actual {actual!r} bpp "
        f"({out['bytes']} bytes), est {float(res['est_bpp'].mean())!r}, PSNR "
        f"{float(res['psnr'].mean())!r} dB; nic_tpu's actual {JAX_INT8_ACTUAL_BPP!r} "
        f"(rel diff {d_actual:.2e}, tolerance {BPP_RTOL:g}), est {JAX_INT8_EST['est_bpp']!r}, "
        f"PSNR {JAX_INT8_EST['psnr']!r} dB; K1 launches encode "
        f"{encode_launches}, decode {decode_launches}")
    if not d_actual <= BPP_RTOL:
        raise AssertionError("mbt2018 --quant int8's actual bpp disagrees with nic_tpu's")
    if encode_launches < 6 or decode_launches < 3:
        raise AssertionError("the int8 codec path did not run K1 in every GDN")
    return dict(actual_bpp=actual, est_bpp=float(res["est_bpp"].mean()),
                psnr=float(res["psnr"].mean()), k1_launches_encode=encode_launches,
                k1_launches_decode=decode_launches, encode_ms=out["timing"],
                decode_ms=dec["timing"])


def run_quant_sga(model_cpu, model_bf16_cpu):
    """(c) bf16 SGA at --quant none, int8 and int8_all through
    LatentOptimizer, METHOD_ITS steps each on the photos, K1's launches
    counted from zero on each (e): ms/step, the RD objective below the same
    model's amortized one, and the stream of the transmitted latents decoded
    exactly; the first QUANT_STEPS steps of int8 and int8_all on a crop, the
    card against the port's CPU path, with the CLI's float32 transforms."""
    import numpy as np
    import torch

    from nic_tpu_torch.coding.codec import HyperpriorCodec
    from nic_tpu_torch.infer.engine import LatentOptimizer
    from nic_tpu_torch.infer.methods import SGA
    from nic_tpu_torch.ops import gdn_cuda

    x = np.load(PHOTOS).astype(np.float32) / 255.0
    card = copy.deepcopy(model_bf16_cpu).to("cuda")
    out = {}
    for quant in QUANT_MODES:
        model = card if quant == "none" else card.clone(quant=quant)
        opt = LatentOptimizer(model, "cuda")
        base = opt.eval_amortized(x)
        rd_base = float(LMBDA * base["mse"].mean() + base["est_bpp"].mean())
        gdn_cuda.launches = 0
        res = opt.optimize(x, LMBDA, method=SGA.replace(iterations=METHOD_ITS), seed=0)
        launches = gdn_cuda.launches
        steps, loop_ms = opt.last_timing["steps"], opt.last_timing["loop_ms"]
        rd = float(LMBDA * res["mse"].mean() + res["est_bpp"].mean())
        codec = HyperpriorCodec(model, "cuda")
        blob = codec.compress_optimized(res["y"], res["z"], x.shape[1:3])
        x_hat = codec.decompress(blob)
        exact = np.array_equal(np.round(x_hat * 255.0).astype(np.uint8), codec.last_pixels)
        actual = len(blob) * 8 / (x.shape[0] * x.shape[1] * x.shape[2])
        out[quant] = dict(steps=steps, ms_per_step=loop_ms / steps, k1_launches=launches,
                          est_bpp=float(res["est_bpp"].mean()), psnr=float(res["psnr"].mean()),
                          actual_bpp=actual, rd_objective=rd, rd_objective_amortized=rd_base,
                          amortized_est_bpp=float(base["est_bpp"].mean()),
                          amortized_psnr=float(base["psnr"].mean()), stream_exact=exact)
        log(f"bf16 sga --quant {quant}: {steps} steps in {loop_ms:.1f} ms = "
            f"{loop_ms / steps:.3f} ms/step; K1 launches {launches}; est bpp "
            f"{out[quant]['est_bpp']!r}, PSNR {out[quant]['psnr']!r} dB, actual "
            f"{actual!r} bpp, stream exact {exact}; rounded RD objective {rd!r} vs its "
            f"amortized {rd_base!r}")
        for k in ("est_bpp", "psnr", "losses"):
            if not np.all(np.isfinite(res[k])):
                raise AssertionError(f"sga --quant {quant}: {k} is not finite")
        if steps != METHOD_ITS or launches < 3 * steps:
            raise AssertionError(f"sga --quant {quant} ran {steps} steps with {launches} "
                                 "K1 launches")
        if not rd < rd_base:
            raise AssertionError(f"sga --quant {quant} did not lower the RD objective")
        if not exact:
            raise AssertionError(f"sga --quant {quant}: the stream does not decode exactly")

    crop = x[:1, 100:164, 200:264]
    rng = np.random.default_rng(15)
    y0, z0 = LatentOptimizer(model_cpu, "cpu").amortized_init(crop)
    draws = {(it, name): torch.from_numpy(rng.gumbel(size=(*v.shape, 2)).astype(np.float32))
             for it in range(QUANT_STEPS) for name, v in (("y", y0), ("z", z0))}

    def noise_fn(step, name, shape):
        return draws[(step, name)]

    spec = SGA.replace(iterations=QUANT_STEPS)

    for quant in QUANT_MODES[1:]:
        r_g = LatentOptimizer(copy.deepcopy(model_cpu).clone(quant=quant), "cuda").optimize(
            crop, LMBDA, method=spec, noise_fn=noise_fn)
        r_c = LatentOptimizer(model_cpu.clone(quant=quant), "cpu").optimize(
            crop, LMBDA, method=spec, noise_fn=noise_fn)
        errs = np.abs(r_g["losses"] - r_c["losses"]) / np.abs(r_c["losses"])
        out[quant].update(card_vs_cpu_first_loss_rel_err=float(errs[0]),
                          card_vs_cpu_loss_rel_err=float(errs.max()))
        log(f"sga --quant {quant} (float32 transforms): first {QUANT_STEPS} steps on a "
            f"64x64 crop, card vs CPU: first loss rel err {errs[0]:.2e} (tolerance "
            f"{QUANT_FIRST_RTOL:g}), largest {errs.max():.2e} (tolerance {QUANT_LOSS_RTOL:g})")
        if not (errs[0] <= QUANT_FIRST_RTOL and errs.max() <= QUANT_LOSS_RTOL):
            raise AssertionError(f"sga --quant {quant}: the card's steps disagree with the CPU's")
    return out


def run_int8_variants(model_cpu, model_bf16_cpu, workdir):
    """Phase 15: (a) and (d) ``check_int8_convs``, (b) ``run_quant_codec``,
    (c) and (e) ``run_quant_sga``."""
    convs, variants = check_int8_convs(model_bf16_cpu)
    return dict(int8_convs=convs, upsample_variants=variants,
                mbt2018_int8=run_quant_codec(workdir),
                sga_bf16=run_quant_sga(model_cpu, model_bf16_cpu))


def check_k1_last_scripts():
    """K1 against its plain version at the new shapes of phase 16's paths
    (LAST_SCRIPTS_K1; GDN and IGDN, against the plain version on the same
    inputs), and its times beside the bound, the plain version and cuBLAS's
    addmm (IGDN)."""
    import torch

    from nic_tpu_torch.ops.gdn_cuda import gdn_forward_kernel, gdn_kernel, gdn_reference

    gen = torch.Generator(device="cuda").manual_seed(16)
    table, max_abs = [], 0.0
    for path, rows, c, dtype in LAST_SCRIPTS_K1:
        dt = getattr(torch, dtype)
        x, beta, gamma = k1_inputs(rows, gen, c)
        x, gamma = x.to(dt), gamma.to(dt)
        errs = {}
        with torch.no_grad():
            for inverse in (False, True):
                out = gdn_kernel(x, beta, gamma, inverse)
                ref = gdn_reference(x, beta, gamma, inverse)
                torch.cuda.synchronize()
                errs["IGDN" if inverse else "GDN"] = rel_err(out, ref)
                if dtype == "float32":
                    max_abs = max(max_abs, float((out - ref).abs().max()))
                del out, ref
            xsq = x * x
            ms = time_ms(lambda: gdn_forward_kernel(x, gamma, beta, True))
            plain_ms = time_ms(lambda: gdn_reference(x, beta, gamma, True))
            library_ms = time_ms(lambda: torch.addmm(beta.to(dt), xsq, gamma))
        del x, xsq
        torch.cuda.empty_cache()
        bound, bound_by, _ = k1_bound_ms(rows, dtype, c)
        tol = K1_RTOL[dtype]
        table.append(dict(rows=rows, channels=c, path=path, dtype=dtype, rel_err=errs, ms=ms,
                          plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                          library_ms=library_ms))
        log(f"K1 at {path}'s M={rows} C={c} {dtype}: rel err GDN {errs['GDN']:.2e}, IGDN "
            f"{errs['IGDN']:.2e} (tolerance {tol:g}); IGDN kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, addmm [cuBLAS] {library_ms:.4f} ms, bound {bound:.4f} ms "
            f"({bound_by})")
        if not max(errs.values()) <= tol:
            raise AssertionError(f"K1 disagrees with its plain version at M={rows} C={c}")
    return table, max_abs


def run_landscape(model_cpu, model_bf16_cpu):
    """(a) the landscape of photo 0 with the bf16 model, and on a crop the
    card against the port's CPU path (fp32)."""
    import numpy as np
    import torch

    from nic_tpu_torch.infer.engine import LatentOptimizer
    from nic_tpu_torch.infer.methods import SGA
    from nic_tpu_torch.ops import gdn_cuda
    from nic_tpu_torch.tools import sga_landscape
    from nic_tpu_torch.utils import pad_to_64

    photos = np.load(PHOTOS).astype(np.float32) / 255.0
    x = pad_to_64(photos[:1])
    card = copy.deepcopy(model_bf16_cpu).to("cuda")
    opt = LatentOptimizer(card, "cuda")
    base = opt.eval_amortized(x)
    rd_base = float(LMBDA * base["mse"].mean() + base["est_bpp"].mean())
    y0 = opt.amortized_init(x)[0].cpu().numpy()
    t = time.perf_counter()
    gdn_cuda.launches = 0
    land = sga_landscape.landscape(card, x, LMBDA, SGA.replace(iterations=LANDSCAPE_ITS),
                                   LANDSCAPE_RECORD_EVERY, LANDSCAPE_GRID, 1.2, 0,
                                   device="cuda")
    launches = gdn_cuda.launches
    secs = time.perf_counter() - t
    res, zz = land["result"], land["objective"]
    rd = float(LMBDA * res["mse"].mean() + res["est_bpp"].mean())
    rows = res["trajectory_y"].shape[0]
    first_equal = bool(np.array_equal(res["trajectory_y"][0], y0))

    # The trajectory's end inside a batch of 32 (with 31 grid points) and alone.
    y_star, z_star, xt = (torch.as_tensor(a, device="cuda")
                          for a in (res["trajectory_y"][-1], res["trajectory_z"][-1], x))
    args = (card, xt, y_star, z_star, land["coords"])
    vv1, vv2 = np.meshgrid(land["g1"], land["g2"])
    v1 = np.concatenate([[land["t1"][-1]], vv1.ravel()[:31]])
    v2 = np.concatenate([[land["t2"][-1]], vv2.ravel()[:31]])
    in_batch = sga_landscape.objective_at(*args, v1, v2, LMBDA)[0]
    alone = sga_landscape.objective_at(*args, v1[:1], v2[:1], LMBDA)[0]
    batch_err = abs(float(in_batch) - float(alone)) / abs(float(alone))
    log(f"sga_landscape: {LANDSCAPE_ITS} bf16 SGA steps on photo 0, {rows} rows recorded, "
        f"first row equal to the amortized y: {first_equal}; coords {land['coords']} moved "
        f"{float(land['moved'][0]):.3f}, {float(land['moved'][1]):.3f}; {LANDSCAPE_GRID}^2 "
        f"grid objective in [{float(zz.min())!r}, {float(zz.max())!r}]; the trajectory's end "
        f"in a batch of 32 {float(in_batch)!r} vs alone {float(alone)!r} (rel diff "
        f"{batch_err:.2e}, tolerance {LANDSCAPE_BATCH_RTOL:g}); rounded RD objective {rd!r} "
        f"vs amortized {rd_base!r}; K1 launches {launches}; {secs:.1f} s")
    if not first_equal or rows != LANDSCAPE_ITS // LANDSCAPE_RECORD_EVERY + 1:
        raise AssertionError("sga_landscape: the trajectory does not start at amortized y")
    if not (np.all(np.isfinite(zz)) and np.ptp(zz) > 0):
        raise AssertionError("sga_landscape: the grid objective is not finite or constant")
    if not batch_err <= LANDSCAPE_BATCH_RTOL:
        raise AssertionError("sga_landscape: a grid point in a batch differs from alone")
    if not rd < rd_base:
        raise AssertionError("sga_landscape: SGA did not lower the RD objective")
    if launches < 3 * LANDSCAPE_ITS:
        raise AssertionError(f"K1 launched {launches} times on sga_landscape")

    crop = photos[:1, 100:164, 200:264]
    rng = np.random.default_rng(16)
    y0c, z0c = LatentOptimizer(model_cpu, "cpu").amortized_init(crop)
    draws = {(it, name): rng.gumbel(size=(*v.shape, 2)).astype(np.float32)
             for it in range(LANDSCAPE_CROP_ITS) for name, v in (("y", y0c), ("z", z0c))}
    draws.update({(i, "sample"): rng.gumbel(size=(2, 2)).astype(np.float32)
                  for i in range(1, LANDSCAPE_CROP_ITS // LANDSCAPE_CROP_RECORD_EVERY + 1)})

    def noise_fn(step, name, shape):
        return torch.from_numpy(draws[(step, name)])

    spec = SGA.replace(iterations=LANDSCAPE_CROP_ITS)
    lands = {dev: sga_landscape.landscape(
        model_cpu if dev == "cpu" else copy.deepcopy(model_cpu).to("cuda"), crop, LMBDA,
        spec, LANDSCAPE_CROP_RECORD_EVERY, LANDSCAPE_CROP_GRID, 1.2, 0, noise_fn, dev)
        for dev in ("cuda", "cpu")}
    g, c = lands["cuda"], lands["cpu"]
    traj_err = rel_err(torch.from_numpy(g["trajectory"]), torch.from_numpy(c["trajectory"]))
    sample_err = float(np.abs(g["samples"] - c["samples"]).max())
    vv1, vv2 = np.meshgrid(g["g1"], g["g2"])
    cpu_grid = sga_landscape.objective_at(
        model_cpu, torch.from_numpy(crop), *(torch.from_numpy(g["result"][k][-1])
                                             for k in ("trajectory_y", "trajectory_z")),
        g["coords"], vv1.ravel(), vv2.ravel(), LMBDA).reshape(vv1.shape)
    grid_err = rel_err(torch.from_numpy(g["objective"]), torch.from_numpy(cpu_grid))
    log(f"sga_landscape (float32): {LANDSCAPE_CROP_ITS} steps on a 64x64 crop recorded every "
        f"{LANDSCAPE_CROP_RECORD_EVERY}, card vs CPU: trajectory rel err {traj_err:.2e}, "
        f"{LANDSCAPE_CROP_GRID}^2 grid rel err {grid_err:.2e} (tolerance "
        f"{METHOD_LOSS_RTOL:g}), samples abs err {sample_err:.2e}; coords card "
        f"{g['coords']}, CPU {c['coords']}")
    if not (traj_err <= METHOD_LOSS_RTOL and grid_err <= METHOD_LOSS_RTOL
            and sample_err <= METHOD_LOSS_RTOL):
        raise AssertionError("sga_landscape: the card disagrees with the CPU on the crop")
    return dict(k1_launches=launches, seconds=secs, steps=LANDSCAPE_ITS, rows=rows,
                coords=list(land["coords"]), moved=[float(m) for m in land["moved"]],
                objective_min=float(zz.min()), objective_max=float(zz.max()),
                in_batch_vs_alone_rel_err=batch_err, rd_objective=rd,
                rd_objective_amortized=rd_base, est_bpp=float(res["est_bpp"].mean()),
                psnr=float(res["psnr"].mean()),
                card_vs_cpu=dict(trajectory_rel_err=traj_err, grid_rel_err=grid_err,
                                 samples_abs_err=sample_err,
                                 coords_equal=g["coords"] == c["coords"]))


def run_diagnose(workdir):
    """(b) diagnose_photos on the photos against nic_tpu's numbers."""
    from nic_tpu_torch.ops import gdn_cuda
    from nic_tpu_torch.tools import diagnose_photos

    out = os.path.join(workdir, "diagnose.json")
    t = time.perf_counter()
    gdn_cuda.launches = 0
    record = diagnose_photos.main([os.path.join(CKPT_DIR, RUN), PHOTOS, "--out", out])
    launches = gdn_cuda.launches
    secs = time.perf_counter() - t
    mean = record["mean"]
    bpp = mean["y_bpp"] + mean["z_bpp"]
    d_bpp = abs(bpp - JAX_AMORTIZED_BPP) / JAX_AMORTIZED_BPP
    d_psnr = abs(mean["psnr"] - JAX_DIAGNOSE["psnr"])
    sig_hi = max(r["sig_hi"] for r in record["rows"])
    log(f"diagnose_photos: mean est. bpp {bpp!r} vs nic_tpu's amortized {JAX_AMORTIZED_BPP!r} "
        f"(rel diff {d_bpp:.2e}, tolerance {BPP_RTOL:g}); mean PSNR {mean['psnr']!r} dB vs "
        f"nic_tpu's script {JAX_DIAGNOSE['psnr']!r} (diff {d_psnr:.2e} dB, tolerance "
        f"{PSNR_ATOL_DB:g}); sig_lo {mean['sig_lo']!r} (nic_tpu {JAX_DIAGNOSE['sig_lo']!r}), "
        f"largest sig_hi {sig_hi!r} (at most {SIG_HI_MAX:g}); K1 launches {launches}; "
        f"{secs:.1f} s")
    if not (d_bpp <= BPP_RTOL and d_psnr <= PSNR_ATOL_DB and sig_hi <= SIG_HI_MAX):
        raise AssertionError("diagnose_photos disagrees with nic_tpu's numbers")
    with open(out) as f:
        if json.load(f) != record:
            raise AssertionError("diagnose_photos' JSON is not its record")
    if launches < 6 * len(record["rows"]):
        raise AssertionError(f"K1 launched {launches} times on diagnose_photos")
    return dict(k1_launches=launches, seconds=secs, est_bpp=bpp, **mean)


def run_demo():
    """(c) the demo at its nf=16, 64x64 configuration."""
    from nic_tpu_torch.ops import gdn_cuda
    from nic_tpu_torch.tools import demo

    t = time.perf_counter()
    gdn_cuda.launches = 0
    out = demo.main(["--steps", str(DEMO_STEPS), "--sga_its", str(DEMO_SGA_ITS)])
    launches = gdn_cuda.launches
    secs = time.perf_counter() - t
    amortized, sga = out["amortized"], out["sga"]
    log(f"demo: {out['steps']} training steps; amortized {amortized['actual_bpp']!r} bpp "
        f"actual, RD objective {amortized['rd_objective']!r}; SGA {sga['actual_bpp']!r} bpp "
        f"actual, RD objective {sga['rd_objective']!r}; both streams exact "
        f"{out['streams_exact']}; K1 launches {launches}; {secs:.1f} s")
    if not (out["streams_exact"] and sga["rd_objective"] < amortized["rd_objective"]):
        raise AssertionError("demo: a stream was not exact or SGA did not improve")
    if out["steps"] != DEMO_STEPS or launches < 6 * DEMO_STEPS + 3 * DEMO_SGA_ITS:
        raise AssertionError(f"demo: {out['steps']} steps, K1 launched {launches} times")
    out.pop("train_losses")
    return dict(k1_launches=launches, seconds=secs, **out)


def run_last_scripts(model_cpu, model_bf16_cpu, workdir):
    """Phase 16: K1 at the paths' new shapes (``check_k1_last_scripts``), then
    (a) ``run_landscape``, (b) ``run_diagnose``, (c) ``run_demo``. Returns
    (K1's table, its largest float32 error, the paths)."""
    k1_table, k1_max_abs = check_k1_last_scripts()
    paths = dict(sga_landscape=run_landscape(model_cpu, model_bf16_cpu),
                 diagnose_photos=run_diagnose(workdir), demo=run_demo())
    return k1_table, k1_max_abs, paths


def kernel_row(name, source, replaces, launches, max_abs, row, library, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=max_abs, ms=row["ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"],
                library=library, **extra)


def build_all():
    """Build every native library from the checkout, the compilers started
    together."""
    from nic_tpu_torch.ops.build import build_libraries

    sources = ("gdn.cu", "convt_igdn.cu", "rans.cpp")
    t = time.perf_counter()
    libs = build_libraries(sources, force=True)
    log(f"build: nvcc (gdn.cu, convt_igdn.cu) and g++ (rans.cpp), run together, "
        f"took {time.perf_counter() - t:.2f} s")
    for source, lib in zip(sources, libs):
        log(f"build: {os.path.relpath(lib, ROOT)}")
        # One line per kernel: its (mangled) name, registers and spills. The
        # shared memory is dynamic, sized at launch (see each source).
        entry, spills = None, ""
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "spill" in line:
                spills = line.split(":", 1)[-1].strip()
            elif "Used" in line and "registers" in line:
                log(f"build: ptxas ({source}) {entry}: {line.split(':', 1)[-1].strip()}; "
                    f"{spills}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from nic_tpu_torch import config
    from nic_tpu_torch.checkpoint import load_model
    from nic_tpu_torch.tools.profile_train import write_photo_corpus

    config.set_fp32_precision()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} x{count}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    build_all()
    log(f"bounds: {BOUND_DEFINITION}")

    k1_max_abs = check_k1()
    k1_timings = time_k1()
    log("K1 checked and timed")

    _, model_cpu = load_model(CKPT_DIR, RUN, 192, "cpu")
    amortized = check_amortized(model_cpu)
    log("amortized forward checked")

    workdir = tempfile.mkdtemp(prefix="nic_tpu_torch_smoke_")
    try:
        k1_launches, sga_path = run_main_path(amortized, workdir)
        log("main path done")

        layers = gs_layers(model_cpu)
        k2_max_abs = check_k2(layers)
        k2_timings = time_k2(layers)
        k2_launches, k2_path = run_k2_path(layers)
        del layers
        torch.cuda.empty_cache()
        log("K2 checked, timed and driven")

        mbt2018_path = run_bitstreams(workdir)
        log("bitstreams done")

        _, model_bf16 = load_model(CKPT_DIR, RUN, 192, "cpu", compute_dtype=torch.bfloat16)
        amortized_bf16, k1_bf16_model_abs = check_bf16_amortized(model_bf16)
        log("bf16 amortized forward checked")
        k1_bf16_launches, bf16_path = run_bf16_sga(model_bf16, amortized_bf16,
                                                   sga_path["ms_per_step"])
        log("bf16 sga done")

        method_paths = run_methods(amortized, workdir)
        method_errs = check_methods_card_vs_cpu(model_cpu)
        for script, err in method_errs.items():
            method_paths[script]["card_vs_cpu_loss_rel_err"] = err
        log("methods done")

        t = time.perf_counter()
        bb_paths = run_bits_back(workdir)
        bb_errs = check_bb_card_vs_cpu()
        bb_paths["bb_sga"].update(card_vs_cpu_loss_rel_err=bb_errs)
        log(f"bits-back done in {time.perf_counter() - t:.1f} s")

        t = time.perf_counter()
        k1_train, k1_train_max_abs = check_k1_train()
        photos_dir = os.path.join(workdir, "train_photos")
        os.makedirs(photos_dir)
        photos_glob = write_photo_corpus(photos_dir)
        train_path = run_training(workdir, photos_glob)
        train_path["card_vs_cpu"] = check_train_card_vs_cpu(
            "mbt2018", os.path.join(CKPT_DIR, RUN), workdir)
        train_path["k1_forward_and_backward_rel_err"] = k1_train
        train_path["served"] = run_trained_serving(workdir, photos_glob, amortized,
                                                   mbt2018_path)
        train_bb_path = run_bb_training(workdir, photos_glob)
        train_bb_path["card_vs_cpu"] = check_train_card_vs_cpu(
            "mbt2018_bb", os.path.join(CKPT_DIR, BB_RUN), workdir)
        prior_path = run_learned_prior(model_cpu, workdir)
        log(f"training done in {time.perf_counter() - t:.1f} s")

        t = time.perf_counter()
        k1_multi, k1_multi_max_abs = check_k1_multi()
        parallel = dict(spatial=check_spatial(model_cpu),
                        dp_inference=check_dp_inference(model_cpu),
                        dp_training=check_dp_training(workdir))
        parallel.update(run_parallel_cli(workdir, os.path.join(photos_dir, "photo_0.png")))
        log(f"multi-GPU done in {time.perf_counter() - t:.1f} s")

        t = time.perf_counter()
        evaluation = run_evaluation(workdir, mbt2018_path)
        log(f"evaluation done in {time.perf_counter() - t:.1f} s")

        t = time.perf_counter()
        int8_variants = run_int8_variants(model_cpu, model_bf16, workdir)
        log(f"int8 and up-sampling variants done in {time.perf_counter() - t:.1f} s")

        t = time.perf_counter()
        k1_last, k1_last_max_abs, last_scripts = run_last_scripts(model_cpu, model_bf16,
                                                                  workdir)
        log(f"last scripts done in {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(workdir)

    k1_row = k1_timings[len(GS_ROWS) - 1]
    k2_row = k2_timings[len(GS_ROWS) - 1]
    kernels = [
        kernel_row(
            "gdn (K1, fused GDN/IGDN)", "nic_tpu_torch/csrc/gdn.cu",
            "nic_tpu/ops/pallas_gdn.py:23", k1_launches,
            max(k1_max_abs, k1_train_max_abs, k1_multi_max_abs, k1_last_max_abs), k1_row,
            "torch.addmm(beta, x^2, gamma), the cuBLAS product at K1's core",
            shape=f"IGDN M={k1_row['rows']} C={CHANNELS} float32",
            shapes=k1_timings + k1_multi + k1_last,
            launches_by_path=dict(
                sga=k1_launches, sga_bf16=k1_bf16_launches,
                **{m: method_paths[m]["k1_launches"] for m in METHODS},
                **{b: bb_paths[b]["k1_launches"] for b in BB_SCRIPTS},
                train=train_path["k1_launches"], train_bb=train_bb_path["k1_launches"],
                spatial_per_rank=[r["k1_launches"] for r in parallel["spatial"]["per_rank"]],
                **{f"dp_inference_{n}_per_rank": [
                    r["k1_launches"] for r in parallel["dp_inference"][n]["per_rank"]]
                   for n in ("nccl_1", "gloo_2")},
                dp_train_nccl_1=parallel["dp_training"]["nccl_1"]["k1_launches"],
                dp_train_gloo_2=parallel["dp_training"]["gloo_2"]["k1_launches"],
                sga_data_parallel=parallel["data_parallel"]["k1_launches"],
                sga_spatial=parallel["spatial_cli"]["k1_launches"],
                **{k: v["k1_launches"] for k, v in evaluation.items()},
                **{f"sga_bf16_quant_{q}": v["k1_launches"]
                   for q, v in int8_variants["sga_bf16"].items()},
                mbt2018_int8_encode=int8_variants["mbt2018_int8"]["k1_launches_encode"],
                **{k: v["k1_launches"] for k, v in last_scripts.items()}),
            max_abs_err_bf16_on_the_model=k1_bf16_model_abs),
        kernel_row(
            "convt_igdn (K2, fused 5x5 up-conv + IGDN)", "nic_tpu_torch/csrc/convt_igdn.cu",
            "nic_tpu/ops/pallas_convt.py:67", k2_launches, k2_max_abs, k2_row,
            "torch.nn.functional.conv_transpose2d, cuDNN's product at K2's core",
            shape=f"IGDN {k2_row['shape']} float32", shapes=k2_timings),
    ]
    paths = {"sga": sga_path, "mbt2018": mbt2018_path,
             "exp_fused_convt bench + fused_synthesis_layer": k2_path,
             "sga bf16 (LatentOptimizer)": bf16_path,
             "bf16 amortized": dict(est_bpp=float(amortized_bf16["est_bpp"].mean()),
                                    psnr=float(amortized_bf16["psnr"].mean())),
             **method_paths, **bb_paths, "train": train_path, "train_bb": train_bb_path,
             "learned_prior": prior_path, **parallel, **evaluation,
             "int8 and up-sampling variants": int8_variants, **last_scripts}
    log(f"all phases passed in {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": kernels, "paths": paths}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
