"""nic_tpu_torch: the PyTorch + CUDA port of nic_tpu for NVIDIA Hopper.

A second package beside the JAX reference (``nic_tpu``), with module names
that mirror it. It trains the MBT2018 (mean-scale hyperprior) and bits-back
models (``train/``), runs the paper's flagship workload,
``python -m nic_tpu_torch sga compress`` (amortized inference followed by
stochastic Gumbel annealing of the latents), the other inference methods
and the bits-back family, and writes and reads real rANS and BB-ANS
streams, with every GDN/IGDN evaluated by a hand-written CUDA kernel
(``ops/gdn_cuda.py``, ``csrc/gdn.cu``) on the card.

The package imports torch, numpy and PIL only; never jax, never nic_tpu.
Tensors keep nic_tpu's NHWC layout at public functions.
"""

__version__ = "0.1.0"
