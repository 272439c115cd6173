"""Image quality metrics: PSNR and multi-scale SSIM
(counterpart of nic_tpu/evaluation/metrics.py).

The TF defaults the reference relies on: 11x11 Gaussian window (sigma 1.5),
k1=.01, k2=.03, 5 scales with the Wang et al. power factors, VALID
filtering, symmetric-pad + 2x2 average-pool downsampling. NHWC in, fp32.
"""

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def psnr(a, b, max_val: float = 255.0):
    """Per-image PSNR over [N,H,W,C] batches (tf.image.psnr)."""
    mse = torch.mean(torch.square(a - b), dim=(1, 2, 3))
    return 10.0 * torch.log10(max_val ** 2 / mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    kernel2d = np.outer(g, g)
    return (kernel2d / kernel2d.sum()).astype(np.float32)


def _depthwise_filter(x, kernel2d):
    """VALID depthwise 2-D filtering; x is NCHW."""
    c = x.shape[1]
    k = torch.as_tensor(kernel2d, device=x.device)[None, None].expand(c, 1, -1, -1)
    return F.conv2d(x, k, groups=c)


def _ssim_per_channel(a, b, max_val: float, filter_size: int = 11,
                      filter_sigma: float = 1.5, k1: float = 0.01,
                      k2: float = 0.03) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ssim, cs) averaged over space, per [N, C]; a and b are NCHW."""
    kernel = _gaussian_kernel(filter_size, filter_sigma)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2

    mu_a = _depthwise_filter(a, kernel)
    mu_b = _depthwise_filter(b, kernel)
    mu_aa = _depthwise_filter(a * a, kernel)
    mu_bb = _depthwise_filter(b * b, kernel)
    mu_ab = _depthwise_filter(a * b, kernel)

    var_a = mu_aa - mu_a * mu_a
    var_b = mu_bb - mu_b * mu_b
    cov = mu_ab - mu_a * mu_b

    luminance = (2.0 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)
    cs = (2.0 * cov + c2) / (var_a + var_b + c2)
    ssim = torch.mean(luminance * cs, dim=(2, 3))
    cs = torch.mean(cs, dim=(2, 3))
    return ssim, cs


def _pad_to_even_and_downsample(x):
    """Symmetric-pad H,W to even, then 2x2 average pool; x is NCHW."""
    ph, pw = x.shape[2] % 2, x.shape[3] % 2
    if ph or pw:
        # A one-pixel symmetric pad repeats the edge.
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    return F.avg_pool2d(x, 2)


def msssim(a, b, max_val: float = 255.0):
    """Multi-scale SSIM per image over [N,H,W,C] (tf.image.ssim_multiscale).

    Requires H, W >= 11 * 2^4 = 176 for the 5 scales.
    """
    a = a.permute(0, 3, 1, 2)
    b = b.permute(0, 3, 1, 2)
    weights = torch.tensor(_MSSSIM_WEIGHTS, device=a.device)
    mcs = []
    ssim = None
    for i in range(len(_MSSSIM_WEIGHTS)):
        if i > 0:
            a = _pad_to_even_and_downsample(a)
            b = _pad_to_even_and_downsample(b)
        ssim, cs = _ssim_per_channel(a, b, max_val)
        mcs.append(torch.relu(cs))
    mcs_stack = torch.stack(mcs[:-1], dim=-1)  # [N, C, scales-1]
    value = torch.prod(mcs_stack ** weights[:-1], dim=-1) * (
        torch.relu(ssim) ** weights[-1]
    )
    return torch.mean(value, dim=-1)  # mean over channels -> [N]


def msssim_db(msssim_val):
    """-10 log10(1 - msssim)."""
    return -10.0 * torch.log10(1.0 - msssim_val)
