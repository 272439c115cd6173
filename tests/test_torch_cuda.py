"""The port's CUDA kernels against their plain versions, on the card.

Imports neither jax nor nic_tpu, so it runs where only torch is installed:

  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test skips. Tolerances, max-norm relative: float32
1e-5 (fp32 accumulation in another order), bfloat16 2e-2 (output rounding;
the plain version runs in fp32 on the same bf16 inputs).
"""

import pytest
import torch

from nic_tpu_torch.ops import gdn_cuda
from nic_tpu_torch.ops.gdn import gdn

RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max())


def _inputs(rows, channels, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = 2.0 * torch.randn(rows, channels, device="cuda", generator=gen)
    gamma = 0.1 * torch.eye(channels, device="cuda") + 0.01 * torch.rand(
        channels, channels, device="cuda", generator=gen)
    beta = 1.0 + 0.1 * torch.rand(channels, device="cuda", generator=gen)
    w = torch.randn(rows, channels, device="cuda", generator=gen)
    return x, beta, gamma, w


@pytest.mark.cuda
@pytest.mark.parametrize("rows,channels", [(9217, 192), (37, 16), (512, 256), (1, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_kernel_matches_plain_version(rows, channels, dtype, inverse):
    _need_card()
    x, beta, gamma, w = _inputs(rows, channels)
    xk = x.to(dtype).requires_grad_(True)
    before = gdn_cuda.launches
    out = gdn(xk, beta, gamma, inverse)  # the dispatch takes the kernel
    assert gdn_cuda.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    (dx,) = torch.autograd.grad(torch.sum(out.float() * w), xk)
    xr = xk.detach().float().requires_grad_(True)
    ref = gdn_cuda.gdn_reference(xr, beta, gamma.to(dtype).float(), inverse)
    (dx_ref,) = torch.autograd.grad(torch.sum(ref * w), xr)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= RTOL[dtype]
    assert _rel(dx, dx_ref) <= RTOL[dtype]


@pytest.mark.cuda
def test_gdn_kernel_nhwc_and_parameter_gradients():
    _need_card()
    x, beta, gamma, w = _inputs(2 * 9 * 7, 24, seed=1)
    x4 = x.reshape(2, 9, 7, 24)
    args = [t.clone().requires_grad_(True) for t in (x4, beta, gamma)]
    ref_args = [t.clone().requires_grad_(True) for t in (x4, beta, gamma)]
    out = gdn_cuda.gdn_kernel(args[0], args[1], args[2], True)
    ref = gdn_cuda.gdn_reference(ref_args[0], ref_args[1], ref_args[2], True)
    grads = torch.autograd.grad(torch.sum(out * w.reshape(out.shape)), args)
    ref_grads = torch.autograd.grad(torch.sum(ref * w.reshape(ref.shape)), ref_args)
    assert _rel(out, ref) <= 1e-5
    for g, r in zip(grads, ref_grads):
        assert _rel(g, r) <= 1e-4


@pytest.mark.cuda
def test_gdn_kernel_refuses_what_it_does_not_take():
    _need_card()
    x, beta, gamma, _ = _inputs(64, 300)
    with pytest.raises(ValueError, match="at most"):
        gdn_cuda.gdn_forward_kernel(x, gamma, beta, False)
    x, beta, gamma, _ = _inputs(64, 16)
    with pytest.raises(TypeError):
        gdn_cuda.gdn_forward_kernel(x.half(), gamma.half(), beta, False)
    with pytest.raises(ValueError, match="contiguous"):
        gdn_cuda.gdn_forward_kernel(x.t().contiguous().t(), gamma, beta, False)
