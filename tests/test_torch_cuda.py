"""The port's CUDA kernels against their plain versions, on the card.

Imports neither jax nor nic_tpu, so it runs where only torch is installed:

  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test skips but those of the build rules (the g++
build of the rANS coder, the rebuild rule, the package data), which need no
card. Tolerances, max-norm relative: float32 1e-5 (fp32
accumulation in another order), bfloat16 2e-2 (output rounding; the plain
version runs in fp32 on the same bf16 inputs).
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
@pytest.mark.parametrize("rows", [31, 33, 127, 129, 16897])
@pytest.mark.parametrize("channels", [3, 16, 24, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_kernel_at_tile_edges(rows, channels, dtype, inverse):
    """Rows at the edges of the kernel's row tiles (32 in fp32, 128 in bf16)
    and more tiles than SMs (each persistent block takes several); C under,
    at and over the 64-wide padding, rows of 6 bytes (staged element by
    element) and C = 256 (two blocks along the columns)."""
    _need_card()
    x, beta, gamma, _ = _inputs(rows, channels, seed=rows + channels)
    xk, gk = x.to(dtype), gamma.to(dtype)
    out = gdn_cuda.gdn_forward_kernel(xk, gk, beta, inverse)
    ref = gdn_cuda.gdn_reference(xk.float(), beta, gk.float(), inverse)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gdn_kernel_on_a_view_off_16_byte_alignment(dtype):
    """x one element past an aligned address: the kernel stages it element
    by element instead of by 16-byte copies."""
    _need_card()
    x, beta, gamma, _ = _inputs(300, 192, seed=9)
    buf = torch.empty(300 * 192 + 1, dtype=dtype, device="cuda")
    xv = buf[1:].view(300, 192)
    xv.copy_(x.to(dtype))
    out = gdn_cuda.gdn_forward_kernel(xv, gamma.to(dtype), beta, True)
    ref = gdn_cuda.gdn_reference(xv.float(), beta, gamma.to(dtype).float(), True)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= RTOL[dtype]


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


# K2, the fused transposed conv + (I)GDN, against its plain version. The
# plain version runs K2's own formulation in float32 on the same inputs, so
# float32 differs only in summation order (1e-5 max-norm relative) and
# bfloat16 only in the output rounding (2e-2, the same few-ulp bound as K1).
def _k2_inputs(shape, co, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, h, w, c = shape
    x = torch.randn(n, h, w, c, device="cuda", generator=gen)
    wt = 0.05 * torch.randn(5, 5, c, co, device="cuda", generator=gen)
    bias = 0.1 * torch.randn(co, device="cuda", generator=gen)
    beta = 0.5 + torch.rand(co, device="cuda", generator=gen)
    gamma = 0.05 * torch.rand(co, co, device="cuda", generator=gen)
    return x, wt, bias, beta, gamma


@pytest.mark.cuda
@pytest.mark.parametrize("shape,co", [((2, 16, 24, 192), 192), ((3, 13, 9, 192), 192),
                                      ((1, 7, 5, 40), 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inverse", [True, False])
def test_convt_igdn_kernel_matches_plain_version(shape, co, dtype, inverse):
    _need_card()
    from nic_tpu_torch.ops import convt_igdn

    x, w, bias, beta, gamma = _k2_inputs(shape, co, seed=2)
    x, w = x.to(dtype), w.to(dtype)
    before = convt_igdn.launches
    out = convt_igdn.conv_transpose_igdn_up2(x, w, bias, beta, gamma, inverse)
    assert convt_igdn.launches == before + 1
    ref = convt_igdn.conv_transpose_igdn_up2_plain(x, w, bias, beta, gamma, inverse)
    torch.cuda.synchronize()
    n, h, wd, _ = shape
    assert out.shape == ref.shape == (n, 2 * h, 2 * wd, co) and out.dtype == dtype
    assert _rel(out, ref) <= RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,co", [((1, 8, 8, 32), 32), ((1, 9, 15, 24), 64),
                                      ((1, 66, 65, 64), 64), ((1, 5, 6, 20), 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inverse", [True, False])
def test_convt_igdn_kernel_at_tile_edges(shape, co, dtype, inverse):
    """One whole 64-pixel tile; 135 pixels (ragged 64- and 128-pixel tiles);
    a grid large enough for the 128-pixel blocks; rows of 40 bytes (bf16,
    staged and stored element by element)."""
    _need_card()
    from nic_tpu_torch.ops import convt_igdn

    x, w, bias, beta, gamma = _k2_inputs(shape, co, seed=11)
    x, w = x.to(dtype), w.to(dtype)
    out = convt_igdn.conv_transpose_igdn_up2(x, w, bias, beta, gamma, inverse)
    ref = convt_igdn.conv_transpose_igdn_up2_plain(x, w, bias, beta, gamma, inverse)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and _rel(out, ref) <= RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_synthesis_layer_backward_on_the_card(dtype):
    """The kernel's forward with the composite's gradients: every gradient
    equals the composite's own autograd (it is the same computation), and
    the forward agrees with the composite (bfloat16: the composite also
    rounds gamma and the conv output to bfloat16); cuDNN's backward may sum
    in another order from call to call, hence the same tolerances as the
    forward."""
    _need_card()
    from nic_tpu_torch import config
    from nic_tpu_torch.ops import convt_igdn

    config.set_fp32_precision()  # the composite's cuDNN conv in full fp32
    x, w, bias, beta, gamma = _k2_inputs((2, 9, 11, 64), 64, seed=3)
    x = x.to(dtype)
    args = [t.clone().requires_grad_(True) for t in (x, w, bias, beta, gamma)]
    ref_args = [t.clone().requires_grad_(True) for t in (x, w, bias, beta, gamma)]
    out = convt_igdn.fused_synthesis_layer(*args)
    ref = convt_igdn.conv_transpose_igdn_up2_reference(*ref_args)
    g = torch.randn(out.shape, device="cuda").to(dtype)
    grads = torch.autograd.grad(out, args, g)
    ref_grads = torch.autograd.grad(ref, ref_args, g)
    assert _rel(out, ref) <= {torch.float32: 1e-5, torch.bfloat16: 3e-2}[dtype]
    for got, want in zip(grads, ref_grads):
        assert got.dtype == want.dtype
        assert _rel(got, want) <= RTOL[dtype]


@pytest.mark.cuda
def test_convt_igdn_kernel_refuses_what_it_does_not_take():
    _need_card()
    from nic_tpu_torch.ops import convt_igdn

    x, w, bias, beta, gamma = _k2_inputs((1, 4, 4, 16), 200, seed=4)
    with pytest.raises(ValueError, match="at most"):
        convt_igdn.convt_igdn_forward_kernel(x, w, bias, beta, gamma, True)
    x, w, bias, beta, gamma = _k2_inputs((1, 4, 4, 16), 16, seed=4)
    with pytest.raises(TypeError):
        convt_igdn.convt_igdn_forward_kernel(x.half(), w.half(), bias, beta, gamma, True)
    with pytest.raises(ValueError, match="contiguous"):
        convt_igdn.convt_igdn_forward_kernel(
            x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3), w, bias, beta,
            gamma, True)
    with pytest.raises(ValueError, match="w must be"):
        convt_igdn.convt_igdn_forward_kernel(x, w.bfloat16(), bias, beta, gamma, True)


def test_rans_library_builds_with_gxx_into_the_build_directory():
    """The host route of ops/build.py: g++ builds csrc/rans.cpp into _build/
    (runs wherever g++ is, card or not), and this build leaves no temporary
    file behind (other processes, such as other test workers, may be building
    the same library at the same time under their own temporary names)."""
    import os
    import shutil

    from nic_tpu_torch.ops.build import BUILD_DIR, CSRC_DIR, build_library

    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    lib = build_library("rans.cpp", force=True)
    assert lib == BUILD_DIR / "librans.so" and lib.exists()
    assert not (CSRC_DIR / "librans.so").exists()
    assert not any(p.name.endswith(f".{os.getpid()}.tmp") for p in BUILD_DIR.iterdir())
    assert os.access(lib, os.R_OK)


def test_build_staleness_covers_shared_headers(tmp_path, monkeypatch):
    """A CUDA library is rebuilt when its source or any shared header
    csrc/*.cuh is newer than it; a host (.cpp) library only for its source."""
    import os

    from nic_tpu_torch.ops import build

    csrc, out = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    out.mkdir()
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    for name in ("k.cu", "tc_tile.cuh", "h.cpp"):
        (csrc / name).write_text("")
    assert build.is_stale("k.cu") and build.is_stale("h.cpp")  # nothing built yet
    lib_cu, lib_cpp = build.library_path("k.cu"), build.library_path("h.cpp")

    def at(path, t):
        path.touch()
        os.utime(path, (t, t))

    for path in (csrc / "k.cu", csrc / "h.cpp", csrc / "tc_tile.cuh"):
        at(path, 100)
    at(lib_cu, 200)
    at(lib_cpp, 200)
    assert not build.is_stale("k.cu") and not build.is_stale("h.cpp")
    at(csrc / "tc_tile.cuh", 300)
    assert build.is_stale("k.cu") and not build.is_stale("h.cpp")
    at(lib_cu, 400)
    assert not build.is_stale("k.cu")
    at(csrc / "k.cu", 500)
    assert build.is_stale("k.cu")


def test_kernel_variant_edits_match_the_sources():
    """Every ablation of tools/kernel_variants.py edits the current sources
    (an edit whose text is gone would make the tool fail on the card)."""
    from nic_tpu_torch.ops.build import CSRC_DIR
    from nic_tpu_torch.tools import kernel_variants

    base = {p.name: p.read_text() for p in CSRC_DIR.iterdir() if p.is_file()}
    for variant, edits in kernel_variants.VARIANTS.items():
        texts = kernel_variants.edited_sources(edits)
        assert (texts == base) == (variant == "base"), variant
        assert kernel_variants.sources_of(variant), variant


def test_package_data_ships_every_kernel_source():
    """pyproject.toml's package data names every file under csrc/, shared
    headers included, so an installed package can build its kernels."""
    import fnmatch
    import os
    import tomllib

    from nic_tpu_torch.ops.build import CSRC_DIR

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"]["nic_tpu_torch"]
    names = sorted(p.name for p in CSRC_DIR.iterdir() if p.is_file())
    assert any(n.endswith(".cuh") for n in names)
    for name in names:
        assert any(fnmatch.fnmatch(f"csrc/{name}", pat) for pat in patterns), name


@pytest.mark.cuda
@pytest.mark.parametrize("parallel", [False, True])
def test_codec_roundtrip_on_the_card(parallel):
    """HyperpriorCodec on the card: a 64x64 crop of the photos through the
    committed nf=192 checkpoint decodes exactly to the compress side's
    pixels, which are the eval forward's reconstruction PNG-quantized."""
    _need_card()
    import os

    import numpy as np

    from nic_tpu_torch.checkpoint import load_model
    from nic_tpu_torch.coding.codec import HyperpriorCodec

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _, model = load_model(os.path.join(root, "checkpoints_synth3"),
                          "mbt2018-num_filters=192-lmbda=0.01", 192, "cuda")
    x = np.load(os.path.join(root, "data_real", "eval_photos.npy"))[:2, 100:164, 200:264]
    x = x.astype(np.float32) / 255.0
    codec = HyperpriorCodec(model, "cuda")
    blob, out = codec.compress(x, parallel=parallel)
    x_hat = codec.decompress(blob)
    np.testing.assert_array_equal(np.round(x_hat * 255.0).astype(np.uint8), out["pixels"])
    ref = np.clip(out["x_tilde"].cpu().numpy(), 0.0, 1.0)
    assert np.abs(x_hat - ref).max() <= 0.5 / 255.0 + 1e-6


def _committed_model(device, dtype=torch.float32):
    import os

    from nic_tpu_torch.checkpoint import load_model

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _, model = load_model(os.path.join(root, "checkpoints_synth3"),
                          "mbt2018-num_filters=192-lmbda=0.01", 192, device,
                          compute_dtype=dtype)
    return model


def _photo_crops(h=64, w=64):
    import os

    import numpy as np

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    x = np.load(os.path.join(root, "data_real", "eval_photos.npy"))
    return x[:2, 100:100 + h, 200:200 + w].astype(np.float32) / 255.0


@pytest.mark.cuda
def test_k1_bf16_on_the_model_gdn_layers():
    """The bf16 model's six GDN and IGDN layers run K1's bf16 route, and K1
    agrees with its plain version on the inputs the model gives it."""
    _need_card()
    from nic_tpu_torch.models.layers import GDN

    model = _committed_model("cuda", torch.bfloat16)
    seen = []
    for m in model.modules():
        if isinstance(m, GDN):
            m.register_forward_pre_hook(lambda mod, args: seen.append((mod, args[0])))
    x = torch.from_numpy(_photo_crops(128, 128)).to("cuda")
    before = gdn_cuda.launches
    with torch.no_grad():
        model(x)
        assert gdn_cuda.launches == before + 6 and len(seen) == 6
        for mod, xg in seen:
            assert xg.dtype == torch.bfloat16
            beta, gamma = mod.effective_params()
            out = gdn_cuda.gdn_kernel(xg, beta, gamma, mod.inverse)
            ref = gdn_cuda.gdn_reference(xg, beta, gamma, mod.inverse)
            torch.cuda.synchronize()
            assert _rel(out, ref) <= RTOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["map", "ste", "unoise", "danneal"])
def test_method_first_steps_card_vs_cpu(method):
    """Each method's first 20 steps on 64x64 crops, early stop off: the
    card's loss of every step against the port's CPU path within 1e-3
    (fp32 sums in another order, carried through 20 Adam steps); unoise gets
    the same uniform draws on both."""
    _need_card()
    import numpy as np

    from nic_tpu_torch.infer.engine import LatentOptimizer
    from nic_tpu_torch.infer.methods import get_method

    x = _photo_crops()
    cpu = LatentOptimizer(_committed_model("cpu"), "cpu")
    card = LatentOptimizer(_committed_model("cuda"), "cuda")
    y0, z0 = cpu.amortized_init(x)
    rng = np.random.default_rng(1)
    draws = {(it, n): torch.from_numpy(rng.uniform(-0.5, 0.5, v.shape).astype(np.float32))
             for it in range(20) for n, v in (("y", y0), ("z", z0))}
    fn = (lambda step, name, shape: draws[(step, name)]) if method == "unoise" else None
    spec = get_method(method).replace(iterations=20, early_stop=False)
    r_c = cpu.optimize(x, 0.01, method=spec, seed=0, noise_fn=fn)
    r_g = card.optimize(x, 0.01, method=spec, seed=0, noise_fn=fn)
    assert np.max(np.abs(r_g["losses"] - r_c["losses"]) / np.abs(r_c["losses"])) <= 1e-3


def _committed_bb_model(device):
    import os

    from nic_tpu_torch.checkpoint import load_model

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _, model = load_model(os.path.join(root, "checkpoints_synth3"),
                          "mbt2018_bb-num_filters=192-lmbda=0.01", 192, device,
                          model="mbt2018_bb")
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("chained", [True, False])
def test_bb_roundtrip_on_the_card(chained):
    """BB-ANS on the card: bb_plain's stream and a bb_no_sga-optimized
    posterior's stream of two 64x64 photo crops decode exactly to the
    encoder's pixels, with the initial bits back, and g_s runs K1."""
    _need_card()
    import numpy as np

    from nic_tpu_torch.coding.bb_codec import BitsBackCodec
    from nic_tpu_torch.infer.bb import BB_NO_SGA, BBLatentOptimizer

    x = _photo_crops()
    model = _committed_bb_model("cuda")
    codec = BitsBackCodec(model, "cuda")
    before = gdn_cuda.launches
    blob, info = codec.compress(x, seed=1, chained=chained)
    assert gdn_cuda.launches >= before + 3 + 2 * 3
    pixels = codec.last_pixels
    x_hat, init_ok = codec.decompress(blob)
    assert init_ok and 0 < info["net_bpp"] < info["actual_bpp"]
    np.testing.assert_array_equal(np.round(x_hat * 255.0).astype(np.uint8), pixels)

    res = BBLatentOptimizer(model, "cuda").optimize(
        x, 0.01, BB_NO_SGA.replace(rate_iterations=5), seed=0)
    blob, info = codec.compress_optimized(x, res["y"], res["z_mean"], res["z_logvar"],
                                          seed=2, chained=chained)
    pixels = codec.last_pixels
    x_hat, init_ok = codec.decompress_optimized(blob)
    assert init_ok and info["delta_bpp"] > 0
    np.testing.assert_array_equal(np.round(x_hat * 255.0).astype(np.uint8), pixels)


@pytest.mark.cuda
def test_bb_phases_first_steps_card_vs_cpu():
    """bb_sga's first 20 steps of each phase on 64x64 crops, fed the same
    draws: each step's loss on the card against the port's CPU path within
    1e-3 (fp32 sums in another order, carried through 20 Adam steps)."""
    _need_card()
    import numpy as np

    from nic_tpu_torch.infer.bb import BB_SGA, BBLatentOptimizer

    x = _photo_crops()
    rng = np.random.default_rng(2)
    draws = {}

    def noise_fn(step, name, shape):
        if (step, name) not in draws:
            a = rng.gumbel(size=shape) if name == "gumbel" else rng.standard_normal(shape)
            draws[(step, name)] = torch.from_numpy(a.astype(np.float32))
        return draws[(step, name)]

    spec = BB_SGA.replace(rd_iterations=20, rate_iterations=20)
    r_c = BBLatentOptimizer(_committed_bb_model("cpu"), "cpu").optimize(
        x, 0.01, spec, seed=0, noise_fn=noise_fn)
    r_g = BBLatentOptimizer(_committed_bb_model("cuda"), "cuda").optimize(
        x, 0.01, spec, seed=0, noise_fn=noise_fn)
    for k in ("rd_losses", "rate_losses"):
        assert np.max(np.abs(r_g[k] - r_c[k]) / np.abs(r_c[k])) <= 1e-3, k


@pytest.mark.cuda
def test_bb_steps_make_no_host_sync():
    """Three steps of each bits-back phase on the card under
    ``torch.cuda.set_sync_debug_mode("error")``, built from the engine's own
    pieces: a host sync in a step raises."""
    _need_card()
    import numpy as np

    from nic_tpu_torch.infer.adam import adam_init, adam_update
    from nic_tpu_torch.infer.bb import BB_SGA, _rate_loss, _rd_loss
    from nic_tpu_torch.ops.quantize import draw_gumbel
    from nic_tpu_torch.ops.schedules import annealed_temperature

    model = _committed_bb_model("cuda")
    x = torch.from_numpy(_photo_crops()).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        y = model.analyze(x)
        state = [t.clone().requires_grad_(True) for t in (y, *model.hyper_posterior(y))]
    adam = adam_init(state)
    losses = torch.zeros(6, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for it in range(3):
            t = annealed_temperature(it, r=BB_SGA.annealing_rate, ub=BB_SGA.temperature_ub,
                                     scheme=BB_SGA.annealing_scheme, t0=BB_SGA.t0)
            gumbel = draw_gumbel(tuple(y.shape) + (2,), gen, "cuda")
            eps = torch.randn(state[1].shape, generator=gen, device="cuda")
            loss = _rd_loss(model, *state, x, 0.01, t, gumbel, eps)
            adam = adam_update(state, torch.autograd.grad(loss, state), adam, BB_SGA.rd_lr)
            losses[it] = loss.detach()
        y_tilde = torch.round(state[0].detach())
        post = [t.detach().clone().requires_grad_(True) for t in state[1:]]
        adam = adam_init(post)
        for it in range(3):
            eps = torch.randn(post[0].shape, generator=gen, device="cuda")
            loss = _rate_loss(model, y_tilde, *post, eps, 64 * 64)
            adam = adam_update(post, torch.autograd.grad(loss, post), adam, BB_SGA.rate_lr)
            losses[3 + it] = loss.detach()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.all(np.isfinite(losses.cpu().numpy()))


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_kernel_parameter_gradients_through_a_fresh_layer(inverse):
    """K1's forward and its backward's dgamma and dbeta (``gdn_backward``,
    torch matmuls) on the card, through GDN.effective_params at a fresh init
    (gamma's off-diagonals exactly at their bound 2^-18, where the bound
    passes the gradient), at the training step's smallest shape: the
    forward against the plain version within 1e-5 (max-norm relative, fp32
    sums in another order), the gradients against autograd through it
    within 1e-4 of each gradient's L2 norm."""
    _need_card()
    from nic_tpu_torch.models.layers import GDN

    x, _, _, w = _inputs(8192, 192, seed=7)
    layer = GDN(192, inverse=inverse).to("cuda")
    ref = GDN(192, inverse=inverse).to("cuda")
    before = gdn_cuda.launches
    out = layer(x)
    torch.sum(out * w).backward()
    assert gdn_cuda.launches == before + 1
    beta, gamma = ref.effective_params()
    want = gdn_cuda.gdn_reference(x, beta, gamma, inverse)
    torch.sum(want * w).backward()
    assert float((out - want).abs().max() / want.abs().max()) <= 1e-5
    off = ~torch.eye(192, dtype=torch.bool, device="cuda")
    assert bool(torch.all(layer.gamma.detach()[off] == 2.0 ** -18))
    assert int(torch.count_nonzero(layer.gamma.grad[off])) > 0
    for got, want in ((layer.beta.grad, ref.beta.grad), (layer.gamma.grad, ref.gamma.grad)):
        assert float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mbt2018", "mbt2018_bb"])
def test_train_step_card_vs_cpu(model):
    """One optimizer step at nf=16, batch 2, patch 64 from the same init,
    batch and noise: the card's gradients before the step within 1e-4 of
    each leaf's L2 norm and its loss within 1e-5 of the CPU's (fp32 sums in
    another order); its parameters within 2 lr (Adam's near-zero
    gradients) and 1e-2 lr on average over each leaf."""
    _need_card()
    import numpy as np

    from nic_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(model=model, num_filters=16, batchsize=2, patchsize=64)
    rng = np.random.default_rng(3)
    batch = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    first = (rng.uniform(-0.5, 0.5, (2, 1, 1, 16)) if model == "mbt2018"
             else rng.standard_normal((2, 1, 1, 16)))
    noise = tuple(torch.from_numpy(a.astype(np.float32))
                  for a in (first, rng.uniform(-0.5, 0.5, (2, 4, 4, 16))))
    card, cpu = Trainer(cfg, device="cuda"), Trainer(cfg, device="cpu")
    grads = []
    for trainer in (card, cpu):
        x = torch.from_numpy(batch).to(trainer.device).float() / 255.0
        trainer.loss(x, tuple(n.to(trainer.device) for n in noise))[0].backward()
        # The bits-back model's unused quantiles get no gradient.
        grads.append({k: p.grad.detach().cpu().double()
                      for k, p in trainer.model.named_parameters() if p.grad is not None})
        trainer.optimizer.zero_grad(set_to_none=True)
    assert grads[0].keys() == grads[1].keys()
    for k, want in grads[1].items():
        diff = torch.linalg.vector_norm(grads[0][k] - want)
        assert float(diff) <= 1e-4 * float(torch.linalg.vector_norm(want)), k
    before = gdn_cuda.launches
    got = card.train_step(batch, noise)
    assert gdn_cuda.launches == before + 6
    want = cpu.train_step(batch, noise)
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
    a, b = card.params_to_jax(), cpu.params_to_jax()
    for k in b:
        lr = cfg.aux_lr if model == "mbt2018" and k.endswith("quantiles") else cfg.main_lr
        assert np.abs(a[k] - b[k]).max() <= 2 * lr, k
        assert np.abs(a[k] - b[k]).mean() <= 1e-2 * lr, k


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mbt2018", "mbt2018_bb"])
def test_train_steps_make_no_host_sync(model):
    """Training steps on a batch already on the card, under
    ``torch.cuda.set_sync_debug_mode("error")``: the noise, the forward, K1,
    the backward and Adam never wait for the device."""
    _need_card()
    from nic_tpu_torch.train.trainer import TrainConfig, Trainer

    trainer = Trainer(TrainConfig(model=model, num_filters=16, batchsize=2, patchsize=64),
                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = torch.randint(0, 256, (3, 2, 64, 64, 3), dtype=torch.uint8, device="cuda",
                            generator=gen)
    trainer.run_steps(batches[:1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.run_steps(batches)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert trainer.step == 4


def _collectives_rank(rank, device):
    """The collectives of parallel/mesh.Comm on CUDA tensors."""
    import torch.distributed as dist

    from nic_tpu_torch.parallel.mesh import Comm

    comm = Comm(dist.group.WORLD)
    t = torch.full((3,), rank + 1.0, device=device)
    gathered = [g.cpu() for g in comm.all_gather(t)]
    summed = comm.all_reduce(t.clone()).cpu()
    return gathered, summed, t.device.type


@pytest.mark.cuda
def test_gloo_ranks_share_the_card_with_cuda_tensors():
    _need_card()
    from nic_tpu_torch.parallel.mesh import spawn

    for gathered, summed, dev in spawn(_collectives_rank, 2, device="cuda", backend="gloo"):
        assert dev == "cuda"
        assert [g.tolist() for g in gathered] == [[1.0] * 3, [2.0] * 3]
        assert summed.tolist() == [3.0] * 3


@pytest.mark.cuda
def test_nccl_refuses_more_ranks_than_cards(tmp_path, monkeypatch):
    _need_card()
    from nic_tpu_torch.parallel.mesh import init_group, spawn

    count = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="one rank per card"):
        spawn(_collectives_rank, count + 1, device="cuda")
    monkeypatch.setenv("LOCAL_RANK", str(count))
    with pytest.raises(RuntimeError, match="one rank per card"):
        init_group(f"file://{tmp_path}/rendezvous", 2, 1, device="cuda")


def _small_model_state(nf=16):
    from nic_tpu_torch.models.mbt2018 import MeanScaleHyperprior

    model = MeanScaleHyperprior(nf)
    gen = torch.Generator().manual_seed(0)
    for module in model.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(generator=gen)
    return model.state_dict()


def _spatial_rank(rank, device, state, x):
    import torch.distributed as dist

    from nic_tpu_torch.infer.methods import DANNEAL
    from nic_tpu_torch.models.mbt2018 import MeanScaleHyperprior
    from nic_tpu_torch.parallel.spatial import SpatialLatentOptimizer

    model = MeanScaleHyperprior(state["analysis.gdn_0.beta"].shape[0])
    model.load_state_dict(state)
    sp = SpatialLatentOptimizer(model, device, dist.group.WORLD)
    before = gdn_cuda.launches
    y, z = sp.amortized_init(x)
    res = sp.optimize(x, 0.01, DANNEAL.replace(iterations=10))
    return y.cpu(), z.cpu(), res, gdn_cuda.launches - before


@pytest.mark.cuda
def test_spatial_on_the_card_matches_the_unsharded_engine():
    """2 gloo ranks share the card: halo-exchanged g_a and g_s (K1 in their
    GDN and IGDN on each rank) against the unsharded engine on the card;
    the amortized latents within 2e-5, danneal's rounded y 99.9 % equal."""
    _need_card()
    import numpy as np

    from nic_tpu_torch.infer.engine import LatentOptimizer
    from nic_tpu_torch.infer.methods import DANNEAL
    from nic_tpu_torch.models.mbt2018 import MeanScaleHyperprior
    from nic_tpu_torch.parallel.mesh import spawn

    state = _small_model_state()
    x = np.random.default_rng(0).random((1, 128, 192, 3)).astype(np.float32)
    ranks = spawn(_spatial_rank, 2, (state, x), device="cuda", backend="gloo")
    model = MeanScaleHyperprior(16)
    model.load_state_dict(state)
    opt = LatentOptimizer(model, "cuda")
    y, z = (t.cpu() for t in opt.amortized_init(x))
    ref = opt.optimize(x, 0.01, DANNEAL.replace(iterations=10))
    for ys, zs, res, launches in ranks:
        assert float((ys - y).abs().max()) <= 2e-5 and float((zs - z).abs().max()) <= 2e-5
        assert np.mean(res["y"] == ref["y"]) >= 0.999
        np.testing.assert_allclose(res["est_bpp"], ref["est_bpp"], rtol=1e-3)
        assert launches >= 3 * 10


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride,transpose,shape,co", [
    (5, 2, True, (2, 6, 8, 16), 24), (5, 2, True, (1, 3, 5, 12), 20),
    (5, 2, False, (2, 13, 9, 16), 12), (3, 1, False, (2, 7, 8, 16), 24),
    (3, 2, True, (2, 5, 6, 12), 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_conv_on_the_card_equals_the_cpu(k, stride, transpose, shape, co, dtype):
    """The int8 convs (im2col and torch._int_mm, with padded rows and
    channels) on the card equal the CPU path bit for bit: the forward, and
    int8_all's input cotangent of the 5x5 stride-2 up-conv."""
    from nic_tpu_torch.ops import int8conv

    _need_card()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen).to(dtype)
    w = (0.1 * torch.randn(k, k, shape[3], co, generator=gen)).to(dtype)
    want = int8conv.int8_conv(x, w, stride, transpose)
    got = int8conv.int8_conv(x.cuda(), w.cuda(), stride, transpose)
    assert got.is_cuda and torch.equal(got.cpu(), want)
    if transpose and (k, stride) == (5, 2):
        g = torch.randn(want.shape, generator=gen).to(torch.bfloat16)
        assert torch.equal(int8conv.qbwd_x_up2(g.cuda(), w.cuda()).cpu(),
                           int8conv.qbwd_x_up2(g, w))


@pytest.mark.cuda
def test_sga_landscape_on_the_card_matches_the_cpu():
    """tools/sga_landscape on a 64x64 crop with a seeded nf=16 model, fed one
    set of Gumbel draws on both devices: the trajectory, the samples and the
    grid (the card's y*, z*, coordinates and axes evaluated on both) within
    1e-3 (float32 sums in another order through 10 Adam steps, as
    test_method_first_steps_card_vs_cpu); the first row is the amortized y,
    and the recorded run's latents equal an unrecorded run's."""
    _need_card()
    import numpy as np

    from nic_tpu_torch.infer.engine import LatentOptimizer
    from nic_tpu_torch.infer.methods import SGA
    from nic_tpu_torch.models.mbt2018 import MeanScaleHyperprior
    from nic_tpu_torch.tools import sga_landscape

    def model(device):
        m = MeanScaleHyperprior(16)
        m.load_state_dict(_small_model_state(16))
        return m.to(device)

    x = _photo_crops()[:1]
    y0, z0 = LatentOptimizer(model("cpu"), "cpu").amortized_init(x)
    rng = np.random.default_rng(2)
    draws = {(it, n): rng.gumbel(size=(*v.shape, 2)).astype(np.float32)
             for it in range(10) for n, v in (("y", y0), ("z", z0))}
    draws.update({(i, "sample"): rng.gumbel(size=(2, 2)).astype(np.float32)
                  for i in range(1, 6)})

    def noise_fn(step, name, shape):
        return torch.from_numpy(draws[(step, name)])

    spec = SGA.replace(iterations=10)
    lands = {dev: sga_landscape.landscape(model(dev), x, 0.01, spec, 2, 4, 1.2, 0, noise_fn,
                                          dev) for dev in ("cuda", "cpu")}
    g, c = lands["cuda"], lands["cpu"]
    assert _rel(torch.from_numpy(g["trajectory"]), torch.from_numpy(c["trajectory"])) <= 1e-3
    assert np.abs(g["samples"] - c["samples"]).max() <= 1e-3
    np.testing.assert_array_equal(g["result"]["trajectory_y"][0],
                                  LatentOptimizer(model("cuda"), "cuda").amortized_init(x)[0]
                                  .cpu().numpy())
    vv1, vv2 = np.meshgrid(g["g1"], g["g2"])
    star = [torch.from_numpy(g["result"][k][-1]) for k in ("trajectory_y", "trajectory_z")]
    cpu_grid = sga_landscape.objective_at(model("cpu"), torch.from_numpy(x), *star,
                                          g["coords"], vv1.ravel(), vv2.ravel(), 0.01)
    assert _rel(torch.from_numpy(g["objective"].ravel()), torch.from_numpy(cpu_grid)) <= 1e-3
    plain = LatentOptimizer(model("cuda"), "cuda").optimize(x, 0.01, method=spec,
                                                            noise_fn=noise_fn)
    assert not any(k.startswith("trajectory") for k in plain)
    torch.backends.cudnn.deterministic = True
    try:
        rec = LatentOptimizer(model("cuda"), "cuda").optimize(x, 0.01, method=spec,
                                                              noise_fn=noise_fn, record_every=3)
        plain = LatentOptimizer(model("cuda"), "cuda").optimize(x, 0.01, method=spec,
                                                                noise_fn=noise_fn)
    finally:
        torch.backends.cudnn.deterministic = False
    np.testing.assert_array_equal(rec["losses"], plain["losses"])
    np.testing.assert_array_equal(rec["y"], plain["y"])


@pytest.mark.cuda
def test_diagnose_photos_and_demo_on_the_card(tmp_path):
    """diagnose_photos on the card against the CPU (a seeded nf=16 run, two
    crops): every field within 1e-4, the scale shares within 1e-3 (a scale
    at a bound may move across it by an ulp); the demo at a tiny size runs
    on the card with both streams exact."""
    _need_card()
    import json

    import numpy as np

    from nic_tpu_torch.checkpoint import export_params_npz, params_to_jax
    from nic_tpu_torch.tools import demo, diagnose_photos

    run = tmp_path / "mbt2018-num_filters=16-lmbda=0.01"
    run.mkdir()
    export_params_npz(str(run), 0, params_to_jax(_small_model_state(16)))
    (run / "args.json").write_text(json.dumps({"num_filters": 16}))
    np.save(tmp_path / "crops.npy", (_photo_crops(70, 90) * 255).round().astype(np.uint8))
    got = diagnose_photos.main([str(run), str(tmp_path / "crops.npy")])
    ref = diagnose_photos.main([str(run), str(tmp_path / "crops.npy"), "--device", "cpu"])
    for g, r in zip(got["rows"], ref["rows"]):
        assert list(g) == list(r)
        for k in r:
            tol = 1e-3 if k.startswith("sig") else 1e-4
            assert abs(g[k] - r[k]) <= tol * max(abs(r[k]), 1.0), k
    out = demo.main(["--num_filters", "4", "--steps", "5", "--sga_its", "3"])
    assert out["streams_exact"] and out["steps"] == 5
