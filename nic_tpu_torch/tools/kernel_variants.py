"""Ablations of K1 and K2 on the card: variants built from text edits of
the kernels' sources, timed beside the unedited build in one process.

  python -m nic_tpu_torch.tools.kernel_variants [--out kernel_variants.json]

Each variant copies ``csrc/`` to a temporary directory, applies its edits
(each must match its source at least once, else the tool fails),
and is built by nvcc like ``ops/build.py`` builds the real library; all
builds run at once. Then every build is timed at the main path's largest
shapes (K1: IGDN, M = 147456, C = 192; K2: IGDN, the g_s layer (3, 96, 128,
192) and the smallest one, (3, 24, 32, 192)), in float32 and bfloat16,
with CUDA events over 20 x 5 launches after a warm-up, and its error
against the plain version is printed beside (an ablation that drops work
computes garbage: its error is not a check). The builds are timed in the
order listed, then in reverse, and both times are kept.

What each variant removes or changes says where a kernel's time goes:
``no_mma`` drops the conv / normalizer MMAs, ``no_loads`` K2's cp.async
copies, ``skeleton`` both; ``round_hi`` / ``trunc_hi`` swap the 3xTF32
split's hi rounding; ``lo_unrounded`` leaves lo for the tensor cores to
truncate; ``chain_4`` shortens K1's fp32 MMA chains, ``chain_2`` lengthens
K2's; ``z_stages_3`` gives K2's bf16 route three stages;
``two_blocks_per_sm`` runs K2's build for two blocks per SM on every grid.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

from nic_tpu_torch import config
from nic_tpu_torch.ops import convt_igdn, gdn_cuda
from nic_tpu_torch.ops.build import ARCH_FLAGS, CSRC_DIR, nvcc_path

_SPLIT = ("  hi = kRoundHi ? to_tf32(v) : (__float_as_uint(v) & 0xffffe000u);\n"
          "  lo = to_tf32(v - __uint_as_float(hi));")
_K1_MMA = "for (int k0 = 0; k0 < cp; k0 += C::kKS * Ops::kK)"
_K2_MMA = ("for (int k0 = 0; k0 < C::kChunk; k0 += C::kKS * Ops::kK)\n"
           "        nic_tc::warp_mma_chunk<Ops, kMT, kNT, C::kKS, nic_tc::ASrc::kTile>(")
_K2_A_COPY = "        nic_tc::cp_async16(dst, ok ? src : x, ok);"
_K2_B_COPY = "      nic_tc::cp_async16(bs + kr * kBStride + col, bsrc + kr * kCop + col, true);"

# name -> {source: [(old, new), ...]}; tc_tile.cuh edits apply to both kernels.
VARIANTS = {
    "base": {},
    "no_mma": {"gdn.cu": [(_K1_MMA, _K1_MMA.replace("k0 < cp", "k0 < 0"))],
               "convt_igdn.cu": [(_K2_MMA, _K2_MMA.replace("k0 < C::kChunk", "k0 < 0"))]},
    "no_loads": {"convt_igdn.cu": [(_K2_A_COPY, "        (void)ok;"),
                                   (_K2_B_COPY, "      (void)kr;")]},
    "skeleton": {"convt_igdn.cu": [(_K2_MMA, _K2_MMA.replace("k0 < C::kChunk", "k0 < 0")),
                                   (_K2_A_COPY, "        (void)ok;"),
                                   (_K2_B_COPY, "      (void)kr;")]},
    "round_hi": {"gdn.cu": [("Tf32x3Ops</*kRoundHi=*/false>", "Tf32x3Ops</*kRoundHi=*/true>")]},
    "trunc_hi": {"convt_igdn.cu": [("Tf32x3Ops</*kRoundHi=*/true>",
                                    "Tf32x3Ops</*kRoundHi=*/false>")]},
    "lo_unrounded": {"tc_tile.cuh": [(_SPLIT, _SPLIT.replace(
        "lo = to_tf32(v - __uint_as_float(hi));",
        "lo = __float_as_uint(v - __uint_as_float(hi));"))]},
    "chain_4": {"gdn.cu": [("kKS = kBf16 ? 2 : 8;", "kKS = kBf16 ? 2 : 4;")]},
    "z_stages_3": {"convt_igdn.cu": [("kStages = kBf16 ? 4 : 3;", "kStages = 3;")]},
    "chain_2": {"convt_igdn.cu": [("kKS = kBf16 ? 2 : 1;", "kKS = 2;")]},
    "two_blocks_per_sm": {"convt_igdn.cu": [("  if (blocks <= 2LL * sms)\n", "  if (false)\n")]},
}
SOURCES = ("gdn.cu", "convt_igdn.cu")


def edited_sources(edits, csrc=CSRC_DIR):
    """The csrc/ texts with a variant's edits applied; raises if an edit's
    text is not in its source."""
    texts = {p.name: p.read_text() for p in csrc.iterdir() if p.is_file()}
    for name, subs in edits.items():
        for old, new in subs:
            if old not in texts[name]:
                raise ValueError(f"{name}: edit does not match: {old[:60]!r}")
            texts[name] = texts[name].replace(old, new)
    return texts


def sources_of(variant):
    """The kernel sources a variant's edits reach (all for the base build
    and for edits of the shared header)."""
    edits = VARIANTS[variant]
    if variant == "base" or "tc_tile.cuh" in edits:
        return SOURCES
    return tuple(s for s in SOURCES if s in edits)


def build_variants(workdir):
    """{(variant, source): ctypes library}, all nvcc runs started at once."""
    jobs = []
    for variant, edits in VARIANTS.items():
        d = os.path.join(workdir, variant)
        os.makedirs(d)
        for name, text in edited_sources(edits).items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        for source in sources_of(variant):
            out = os.path.join(d, f"lib_{source}.so")
            cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
                   "-fPIC", "-o", out, os.path.join(d, source)]
            jobs.append((variant, source, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for variant, source, out, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{variant}/{source} failed to build:\n{log}")
        lib = ctypes.CDLL(out)
        if source == "gdn.cu":
            lib.nic_gdn_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
        else:
            lib.nic_convt_igdn_forward.argtypes = [*([ctypes.c_void_p] * 6),
                                                   *([ctypes.c_int] * 9), ctypes.c_void_p]
        libs[variant, source] = lib
    return libs


def time_ms(fn, reps=20, outer=5):
    def many():
        for _ in range(reps):
            fn()
    many()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(outer):
        many()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * outer)


def k1_cases(gen):
    c = 192
    x = 2.0 * torch.randn(147456, c, device="cuda", generator=gen)
    gamma = 0.1 * torch.eye(c, device="cuda") + 0.01 * torch.rand(c, c, device="cuda",
                                                                   generator=gen)
    beta = 1.0 + 0.1 * torch.rand(c, device="cuda", generator=gen)
    for dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        xk, gk = x.to(dt), gamma.to(dt)
        ref = gdn_cuda.gdn_reference(xk.float(), beta, gk.float(), True)
        out = torch.empty_like(xk)

        def run(lib, xk=xk, gk=gk, beta=beta, out=out, code=code):
            err = lib.nic_gdn_forward(xk.data_ptr(), gk.data_ptr(), beta.data_ptr(),
                                      out.data_ptr(), xk.shape[0], xk.shape[1], 1, code,
                                      torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"K1 variant launch failed: cudaError {err}")
        yield f"K1 IGDN M=147456 {dt}", "gdn.cu", run, out, ref


def k2_cases(gen):
    for shape in ((3, 96, 128, 192), (3, 24, 32, 192)):
        n, h, w, c = shape
        x = torch.randn(*shape, device="cuda", generator=gen)
        wt = 0.05 * torch.randn(5, 5, c, c, device="cuda", generator=gen)
        bias = 0.1 * torch.randn(c, device="cuda", generator=gen)
        beta = 0.5 + torch.rand(c, device="cuda", generator=gen)
        gamma = 0.05 * torch.rand(c, c, device="cuda", generator=gen)
        for dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            xk, wk = x.to(dt), wt.to(dt)
            ref = convt_igdn.conv_transpose_igdn_up2_plain(xk, wk, bias, beta, gamma, True)
            wp, gp = convt_igdn.pack_weights(wk, dt), convt_igdn.pack_gamma(gamma, dt)
            out = torch.empty(ref.shape, dtype=dt, device="cuda")

            def run(lib, xk=xk, wp=wp, bias=bias, beta=beta, gp=gp, out=out, code=code):
                n, h, w, c = xk.shape
                err = lib.nic_convt_igdn_forward(
                    xk.data_ptr(), wp.data_ptr(), bias.data_ptr(), beta.data_ptr(),
                    gp.data_ptr(), out.data_ptr(), n, h, w, c, wp.shape[0] // 25, c,
                    gp.shape[0], 1, code, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"K2 variant launch failed: cudaError {err}")
            yield f"K2 IGDN {shape} {dt}", "convt_igdn.cu", run, out, ref


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    config.set_fp32_precision()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    workdir = tempfile.mkdtemp(prefix="nic_kernel_variants_")
    try:
        libs = build_variants(workdir)
        gen = torch.Generator(device="cuda").manual_seed(0)
        table = {}
        for case, source, run, out, ref in [*k1_cases(gen), *k2_cases(gen)]:
            names = [v for v in VARIANTS if source in sources_of(v)]
            row = {}
            for order in (names, names[::-1]):
                for v in order:
                    run(libs[v, source])
                    torch.cuda.synchronize()
                    err = float((out.float() - ref.float()).abs().max() / ref.float().abs().max())
                    ms = time_ms(lambda v=v: run(libs[v, source]))
                    row.setdefault(v, {"ms": [], "rel_err": err})["ms"].append(ms)
            table[case] = row
            print(case + ": " + " | ".join(
                f"{v} {min(r['ms']):.4f} ms ({r['rel_err']:.1e})" for v, r in row.items()),
                flush=True)
    finally:
        shutil.rmtree(workdir)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "cases": table}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
