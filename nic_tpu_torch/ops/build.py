"""Builds the port's native libraries at first use.

Each ``csrc/*.cu`` source has a plain C interface and is compiled on its
own by nvcc into a shared library that ``ctypes`` loads: no PyTorch
headers, no ``torch.utils.cpp_extension``, no ninja. A build takes seconds.
``csrc/*.cpp`` sources are host code (the rANS coder) and are compiled by
g++ the same way. Libraries go to ``nic_tpu_torch/_build/`` (listed in
.gitignore), never beside their sources, and are rebuilt when the source,
or for a CUDA source one of the shared headers ``csrc/*.cuh``, is newer. A
failed build raises with the compiler's output; the library is written
under a temporary name and renamed into place, so a concurrent reader never
loads half a file. ``build_libraries`` starts one compiler
process per source, all together.
"""

import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()


def nvcc_path() -> str:
    """nvcc on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def library_path(source: str) -> Path:
    """Where the library of ``csrc/<source>`` goes: ``libnic_<stem>.so`` for
    a CUDA source, ``lib<stem>.so`` for a host one."""
    stem = Path(source).stem
    name = f"lib{stem}.so" if source.endswith(".cpp") else f"libnic_{stem}.so"
    return BUILD_DIR / name


def _command(src: Path, out: Path):
    if src.suffix == ".cpp":
        return ["g++", *HOST_FLAGS, "-o", str(out), str(src)]
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out), str(src)]


def is_stale(source: str) -> bool:
    """Whether the library of ``csrc/<source>`` is missing or older than its
    source or, for a CUDA source, than any shared header ``csrc/*.cuh``."""
    lib = library_path(source)
    if not lib.exists():
        return True
    inputs = [CSRC_DIR / source]
    if not source.endswith(".cpp"):
        inputs += sorted(CSRC_DIR.glob("*.cuh"))
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build_libraries(sources, force: bool = False) -> list:
    """Paths to the libraries built from ``csrc/<source>`` for each source.

    Rebuilds a library when ``is_stale`` says so or ``force`` is set; the
    compilers of all the libraries to build run at once. Each compiler's output (for nvcc, ptxas's resource report) is
    kept beside its library as ``<library>.log``.
    """
    libs = [library_path(s) for s in sources]
    with _lock:
        jobs = []
        for source, lib in zip(sources, libs):
            if not force and not is_stale(source):
                continue
            src = CSRC_DIR / source
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = _command(src, tmp)
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((lib, tmp, cmd, proc))
        failures = []
        for lib, tmp, cmd, proc in jobs:
            output = proc.communicate()[0]
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"{cmd[0]} failed to build {Path(cmd[-1]).name} "
                                f"(exit {proc.returncode}):\n{' '.join(cmd)}\n{output}")
                continue
            lib.with_suffix(".log").write_text(output)
            os.replace(tmp, lib)
        if failures:
            raise RuntimeError("\n".join(failures))
    return libs


def build_library(source: str, force: bool = False) -> Path:
    """Path to the library built from ``csrc/<source>`` (see
    ``build_libraries``)."""
    return build_libraries([source], force)[0]
