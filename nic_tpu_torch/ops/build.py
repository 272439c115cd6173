"""Builds the port's CUDA kernels with nvcc at first use.

Each ``csrc/*.cu`` source has a plain C interface and is compiled on its
own into a shared library that ``ctypes`` loads: no PyTorch headers, no
``torch.utils.cpp_extension``, no ninja. A build takes seconds. Libraries go
to ``nic_tpu_torch/_build/`` (listed in .gitignore) and are rebuilt when the
source is newer. A failed build raises with nvcc's output.
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


def build_library(source: str, force: bool = False) -> Path:
    """Path to ``_build/libnic_<stem>.so`` built from ``csrc/<source>``.

    Rebuilds when the library is missing, older than its source, or
    ``force`` is set. nvcc's resource report (``-Xptxas -v``) is kept beside
    the library as ``libnic_<stem>.log``.
    """
    src = CSRC_DIR / source
    lib = BUILD_DIR / f"libnic_{src.stem}.so"
    with _lock:
        if (not force and lib.exists()
                and lib.stat().st_mtime >= src.stat().st_mtime):
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        # Atomic rename: concurrent builders never load a half-written file.
        os.replace(tmp, lib)
    return lib
