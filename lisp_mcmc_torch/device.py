"""Device resolution and the hand-written CUDA kernels' build.

Two jobs, both kept out of import time so the package imports on a
machine with no GPU, no CUDA toolkit and no Triton:

- :func:`resolve_device` turns a user's ``device=`` into a
  ``torch.device``.  ``None`` means the GPU; without one it raises
  instead of quietly running on the CPU.
- :func:`load_library` compiles a ``csrc/*.cu`` file with ``nvcc`` for
  ``sm_90a`` into a shared library with a plain C interface and loads
  it with ``ctypes``.  Libraries land in ``build/lisp_mcmc_torch/`` at
  the root of the checkout, named by a hash of their sources, so a
  changed source is rebuilt and an unchanged one is reused.
  :func:`build_all` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["resolve_device", "load_library", "build_all", "BUILD_DIR",
           "CSRC_DIR", "KERNEL_SOURCES"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "lisp_mcmc_torch"
# library name -> its translation unit; every unit includes models.cuh.
KERNEL_SOURCES = {
    "fused_posterior": "fused_posterior.cu",
    "chunk_rwm": "chunk_rwm.cu",
    "microbench": "microbench.cu",
}
_HEADERS = ("models.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; asking for CUDA without a GPU raises.

    The CPU is used only when the caller names it (the tests do).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lisp_mcmc_torch runs on the GPU by default and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path")
    return dev


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "lisp_mcmc_torch/csrc at first use")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in (KERNEL_SOURCES[name], *_HEADERS):
        h.update((CSRC_DIR / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one library; returns ``(Popen, tmp, target)``."""
    target = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
           str(CSRC_DIR / KERNEL_SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish_build(name: str, proc, tmp: Path, target: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {KERNEL_SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, target)
    target.with_suffix(".log").write_text(log)
    return log


def build_all(names=None) -> dict[str, str]:
    """Compile every missing kernel library at once, one ``nvcc`` each.

    Returns ``{name: ptxas log}`` for the libraries built by this call
    (registers, shared memory and spills per kernel).
    """
    names = list(KERNEL_SOURCES) if names is None else list(names)
    with _lock:
        pending = [(n, *_start_build(n)) for n in names
                   if not _target(n).exists()]
        return {n: _finish_build(n, proc, tmp, target)
                for n, proc, tmp, target in pending}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_target(name)))
                _libs[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``.

    Every library exports ``lmt_error_string`` (models.cuh), which maps
    the code through ``cudaGetErrorString``.
    """
    if code != 0:
        lib.lmt_error_string.restype = ctypes.c_char_p
        lib.lmt_error_string.argtypes = [ctypes.c_int]
        msg = lib.lmt_error_string(code).decode()
        raise RuntimeError(f"{what}: kernel launch failed ({code}): {msg}")
