"""Build a CUDA source of ``csrc/`` into a shared library with a plain C
interface and load it with ctypes (the kernels' common build), and the
card's device memory rate that both kernels' bounds take.

``nvcc`` compiles for ``sm_90a`` into ``_build/`` (ignored by git), once per
hash of the source and the flags; a fresh checkout builds at first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["library", "CSRC", "BUILD_DIR", "NVCC_FLAGS", "HBM_BYTES_PER_S"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def library(source: Path) -> ctypes.CDLL:
    """Compile ``source`` (once per hash of it and the flags) into
    ``_build/<stem>_<hash>.so`` and load it."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{source.stem}_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(str(so))
