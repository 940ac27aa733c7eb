"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface.  At first use it is compiled
by nvcc for Hopper (`sm_90a`) into a shared library under `_build/` (listed
in `.gitignore`), named by a hash of the source and the flags, and loaded
with ctypes.  Nothing here runs at import: the CPU tests import every
module on hosts without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of each build made by this process
build_log: Dict[str, str] = {}


def nvcc_command(source: Path, output: Path, nvcc: str = "nvcc") -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) is needed to build the "
                           "port's kernels and was not found")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str, source: Optional[Path] = None) -> Path:
    src = (source or CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def load(name: str, source: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (or of `source`, under `name`),
    built first if needed."""
    with _lock:
        if name in _libs:
            return _libs[name]
        source = source or CSRC_DIR / f"{name}.cu"
        out = library_path(name, source)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(nvcc_command(source, tmp, _nvcc()),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
            build_log[name] = proc.stdout + proc.stderr
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib
