"""Build and load the port's native C++ host libraries (ARSH shard IO,
FLAC decoding): the port's counterpart of
automatic_speech_recognition_tpu/data/_native.py.

Both wrappers (flac.py, shards_native.py) build their .so on first use and
latch failures so a broken toolchain costs one build attempt per process,
not one per call.  `lib<name>.so` is compiled from the port's own
`csrc/<name>.cpp` with the host C++ compiler (the flags of native/Makefile)
into `_build/` (listed in `.gitignore`), named by a hash of the source and
the flags, so a changed source is rebuilt and never loaded stale.  When
the library cannot be built, `load_native` returns None and the callers
fall back to their pure-Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared"]

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}


def source_path(lib_name: str) -> Path:
    """csrc/<name>.cpp of lib<name>.so."""
    stem = lib_name[len("lib"):] if lib_name.startswith("lib") else lib_name
    return CSRC_DIR / (stem.rsplit(".so", 1)[0] + ".cpp")


def library_path(lib_name: str) -> Path:
    src = source_path(lib_name).read_bytes()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{lib_name[:-3]}-{digest[:16]}.so"


def cxx_command(source: Path, output: Path, cxx: str = "g++") -> List[str]:
    return [cxx, *CXX_FLAGS, "-o", str(output), str(source)]


def load_native(lib_name: str,
                configure: Callable[[ctypes.CDLL], None]
                ) -> Optional[ctypes.CDLL]:
    """Build (if needed) and load lib_name from csrc/; None if
    unavailable.  `configure` sets argtypes/restypes on first load."""
    with _lock:
        if lib_name in _libs:
            return _libs[lib_name]
        try:
            out = library_path(lib_name)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                subprocess.run(cxx_command(source_path(lib_name), tmp),
                               check=True, capture_output=True)
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            configure(lib)
        except (OSError, subprocess.SubprocessError):
            lib = None
        _libs[lib_name] = lib
        return lib
