"""Build generated CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source is compiled once, by one ``nvcc`` call, into a shared
library with a plain C interface under ``build/repro_torch/``, named by
the SHA-256 of everything that goes into it (the source, the headers it
may include and the flags).  A library already on disk is loaded as it
is; a library loaded once is kept for the life of the process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Sequence

#: the repository root's ``build/``, listed in ``.gitignore``
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, "Library"] = {}


@dataclass
class Library:
    lib: ctypes.CDLL
    path: Path          # the shared library
    seconds: float      # compile time; 0.0 when found on disk


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc for sm_90a")


def build_library(source: str, include_dirs: Sequence[Path]) -> Library:
    """Compile ``source`` (if not built yet) and load it."""
    h = hashlib.sha256()
    h.update(source.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    for d in include_dirs:
        for f in sorted(Path(d).glob("*.cuh")):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    key = h.hexdigest()
    if key in _LOADED:
        return _LOADED[key]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"{key}.so"
    if so.exists():
        seconds = 0.0
    else:
        cu = BUILD_DIR / f"{key}.cu"
        cu.write_text(source)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS,
               *[f"-I{d}" for d in include_dirs], "-o", tmp, str(cu)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)        # publish atomically
    lib = Library(ctypes.CDLL(str(so)), so, seconds)
    _LOADED[key] = lib
    return lib
