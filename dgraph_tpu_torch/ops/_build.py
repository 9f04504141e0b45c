"""Build a CUDA source of `csrc/` into a shared library and load it with
ctypes.

Each `csrc/<name>.cu` exposes a plain C interface, so `nvcc` builds it
in seconds without PyTorch's headers. The library lands in
`build/dgraph_tpu_torch/` at the root of the checkout, named by a hash
of the source and the flags so an edited source is never served from a
stale build. Building happens at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "dgraph_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register and spill report) of each build made
# by this process, by source name
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from the CUDA toolkit's usual places."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def library_path(name: str) -> Path:
    """Where the build of `csrc/<name>.cu` lives for its current text."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC_DIR / f"{name}.cu")]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(nvcc_command(name, tmp),
                                  capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n"
                                   f"{proc.stdout}{proc.stderr}")
            build_logs[name] = proc.stdout + proc.stderr
            os.replace(tmp, path)
        lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
