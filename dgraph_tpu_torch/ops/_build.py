"""Build a source of `csrc/` into a shared library and load it with
ctypes.

Each `csrc/<name>.cu` exposes a plain C interface, so `nvcc` builds it
in seconds without PyTorch's headers. `csrc/native.cc`, the host
runtime (`dgraph_tpu_torch.native`), is C++ that `g++` builds with the
reference Makefile's flags. The library lands in
`build/dgraph_tpu_torch/` at the root of the checkout, named by a hash
of the source and the flags so an edited source is never served from a
stale build; it is written under a per-process temporary name and
renamed into place, so processes building at once never load a partial
file. Building happens at first use, never at import, and a failed
build raises with the compiler's output.
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
# the reference's native/Makefile (CXXFLAGS and -shared)
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

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


def gxx_path() -> str:
    """g++ from PATH."""
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: a C++ compiler is needed to build "
                       "the port's host runtime (csrc/native.cc)")


def source_path(name: str) -> Path:
    """`csrc/<name>.cu`, else `csrc/<name>.cc`."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cc"


def _flags(src: Path) -> tuple[str, ...]:
    return NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS


def library_path(name: str) -> Path:
    """Where the build of `csrc/<name>` lives for its current text."""
    src = source_path(name)
    tag = hashlib.sha256(
        src.read_bytes() + " ".join(_flags(src)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC_DIR / f"{name}.cu")]


def compile_command(name: str, out: Path) -> list[str]:
    """nvcc for a CUDA source, g++ for a C++ one."""
    src = source_path(name)
    if src.suffix == ".cu":
        return nvcc_command(name, out)
    return [gxx_path(), *GXX_FLAGS, "-o", str(out), str(src)]


def _finish(name: str, proc: subprocess.Popen, tmp: Path,
            path: Path) -> None:
    """Wait for one compiler, record its output, and move its library
    into place; raise if it failed."""
    try:
        out, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        src = source_path(name)
        tool = "nvcc" if src.suffix == ".cu" else "g++"
        raise RuntimeError(f"{tool} failed on csrc/{src.name}:\n{out}")
    build_logs[name] = out
    os.replace(tmp, path)


def build_all(names: list[str]) -> None:
    """Build every named source that has no current library, one
    compiler each, all started together, and wait for all of them."""
    with _lock:
        running = []
        try:
            for name in names:
                path = library_path(name)
                if name in _loaded or path.exists():
                    continue
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.Popen(compile_command(name, tmp),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
                running.append((name, proc, tmp, path))
            for name, proc, tmp, path in running:
                _finish(name, proc, tmp, path)
        finally:
            for _, proc, _, _ in running:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>`, built first if needed."""
    # the launch path: a loaded library is served without hashing its
    # source again (a dict read is atomic under the interpreter lock)
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
