"""Rules of the port: dgraph_tpu_torch and chip_smoke.py import neither
jax nor the reference package, entry points run on the card unless told
otherwise, and chip_smoke.py refuses to run without a card or without
the rest of the repo."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dgraph_tpu_torch import backend
from dgraph_tpu_torch.ops import bitgraph as tbg

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "dgraph_tpu")


def _port_files():
    files = sorted((REPO / "dgraph_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name):
    # exact names and dotted children only: dgraph_tpu_torch is allowed
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_matches_exact_names_only():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("dgraph_tpu") and _forbidden("dgraph_tpu.ops.bitgraph")
    assert not _forbidden("dgraph_tpu_torch")
    assert not _forbidden("dgraph_tpu_torch.ops")
    assert not _forbidden("jaxlib_free")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend.resolve_device(None)
    assert backend.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edges = {1: np.asarray([2, 3], np.uint32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbg.build_bitadjacency(edges)
    assert tbg.build_bitadjacency(edges, device="cpu").device == \
        torch.device("cpu")


def _run_smoke(cwd, script, code=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    args = [sys.executable, script] if code is None else \
        [sys.executable, "-c", code]
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_chip_smoke_fails_without_card():
    proc = _run_smoke(REPO, "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    """Alone in a directory it cannot import the port, even where a card
    is present (faked here), and prints no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    code = ("import runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    proc = _run_smoke(tmp_path, None, code)
    assert proc.returncode != 0
    assert "dgraph_tpu_torch" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_host_runtime_builds_from_the_port_into_its_build_dir():
    """The port's host runtime builds from its own csrc/native.cc with
    the reference Makefile's flags, and its loader resolves the library
    under build/dgraph_tpu_torch/, never under the root native/
    directory (the reference's source and build)."""
    from dgraph_tpu_torch import native
    from dgraph_tpu_torch.ops import _build

    make = (REPO / "native" / "Makefile").read_text().splitlines()
    cxxflags = next(ln.split("?=")[1].split() for ln in make
                    if ln.startswith("CXXFLAGS"))
    assert _build.GXX_FLAGS == (*cxxflags, "-shared")
    assert _build.source_path("native") == \
        REPO / "dgraph_tpu_torch" / "csrc" / "native.cc"
    path = _build.library_path("native")
    assert path.parent == _build.BUILD_DIR == REPO / "build" / "dgraph_tpu_torch"
    assert native.available()
    loaded = Path(native._lib._name).resolve()
    assert loaded == path
    assert REPO / "native" not in loaded.parents
    src = (REPO / "dgraph_tpu_torch" / "native" / "__init__.py").read_text()
    assert "native/build" not in src and '"make"' not in src
