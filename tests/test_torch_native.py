"""The port's host runtime (dgraph_tpu_torch/native, csrc/native.cc)
against the reference's (dgraph_tpu/native, native/native.cc), on the
CPU.

- The reference's tests/test_native.py cases run through both packages
  (tests/test_torch_cold_storage.py's `run_in_both`, the runtime on in
  both): the KV round trip, recovery, torn tail and prefix scan; LSM
  runs, tombstones, compaction and the flush/truncate crash window;
  legacy snapshot migration and truncated-length rejection; the WAL
  backends' interchangeability; the codec, levenshtein and tokenizer
  parity. Both passes must leave the same files with the same bytes.
- The sanitizer harness, built with g++ from the port's own copies of
  native.cc and sanitize_test.cc (the reference's `make asan` flags).
- Stores open across the packages: a `NativeKV`, a `TabletStore` or a
  raft `DiskStorage` directory that one package writes (10 keys, and
  2,000 keys past many 4 KiB memtable flushes) opens in the other with
  every key.
- Each binding gives the reference's bytes on seeded inputs, and counts
  its calls; the library builds once under concurrent builds, and a
  failed build raises.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import dgraph_tpu.native as jn
import dgraph_tpu_torch.native as tn
from dgraph_tpu.cluster import raft as jraft
from dgraph_tpu.engine import lazy_tablets as jlazy
from dgraph_tpu_torch.cluster import raft as traft
from dgraph_tpu_torch.engine import lazy_tablets as tlazy
from dgraph_tpu_torch.ops import _build
from tests.test_torch_cold_storage import reference_cases, run_in_both

REPO = Path(__file__).resolve().parent.parent
SANITIZER = "test_sanitizer_harness_builds_and_passes"
NATIVE = reference_cases("test_native", (SANITIZER,))


def test_the_reference_file_holds_its_cases():
    assert len(NATIVE) == 19
    assert SANITIZER in reference_cases("test_native")


@pytest.mark.parametrize("name", NATIVE)
def test_native_through_both(name, tmp_path):
    run_in_both("test_native", name, tmp_path, native=True)


def test_sanitizer_harness_on_the_port_copy(tmp_path):
    """The port's csrc/sanitize_test.cc drives every C entry of its
    csrc/native.cc under ASan and UBSan (native/Makefile's `asan`
    flags, without make), and the sanitizers stay silent."""
    exe = tmp_path / "sanitize_test"
    src = _build.CSRC_DIR
    build = subprocess.run(
        [_build.gxx_path(), "-g", "-O1", "-std=c++17", "-Wall", "-Wextra",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=undefined",
         "-fno-omit-frame-pointer", "-o", str(exe), str(src / "native.cc"),
         str(src / "sanitize_test.cc")],
        capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stdout + build.stderr
    work = tmp_path / "work"
    work.mkdir()
    run = subprocess.run([str(exe), str(work)], capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "all ok" in run.stdout
    assert "runtime error" not in run.stdout + run.stderr


# -- stores written by one package open in the other -------------------------


def _keys(n: int) -> dict:
    rng = np.random.default_rng(n)
    return {f"k/{i:05d}".encode(): rng.bytes(int(rng.integers(0, 300)))
            for i in range(n)}


def _write_kv(native, d: Path, n: int, memtable: int | None):
    kv = native.NativeKV(str(d))
    if memtable:
        kv.set_memtable(memtable)
    for k, v in _keys(n).items():
        kv.put(k, v)
    kv.close()


def _read_kv(native, d: Path) -> dict:
    kv = native.NativeKV(str(d))
    try:
        return dict(kv.scan(b""))
    finally:
        kv.close()


def _write_tablets(lazy, d: Path, n: int, memtable: int | None):
    store = lazy.TabletStore(str(d)) if lazy is jlazy \
        else lazy.TabletStore(str(d), "cpu")
    if memtable:
        store.kv.set_memtable(memtable)
    for k, v in _keys(n).items():
        store.kv.put(b"tab:" + k, v)
    store.close()


def _read_tablets(lazy, d: Path) -> dict:
    store = lazy.TabletStore(str(d)) if lazy is jlazy \
        else lazy.TabletStore(str(d), "cpu")
    try:
        assert len(store.preds()) == len(dict(store.kv.scan(b"tab:")))
        return {k[len(b"tab:"):]: v for k, v in store.kv.scan(b"tab:")}
    finally:
        store.close()


def _write_raft(raft, d: Path, n: int, memtable: int | None):
    st = raft.DiskStorage(str(d))
    if memtable:
        st._kv.set_memtable(memtable)
    st.save_hardstate(3, 2)
    st.append([raft.Entry(3, i, ("commit", i, [v], {}))
               for i, v in enumerate(_keys(n).values(), 1)])
    st.close()


def _read_raft(raft, d: Path) -> dict:
    st = raft.DiskStorage(str(d))
    try:
        assert (st.term, st.voted_for) == (3, 2)
        return {f"k/{e.index - 1:05d}".encode(): e.data[2][0]
                for e in st.entries}
    finally:
        st.close()


STORES = {"kv": (jn, tn, _write_kv, _read_kv),
          "tablet_store": (jlazy, tlazy, _write_tablets, _read_tablets),
          "disk_storage": (jraft, traft, _write_raft, _read_raft)}


@pytest.mark.parametrize("kind", sorted(STORES))
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_store_opens_in_the_other_package(kind, writer, tmp_path):
    """10 keys in the memtable and WAL, then 2,000 keys across the
    runs of a 4 KiB memtable: the other package opens the directory
    with every key, and the two packages write the same files."""
    ref, port, write, read = STORES[kind]
    mine, other = (ref, port) if writer == "ref" else (port, ref)
    for n, memtable in ((10, None), (2000, 4096)):
        d = tmp_path / f"{kind}-{n}"
        d.mkdir()
        write(mine, d / "w", n, memtable)
        if n > 10:
            assert len(list((d / "w").glob("run-*.sst"))) > 1
        assert read(other, d / "w") == _keys(n), (kind, n)
        assert read(mine, d / "w") == _keys(n), (kind, n)
        write(other, d / "o", n, memtable)
        assert _files(d / "o") == _files(d / "w")


def _files(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


# -- the bindings give the reference's bytes ---------------------------------

RNG = np.random.default_rng(20261018)
WORDS = ["the", "Running", "quickly", "fox", "Café", "naïve", "x1_y2", "ab",
         "quote\"d", "back\\slash", "tab\there", "ünïcödé", "日本語", ""]


def _strings(n):
    return [" ".join(RNG.choice(WORDS, int(RNG.integers(0, 4))).tolist())
            for _ in range(n)]


def _gv_case():
    out = []
    for n in (0, 1, 3, 4, 5, 47, 48, 1000, 50_000):
        gaps = RNG.integers(1, 1 << int(RNG.integers(1, 40)), n,
                            dtype=np.uint64)
        uids = np.cumsum(gaps, dtype=np.uint64)
        enc = [m.gv_encode(uids) for m in (jn, tn)]
        out.append((enc[0] == enc[1], np.array_equal(
            tn.gv_decode(enc[1]), uids)))
    return out


def _levenshtein_case():
    a, b = _strings(200), _strings(200)
    return [(jn.levenshtein(x, y, d), tn.levenshtein(x, y, d))
            for x, y, d in zip(a, b, RNG.integers(0, 6, 200).tolist())]


def _json_rows_case():
    n = 257
    pres = (RNG.random(n) < 0.8).astype(np.uint8)
    strs = [s.encode() for s in _strings(n)]
    offs = np.zeros(n + 1, np.int64)
    np.cumsum([len(s) for s in strs], out=offs[1:])
    ints = RNG.integers(-2**40, 2**40, n)
    floats = RNG.standard_normal(n) * 1e6
    bools = (RNG.random(n) < 0.5).astype(np.uint8)
    out = []
    for m in (jn, tn):
        cols = [("uid", m.JCOL_UID, np.arange(1, n + 1, dtype=np.uint64),
                 None, None),
                ("i", m.JCOL_INT, ints, None, pres),
                ("f", m.JCOL_FLOAT, floats, None, pres),
                ("b", m.JCOL_BOOL, bools, None, 1 - pres),
                ("s", m.JCOL_STR, np.frombuffer(b"".join(strs), np.uint8),
                 offs, pres)]
        out.append(m.json_rows(n, cols))
    return out


def _match_case():
    vals = [s.encode() for s in _strings(300)]
    offs = np.zeros(len(vals) + 1, np.int64)
    np.cumsum([len(v) for v in vals], out=offs[1:])
    blob = np.frombuffer(b"".join(vals), np.uint8)
    idx = RNG.choice(len(vals), 120, replace=False)
    return [(m.match_mask(b"quickly fox", 3, blob, offs).tolist(),
             m.match_mask_idx(b"the", 1, blob, offs, idx).tolist())
            for m in (jn, tn)]


def _merge_count_case():
    buckets = [np.unique(RNG.integers(1, 5000, int(RNG.integers(0, 900)),
                                      dtype=np.uint64)) for _ in range(7)]
    return [[m.merge_count(buckets, need).tolist() for need in (1, 2, 4, 8)]
            for m in (jn, tn)]


def _tokenize_case():
    vals = [s.encode() for s in _strings(400) if s.isascii()]
    offs = np.zeros(len(vals) + 1, np.uint64)
    np.cumsum([len(v) for v in vals], out=offs[1:], dtype=np.uint64)
    payload = np.frombuffer(b"".join(vals), np.uint8)
    out = []
    for m in (jn, tn):
        toks, groups = m.tokenize_batch(
            payload, offs, m.TOK_TERM | m.TOK_TRIGRAM | m.TOK_FULLTEXT_EN
            | m.TOK_EXACT, (1, 2, 3, 4))
        out.append((toks, [g.tolist() for g in groups]))
    return out


RDF = """<0x1> <name> "Alice" .
<0x1> <name> "Alicia"@es .
<0x2> <name> "Bob \\"quoted\\"" .
<0x1> <friend> <0x2> (since=2020, close=true) .
<0x4> <score> "3.5"^^<xs:float> .
<0x5> <name> "Café Unicode" .
<0x6> <aka> "One" (kind="working") .
_:blank <name> "Blanky" .
<0x3> <owns> _:blank .
not a quad
"""


def _rdf_case():
    out = []
    for m in (jn, tn):
        p = m.rdf_parse(RDF.encode())
        out.append(([a.tolist() for a in p.edges + p.vals + p.fallback],
                    p.preds, p.langs, p.dtypes))
    return out


BINDINGS = {"gv_codec": _gv_case, "levenshtein": _levenshtein_case,
            "json_rows": _json_rows_case, "match_mask": _match_case,
            "merge_count": _merge_count_case,
            "tokenize_batch": _tokenize_case, "rdf_parse": _rdf_case}


@pytest.mark.parametrize("binding", sorted(BINDINGS))
def test_binding_equals_the_reference(binding):
    got = BINDINGS[binding]()
    if binding == "gv_codec":
        assert got == [(True, True)] * len(got)
    elif binding == "levenshtein":
        assert [p for p in got if p[0] != p[1]] == []
    else:
        ref, port = got
        assert port == ref
        assert port is not None


def test_each_binding_counts_its_calls(tmp_path):
    """A binding's count moves by one where it calls its C entry, and a
    caller switched off (`available` False) takes no binding."""
    tn.reset_calls()
    assert set(tn.call_counts().values()) == {0}
    for case in BINDINGS.values():
        case()
    kv = tn.NativeKV(str(tmp_path / "kv"))
    kv.close()
    tn.NativeWal(str(tmp_path / "w.log")).close()
    counts = tn.call_counts()
    assert counts["NativeKV"] == counts["NativeWal"] == 1
    assert counts["gv_encode"] == counts["gv_decode"] == 9
    assert counts["levenshtein"] == 200
    assert counts["match_mask"] == counts["match_mask_idx"] == 1
    assert counts["merge_count"] == 4
    assert counts["json_rows"] == counts["tokenize_batch"] == \
        counts["rdf_parse"] == 1
    from dgraph_tpu_torch.storage.kvfallback import PyKV
    from dgraph_tpu_torch.storage.wal import Wal
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tn, "available", lambda: False)
        tn.reset_calls()
        store = tlazy.TabletStore(str(tmp_path / "store"), "cpu")
        assert isinstance(store.kv, PyKV)
        store.close()
        wal = Wal(str(tmp_path / "w2.log"))
        assert wal.native is False
        wal.close()
        assert set(tn.call_counts().values()) == {0}
    finally:
        mp.undo()
    wal = Wal(str(tmp_path / "w3.log"))
    assert wal.native is True
    wal.close()


# -- the build ---------------------------------------------------------------

BUILD_ONE = """
import sys
from pathlib import Path
from dgraph_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
lib = _build.load("native")
print(_build.library_path("native"))
"""


def test_concurrent_builds_leave_one_library(tmp_path):
    """Three processes building the library at once into one directory
    each load a whole library, and one file remains, under its content
    hash name, with no temporary left."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONE, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        [Path(paths.pop()).name]


def test_failed_build_raises(monkeypatch, tmp_path):
    """A failed build is an error with the compiler's output, never a
    quiet switch to the pure-Python branches."""
    monkeypatch.setattr(_build, "gxx_path", lambda: "false")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(tn, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on csrc/native.cc"):
        tn.available()
    assert not list(tmp_path.glob("*.so"))


def test_module_imports_build_nothing():
    """Importing the runtime's module builds and loads nothing."""
    code = ("import dgraph_tpu_torch.native as n, dgraph_tpu_torch.ops._build"
            " as b\nassert n._lib is None and not b._loaded\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert importlib.import_module("dgraph_tpu_torch.native") is tn
