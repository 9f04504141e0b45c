"""The port's distributed ingest (dgraph_tpu_torch/ingest/distributed.py)
against the reference's, on the CPU.

tests/test_ingest_dist.py's 7 tests run through both packages
(tests/test_torch_cold_storage.py's `run_in_both`), the SIGKILL retry
included: the port's workers and reducers run as
`python -m dgraph_tpu_torch.ingest.distributed` processes, or as threads
in the in-process mode. Every group snapshot the port's reducers write
must be byte-equal to the reference's: the in-process runs' files are
compared pass against pass, with the host runtime off in both packages
and, in the `_native_on` test, on in both; and the port's
process-spawned run against the reference's in-process run. A spawned
child loads its own package's runtime whatever its parent patched, so
a spawned run's files are compared only with the runtime on (with it
off in the parent, the children's native tokenizer orders the index
otherwise for the same contents).
"""

from __future__ import annotations

import json

import pytest

from dgraph_tpu.ingest import distributed as jdist
from dgraph_tpu_torch.ingest import distributed as tdist
from tests.test_torch_cold_storage import reference_cases, run_in_both

DIST = reference_cases("test_ingest_dist")
# spawned reducers load the native runtime, so their snapshot bytes
# follow its tokenizer (see the module docstring)
SPAWNED = ("test_worker_sigkill_mid_shuffle_retries_byte_identical",)


def test_the_reference_file_holds_its_cases():
    assert len(DIST) == 7


@pytest.mark.parametrize("name", DIST)
def test_ingest_dist_through_both(name, tmp_path):
    run_in_both("test_ingest_dist", name, tmp_path,
                compare_files=name not in SPAWNED)


@pytest.mark.parametrize("name", DIST)
def test_ingest_dist_through_both_native_on(name, tmp_path):
    run_in_both("test_ingest_dist", name, tmp_path, native=True)


SCHEMA = """\
name: string @index(exact) .
age: int @index(int) .
knows: [uid] @reverse .
note: string .
tags: [string] @index(term) .
"""


def _rdf(path, n=300):
    lines = []
    for i in range(n):
        lines.append(f'_:p{i} <name> "person {i}" .')
        lines.append(f'_:p{i} <age> "{20 + i % 50}"^^<xs:int> .')
        lines.append(f"_:p{i} <knows> _:p{(i * 7 + 1) % n} .")
        lines.append(f'_:p{i} <tags> "t{i % 5} t{i % 3} x{i % 11}" .')
        if i % 3 == 0:
            lines.append(f'_:p{i} <note> "n{i}"@en .')
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_spawned_reducers_match_the_reference(tmp_path):
    """The port's process-spawned load (two workers, three reducers,
    each child on the port's host runtime) writes group snapshots
    byte-equal to the reference's in-process load with its runtime on,
    and an equal manifest."""
    rdf = _rdf(tmp_path / "seed.rdf")
    ref = jdist.distributed_load([rdf], schema=SCHEMA, groups=3, workers=2,
                                 outdir=str(tmp_path / "ref"),
                                 in_process=True, chunk_bytes=4096,
                                 timeout_s=120)
    port = tdist.distributed_load([rdf], schema=SCHEMA, groups=3,
                                  workers=2, outdir=str(tmp_path / "port"),
                                  chunk_bytes=4096, timeout_s=180)
    drop = ("stats",)
    assert {k: v for k, v in port.items() if k not in drop} == \
        {k: v for k, v in ref.items() if k not in drop}
    assert port["stats"]["mapped"] == ref["stats"]["mapped"]
    for g in (1, 2, 3):
        assert (tmp_path / "port" / f"g{g}" / "p.snap").read_bytes() == \
            (tmp_path / "ref" / f"g{g}" / "p.snap").read_bytes(), g
    written = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert written["tablets"] == ref["tablets"]
