"""The port's wire codec (dgraph_tpu_torch.wire) against the reference's
(dgraph_tpu.wire): the inputs of tests/test_wire.py give equal `dumps`
bytes and round-trip through both codecs, each decoding the other's
bytes, the raft Entry and Msg records included."""

import datetime
import pickle
import socket

import numpy as np
import pytest

from dgraph_tpu import wire as jw
from dgraph_tpu.cluster import raft as jraft
from dgraph_tpu.models import types as jtypes
from dgraph_tpu.storage import tablet as jtab
from dgraph_tpu_torch import wire as tw
from dgraph_tpu_torch.cluster import raft as traft
from dgraph_tpu_torch.models import types as ttypes
from dgraph_tpu_torch.storage import tablet as ttab
from dgraph_tpu_torch.storage.wal import _decode_record

SCALARS = [
    None, True, False, 0, 1, -1, 2**40, -(2**40), 2**70, -(2**70),
    3.14159, float("inf"), "", "héllo wörld 日本語", b"", b"\x00\xff",
    [], [1, [2, [3]]], (), (1, "two", None), {}, {"k": [1, 2]},
    {(1, 2): {"since": 2015}},
]

ARRAYS = [np.arange(7, dtype=np.uint64), np.array([], dtype=np.uint32),
          np.arange(6, dtype=np.int32).reshape(2, 3),
          np.array([1.5, -2.5], dtype=np.float64)]

DATES = [datetime.datetime(2015, 3, 2, 10, 30, 5),
         datetime.datetime(1999, 12, 31, 23, 59, 59, 123456),
         datetime.datetime(2020, 1, 1, tzinfo=datetime.timezone.utc),
         datetime.date(1980, 6, 15)]


def _same_bytes_and_cross_decode(obj):
    blob = jw.dumps(obj)
    assert tw.dumps(obj) == blob
    assert tw.loads(blob) == obj
    assert jw.loads(tw.dumps(obj)) == obj


@pytest.mark.parametrize("obj", SCALARS, ids=repr)
def test_scalar_bytes_equal_and_cross_decode(obj):
    _same_bytes_and_cross_decode(obj)


@pytest.mark.parametrize("arr", ARRAYS, ids=lambda a: f"{a.dtype}{a.shape}")
def test_ndarray_bytes_equal_and_cross_decode(arr):
    blob = jw.dumps(arr)
    assert tw.dumps(arr) == blob
    back = tw.loads(blob)
    assert back.dtype == arr.dtype and back.shape == arr.shape
    assert np.array_equal(back, arr)


@pytest.mark.parametrize("d", DATES, ids=str)
def test_datetime_bytes_equal_and_cross_decode(d):
    _same_bytes_and_cross_decode(d)


def _records(types, tab):
    p = tab.Posting(types.Val(types.TypeID.STRING, "alice"), lang="en",
                    facets={"since": types.Val(types.TypeID.INT, 2015)})
    op = tab.EdgeOp("set", 1, 2, posting=p,
                    facets={"w": types.Val(types.TypeID.INT, 3)})
    vec = tab.EdgeOp("set", 7, posting=tab.Posting(types.Val(
        types.TypeID.FLOAT32VECTOR, np.arange(4, dtype=np.float32))))
    return op, ("commit", 7, [("friend", op), ("emb", vec)],
                {"friend": "friend: [uid] ."})


def test_record_bytes_equal_and_cross_decode():
    jop, jrec = _records(jtypes, jtab)
    top, trec = _records(ttypes, ttab)
    assert tw.dumps(top) == jw.dumps(jop)
    assert tw.dumps(trec) == jw.dumps(jrec)
    back = tw.loads(jw.dumps(jop))
    assert type(back) is ttab.EdgeOp and back == top
    assert type(back.posting.value) is ttypes.Val
    assert tw.dumps(tw.loads(jw.dumps(jrec))) == jw.dumps(jrec)
    assert jw.dumps(jw.loads(tw.dumps(trec))) == jw.dumps(jrec)


def _raft_records(raft, types, tab):
    _, rec = _records(types, tab)
    e = raft.Entry(term=3, index=17, data=rec)
    m = raft.Msg(type="append_req", frm=1, to=2, term=3, prev_index=16,
                 prev_term=3, entries=[e, raft.Entry(3, 18, None)],
                 commit=15)
    v = raft.Msg(type="vote_resp", frm=2, to=1, term=4, granted=True)
    s = raft.Msg(type="snap_req", frm=1, to=3, term=4, snap_index=9,
                 snap_term=2, snap_data=b"\x00state")
    return [e, m, v, s]


@pytest.mark.parametrize("i", range(4), ids=["entry", "append_req",
                                             "vote_resp", "snap_req"])
def test_raft_records_bytes_equal_and_cross_decode(i):
    """Entry and Msg encode to the same bytes in both packages, and each
    decodes the other's into its own raft classes, whose bytes are the
    record's again."""
    j = _raft_records(jraft, jtypes, jtab)[i]
    t = _raft_records(traft, ttypes, ttab)[i]
    blob = jw.dumps(j)
    assert tw.dumps(t) == blob
    back = tw.loads(blob)
    assert type(back) is type(t) and tw.dumps(back) == blob
    there = jw.loads(tw.dumps(t))
    assert type(there) is type(j) and jw.dumps(there) == blob


def test_version_check():
    blob = bytearray(jw.dumps(42))
    blob[0] = 99
    with pytest.raises(tw.WireError):
        tw.loads(bytes(blob))


def test_pickle_fallback_sniffing():
    rec = ("alter", "name: string .")
    assert _decode_record(pickle.dumps(rec)) == rec
    assert _decode_record(jw.dumps(rec)) == rec


def test_frames_cross_over_socketpair():
    a, b = socket.socketpair()
    payloads = [jw.dumps(("commit", i, [], {})) for i in range(3)]
    for i, p in enumerate(payloads):
        (jw if i % 2 else tw).write_frame(a, p)
    got = [tw.read_frame(b) for _ in payloads]
    assert got == payloads
    a.close()
    with pytest.raises(EOFError):
        tw.read_frame(b)
    b.close()


def test_unencodable_type_is_explicit():
    class Weird:
        pass

    with pytest.raises(tw.WireError):
        tw.dumps(Weird())
