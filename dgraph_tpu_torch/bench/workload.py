"""Seeded LDBC-SNB-style social-graph workload generator.

The reference validates its clusters with docker-compose topologies
under traffic tools (`dgraph counter`, SURVEY §4.5/§4.7); LDBC's
Social Network Benchmark is the community-standard graph workload
shape: a person/knows/post graph queried by short point reads,
2–3-hop friend traversals, and aggregations, interleaved with a
write stream. This module is that shape for dgraph-tpu, as two pure
functions of a seed:

  Workload(cfg).schema() / .quads()   the generated social graph
  Workload(cfg).ops(n)                the mixed read/write op stream

Determinism is a hard contract (tests/test_workload.py): the same
config produces BYTE-IDENTICAL schema, quads and op stream in any
process — random.Random(seed) only, no hash-order iteration, no wall
clock — so two harness runs (or a run and its CI re-check) replay the
exact same traffic.

Read/write disjointness, for the under-load parity oracle: every read
op touches only the seeded person.*/knows/post.* predicates, every
mutation touches only fresh blank nodes under churn.* predicates.
Reads are therefore time-invariant while the write stream churns, and
"responses under concurrent load" must byte-match "the same queries
replayed sequentially after quiescing" — an exact differential check
tools/dgbench.py runs on a sampled subset of every run.

Port of `dgraph_tpu/bench/workload.py`: a copy (standard library
only). Its schema, quads and op lines are byte-identical to the
reference's for the same config.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass

FIRST = ("Alice", "Bruno", "Chen", "Devi", "Emeka", "Farah", "Goran",
         "Hana", "Ivan", "Jun", "Kaia", "Liam", "Mina", "Noor",
         "Otto", "Priya")
LAST = ("Abe", "Brandt", "Cruz", "Diaz", "Endo", "Fox", "Gupta",
        "Haas", "Ito", "Jha", "Kim", "Lund", "Mora", "Ngo", "Okafor",
        "Park")
CITIES = ("amsterdam", "bengaluru", "cairo", "denver", "edinburgh",
          "fukuoka", "geneva", "hanoi", "istanbul", "jakarta",
          "kyoto", "lagos")
TOPICS = ("ai", "bikes", "chess", "dgraph", "espresso", "fjords",
          "gardens", "hiking", "indie", "jazz", "kernels", "lasers",
          "maps", "noodles", "opera", "pottery")

SCHEMA = """\
person.name: string @index(exact, term) .
person.city: string @index(exact) .
person.age: int @index(int) .
person.embedding: float32vector @index(vector) .
knows: [uid] @reverse @count .
post.author: [uid] @reverse .
post.topic: string @index(exact) .
post.score: int @index(int) .
churn.note: string .
churn.ref: [uid] .
"""

# op kinds and their default mix weights: the LDBC-interactive-style
# split — short reads dominate, traversals and analytics ride along,
# ~20% writes (half single-edge, half fan-out)
DEFAULT_MIX = (
    ("short_read", 0.40),
    ("traverse2", 0.14),
    ("traverse3", 0.06),
    ("similar", 0.07),
    ("agg_count", 0.13),
    ("mut_edge", 0.12),
    ("mut_fanout", 0.08),
)

# read-only zipfian mix for the read scale-out bench (learner
# replicas + result cache): person popularity follows a zipf(s)
# distribution — a hot head the cache can serve, a long tail that
# keeps missing — so the measured QPS curve reflects what a cache +
# read replicas actually buy under skewed real-world traffic
ZIPF_READ_MIX = (
    ("zipf_short", 0.55),
    ("zipf_traverse", 0.25),
    ("zipf_agg", 0.20),
)

# --mix name -> weights table (tools/dgbench.py, scale-out bench)
MIXES = {"default": DEFAULT_MIX, "zipf-read": ZIPF_READ_MIX}

ZIPF_S = 1.1  # the exponent: ~YCSB's scrambled-zipfian skew


@dataclass(frozen=True)
class WorkloadConfig:
    seed: int = 20260803
    persons: int = 400
    posts_per_person: int = 2
    knows_out: int = 8          # out-degree of the knows graph
    embed_dim: int = 16
    fanout_edges: int = 8       # triples per fan-out mutation
    mix: tuple = DEFAULT_MIX


@dataclass(frozen=True)
class Op:
    """One workload operation. Reads carry `query`; writes carry
    `set_nquads` (all writes are inserts of fresh churn entities —
    see the module docstring's disjointness contract)."""
    kind: str
    write: bool
    query: str = ""
    set_nquads: str = ""

    def to_line(self) -> str:
        """Canonical one-line JSON — the byte-identity unit the
        determinism tests (and cross-process hashes) compare."""
        return json.dumps(
            {"kind": self.kind, "write": self.write,
             "query": self.query, "set_nquads": self.set_nquads},
            sort_keys=True, separators=(",", ":"))


def _person_name(i: int) -> str:
    return (f"{FIRST[i % len(FIRST)]} "
            f"{LAST[(i // len(FIRST)) % len(LAST)]} {i}")


def _zipf_cdf(n: int, s: float = ZIPF_S) -> list[float]:
    """Normalized cumulative weights of zipf(s) over ranks 1..n."""
    acc, out = 0.0, []
    for rank in range(1, n + 1):
        acc += 1.0 / rank ** s
        out.append(acc)
    return [c / acc for c in out]


def _zipf_draw(cdf: list[float], rng: random.Random) -> int:
    """Inverse-CDF zipfian index draw (0-based, 0 = hottest)."""
    import bisect

    return min(bisect.bisect_left(cdf, rng.random()), len(cdf) - 1)


def _vec_literal(vals: list[float]) -> str:
    return "[" + ", ".join(f"{v:.4f}" for v in vals) + "]"


class Workload:
    """The generated graph + op stream for one config. Every method
    is deterministic in `cfg` alone; `ops()` takes an extra stream
    seed so phases of one run can draw non-overlapping traffic from
    the same graph."""

    def __init__(self, cfg: WorkloadConfig = WorkloadConfig()):
        self.cfg = cfg
        rng = random.Random(cfg.seed)
        n = cfg.persons
        self._names = [_person_name(i) for i in range(n)]
        self._cities = [CITIES[rng.randrange(len(CITIES))]
                        for _ in range(n)]
        self._ages = [rng.randrange(18, 81) for _ in range(n)]
        self._vecs = [[rng.uniform(-1, 1) for _ in range(cfg.embed_dim)]
                      for _ in range(n)]
        # knows: fixed out-degree, no self loops; duplicates fine
        # (posting lists dedupe) but keep them rare for real fan-out
        self._knows = []
        for i in range(n):
            peers = set()
            while len(peers) < min(cfg.knows_out, n - 1):
                j = rng.randrange(n)
                if j != i:
                    peers.add(j)
            self._knows.append(sorted(peers))
        self._posts = []
        for i in range(n):
            for p in range(cfg.posts_per_person):
                self._posts.append(
                    (i, TOPICS[rng.randrange(len(TOPICS))],
                     rng.randrange(101)))
        # zipfian popularity CDFs for the zipf-read mix: person i has
        # rank i+1 (person 0 is the head), weight 1/rank^ZIPF_S;
        # sampling is inverse-CDF over rng.random() so the stream
        # stays a pure function of the seed (bisect, no rejection)
        self._zipf_cdf = _zipf_cdf(n)
        self._zipf_topic_cdf = _zipf_cdf(len(TOPICS))

    # ------------------------------------------------------------ graph

    def schema(self) -> str:
        return SCHEMA

    def quads(self) -> list[str]:
        """The seeded graph as RDF N-Quad lines (blank-node subjects;
        uid assignment happens at load time and no read op depends on
        it — everything is addressed by indexed values)."""
        out = []
        for i, name in enumerate(self._names):
            s = f"_:p{i}"
            out.append(f'{s} <person.name> "{name}" .')
            out.append(f'{s} <person.city> "{self._cities[i]}" .')
            out.append(f'{s} <person.age> "{self._ages[i]}"^^<xs:int> .')
            out.append(f'{s} <person.embedding> '
                       f'"{_vec_literal(self._vecs[i])}"'
                       f'^^<xs:float32vector> .')
            for j in self._knows[i]:
                out.append(f"{s} <knows> _:p{j} .")
        for k, (author, topic, score) in enumerate(self._posts):
            s = f"_:o{k}"
            out.append(f"{s} <post.author> _:p{author} .")
            out.append(f'{s} <post.topic> "{topic}" .')
            out.append(f'{s} <post.score> "{score}"^^<xs:int> .')
        return out

    def read_predicates(self) -> tuple:
        """The seeded (read-side) predicates, in a deterministic
        order — dgbench touches one of each early so tablet claiming
        spreads them across groups before the timed run."""
        return ("person.name", "person.city", "person.age",
                "person.embedding", "knows", "post.author",
                "post.topic", "post.score")

    # -------------------------------------------------------------- ops

    def ops(self, n: int, stream_seed: int = 0) -> list[Op]:
        """`n` mixed ops drawn with a stream-local RNG. Same (cfg,
        n, stream_seed) => byte-identical list in any process."""
        # string seed: version-2 seeding hashes the bytes with sha512
        # (stable across processes and Python versions; tuple seeds
        # are deprecated)
        rng = random.Random(f"{self.cfg.seed}:{stream_seed}:{n}")
        kinds = [k for k, _ in self.cfg.mix]
        weights = [w for _, w in self.cfg.mix]
        out = []
        for i in range(n):
            kind = rng.choices(kinds, weights=weights)[0]
            out.append(self._one(kind, i, rng))
        return out

    def _one(self, kind: str, i: int, rng: random.Random) -> Op:
        name = self._names[rng.randrange(len(self._names))]
        if kind == "short_read":
            return Op(kind, False, query=(
                '{ q(func: eq(person.name, "%s")) '
                '{ person.name person.age person.city } }' % name))
        if kind == "traverse2":
            return Op(kind, False, query=(
                '{ q(func: eq(person.name, "%s")) { person.name '
                'knows { person.name knows { person.name } } } }'
                % name))
        if kind == "traverse3":
            return Op(kind, False, query=(
                '{ q(func: eq(person.name, "%s")) { person.name '
                'knows { knows { knows { person.name } } } } }'
                % name))
        if kind == "similar":
            probe = [v + rng.uniform(-0.05, 0.05)
                     for v in self._vecs[rng.randrange(
                         len(self._vecs))]]
            return Op(kind, False, query=(
                '{ q(func: similar_to(person.embedding, 5, "%s")) '
                '{ person.name } }' % _vec_literal(probe)))
        if kind == "agg_count":
            topic = TOPICS[rng.randrange(len(TOPICS))]
            return Op(kind, False, query=(
                '{ q(func: eq(post.topic, "%s")) { count(uid) } }'
                % topic))
        if kind == "zipf_short":
            hot = self._names[_zipf_draw(self._zipf_cdf, rng)]
            return Op(kind, False, query=(
                '{ q(func: eq(person.name, "%s")) '
                '{ person.name person.age person.city } }' % hot))
        if kind == "zipf_traverse":
            hot = self._names[_zipf_draw(self._zipf_cdf, rng)]
            return Op(kind, False, query=(
                '{ q(func: eq(person.name, "%s")) { person.name '
                'knows { person.name } } }' % hot))
        if kind == "zipf_agg":
            topic = TOPICS[_zipf_draw(self._zipf_topic_cdf, rng)]
            return Op(kind, False, query=(
                '{ q(func: eq(post.topic, "%s")) { count(uid) } }'
                % topic))
        if kind == "mut_edge":
            return Op(kind, True, set_nquads=(
                f'_:c <churn.note> "edge-{i}-{rng.randrange(1 << 30)}" .'))
        if kind == "mut_fanout":
            sub = f"_:f{i}"
            tag = rng.randrange(1 << 30)
            lines = [f'{sub} <churn.note> "fan-{i}-{tag}" .']
            for e in range(self.cfg.fanout_edges):
                lines.append(f"{sub} <churn.ref> _:r{i}x{e} .")
                lines.append(
                    f'_:r{i}x{e} <churn.note> "ref-{i}-{e}-{tag}" .')
            return Op(kind, True, set_nquads="\n".join(lines))
        raise ValueError(f"unknown op kind {kind!r}")


def stream_digest(ops_list: list[Op]) -> str:
    """SHA-256 over the canonical op lines — what the cross-process
    determinism test compares."""
    import hashlib

    h = hashlib.sha256()
    for op in ops_list:
        h.update(op.to_line().encode())
        h.update(b"\n")
    return h.hexdigest()
