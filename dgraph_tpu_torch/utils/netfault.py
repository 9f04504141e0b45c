"""Network fault injection: a runtime-controllable outbound rule table.

The reference proves fault tolerance with Jepsen nemeses that cut real
networks from the outside (contrib/jepsen/main.go: partition-ring,
partition-half, skew-clock); utils/failpoint.py already covers the
*surgical in-process* half of that matrix. This module is the network
half, enforced at the two process-egress choke points —
cluster/transport.py `send` (Raft frames) and cluster/client.py
`_rpc_once` (every wire RPC: client->server, alpha->zero, federated
tasks, 2PC stage/finalize) — so a rule armed in one process shapes
every byte it tries to put on the wire.

The table is PROCESS-LOCAL and OUTBOUND-ONLY (the iptables-OUTPUT
model): the src of every rule is implicitly "this process", the dst is
matched against the destination listener address. A symmetric
partition between nodes A and B is therefore two rules — one armed on
A covering B's addresses, one on B covering A's — which is exactly how
tools/dgchaos.py builds its partition nemeses via the `{"op":"fault"}`
wire op / POST /debug/fault. One-way partitions arm one side only.
Responses flowing back over an already-accepted connection are NOT
intercepted (in-flight packets survive real partitions too); cutting
both directions of fresh traffic is what the symmetric rule pair does.

Rule shape (a plain dict, JSON-serializable end to end):

    {"id": "r1",                     # auto-assigned when omitted
     "dst": "127.0.0.1:7080" | [..] | "*",   # listener addr(s)
     "drop": 1.0,                    # P(frame/RPC dropped); 1.0 = cut
     "delay_ms": 40.0,               # fixed delay before each send
     "jitter_ms": 25.0,              # + uniform[0, jitter) extra
     "dup": 0.0}                     # P(Raft frame sent twice)

First matching rule wins (exact dst before "*", in arm order).
`dup` applies to Raft frames only: transport messages are idempotent
by protocol, while duplicating a framed RPC would desynchronize the
request/response pairing on the pooled client connection.

Inert cost: `armed()` is one falsy-dict check — the transport seam
gate (`bench_micro.py --netfault-overhead`) holds it under 1% of the
summary mix. Determinism: `seed()` pins the module RNG so a chaos
schedule replays; the env var DGRAPH_TPU_NETFAULT (a JSON rule list)
arms subprocess cluster nodes at boot, like DGRAPH_TPU_FAILPOINTS.

Port of `dgraph_tpu/utils/netfault.py`: a copy, its imports pointed at this
package.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Optional, Union

from dgraph_tpu_torch.utils.metrics import inc_counter, set_gauge

ENV_VAR = "DGRAPH_TPU_NETFAULT"

# verdicts act() hands back to the enforcement seams
DROP = "drop"
DUP = "dup"

_MAX_DELAY_S = 5.0  # clamp: a fat-fingered delay must not wedge a node

_LOCK = threading.Lock()
_RULES: dict[str, dict] = {}   # id -> rule (insertion order = priority)
_RNG = random.Random()
_SEQ = [0]


def armed() -> bool:
    """One falsy-dict check: the whole inert-path cost at the seams."""
    return bool(_RULES)


def _norm_dst(dst: Union[str, list, tuple]) -> tuple[str, ...]:
    if isinstance(dst, str):
        return (dst,)
    return tuple(str(d) for d in dst)


def _validate(rule: dict) -> dict:
    out = {
        "id": str(rule.get("id") or ""),
        "dst": _norm_dst(rule.get("dst", "*")),
        "drop": min(1.0, max(0.0, float(rule.get("drop", 0.0)))),
        "delay_ms": max(0.0, float(rule.get("delay_ms", 0.0))),
        "jitter_ms": max(0.0, float(rule.get("jitter_ms", 0.0))),
        "dup": min(1.0, max(0.0, float(rule.get("dup", 0.0)))),
    }
    if not (out["drop"] or out["delay_ms"] or out["jitter_ms"]
            or out["dup"]):
        raise ValueError(
            f"inert fault rule {rule!r}: want drop/delay_ms/"
            "jitter_ms/dup")
    return out


def add_rule(rule: dict) -> str:
    """Arm one rule; returns its id. Validation is eager so a typo'd
    nemesis fails at arm time, not silently mid-schedule."""
    r = _validate(rule)
    with _LOCK:
        if not r["id"]:
            _SEQ[0] += 1
            r["id"] = f"r{_SEQ[0]}"
        _RULES[r["id"]] = r
        n = len(_RULES)
    set_gauge("dgraph_net_fault_rules", n)
    return r["id"]


def set_rules(rule_list: list) -> list[str]:
    """Replace the whole table atomically (the nemesis 'arm schedule'
    op): either every rule parses or nothing changes."""
    parsed = [_validate(dict(r)) for r in rule_list]
    with _LOCK:
        _RULES.clear()
        ids = []
        for r in parsed:
            if not r["id"]:
                _SEQ[0] += 1
                r["id"] = f"r{_SEQ[0]}"
            _RULES[r["id"]] = r
            ids.append(r["id"])
        n = len(_RULES)
    set_gauge("dgraph_net_fault_rules", n)
    return ids


def remove(rule_id: str) -> bool:
    with _LOCK:
        found = _RULES.pop(rule_id, None) is not None
        n = len(_RULES)
    set_gauge("dgraph_net_fault_rules", n)
    return found


def clear():
    with _LOCK:
        _RULES.clear()
    set_gauge("dgraph_net_fault_rules", 0)


def rules() -> list[dict]:
    """JSON-ready snapshot of the armed table (the /debug/fault and
    /debug/stats payload — an operator can SEE a partition)."""
    with _LOCK:
        return [dict(r, dst=list(r["dst"])) for r in _RULES.values()]


def seed(n: int):
    """Pin the probabilistic rolls so a chaos schedule replays."""
    _RNG.seed(n)


def _match(addr: str) -> Optional[dict]:
    # exact dst beats "*" regardless of arm order; within a class,
    # first armed wins
    wild = None
    for r in _RULES.values():
        if addr in r["dst"]:
            return r
        if wild is None and "*" in r["dst"]:
            wild = r
    return wild


def act(addr: Union[str, tuple],
        can_dup: bool = True) -> Optional[str]:
    """Evaluate the table for one outbound send to `addr`
    ("host:port" or a (host, port) tuple). Applies any delay INLINE
    (sleeping the sending thread — the coarse model of a slow link),
    then returns DROP, DUP or None. Callers must check `armed()`
    first; this function assumes a non-empty table is likely.

    `can_dup=False` (the RPC seams, where duplicating a framed
    request would desynchronize the pooled request/response pairing)
    skips the dup roll entirely — the dup counter only ever counts
    duplications that actually happen."""
    if not isinstance(addr, str):
        addr = f"{addr[0]}:{addr[1]}"
    with _LOCK:
        r = _match(addr)
        if r is None:
            return None
        # independent rolls, all drawn under the lock so a seeded
        # schedule replays byte-for-byte under thread interleaving
        dropped = r["drop"] and _RNG.random() < r["drop"]
        duped = (can_dup and not dropped and r["dup"]
                 and _RNG.random() < r["dup"])
        delay_s = 0.0
        if not dropped and (r["delay_ms"] or r["jitter_ms"]):
            delay_s = min(_MAX_DELAY_S,
                          (r["delay_ms"]
                           + _RNG.random() * r["jitter_ms"]) / 1e3)
    if dropped:
        # a dropped frame pays no delay: the seam fails fast, like a
        # blackholed packet (the sender's own timeouts model the wait)
        inc_counter("dgraph_net_fault_drops_total")
        return DROP
    # sleep OUTSIDE the lock: one delayed link must not serialize
    # verdicts for every other destination
    if delay_s:
        inc_counter("dgraph_net_fault_delays_total")
        time.sleep(delay_s)
    if duped:
        inc_counter("dgraph_net_fault_dups_total")
        return DUP
    return None


def handle_control(req: dict) -> dict:
    """The one fault-control dispatch shared by the `{"op":"fault"}`
    wire op and POST /debug/fault: {"action": "list"|"add"|"set"|
    "remove"|"clear", "rules": [...], "rule": {...}, "id": "...",
    "seed": N}. Returns the post-action table."""
    action = req.get("action", "list")
    if "seed" in req:
        seed(int(req["seed"]))
    if action == "add":
        add_rule(dict(req["rule"]))
    elif action == "set":
        set_rules(list(req.get("rules", ())))
    elif action == "remove":
        remove(str(req.get("id", "")))
    elif action == "clear":
        clear()
    elif action != "list":
        raise ValueError(f"unknown fault action {action!r}")
    return {"rules": rules()}


def arm_from_env(env: Optional[str] = None):
    """Arm from DGRAPH_TPU_NETFAULT (a JSON rule list) — subprocess
    cluster nodes booted mid-nemesis inherit the fault plane the same
    way they inherit failpoints. Unset/empty stays inert."""
    raw = os.environ.get(ENV_VAR, "") if env is None else env
    raw = raw.strip()
    if not raw:
        return
    set_rules(json.loads(raw))


arm_from_env()
