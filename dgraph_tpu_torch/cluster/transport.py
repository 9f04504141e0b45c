"""TCP transport for Raft messages: the conn/ tier.

The reference moves Raft traffic over gRPC streams with pooled
connections (conn/pool.go:45 Pool, conn/node.go:48 send loops,
conn/raft_server.go:126 RaftMessage handler). Here the same role is a
length-prefixed wire-frame protocol over plain TCP: one listener per
node, one lazily-dialed persistent connection per peer, best-effort
send (Raft tolerates drops; the protocol retries by design).

This plugs into the Msg seam cluster/raft.py promises: anything that
can deliver `Msg` objects can drive a RaftNode — the SimCluster bus in
tests, this transport in real deployments.

Port of `dgraph_tpu/cluster/transport.py`: a copy, its imports pointed at
this package.
"""

from __future__ import annotations

import socket
import threading
from typing import Callable, Optional

from dgraph_tpu_torch import wire
from dgraph_tpu_torch.cluster.raft import Msg
from dgraph_tpu_torch.utils import failpoint, netfault
from dgraph_tpu_torch.utils.metrics import inc_counter

_HELLO = b"DGTRAFT1"


class TcpTransport:
    """Raft Msg delivery over TCP (peer id -> (host, port) map)."""

    def __init__(self, node_id: int, peers: dict[int, tuple[str, int]],
                 on_msg: Callable[[Msg], None]):
        self.id = node_id
        self.peers = dict(peers)
        self.on_msg = on_msg
        self._out: dict[int, socket.socket] = {}
        self._out_lock = threading.Lock()
        self._closed = threading.Event()
        host, port = self.peers[node_id]
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self.addr = self._listener.getsockname()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"raft-accept-{node_id}",
            daemon=True)

    def start(self):
        """Begin accepting inbound connections. Separate from __init__
        so the owner can finish wiring (e.g. assign the transport
        attribute its on_msg handler reads) before messages arrive."""
        self._accept_thread.start()

    # ------------------------------------------------------------ inbound

    def _accept_loop(self):
        while not self._closed.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._read_loop, args=(conn,),
                             daemon=True).start()

    def _read_loop(self, conn: socket.socket):
        try:
            if wire.read_frame(conn) != _HELLO:
                return
            while not self._closed.is_set():
                msg = wire.loads(wire.read_frame(conn))
                if isinstance(msg, Msg):
                    self.on_msg(msg)
        except (EOFError, OSError, wire.WireError):
            pass
        finally:
            conn.close()

    # ----------------------------------------------------------- outbound

    def send(self, msg: Msg) -> bool:
        """Best-effort: one attempt over the pooled conn, one redial.
        Raft's own retry logic (heartbeats, append retries) recovers
        from drops, like the reference's conn.Pool send failures."""
        if self._closed.is_set():
            return False
        try:
            # chaos seam: an armed `transport.send` failpoint delays
            # (sleep) or drops (error) outbound Raft frames — the
            # deterministic in-process flaky-network nemesis
            failpoint.fire("transport.send")
        except failpoint.FailpointError:
            inc_counter("raft_send_drops")
            return False
        dup = False
        if netfault.armed():
            # network fault plane (utils/netfault.py): the armed rule
            # table models this link — drop eats the frame (Raft's own
            # retries recover, exactly like a lossy wire), delay slept
            # inside act(), DUP sends the idempotent frame twice
            addr = self.peers.get(msg.to)
            verdict = netfault.act(addr) if addr is not None else None
            if verdict == netfault.DROP:
                inc_counter("raft_send_drops")
                return False
            dup = verdict == netfault.DUP
        for attempt in (0, 1):
            sock = self._conn_to(msg.to, force_new=attempt == 1)
            if sock is None:
                inc_counter("raft_send_drops")
                return False
            try:
                wire.write_frame(sock, wire.dumps(msg))
                if dup:
                    wire.write_frame(sock, wire.dumps(msg))
                return True
            except OSError:
                self._drop_conn(msg.to)
        inc_counter("raft_send_drops")
        return False

    def _conn_to(self, peer: int,
                 force_new: bool = False) -> Optional[socket.socket]:
        with self._out_lock:
            sock = self._out.get(peer)
            if sock is not None and not force_new:
                return sock
            if sock is not None:
                sock.close()
                del self._out[peer]
            addr = self.peers.get(peer)
        if addr is None:
            return None
        # dial OUTSIDE the lock (dglint DG04): a 1s connect timeout to
        # one dead peer must not serialize sends to every healthy peer
        try:
            sock = socket.create_connection(addr, timeout=1.0)
            sock.settimeout(5.0)
            wire.write_frame(sock, _HELLO)
        except OSError:
            return None
        with self._out_lock:
            if self._closed.is_set():
                sock.close()
                return None
            cur = self._out.get(peer)
            if cur is not None:
                # a racing dialer won; keep ONE pooled conn per peer
                sock.close()
                return cur
            self._out[peer] = sock
            return sock

    def _drop_conn(self, peer: int):
        with self._out_lock:
            sock = self._out.pop(peer, None)
        if sock is not None:
            sock.close()

    # -------------------------------------------------------------- close

    def close(self):
        self._closed.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._out_lock:
            for sock in self._out.values():
                sock.close()
            self._out.clear()
