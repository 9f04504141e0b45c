"""Spawn/teardown of a real multi-group, multi-process cluster.

The reference load-tests against docker-compose topologies (compose/
compose.go emits N zeros x G groups x R replicas); this module is that
topology as subprocesses of the EXISTING CLI — every node is a real
`python -m dgraph_tpu_torch node` process on real sockets, nothing
shares a GIL with the load generator. Used by tools/dgbench.py and the
tools/check.sh load smoke; tests spawn the same shape ad hoc
(tests/test_multigroup.py) and can migrate here.

Each node gets a --debug-port (the read-only observability listener,
server/debug_http.py) so collectors scrape HTTP; data traffic flows
over the cluster wire via the returned RoutedCluster.

Port of `dgraph_tpu/bench/spawn.py`: a copy, its imports pointed at this
package. Every alpha builds its engine on `device` (None: the card,
where a node without one exits at boot; `alpha_args` may carry
`--device` too), and so does `routed()`'s federated coordinator. A zero
touches no card.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from typing import Optional

_REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def free_ports(n: int) -> list[int]:
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class ProcessCluster:
    """`zeros` zero nodes (one Raft quorum) + `groups` alpha groups of
    `replicas` each, spawned via the CLI. `log_dir` captures each
    node's stderr (the run report's per-node logs); `max_pending`
    turns on wire-surface admission control on every alpha."""

    def __init__(self, groups: int = 2, replicas: int = 1,
                 zeros: int = 1, max_pending: int = 0,
                 log_dir: Optional[str] = None,
                 data_dir: Optional[str] = None,
                 tick_ms: int = 30, election_ticks: int = 8,
                 env_extra: Optional[dict] = None,
                 snapshots: Optional[dict] = None,
                 zero_args: Optional[list] = None,
                 alpha_args: Optional[list] = None,
                 learners: int = 0,
                 cpus_per_group: int = 0,
                 device=None):
        # zero_args: extra CLI flags for every zero node — how the
        # rebalance smoke / benches arm the heat-driven rebalancer
        # (--rebalance-interval, --split-heat, --move-throttle-mb-s)
        #
        # cpus_per_group > 0 pins each alpha GROUP's processes to its
        # own disjoint CPU set (Linux sched_setaffinity). On one box
        # every "group" otherwise shares the same cores, so tablet
        # placement cannot change capacity and a placement bench
        # measures only federation overhead; disjoint sets emulate
        # the real deployment where each group owns its machines.
        self.cpus_per_group = int(cpus_per_group)
        if self.cpus_per_group > 0:
            try:
                avail = len(os.sched_getaffinity(0))
            except AttributeError:
                avail = 0
            if avail < groups * self.cpus_per_group:
                # a short final slice would hand higher-numbered
                # groups less silicon BY CONSTRUCTION and the bench
                # would attribute that to tablet placement — refuse
                # to pin asymmetrically, loudly
                print(f"[spawn] cpus_per_group={self.cpus_per_group} x "
                      f"{groups} groups exceeds {avail} available "
                      "CPUs; affinity pinning DISABLED",
                      file=sys.stderr)
                self.cpus_per_group = 0
        # snapshots: {group -> p.snap path} boots each group's alphas
        # from a bulk/distributed-ingest output (`node --snapshot`);
        # every replica of a group must boot the same file
        self.snapshots = dict(snapshots or {})
        # alpha_args: extra CLI flags for every alpha node — how the
        # read scale-out smoke/bench arm the result cache and tenant
        # QoS (--result-cache, --tenant-rate, --tenant-burst)
        self.alpha_args = [str(a) for a in (alpha_args or ())]
        # device: every alpha's engine (`node --device`; None leaves
        # the node's default, the card) and routed()'s coordinator
        self.device = device
        if device is not None:
            self.alpha_args += ["--device", str(device)]
        # learners: non-voting read replicas per group, spawned AFTER
        # the voters with ids above the voter range. Their raft peer
        # map holds only themselves (the voters' --raft-peers must
        # never list a learner as a voter); the learner discovers the
        # group's voters through zero and conf-joins as add_learner.
        self.learners = int(learners)
        self.groups_n = groups
        self.replicas = replicas
        self.procs: dict[str, subprocess.Popen] = {}
        self.debug_urls: dict[str, str] = {}
        self.zero_addrs: dict[int, tuple[str, int]] = {}
        self.group_addrs: dict[int, dict[int, tuple[str, int]]] = {}
        # per-node address book for the chaos plane: a nemesis that
        # partitions node A from node B needs EVERY listener B owns
        # (raft + client; the debug port stays reachable on purpose —
        # it's the out-of-band control/observation channel)
        self.node_addrs: dict[str, dict[str, tuple[str, int]]] = {}
        self._node_args: dict[str, list[str]] = {}
        self._node_env: dict[str, dict] = {}
        self._logs: dict[str, object] = {}
        self._env = dict(os.environ, PYTHONPATH=_REPO)
        if env_extra:
            self._env.update(env_extra)
        self._tick = ["--tick-ms", str(tick_ms),
                      "--election-ticks", str(election_ticks)]
        self.log_dir = log_dir
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        # data_dir gives every node a persistent raft WAL/snapshot dir
        # (--wal -> cluster/raft.DiskStorage): the restart() nemesis
        # reboots a SIGKILLed node onto its existing state, so
        # acknowledged writes must survive the crash
        self.data_dir = data_dir
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)

        # zero quorum
        zports = free_ports(3 * zeros)
        zraft = {i + 1: ("127.0.0.1", zports[3 * i])
                 for i in range(zeros)}
        zpeers = ",".join(f"{i}={h}:{p}" for i, (h, p) in zraft.items())
        for i in range(1, zeros + 1):
            cport, dport = zports[3 * (i - 1) + 1], zports[3 * (i - 1) + 2]
            self.zero_addrs[i] = ("127.0.0.1", cport)
            self.node_addrs[f"zero-n{i}"] = {
                "raft": zraft[i], "client": ("127.0.0.1", cport),
                "debug": ("127.0.0.1", dport)}
            self._spawn(f"zero-n{i}", [
                "--kind", "zero", "--id", str(i),
                "--raft-peers", zpeers,
                "--client-addr", f"127.0.0.1:{cport}",
                "--debug-port", str(dport)]
                + [str(a) for a in (zero_args or ())])
        zero_spec = ",".join(f"{i}={h}:{p}"
                             for i, (h, p) in self.zero_addrs.items())

        # alpha groups
        for g in range(1, groups + 1):
            ports = free_ports(3 * replicas)
            graft = {i + 1: ("127.0.0.1", ports[3 * i])
                     for i in range(replicas)}
            gpeers = ",".join(f"{i}={h}:{p}"
                              for i, (h, p) in graft.items())
            self.group_addrs[g] = {}
            for i in range(1, replicas + 1):
                cport = ports[3 * (i - 1) + 1]
                dport = ports[3 * (i - 1) + 2]
                self.group_addrs[g][i] = ("127.0.0.1", cport)
                self.node_addrs[f"alpha-g{g}-n{i}"] = {
                    "raft": graft[i], "client": ("127.0.0.1", cport),
                    "debug": ("127.0.0.1", dport)}
                args = ["--kind", "alpha", "--id", str(i),
                        "--group", str(g),
                        "--raft-peers", gpeers,
                        "--client-addr", f"127.0.0.1:{cport}",
                        "--zero", zero_spec,
                        "--debug-port", str(dport)]
                if max_pending:
                    args += ["--max-pending", str(max_pending)]
                if g in self.snapshots:
                    args += ["--snapshot", self.snapshots[g]]
                self._spawn(f"alpha-g{g}-n{i}", args + self.alpha_args)

        # learner read replicas (ids above the voter range; voters'
        # peer maps stay voters-only — the learner conf-joins live)
        self.learner_addrs: dict[int, dict[int, tuple[str, int]]] = {}
        for g in range(1, groups + 1):
            self.learner_addrs[g] = {}
            for k in range(self.learners):
                i = replicas + 1 + k
                rport, cport, dport = free_ports(3)
                self.learner_addrs[g][i] = ("127.0.0.1", cport)
                self.node_addrs[f"alpha-g{g}-n{i}"] = {
                    "raft": ("127.0.0.1", rport),
                    "client": ("127.0.0.1", cport),
                    "debug": ("127.0.0.1", dport)}
                args = ["--kind", "alpha", "--id", str(i),
                        "--group", str(g), "--learner",
                        "--raft-peers", f"{i}=127.0.0.1:{rport}",
                        "--client-addr", f"127.0.0.1:{cport}",
                        "--zero", zero_spec,
                        "--debug-port", str(dport)]
                if max_pending:
                    args += ["--max-pending", str(max_pending)]
                if g in self.snapshots:
                    args += ["--snapshot", self.snapshots[g]]
                self._spawn(f"alpha-g{g}-n{i}", args + self.alpha_args)

    def _spawn(self, name: str, args: list[str]):
        if name not in self._node_args:
            if self.data_dir:
                args = args + ["--wal",
                               os.path.join(self.data_dir, name)]
            self._node_args[name] = list(args)
        env = self._env
        if name in self._node_env:
            env = dict(env, **self._node_env[name])
        if self.log_dir:
            # append mode: a restarted node's pre-crash log survives
            log = open(os.path.join(self.log_dir, name + ".log"), "a")
            old = self._logs.get(name)
            if old is not None:
                try:
                    old.close()
                except OSError:
                    pass
            self._logs[name] = log
        else:
            log = subprocess.DEVNULL
        dport = args[args.index("--debug-port") + 1]
        self.debug_urls[name] = f"http://127.0.0.1:{dport}"
        preexec = None
        if self.cpus_per_group > 0 and name.startswith("alpha-g") \
                and hasattr(os, "sched_setaffinity"):
            g = int(name.split("-")[1][1:])
            avail = sorted(os.sched_getaffinity(0))
            lo = (g - 1) * self.cpus_per_group
            cpuset = set(avail[lo:lo + self.cpus_per_group])
            if cpuset:
                def preexec(cs=cpuset):  # noqa: E731
                    os.sched_setaffinity(0, cs)
        self.procs[name] = subprocess.Popen(
            [sys.executable, "-m", "dgraph_tpu_torch", "node"]
            + self._node_args[name] + self._tick,
            env=env, cwd=_REPO, preexec_fn=preexec,
            stdout=subprocess.DEVNULL, stderr=log)

    # ------------------------------------------------------------ clients

    def routed(self, timeout: float = 30.0):
        """A fresh RoutedCluster over this topology (caller closes)."""
        from dgraph_tpu_torch.cluster.client import ClusterClient
        from dgraph_tpu_torch.cluster.topology import RoutedCluster
        zero = ClusterClient(self.zero_addrs, timeout=timeout)
        groups = {g: ClusterClient(addrs, timeout=timeout)
                  for g, addrs in self.group_addrs.items()}
        return RoutedCluster(zero, groups, device=self.device)

    def node_clients(self, timeout: float = 30.0) -> dict:
        """One single-address ClusterClient per NODE (not per group):
        the collector path — stats/traces/pprof ops hit a specific
        process, not whoever the leader is."""
        from dgraph_tpu_torch.cluster.client import ClusterClient
        out = {}
        for i, addr in self.zero_addrs.items():
            out[f"zero-n{i}"] = ClusterClient({1: addr},
                                              timeout=timeout)
        for g, members in self.group_addrs.items():
            for i, addr in members.items():
                out[f"alpha-g{g}-n{i}"] = ClusterClient(
                    {1: addr}, timeout=timeout)
        return out

    # ------------------------------------------------------------- health

    def wait_ready(self, timeout_s: float = 60.0):
        """Every raft quorum (zero + each group) has a leader."""
        from dgraph_tpu_torch.cluster.client import ClusterClient
        pending = {"zero": ClusterClient(self.zero_addrs, timeout=5.0)}
        for g, addrs in self.group_addrs.items():
            pending[f"g{g}"] = ClusterClient(addrs, timeout=5.0)
        try:
            end = time.monotonic() + timeout_s
            ready: set[str] = set()
            while time.monotonic() < end and len(ready) < len(pending):
                for name, cl in pending.items():
                    if name in ready:
                        continue
                    for node in list(cl.addrs):
                        try:
                            if cl.status(node).get("role") == "leader":
                                ready.add(name)
                                break
                        except (ConnectionError, RuntimeError, KeyError):
                            continue
                if len(ready) < len(pending):
                    time.sleep(0.2)
            if len(ready) < len(pending):
                raise TimeoutError(
                    f"cluster not ready after {timeout_s}s: "
                    f"missing {sorted(set(pending) - ready)}")
        finally:
            for cl in pending.values():
                cl.close()

    def wait_learners(self, timeout_s: float = 60.0):
        """Every learner has conf-joined its group (it sees a leader
        and applied the joining snapshot/log) — the edge after which
        follower reads stop returning wholesale StaleRead."""
        from dgraph_tpu_torch.cluster.client import ClusterClient
        end = time.monotonic() + timeout_s
        for g, members in getattr(self, "learner_addrs", {}).items():
            for i, addr in members.items():
                cl = ClusterClient({1: addr}, timeout=5.0)
                try:
                    while True:
                        try:
                            st = cl.status(1)
                            if st.get("leader") is not None \
                                    and st.get("learner"):
                                break
                        except (ConnectionError, RuntimeError,
                                KeyError):
                            pass
                        if time.monotonic() > end:
                            raise TimeoutError(
                                f"learner alpha-g{g}-n{i} did not "
                                f"join within {timeout_s}s")
                        time.sleep(0.2)
                finally:
                    cl.close()

    def alive(self) -> list[str]:
        return [n for n, p in self.procs.items() if p.poll() is None]

    # ------------------------------------------------------- chaos plane
    # Per-node crash/restart controls for the nemesis harness
    # (tools/dgchaos.py): a node can be SIGKILLed under load and
    # rebooted onto its existing WAL/snapshot dirs (data_dir=).

    def kill(self, name: str, sig: int = signal.SIGKILL):
        """Send `sig` to one node. SIGKILL/SIGTERM reap the process
        (so restart() can re-bind its ports); SIGSTOP/SIGCONT pause
        and resume in place — the network-indistinguishable-partition
        nemesis."""
        p = self.procs[name]
        if p.poll() is not None:
            return
        p.send_signal(sig)
        if sig in (signal.SIGKILL, signal.SIGTERM):
            # never hang the harness on a wedged shutdown path (an
            # armed failpoint holding a lock, a stuck flush): escalate
            # to SIGKILL like teardown() does
            try:
                p.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def restart(self, name: str,
                extra_env: Optional[dict] = None):
        """Reboot a dead node with its ORIGINAL args — same ports,
        same --wal dir. Without data_dir the node comes back empty and
        relies on the raft snapshot transfer from its peers; with it,
        DiskStorage replays the persisted log + snapshot first.

        `extra_env` overlays the node's environment for THIS and
        every later restart — the rolling-upgrade nemesis reboots
        each node with a bumped DGRAPH_TPU_BUILD_VERSION to simulate
        a new binary (the version surfaces on hello/debug stats;
        format and protocol stay min()-negotiated)."""
        p = self.procs.get(name)
        if p is not None and p.poll() is None:
            raise RuntimeError(f"{name} is still running; kill() first")
        if extra_env:
            self._node_env.setdefault(name, {}).update(extra_env)
        self._spawn(name, self._node_args[name])

    def _quorum_of(self, name: str) -> dict[int, tuple[str, int]]:
        """The client addrs of the raft quorum `name` belongs to."""
        if name.startswith("zero"):
            return dict(self.zero_addrs)
        g = int(name.split("-")[1][1:])
        return dict(self.group_addrs[g])

    def leader_of(self, quorum: str,
                  timeout_s: float = 30.0) -> str:
        """Current leader of a quorum ('zero' or 'g<N>') as a node
        name — the kill-leader nemesis target."""
        from dgraph_tpu_torch.cluster.client import ClusterClient
        addrs = dict(self.zero_addrs) if quorum == "zero" \
            else dict(self.group_addrs[int(quorum[1:])])
        cl = ClusterClient(addrs, timeout=5.0)
        try:
            end = time.monotonic() + timeout_s
            while time.monotonic() < end:
                for node in list(addrs):
                    try:
                        if cl.status(node).get("role") == "leader":
                            return f"zero-n{node}" \
                                if quorum == "zero" \
                                else f"alpha-{quorum}-n{node}"
                    except (ConnectionError, RuntimeError, KeyError):
                        continue
                time.sleep(0.2)
            raise TimeoutError(f"no {quorum} leader in {timeout_s}s")
        finally:
            cl.close()

    def wait_caught_up(self, name: str, timeout_s: float = 60.0):
        """Block until a (re)started node rejoined its quorum AND
        applied at least everything its peers had applied when this
        call began — the 'recovery is complete' edge the chaos
        report's restart nemeses measure against. Returns the node's
        final status dict."""
        from dgraph_tpu_torch.cluster.client import ClusterClient
        addrs = self._quorum_of(name)
        nid = int(name.rsplit("n", 1)[1])
        cl = ClusterClient(addrs, timeout=5.0)
        try:
            end = time.monotonic() + timeout_s
            # the catch-up goal: the max applied index any PEER holds
            # now (a single-replica quorum has no peers — the node
            # only has to come back up and re-elect itself)
            goal = 0
            peers = [n for n in addrs if n != nid]
            while peers and time.monotonic() < end:
                seen = []
                for node in peers:
                    try:
                        seen.append(int(
                            cl.status(node).get("applied", 0)))
                    except (ConnectionError, RuntimeError, KeyError):
                        continue
                if seen:
                    goal = max(seen)
                    break
                time.sleep(0.2)
            while time.monotonic() < end:
                try:
                    st = cl.status(nid)
                except (ConnectionError, RuntimeError, KeyError):
                    time.sleep(0.2)
                    continue
                # `leader is not None` matters: a freshly rebooted
                # node reports follower/applied=0 BEFORE any election
                # — only once a leader exists has the new term's noop
                # committed and the persisted log replayed (§5.4.2)
                if st.get("leader") is not None \
                        and st.get("role") in ("leader", "follower") \
                        and int(st.get("applied", 0)) >= goal:
                    return st
                time.sleep(0.2)
            raise TimeoutError(
                f"{name} not caught up to applied>={goal} "
                f"within {timeout_s}s")
        finally:
            cl.close()

    def teardown(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + 5.0
        for p in self.procs.values():
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for log in self._logs.values():
            try:
                log.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.teardown()
