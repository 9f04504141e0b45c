"""Command-line interface.

Mirrors the reference's cobra command tree (dgraph/main.go:29,
dgraph/cmd/root.go:75-78): `alpha` serves the engine, plus the smaller
operational tools. Flags can also come from DGRAPH_TPU_<CMD>_<FLAG>
environment variables, like the reference's DGRAPH_ALPHA_* viper prefixes
(dgraph/cmd/root.go:104-143).

Port of `dgraph_tpu/cli.py`: a copy, its imports pointed at this
package. Every engine a command builds runs on `--device` (default:
the card, raising without one; `--device cpu` for the CPU);
`--no-device` keeps its meaning, `prefer_device=False`. A `node
--kind alpha` builds its engine on `--device` with the reference's host
tiers (`prefer_device=False`); a zero touches no card; `rebalance`'s
federated coordinator runs on `--device`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from dgraph_tpu_torch import __version__


def _coerce(v, default):
    if isinstance(default, bool):
        return str(v).lower() in ("1", "true", "yes")
    if isinstance(default, int) and not isinstance(default, bool):
        return int(v)
    return v


def _apply_config_layers(sub_choices: dict, argv: list) -> list:
    """Flag layering, lowest to highest precedence: parser defaults <
    --config FILE (JSON {subcommand: {flag: value}}) <
    DGRAPH_TPU_<CMD>_<FLAG> env vars < explicit CLI flags — the
    reference's viper config/env/flag stack (dgraph/cmd/root.go:104).
    Mutates the chosen subparser's defaults; returns argv without the
    --config pair."""
    argv = list(argv)
    cfg = {}
    path = None
    for i, a in enumerate(argv):
        if a == "--config":
            if i + 1 >= len(argv):
                print("--config needs a file argument", file=sys.stderr)
                raise SystemExit(2)
            path = argv[i + 1]
            del argv[i:i + 2]
            break
        if a.startswith("--config="):
            path = a.split("=", 1)[1]
            del argv[i]
            break
    if path is not None:
        try:
            with open(path) as f:
                cfg = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"--config {path}: {e}", file=sys.stderr)
            raise SystemExit(2)
    cmd = next((a for a in argv if not a.startswith("-")), None)
    sp = sub_choices.get(cmd)
    if sp is None:
        return argv
    file_vals = cfg.get(cmd, {})
    if not isinstance(file_vals, dict):
        print(f"--config: section {cmd!r} must be an object",
              file=sys.stderr)
        raise SystemExit(2)

    def usage_err(dest, raw, why):
        print(f"config/env value for --{dest.replace('_', '-')}: "
              f"{raw!r} {why}", file=sys.stderr)
        raise SystemExit(2)

    layer = {}
    for action in sp._actions:
        dest = action.dest
        if dest in ("help",):
            continue
        fkey = dest.replace("_", "-")
        raw = None
        if fkey in file_vals or dest in file_vals:
            raw = file_vals.get(fkey, file_vals.get(dest))
        env = os.environ.get(f"DGRAPH_TPU_{cmd.upper()}_{dest.upper()}")
        if env is not None:
            raw = env
        if raw is None:
            continue
        try:
            # run the action's own converter when it has one, else
            # coerce toward the default's type — and honor `choices`,
            # which argparse only checks for CLI-supplied values
            val = action.type(raw) if callable(action.type)                 else _coerce(raw, action.default)
        except (TypeError, ValueError) as e:
            usage_err(dest, raw, f"is invalid ({e})")
        if action.choices is not None and val not in action.choices:
            usage_err(dest, raw,
                      f"not one of {sorted(action.choices)}")
        layer[dest] = val
        # a layered value SATISFIES a required flag (viper semantics)
        action.required = False
    if layer:
        sp.set_defaults(**layer)
    return argv


def cmd_alpha(args) -> int:
    from dgraph_tpu_torch.engine.db import GraphDB
    from dgraph_tpu_torch.server.http import serve

    _load_custom_toks(args)
    enc_key = _enc_key(args)
    if args.snapshot:
        from dgraph_tpu_torch.storage.snapshot import load_snapshot

        db = load_snapshot(args.snapshot,
                           GraphDB(wal_path=args.wal or None,
                                   device=args.device,
                                   prefer_device=not args.no_device,
                                   enc_key=enc_key,
                                   plan_cache_size=args.plan_cache_size,
                                   result_cache_entries=args.result_cache))
    else:
        db = GraphDB(wal_path=args.wal or None, device=args.device,
                     prefer_device=not args.no_device, enc_key=enc_key,
                     plan_cache_size=args.plan_cache_size,
                     result_cache_entries=args.result_cache)
    secret = None
    if args.acl_secret_file:
        with open(args.acl_secret_file, "rb") as f:
            secret = f.read().strip()
    print(f"dgraph-tpu alpha listening on http://{args.host}:{args.port}"
          + (" (ACL on)" if secret else ""), file=sys.stderr)
    tls_ctx = None
    if args.tls_dir:
        from dgraph_tpu_torch.server.tls import server_context
        tls_ctx = server_context(args.tls_dir,
                                 require_client_cert=args.tls_mtls)
    httpd, alpha = serve(db, host=args.host, port=args.port, block=False,
                         acl_secret=secret, tls_context=tls_ctx,
                         mutations_mode=args.mutations,
                         max_pending=args.max_pending,
                         batch_window_us=args.batch_window_us,
                         tenant_rate=args.tenant_rate,
                         tenant_burst=args.tenant_burst)
    _start_watchdog(alpha, "alpha", wal_path=args.wal or "")
    grpc_srv = None
    if args.grpc_port:
        from dgraph_tpu_torch.server.grpc_api import serve_grpc
        # the gRPC listener inherits the SAME TLS posture as HTTP —
        # --tls-dir must never leave a cleartext side door open
        grpc_srv, gport = serve_grpc(
            alpha, host=args.host, port=args.grpc_port,
            tls_dir=args.tls_dir, require_client_cert=args.tls_mtls)
        print(f"dgraph-tpu alpha gRPC on {args.host}:{gport}"
              + (" (TLS)" if args.tls_dir else ""), file=sys.stderr)
    try:
        import time as _time
        while True:  # interruptible on every platform
            _time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        # graceful drain: stop admitting writes, let in-flight
        # requests finish (bounded), then tear the listeners down
        alpha.draining = True
        alpha.wait_idle(timeout_s=10.0)
        httpd.shutdown()
        if grpc_srv is not None:
            grpc_srv.stop(grace=2).wait()
    return 0


def _parse_peers(spec: str) -> dict[int, tuple[str, int]]:
    """'1=127.0.0.1:7101,2=127.0.0.1:7102' -> {1: (host, port), ...}"""
    out: dict[int, tuple[str, int]] = {}
    for part in spec.split(","):
        nid, addr = part.split("=", 1)
        host, port = addr.rsplit(":", 1)
        out[int(nid)] = (host, int(port))
    return out


def cmd_node(args) -> int:
    """A Raft replica process: alpha (replicated GraphDB group member)
    or zero (replicated coordinator quorum member). Ref: dgraph alpha
    --raft / dgraph zero (worker/draft.go, dgraph/cmd/zero/zero.go)."""
    if getattr(args, "skew_s", 0.0):
        # skew-clock nemesis: wall-clock reads in THIS process (TTL
        # reconciliation, stage ages, logs) are offset; raft ticks use
        # time.monotonic and are untouched
        import time as _time
        _real_time = _time.time
        _off = args.skew_s
        _time.time = lambda: _real_time() + _off

    from dgraph_tpu_torch.cluster.service import AlphaServer, ZeroServer

    peers = _parse_peers(args.raft_peers)
    chost, cport = args.client_addr.rsplit(":", 1)
    storage = None
    if args.wal:
        from dgraph_tpu_torch.cluster.raft import DiskStorage
        storage = DiskStorage(args.wal, sync=args.sync)
    kw = dict(storage=storage, tick_s=args.tick_ms / 1000.0,
              election_ticks=args.election_ticks,
              debug_port=args.debug_port, debug_host=args.debug_host)
    if args.kind == "alpha":
        zero_addrs = _parse_peers(args.zero) if args.zero else None
        # the alpha's engine runs on --device (None: the card); the
        # reference's host tiers (prefer_device=False) stay the default
        db_kw = {"device": args.device}
        if getattr(args, "result_cache", 0):
            db_kw["result_cache_entries"] = args.result_cache
        srv = AlphaServer(args.id, peers, (chost, int(cport)),
                          group=args.group, replicas=args.replicas,
                          zero_addrs=zero_addrs,
                          max_pending=args.max_pending,
                          learner=getattr(args, "learner", False),
                          tenant_rate=getattr(args, "tenant_rate", 0.0),
                          tenant_burst=getattr(args, "tenant_burst",
                                               0.0),
                          db_kw=db_kw,
                          snapshot=getattr(args, "snapshot", ""), **kw)
    else:
        srv = ZeroServer(
            args.id, peers, (chost, int(cport)),
            move_throttle_mb_s=args.move_throttle_mb_s,
            move_fence_lag=args.move_fence_lag,
            move_fence_timeout_s=args.move_fence_timeout_s,
            rebalance_interval_s=args.rebalance_interval,
            rebalance_band=args.rebalance_band,
            split_heat=args.split_heat,
            rebalance_pin=args.rebalance_pin,
            rebalance_cooldown_s=args.rebalance_cooldown_s,
            standby_of=_parse_peers(args.standby_of)
            if getattr(args, "standby_of", "") else None, **kw)
    print(f"dgraph-tpu {args.kind} node {args.id}: raft "
          f"{peers[args.id]}, client {srv.client_addr}"
          + (f", debug http {args.debug_host}:{args.debug_port}"
             if args.debug_port else ""), file=sys.stderr,
          flush=True)
    _start_watchdog(srv, getattr(srv, "node_name",
                                 f"{args.kind}-{args.id}"),
                    wal_path=args.wal)
    srv.serve_forever()
    return 0


def _start_watchdog(srv, node_name: str, wal_path: str = ""):
    """Start the per-process alert watchdog (utils/watchdog.py) for a
    long-lived server process. DGRAPH_TPU_WATCHDOG=0 disables; bare
    library embeddings never pass through here so they pay nothing.
    Incident bundles land under $DGRAPH_TPU_INCIDENT_DIR/<node> when
    set, else beside the WAL, else stay in-memory-only (no recorder)."""
    if os.environ.get("DGRAPH_TPU_WATCHDOG", "1") == "0":
        return None
    from dgraph_tpu_torch.utils import watchdog
    base = os.environ.get("DGRAPH_TPU_INCIDENT_DIR", "")
    if base:
        inc_dir = os.path.join(base, node_name)
    elif wal_path:
        root = wal_path if os.path.isdir(wal_path) \
            else os.path.dirname(os.path.abspath(wal_path))
        inc_dir = os.path.join(root, "incidents")
    else:
        inc_dir = None
    wd = watchdog.ensure_started(incident_dir=inc_dir, node=node_name)
    if hasattr(srv, "attach_watchdog"):
        srv.attach_watchdog(wd)
    return wd


def _enc_key(args):
    if getattr(args, "encryption_key_file", ""):
        from dgraph_tpu_torch.storage.enc import load_key
        return load_key(args.encryption_key_file)
    return None


def _load_custom_toks(args):
    paths = getattr(args, "custom_tokenizers", "")
    if paths:
        from dgraph_tpu_torch.models.tokenizer import load_custom_tokenizers
        for spec in load_custom_tokenizers(paths.split(",")):
            print(f"loaded custom tokenizer {spec.name!r} "
                  f"(id {spec.ident:#x})", file=sys.stderr)


def cmd_backup(args) -> int:
    """Binary backup with incremental manifest chain
    (ref `dgraph backup` -> ee/backup/backup.go)."""
    from dgraph_tpu_torch.engine.db import GraphDB

    db = GraphDB(wal_path=args.wal or None, device=args.device,
                 prefer_device=False, enc_key=_enc_key(args))
    from dgraph_tpu_torch.storage.backup import backup

    entry = backup(db, args.destination, force_full=args.full,
                   key=_enc_key(args))
    print(json.dumps(entry, indent=2))
    return 0


def cmd_restore(args) -> int:
    """Restore a backup chain into a fresh store
    (ref `dgraph restore` -> ee/backup/restore.go). With --to-ts,
    point-in-time restore: the chain base plus the captured change
    tail replayed up to that exact commit_ts (storage/backup.py
    restore_to_ts; docs/deployment.md "Disaster recovery")."""
    from dgraph_tpu_torch.engine.db import GraphDB
    from dgraph_tpu_torch.storage.backup import restore, restore_to_ts

    db = GraphDB(wal_path=args.wal or None, device=args.device,
                 prefer_device=False, enc_key=_enc_key(args))
    if args.to_ts:
        restore_to_ts(args.location, args.to_ts, db=db,
                      key=_enc_key(args))
    else:
        restore(args.location, db=db, key=_enc_key(args))
    if args.snapshot_out:
        from dgraph_tpu_torch.storage.snapshot import save_snapshot
        save_snapshot(db, args.snapshot_out)
    print(f"restored {len(db.tablets)} predicates, "
          f"max_ts={db.coordinator.max_assigned()}", file=sys.stderr)
    return 0


def cmd_acl(args) -> int:
    """ACL admin against a store directory (ref `dgraph acl` subcommands,
    ee/acl/acl.go: useradd/userdel/groupadd/groupdel/usermod/chmod/info)."""
    from dgraph_tpu_torch.engine.db import GraphDB
    from dgraph_tpu_torch.server.acl import AclManager

    if not args.wal:
        # without a WAL every change silently dies with the process
        # (advisor finding) — refuse rather than print a false success
        print("acl: --wal is required (changes must persist)",
              file=sys.stderr)
        return 2
    db = GraphDB(wal_path=args.wal, device=args.device,
                 prefer_device=False, enc_key=_enc_key(args))
    mgr = AclManager(db, secret=b"cli")
    op = args.acl_op
    if op == "useradd":
        mgr.add_user(args.user, args.password)
    elif op == "userdel":
        mgr.delete_principal(args.user)
    elif op == "groupadd":
        mgr.add_group(args.group)
    elif op == "groupdel":
        mgr.delete_principal(args.group)
    elif op == "usermod":
        mgr.set_groups(args.user, [g for g in args.groups.split(",") if g])
    elif op == "chmod":
        mgr.chmod(args.group, args.pred, args.perm)
    elif op == "info":
        print(json.dumps(mgr.info(), indent=2))
    return 0


def cmd_version(args) -> int:
    print(f"dgraph-tpu {__version__}")
    import torch

    print(f"torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"cards: {torch.cuda.device_count()}")
    if torch.cuda.is_available():
        from dgraph_tpu_torch.backend import card_info
        print(card_info())
    return 0


def cmd_increment(args) -> int:
    """Txn smoke-test canary: read-increment-write a counter N times,
    read and write inside ONE transaction so concurrent canaries
    conflict-abort instead of losing updates
    (ref dgraph/cmd/counter/increment.go:109)."""
    import urllib.error
    import urllib.request

    base = f"http://{args.addr}"

    def post(path, data, ctype):
        req = urllib.request.Request(
            base + path, data.encode(), {"Content-Type": ctype})
        return json.loads(urllib.request.urlopen(req).read())

    done = 0
    while done < args.num:
        # the query's read ts names the txn; mutate+commit attach to it
        r = post("/query", '{ q(func: has(counter.val)) { uid counter.val } }',
                 "application/dql")
        ts = r["extensions"]["txn"]["start_ts"]
        rows = r["data"]["q"]
        if rows:
            uid, val = rows[0]["uid"], rows[0]["counter.val"] + 1
            sub = f"<{uid}>"
        else:
            sub, val = "_:c", 1
        try:
            post(f"/mutate?startTs={ts}",
                 f'{sub} <counter.val> "{val}"^^<xs:int> .',
                 "application/rdf")
            post(f"/commit?startTs={ts}", "", "application/json")
        except urllib.error.HTTPError as e:
            if e.code == 409:  # conflict: retry the whole read-modify-write
                continue
            raise
        done += 1
        print(f"counter.val = {val}")
    return 0


def cmd_bulk(args) -> int:
    """Offline bulk loader (ref dgraph/cmd/bulk/run.go:106). With
    --workers N the load runs cluster-parallel (map workers + one
    reduce process per --reduce-shards group, ingest/distributed.py)
    writing bootable group snapshots directly."""
    import time

    from dgraph_tpu_torch.ingest.bulk import bulk_load

    _load_custom_toks(args)
    schema = open(args.schema).read() if args.schema else ""
    if args.workers > 0:
        if not args.out:
            print("error: --workers needs --out (a directory of "
                  "group snapshots)", file=sys.stderr)
            return 2
        from dgraph_tpu_torch.ingest.distributed import distributed_load
        toks = tuple(p for p in getattr(
            args, "custom_tokenizers", "").split(",") if p)
        manifest = distributed_load(
            args.files, schema=schema,
            groups=max(1, args.reduce_shards),
            workers=args.workers, outdir=args.out,
            custom_tokenizers=toks)
        st = manifest["stats"]
        print(f"mapped {st['mapped']} nquads in {st['map_s']}s, "
              f"reduced {st['reduced']} in {st['reduce_s']}s "
              f"({st['mapped'] / max(st['total_s'], 1e-9):.0f} "
              f"RDF/s end to end)")
        for g, ps in sorted(manifest["groups"].items(),
                            key=lambda kv: int(kv[0])):
            print(f"group {g}: {len(ps)} tablets -> "
                  f"{args.out}/g{g}/p.snap")
        print(f"manifest written to {args.out}/manifest.json")
        return 0
    t0 = time.monotonic()
    db = bulk_load(args.files, schema=schema, device=args.device)
    dt = time.monotonic() - t0
    n = sum(sum(len(v) for v in t.edges.values()) +
            sum(len(v) for v in t.values.values())
            for t in db.tablets.values())
    print(f"loaded {n} edges across {len(db.tablets)} predicates "
          f"in {dt:.2f}s ({n / max(dt, 1e-9):.0f} edges/s)")
    if args.out and args.reduce_shards > 1:
        from dgraph_tpu_torch.ingest.bulk import bulk_shard_outputs

        manifest = bulk_shard_outputs(db, args.reduce_shards, args.out)
        for g, ps in sorted(manifest["groups"].items(),
                            key=lambda kv: int(kv[0])):
            print(f"group {g}: {len(ps)} tablets -> "
                  f"{args.out}/g{g}/p.snap")
        print(f"manifest written to {args.out}/manifest.json")
    elif args.out:
        from dgraph_tpu_torch.storage.snapshot import save_snapshot

        save_snapshot(db, args.out)
        print(f"snapshot written to {args.out}")
    else:
        print("warning: no --out given; load was a dry run "
              "(nothing persisted)", file=sys.stderr)
    return 0


def cmd_live(args) -> int:
    """Online live loader (ref dgraph/cmd/live/run.go:238). With
    --alpha, streams into a RUNNING server over HTTP (the reference's
    defining mode); otherwise loads an embedded store."""
    schema = open(args.schema).read() if args.schema else ""
    if args.alpha:
        from dgraph_tpu_torch.ingest.live import remote_live_load
        stats = remote_live_load(args.alpha, args.files, schema=schema,
                                 batch_size=args.batch,
                                 concurrency=args.conc,
                                 token=args.token)
        print(json.dumps(stats))
        return 0
    from dgraph_tpu_torch.engine.db import GraphDB
    from dgraph_tpu_torch.ingest.live import live_load

    if not args.wal:
        print("warning: no --wal given; loaded data dies with the process",
              file=sys.stderr)
    db = GraphDB(wal_path=args.wal or None, device=args.device)
    stats = live_load(db, args.files, schema=schema,
                      batch_size=args.batch, concurrency=args.conc)
    print(json.dumps(stats))
    return 0


def cmd_export(args) -> int:
    """Full-store export (ref worker/export.go:376)."""
    from dgraph_tpu_torch.engine.db import GraphDB
    from dgraph_tpu_torch.ingest.export import (
        export_json, export_rdf, export_schema,
    )

    if args.snapshot:
        from dgraph_tpu_torch.storage.snapshot import load_snapshot

        db = load_snapshot(args.snapshot, device=args.device)
    elif args.wal:
        db = GraphDB(wal_path=args.wal, device=args.device)
    else:
        print("export: need --wal or --snapshot", file=sys.stderr)
        return 2
    with open(args.out, "w") as f:
        if args.format == "rdf":
            for line in export_rdf(db):
                f.write(line + "\n")
        else:
            json.dump(export_json(db), f)
    with open(args.out + ".schema", "w") as f:
        f.write(export_schema(db))
    print(f"exported to {args.out} (+.schema)")
    return 0


def cmd_debug(args) -> int:
    """Offline store inspector over a WAL file
    (ref dgraph/cmd/debug/run.go)."""
    from dgraph_tpu_torch.engine.db import GraphDB

    db = GraphDB(wal_path=args.wal, device=args.device)
    if args.what == "jepsen":
        # bank-invariant checker (ref dgraph/cmd/debug/run.go:323
        # --jepsen seekTotal): deltas stay UNFOLDED so every commit in
        # the WAL is a readable MVCC snapshot; the balance total must
        # be identical at each one
        pred = args.pred or "bal"
        tab = db.tablets.get(pred)
        if tab is None:
            print(f"no tablet {pred!r}", file=sys.stderr)
            return 1
        tss = sorted({ts for ts, _ in tab.deltas})
        if tab.base_ts:
            tss.insert(0, tab.base_ts)
        report: dict = {"pred": pred, "snapshots": len(tss),
                        "violations": []}
        want = None
        for ts in tss:
            total = 0
            for uid in tab.src_uids(ts).tolist():
                ps = tab.get_postings(int(uid), ts)
                if ps:
                    try:
                        total += int(ps[0].value.value)
                    except (TypeError, ValueError):
                        pass
            if want is None:
                want = total
            elif total != want:
                report["violations"].append(
                    {"ts": ts, "total": total, "expected": want})
        report["ok"] = not report["violations"]
        report["total"] = want
        print(json.dumps(report, indent=2))
        return 0 if report["ok"] else 1
    db.rollup_all(window=0)  # fold replayed deltas so counts reflect the store
    st = db.state()
    if args.what == "state":
        print(json.dumps(st, indent=2, default=str))
    elif args.what == "schema":
        print(db.schema.describe_all())
    elif args.what == "histogram":
        for pred, tab in sorted(db.tablets.items()):
            n = sum(len(v) for v in tab.edges.values()) + \
                sum(len(v) for v in tab.values.values())
            print(f"{pred}\t{n}")
    elif args.what == "posting":
        # posting inspector (ref dgraph/cmd/debug/run.go lookup mode:
        # dump one uid's postings + the index tokens covering them)
        from dgraph_tpu_torch.models.tokenizer import get_tokenizer, tokens_for
        if not args.pred or not args.uid:
            print("debug posting needs --pred and --uid",
                  file=sys.stderr)
            return 2
        tab = db.tablets.get(args.pred)
        if tab is None:
            print(f"no tablet {args.pred!r}", file=sys.stderr)
            return 1
        uid = int(args.uid, 0)
        ts = db.coordinator.max_assigned()
        out: dict = {"pred": args.pred, "uid": hex(uid)}
        dsts = tab.get_dst_uids(uid, ts)
        if len(dsts):
            out["edges"] = [hex(int(d)) for d in dsts.tolist()]
        rev = tab.get_reverse_uids(uid, ts)
        if len(rev):
            out["reverse"] = [hex(int(s)) for s in rev.tolist()]
        ps = tab.get_postings(uid, ts)
        if ps:
            out["postings"] = [
                {"value": str(p.value.value), "type": p.value.tid.name,
                 "lang": p.lang,
                 "facets": {k: str(v.value)
                            for k, v in p.facets.items()},
                 "tokens": [str(t) for tname in tab.schema.tokenizers
                            for t in tokens_for(
                                p.value, get_tokenizer(tname), p.lang)]}
                for p in ps]
        print(json.dumps(out, indent=2, default=str))
    return 0


def cmd_cert(args) -> int:
    """TLS certificate management (ref `dgraph cert`, dgraph/cmd/cert/)."""
    from dgraph_tpu_torch.server import tls as tlsmod

    if args.cert_op == "ls":
        print(json.dumps(tlsmod.describe(args.dir), indent=2))
        return 0
    import os as _os
    if not _os.path.exists(_os.path.join(args.dir, "ca.crt")):
        tlsmod.create_ca(args.dir, days=args.duration)
        print(f"created CA in {args.dir}", file=sys.stderr)
    if args.cert_op in ("node", "create"):
        hosts = tuple(h for h in args.nodes.split(",") if h)
        crt, key = tlsmod.create_pair(args.dir, "node", hosts=hosts,
                                      days=args.duration)
        print(f"node pair: {crt}, {key}", file=sys.stderr)
    if args.client:
        crt, key = tlsmod.create_pair(args.dir, "client", args.client,
                                      days=args.duration)
        print(f"client pair: {crt}, {key}", file=sys.stderr)
    return 0


def cmd_conv(args) -> int:
    """GeoJSON -> RDF (ref `dgraph conv`, dgraph/cmd/conv/)."""
    from dgraph_tpu_torch.ingest.convert import convert_geojson

    with open(args.geo) as fin, open(args.out, "w") as fout:
        stats = convert_geojson(fin, fout, geopred=args.geopred)
    print(json.dumps(stats))
    return 0


def cmd_migrate(args) -> int:
    """SQL -> RDF + schema (ref `dgraph migrate`, dgraph/cmd/migrate/;
    sqlite is the SQL source here — the table/row/foreign-key mapping
    matches the reference's MySQL walker)."""
    from dgraph_tpu_torch.ingest.convert import migrate_sqlite

    with open(args.output_data, "w") as rdf, \
            open(args.output_schema, "w") as sch:
        stats = migrate_sqlite(args.db, rdf, sch,
                               separator=args.separator)
    print(json.dumps(stats))
    return 0


def cmd_debuginfo(args) -> int:
    """Collect a diagnostics archive (ref `dgraph debuginfo`,
    dgraph/cmd/debuginfo: pprof + state; here: /health /state /metrics
    + thread stacks + env)."""
    import faulthandler
    import io
    import platform
    import tarfile
    import time as _time
    import urllib.request

    files: dict[str, bytes] = {}
    if args.alpha:
        base = f"http://{args.alpha}"
        for path in ("/health", "/state", "/debug/prometheus_metrics"):
            try:
                files[path.strip("/").replace("/", "_")] = \
                    urllib.request.urlopen(base + path, timeout=5).read()
            except Exception as e:  # noqa: BLE001 — capture what we can
                files[path.strip("/").replace("/", "_") + ".error"] = \
                    str(e).encode()
    import tempfile
    with tempfile.TemporaryFile(mode="w+") as tf:
        faulthandler.dump_traceback(file=tf)
        tf.seek(0)
        files["threads.txt"] = tf.read().encode()
    files["platform.txt"] = "\n".join([
        platform.platform(), platform.python_version(),
        f"argv={sys.argv}"]).encode()
    # wall clock: the archive NAME is a user-visible timestamp
    out = args.archive or f"debuginfo-{int(_time.time())}.tar.gz"  # dglint: disable=DG06
    with tarfile.open(out, "w:gz") as tar:
        for name, data in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    print(out)
    return 0


def cmd_compose(args) -> int:
    """Generate a cluster topology launcher (ref compose/compose.go:
    the reference emits docker-compose.yml for N zeros x G groups x R
    replicas; here the artifact is a runnable shell script plus a JSON
    topology map for RoutedCluster)."""
    zeros = args.num_zeros
    groups = args.num_groups
    replicas = args.num_replicas
    port = args.base_port
    lines = ["#!/bin/sh", "# generated by dgraph-tpu compose",
             "set -e", 'mkdir -p "$(dirname "$0")/wal"', ""]
    topo: dict = {"zero": {}, "groups": {}}

    def alloc():
        nonlocal port
        port += 1
        return port

    zraft = {i: f"127.0.0.1:{alloc()}" for i in range(1, zeros + 1)}
    zpeers = ",".join(f"{i}={a}" for i, a in zraft.items())
    for i in range(1, zeros + 1):
        caddr = f"127.0.0.1:{alloc()}"
        topo["zero"][i] = caddr
        lines.append(
            f"python -m dgraph_tpu_torch node --kind zero --id {i} "
            f"--raft-peers {zpeers} --client-addr {caddr} "
            f'--wal "$(dirname "$0")/wal/zero{i}" &')
    zero_clients = ",".join(f"{i}={a}" for i, a in topo["zero"].items())
    for g in range(1, groups + 1):
        graft = {i: f"127.0.0.1:{alloc()}"
                 for i in range(1, replicas + 1)}
        gpeers = ",".join(f"{i}={a}" for i, a in graft.items())
        topo["groups"][g] = {}
        for i in range(1, replicas + 1):
            caddr = f"127.0.0.1:{alloc()}"
            topo["groups"][g][i] = caddr
            lines.append(
                f"python -m dgraph_tpu_torch node --kind alpha --id {i} "
                f"--group {g} --raft-peers {gpeers} "
                f"--client-addr {caddr} --zero {zero_clients} "
                f'--wal "$(dirname "$0")/wal/g{g}n{i}" &')
    lines += ["", "wait"]
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.chmod(args.out, 0o755)
    with open(args.out + ".topology.json", "w") as f:
        json.dump(topo, f, indent=2)
    print(f"wrote {args.out} and {args.out}.topology.json "
          f"({zeros} zeros, {groups} groups x {replicas} replicas)")
    return 0


def cmd_standby(args) -> int:
    """Standby-cluster admin against the STANDBY's zero quorum
    (cluster/replication.py): `status` prints per-predicate
    replication lag; `promote` fails the standby over to a writable
    primary — fencing the old primary, draining to its post-fence CDC
    heads, and reporting measured RPO/RTO (docs/deployment.md
    "Disaster recovery & upgrades")."""
    from dgraph_tpu_torch.cluster.client import ClusterClient

    zero = ClusterClient(_parse_peers(args.zero), timeout=60.0)
    try:
        if args.standby_op == "status":
            out = zero._unwrap(zero.request({"op": "repl_status"}))
            print(json.dumps(out, indent=2))
            return 0
        out = zero.request({"op": "standby_promote",
                            "force": args.force})
        if not out.get("ok"):
            print(f"promote failed: {out.get('error')}",
                  file=sys.stderr)
            return 1
        res = out["result"]
        print(json.dumps(res, indent=2))
        print(f"promoted: rpo_clean={res['rpo_clean']} "
              f"drained={res['rpo_commits_drained']} commits, "
              f"rto={res['rto_ms']}ms", file=sys.stderr)
        return 0
    finally:
        zero.close()


def cmd_rebalance(args) -> int:
    """Tablet rebalancing (ref zero/tablet.go:62 rebalanceTablets; the
    reference runs it inside zero every --rebalance_interval 8m). Takes
    the compose topology map, moves one tablet heaviest->lightest per
    tick until converged; --once for a single pass."""
    import time as _time

    from dgraph_tpu_torch.cluster.client import ClusterClient
    from dgraph_tpu_torch.cluster.topology import Rebalancer, RoutedCluster

    with open(args.topology) as f:
        topo = json.load(f)

    def addrs(d: dict) -> dict:
        out = {}
        for i, a in d.items():
            host, port = a.rsplit(":", 1)
            out[int(i)] = (host, int(port))
        return out

    zero = ClusterClient(addrs(topo["zero"]), timeout=30.0)
    groups = {int(g): ClusterClient(addrs(members), timeout=30.0)
              for g, members in topo["groups"].items()}
    rc = RoutedCluster(zero, groups, device=args.device)
    reb = Rebalancer(rc, interval_s=args.interval,
                     threshold=args.threshold)
    try:
        while True:
            try:
                move = reb.tick()
            except Exception as e:  # noqa: BLE001 — daemon keeps going
                if args.once:
                    raise
                # transient (zero election, concurrent operator move):
                # log and retry next interval, like the in-zero loop
                print(f"rebalance pass failed: {e}", file=sys.stderr)
                move = None
            if move:
                pred, src, dst = move
                print(f"moved tablet {pred!r}: group {src} -> {dst}")
            elif args.once:
                print("balanced")
            if args.once:
                if move is None:
                    return 0
                continue  # --once converges without pacing
            # daemon mode paces ONE move per interval so the cluster
            # absorbs each export/import before the next (the
            # reference's rebalance_interval exists for exactly this)
            _time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        rc.close()


def _device_flag(parser):
    parser.add_argument("--device", default=None,
                        help="torch device of the engine (default: the "
                             "card, cuda:0; `cpu` for the CPU)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dgraph-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("alpha", help="serve the engine over HTTP")
    a.add_argument("--host", default="0.0.0.0")
    a.add_argument("--port", type=int,
                   default=8080)
    a.add_argument("--wal", default="")
    a.add_argument("--snapshot", default="")
    a.add_argument("--no-device", action="store_true",
                   default=False)
    a.add_argument("--max-pending", type=int, default=0,
                   help="admission control: max concurrently admitted "
                        "requests; excess sheds with HTTP 429 "
                        "(retryable). 0 = unbounded (ref the "
                        "reference's pending-query throttle)")
    a.add_argument("--mutations", default="allow",
                   choices=["allow", "disallow", "strict"],
                   help="mutation mode (ref --mutations, "
                        "alpha/run.go:502)")
    a.add_argument("--plan-cache-size", type=int, default=128,
                   help="compiled query plan cache entries "
                        "(query/plan.py); 0 disables and every "
                        "request takes the interpreted path")
    a.add_argument("--batch-window-us", type=int, default=0,
                   help="micro-batching window in microseconds: "
                        "concurrent queries sharing a plan-cache key "
                        "coalesce into one dispatch. 0 = off")
    a.add_argument("--result-cache", type=int, default=0,
                   help="CDC-invalidated query result cache entries "
                        "(engine/result_cache.py): best-effort reads "
                        "serve byte-identical cached responses until "
                        "a write touches their predicate footprint. "
                        "0 = off")
    a.add_argument("--tenant-rate", type=float, default=0.0,
                   help="per-tenant QoS: admission tokens/second per "
                        "X-Dgraph-Tenant namespace; a tenant over its "
                        "rate sheds 429 without starving the rest. "
                        "0 = off")
    a.add_argument("--tenant-burst", type=float, default=0.0,
                   help="per-tenant QoS bucket depth (defaults to "
                        "--tenant-rate when 0)")
    a.add_argument("--acl_secret_file",
                   default="",
                   help="enables ACL; file holds the HMAC jwt secret")
    a.add_argument("--encryption_key_file",
                   default="",
                   help="AES key file: encrypts WAL records at rest")
    a.add_argument("--grpc-port", type=int, default=0,
                   help="also serve the gRPC API on this port (ref "
                        "dgraph alpha's 9080)")
    a.add_argument("--tls-dir", default="",
                   help="serve HTTPS from this cert dir (see `cert`)")
    a.add_argument("--tls-mtls", action="store_true",
                   help="require client certificates (mTLS)")
    a.add_argument("--custom_tokenizers", default="",
                   help="comma-separated Python plugin files, each "
                        "exporting tokenizer() (ref tok/tok.go:116 "
                        "LoadCustomTokenizer)")
    _device_flag(a)
    a.set_defaults(fn=cmd_alpha)

    acl = sub.add_parser("acl", help="ACL admin on a store directory")
    acl.add_argument("acl_op", choices=["useradd", "userdel", "groupadd",
                                        "groupdel", "usermod", "chmod",
                                        "info"])
    acl.add_argument("--wal", default="", help="store WAL path")
    acl.add_argument("--encryption_key_file", default="")
    acl.add_argument("-a", "--user", default="")
    acl.add_argument("-g", "--group", default="")
    acl.add_argument("-p", "--password", default="")
    acl.add_argument("-l", "--groups", default="",
                     help="comma-separated groups for usermod")
    acl.add_argument("--pred", default="", help="predicate for chmod")
    acl.add_argument("-m", "--perm", type=int, default=0,
                     help="perm bits for chmod: Read=4 Write=2 Modify=1")
    _device_flag(acl)
    acl.set_defaults(fn=cmd_acl)

    bk = sub.add_parser("backup", help="binary backup (manifest chain)")
    bk.add_argument("--wal", default="", help="store WAL path")
    bk.add_argument("destination", help="backup dir or file:// URI")
    bk.add_argument("--full", action="store_true",
                    help="force a full backup instead of incremental")
    bk.add_argument("--encryption_key_file", default="")
    _device_flag(bk)
    bk.set_defaults(fn=cmd_backup)

    rs = sub.add_parser("restore", help="restore a backup chain")
    rs.add_argument("location", help="backup dir or file:// URI")
    rs.add_argument("--wal", default="",
                    help="WAL path for the restored store")
    rs.add_argument("--snapshot_out", default="",
                    help="also write a snapshot file")
    rs.add_argument("--to-ts", dest="to_ts", type=int, default=0,
                    help="point-in-time restore: materialize the "
                         "state at this commit_ts (any covered "
                         "instant, not just backup boundaries)")
    rs.add_argument("--encryption_key_file", default="")
    _device_flag(rs)
    rs.set_defaults(fn=cmd_restore)

    v = sub.add_parser("version", help="print version info")
    v.set_defaults(fn=cmd_version)

    c = sub.add_parser("increment", help="txn canary: increment a counter")
    c.add_argument("--addr", default="127.0.0.1:8080")
    c.add_argument("--num", type=int, default=1)
    c.set_defaults(fn=cmd_increment)

    b = sub.add_parser("bulk", help="offline bulk loader")
    b.add_argument("files", nargs="+")
    b.add_argument("--schema", default="")
    b.add_argument("--out", default="",
                   help="snapshot file to write (the bulk output); "
                        "with --reduce-shards > 1, a DIRECTORY of "
                        "per-group snapshots out/g<k>/p.snap")
    b.add_argument("--reduce-shards", type=int, default=1,
                   help="shard the output across N future alpha "
                        "groups (ref dgraph bulk --reduce_shards: "
                        "one out/<i>/p per group)")
    b.add_argument("--workers", type=int, default=0,
                   help="distributed load: N map-worker processes + "
                        "one reduce process per --reduce-shards "
                        "group, streaming the shuffle over the wire "
                        "and writing bootable group snapshots "
                        "directly (0 = single-core loader)")
    b.add_argument("--custom_tokenizers", default="",
                   help="comma-separated Python plugin files, each "
                        "exporting tokenizer()")
    _device_flag(b)
    b.set_defaults(fn=cmd_bulk)

    lv = sub.add_parser("live", help="online live loader")
    lv.add_argument("files", nargs="+")
    lv.add_argument("--schema", default="")
    lv.add_argument("--wal", default="")
    lv.add_argument("--alpha", default="",
                    help="host:port of a running alpha: stream over "
                         "HTTP instead of loading an embedded store")
    lv.add_argument("--token", default="",
                    help="access JWT for ACL-protected alphas "
                         "(ref dgraph live --creds)")
    lv.add_argument("--batch", type=int, default=1000)
    lv.add_argument("--conc", type=int, default=4)
    _device_flag(lv)
    lv.set_defaults(fn=cmd_live)

    e = sub.add_parser("export", help="export store to RDF/JSON")
    e.add_argument("--wal", default="")
    e.add_argument("--snapshot", default="")
    e.add_argument("--out", required=True)
    e.add_argument("--format", choices=["rdf", "json"], default="rdf")
    _device_flag(e)
    e.set_defaults(fn=cmd_export)

    d = sub.add_parser("debug", help="offline store inspector")
    d.add_argument("--wal", required=True)
    d.add_argument("what",
                   choices=["state", "schema", "histogram", "posting",
                            "jepsen"])
    d.add_argument("--pred", default="")
    d.add_argument("--uid", default="")
    _device_flag(d)
    d.set_defaults(fn=cmd_debug)

    n = sub.add_parser("node", help="raft replica (alpha group / zero)")
    n.add_argument("--kind", choices=["alpha", "zero"], default="alpha")
    n.add_argument("--id", type=int, required=True)
    n.add_argument("--raft-peers", required=True,
                   help="id=host:port,... for every group member")
    n.add_argument("--client-addr", required=True, help="host:port")
    n.add_argument("--group", type=int, default=1,
                   help="alpha group id (predicate shard); 0 = let "
                        "zero assign the least-replicated group and "
                        "raft-join it live (ref zero.go:410 Connect)")
    n.add_argument("--replicas", type=int, default=1,
                   help="replica target per group for --group 0 "
                        "placement (ref zero --replicas)")
    n.add_argument("--zero", default="",
                   help="zero quorum client addrs (id=host:port,...) — "
                        "enables multi-group mode: tablet ownership "
                        "checks + zero-leased uid blocks")
    n.add_argument("--skew-s", type=float, default=0.0,
                   help="TEST NEMESIS: offset this process's wall "
                        "clock by SKEW seconds (time.time only) — the "
                        "Jepsen skew-clock nemesis (ref contrib/"
                        "jepsen/main.go:31-43); correctness must not "
                        "depend on wall clocks (the ts oracle is "
                        "zero-issued and logical)")
    n.add_argument("--snapshot", default="",
                   help="boot the group's engine from a bulk output "
                        "snapshot (out/g<k>/p.snap); every replica of "
                        "the group must use the same file")
    n.add_argument("--wal", default="", help="raft storage directory")
    n.add_argument("--sync", action="store_true")
    n.add_argument("--tick-ms", type=int, default=50)
    n.add_argument("--election-ticks", type=int, default=10)
    n.add_argument("--debug-port", type=int, default=0,
                   help="serve the read-only debug/observability "
                        "HTTP surface (/debug/stats, /debug/requests, "
                        "/debug/prometheus_metrics, /debug/traces, "
                        "/debug/pprof) on this port — the reference's "
                        "per-node pprof/expvar mux. 0 = off")
    n.add_argument("--debug-host", default="127.0.0.1",
                   help="bind address for --debug-port (keep it "
                        "localhost/scrape-net: the surface is "
                        "unauthenticated by design)")
    n.add_argument("--max-pending", type=int, default=0,
                   help="alpha only: admission control on the wire "
                        "surface — max concurrently served "
                        "query/mutate/task ops; excess sheds typed "
                        "(retryable) like the HTTP edge's 429. "
                        "0 = unbounded")
    n.add_argument("--learner", action="store_true",
                   help="alpha only: join the group as a NON-VOTING "
                        "read replica (raft learner): receives the "
                        "replicated log, never campaigns or serves "
                        "writes, answers watermark-bounded follower "
                        "reads (with --group 0, zero places it on the "
                        "least-loaded existing group)")
    n.add_argument("--tenant-rate", type=float, default=0.0,
                   help="alpha only: per-tenant QoS admission "
                        "tokens/second per tenant namespace; a tenant "
                        "over its rate sheds typed (retryable) "
                        "without starving the rest. 0 = off")
    n.add_argument("--tenant-burst", type=float, default=0.0,
                   help="alpha only: per-tenant QoS bucket depth "
                        "(defaults to --tenant-rate when 0)")
    n.add_argument("--result-cache", type=int, default=0,
                   help="alpha only: CDC-invalidated query result "
                        "cache entries; replica-consistent change-log "
                        "offsets keep every replica's cache honest. "
                        "0 = off")
    n.add_argument("--move-throttle-mb-s", type=float, default=64.0,
                   help="zero only: tablet-move snapshot streaming "
                        "budget in MB/s (the source keeps serving; "
                        "the throttle bounds the move's bandwidth "
                        "tax). 0 = unthrottled")
    n.add_argument("--move-fence-lag", type=int, default=16,
                   help="zero only: fence the moving tablet's writes "
                        "once CDC catch-up is within this many "
                        "change-log entries of the source head")
    n.add_argument("--move-fence-timeout-s", type=float, default=5.0,
                   help="zero only: unfence (writes resume, catch-up "
                        "continues) if the fence drain hasn't "
                        "converged by then")
    n.add_argument("--rebalance-interval", type=float, default=0.0,
                   help="zero only: heat-driven rebalancer tick "
                        "seconds (ref zero --rebalance_interval 8m); "
                        "0 = disabled")
    n.add_argument("--rebalance-band", type=float, default=1.4,
                   help="zero only: hysteresis — rebalance only when "
                        "the heaviest group's load exceeds BAND x the "
                        "lightest's")
    n.add_argument("--rebalance-pin", default="",
                   help="zero only: comma list of predicates the "
                        "rebalancer must never auto-move — the "
                        "colocation knob for constraints it cannot "
                        "see (e.g. a vector predicate plus the "
                        "attributes its similar_to queries select: "
                        "cross-group vector search is unsupported)")
    n.add_argument("--rebalance-cooldown-s", type=float, default=120.0,
                   help="zero only: a just-moved tablet is frozen "
                        "this long so the heat EWMA re-equilibrates "
                        "instead of thrashing it back")
    n.add_argument("--standby-of", default="",
                   help="zero only: run this cluster as an async-"
                        "replication STANDBY tailing the primary "
                        "whose zero quorum listens at these client "
                        "addrs (id=host:port,...). The standby boots "
                        "write-fenced (client writes refused, typed); "
                        "`dgraph-tpu standby promote` fails over with "
                        "measured RPO/RTO (docs/deployment.md "
                        "\"Disaster recovery & upgrades\")")
    n.add_argument("--split-heat", type=float, default=0.0,
                   help="zero only: heat EWMA past which a group-"
                        "dominating predicate splits into hash-range "
                        "sub-tablets instead of moving whole; "
                        "0 = splitting disabled")
    n.add_argument("--device", default=None,
                   help="alpha only: torch device of the engine "
                        "(default: the card, cuda:0; `cpu` for the "
                        "CPU); a zero touches no card")
    n.set_defaults(fn=cmd_node)

    ct = sub.add_parser("cert", help="TLS certificate management")
    ct.add_argument("cert_op", choices=["create", "node", "ls"],
                    nargs="?", default="create")
    ct.add_argument("--dir", default="tls")
    ct.add_argument("--nodes", default="localhost,127.0.0.1",
                    help="node cert SAN hosts, comma separated")
    ct.add_argument("--client", default="", help="issue a client pair")
    ct.add_argument("--duration", type=int, default=730, help="days")
    ct.set_defaults(fn=cmd_cert)

    cv = sub.add_parser("conv", help="GeoJSON -> RDF converter")
    cv.add_argument("--geo", required=True)
    cv.add_argument("--out", default="output.rdf")
    cv.add_argument("--geopred", default="loc")
    cv.set_defaults(fn=cmd_conv)

    mg = sub.add_parser("migrate", help="SQL (sqlite) -> RDF + schema")
    mg.add_argument("--db", required=True, help="sqlite database file")
    mg.add_argument("--output-data", default="sql.rdf")
    mg.add_argument("--output-schema", default="schema.txt")
    mg.add_argument("--separator", default=".")
    mg.set_defaults(fn=cmd_migrate)

    di = sub.add_parser("debuginfo", help="collect diagnostics archive")
    di.add_argument("--alpha", default="",
                    help="alpha host:port to scrape state/metrics from")
    di.add_argument("--archive", default="")
    di.set_defaults(fn=cmd_debuginfo)

    co = sub.add_parser("compose", help="generate a cluster launcher")
    co.add_argument("--num-zeros", type=int, default=3)
    co.add_argument("--num-groups", type=int, default=2)
    co.add_argument("--num-replicas", type=int, default=3)
    co.add_argument("--base-port", type=int, default=7000)
    co.add_argument("--out", default="cluster.sh")
    co.set_defaults(fn=cmd_compose)

    sb = sub.add_parser("standby",
                        help="async-replication standby admin "
                             "(status / promote)")
    sb.add_argument("standby_op", choices=["status", "promote"],
                    help="status: per-predicate replication lag; "
                         "promote: fail over to a writable primary "
                         "with measured RPO/RTO")
    sb.add_argument("--zero", required=True,
                    help="the STANDBY cluster's zero client addrs "
                         "(id=host:port,...)")
    sb.add_argument("--force", action="store_true",
                    help="promote even if the primary is unreachable "
                         "(accepts losing the unreplicated tail; "
                         "RPO reported as unclean)")
    sb.set_defaults(fn=cmd_standby)

    rb = sub.add_parser("rebalance",
                        help="tablet rebalancer (zero/tablet.go:62)")
    rb.add_argument("topology",
                    help="topology.json from `compose`")
    rb.add_argument("--interval", type=float, default=480.0,
                    help="seconds between passes (ref "
                         "--rebalance_interval 8m)")
    rb.add_argument("--threshold", type=int, default=2,
                    help="min load spread before moving a tablet")
    rb.add_argument("--once", action="store_true",
                    help="run until balanced, then exit")
    rb.add_argument("--device", default=None,
                    help="torch device of the federated coordinator's "
                         "engine (default: the card, cuda:0; `cpu` for "
                         "the CPU)")
    rb.set_defaults(fn=cmd_rebalance)

    argv = _apply_config_layers(sub.choices,
                                argv if argv is not None else sys.argv[1:])
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
