"""Command-line interface of the port: run a standalone node, check or
inspect a data dir offline, back up, restore and verify archives, and print
the config.

The port's counterpart of pilosa_tpu/cli.py's ``server``, ``import``,
``export``, ``check``, ``inspect``, ``backup``, ``restore``,
``backup-verify``, ``config`` and ``generate-config`` commands. ``server`` takes the same flags, plus
``--device``; a flag of a feature this slice does not carry exits with
status 2 and names the ROADMAP.md slice that brings it. Config precedence
is the JAX package's: flags > env (``PILOSA_TPU_*``) > TOML file
(``--config``).

Usage::

    python -m pilosa_tpu_torch.cli server --bind 127.0.0.1:10101 \
        [--device cuda|cpu] [--data-dir DIR]
    python -m pilosa_tpu_torch.cli import [--host H] [--buffer-size N] \
        [--clear] INDEX FIELD FILE...
    python -m pilosa_tpu_torch.cli export [--host H] [--shard N] INDEX FIELD
    python -m pilosa_tpu_torch.cli check [DIR] [--repair] [--archive ARCHIVE]
    python -m pilosa_tpu_torch.cli inspect DIR
    python -m pilosa_tpu_torch.cli backup [--host H] [--parent ID] ARCHIVE
    python -m pilosa_tpu_torch.cli restore [--host H] [--id ID] [--force] \
        [--pitr-ops N] ARCHIVE
    python -m pilosa_tpu_torch.cli backup-verify [--id ID] ARCHIVE
    python -m pilosa_tpu_torch.cli config [--config FILE]
    python -m pilosa_tpu_torch.cli generate-config
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
import urllib.error
import urllib.request

from pilosa_tpu_torch.errors import SLICE_CLUSTER

#: the JAX CLI's config table, key for key and value for value, so
#: ``config`` prints what that CLI prints and a file either CLI writes
#: configures both; the keys of features this slice does not carry are
#: refused by ``server`` when set to anything but their default
#: (``_UNPORTED``). The comments are the JAX CLI's: where they speak of XLA
#: compiles, the port builds its CUDA kernels instead.
_DEFAULTS = {
    "bind": "127.0.0.1:10101",
    "data_dir": "",
    "peers": "",
    "replica_n": 1,
    "anti_entropy_interval": 10.0,
    "check_nodes_interval": 5.0,
    # Quorum fencing: a fenced minority node refuses all external
    # traffic with 503. True opts queries/exports out of the fence
    # (stale reads stay available; writes and schema stay fenced).
    "fence_stale_reads": False,
    # Background integrity scrub: re-verify snapshot CRCs + repair
    # quarantined fragments from replicas (0 disables).
    "scrub_interval": 60.0,
    # Unattended backups: every backup_interval seconds the coordinator
    # captures an incremental into archive_url (a directory path or an
    # s3-style http(s)://host:port/bucket[/prefix] URL; empty disables),
    # opening a fresh full chain every backup_full_every runs and
    # pruning superseded chains down to backup_keep_chains.
    "backup_interval": 0.0,
    "archive_url": "",
    "backup_full_every": 8,
    "backup_keep_chains": 2,
    # WAL records per fragment before a background snapshot triggers
    # (reference MaxOpN, fragment.go:84).
    "max_op_n": 10_000,
    # Cap on preserved *.quarantine evidence files per fragment; the
    # oldest are pruned after a successful scrub repair (0 keeps all).
    "quarantine_keep_n": 0,
    "join": "",
    "tls_cert": "",
    "tls_key": "",
    "tls_ca_cert": "",
    "tls_skip_verify": "",
    "trace_endpoint": "",
    "planner": True,
    # Buffer-pool pre-fault at boot, MB (native recycled page pool; see
    # roaring_codec.cpp). Imports allocate block/staging buffers from
    # recycled fault-warm pages instead of paying first-touch faults —
    # the classic database buffer-pool reserve.
    "import_pool_mb": 512,
    # QoS (pilosa_tpu.qos): concurrency gate on query dispatch, bounded
    # admission queue (excess load sheds with 503 + Retry-After), and a
    # default per-query deadline (seconds; 0 = none). The gate is ON
    # for the CLI server — set qos_max_concurrent = 0 to disable.
    "qos_max_concurrent": 32,
    "qos_max_queue": 64,
    "qos_internal_reserve": 4,
    "qos_default_deadline": 0.0,
    "qos_slow_query_ms": 500.0,
    # Kernel warmup at node start: comma-separated kernel families
    # ("count,topn,bsi"; "" disables) compiled for each shard-count
    # bucket, so steady traffic never pays the cold XLA compile.
    "qos_warmup": "count,topn,bsi",
    "qos_warmup_shards": "1,8,32",
    # Overload resilience. Adaptive concurrency: qos_max_concurrent is
    # the CEILING; the operative limit is measured (AIMD over admitted
    # queue-wait/latency). Per-tenant token buckets (req/s per API key
    # or index; 0 disables; rejections are 429 + Retry-After, distinct
    # from the gate's 503 shed).
    "qos_adaptive": True,
    "qos_tenant_rate": 0.0,
    "qos_tenant_burst": 0.0,
    # Per-peer circuit breakers on the inter-node client: this many
    # consecutive connection failures / deadline overruns open the
    # breaker (0 disables); after the cooldown one half-open probe
    # re-closes it.
    "breaker_threshold": 5,
    "breaker_cooldown": 5.0,
    # Hedged reads on replicated legs: a backup request to the next
    # replica after hedge_delay_ms (0 = measured p95), first success
    # wins, bounded to ~hedge_budget_pct% of primary legs.
    "hedge": True,
    "hedge_delay_ms": 0.0,
    "hedge_budget_pct": 5.0,
    # Chaos fault injection (POST /internal/fault): OFF unless the
    # operator opts in — the route lets any client that can reach the
    # port inject per-query latency, so it must never ship armed.
    "chaos_faults": False,
    # Persistent XLA compilation cache directory. "" resolves to
    # <data-dir>/compile-cache (memory-only when no data dir); "off"
    # disables. A restarted node reloads every kernel compiled by
    # prior runs instead of paying the cold trace+compile.
    "compile_cache_dir": "",
    # Plan-shape bucketing policy: "pow2" rounds stack heights up to
    # power-of-two buckets (zero-padded, bit-identical results) so a
    # never-seen shard count dispatches into an already-compiled
    # kernel; "none" pads only to the device-mesh multiple.
    "plan_buckets": "pow2",
    # Plan-keyed result cache budget, MB (0 disables) and TTL backstop,
    # seconds (0 = epoch-invalidation only). The TTL exists for the
    # cross-node staleness window (a lost index-dirty broadcast), not
    # as the primary invalidation mechanism.
    "result_cache_mb": 64,
    "result_cache_ttl": 0.0,
    # Device-side fold of remote bitmap legs: "auto" picks host vs
    # device by a measured size crossover; "on"/"off" force a side
    # (results are bit-identical either way).
    "device_reduce": "auto",
    # Coalesce concurrent outbound legs to one peer into a single
    # multiplexed request (POST /internal/query-mux). Peers that don't
    # speak the envelope automatically get per-query requests.
    "multiplex": True,
    # Device-side BSI bit-plane transpose for bulk value imports:
    # "auto" picks host vs device by batch size (bit-identical).
    "ingest_transpose": "auto",
    # WAL group commit: fsync window in ms when fsync-per-append is on
    # (0 = one fsync per append; concurrent appends share one fsync).
    "wal_group_commit_ms": 0.0,
    # Import-stream in-flight byte budget, MB (0 = unbounded); over
    # budget trips 429 + Retry-After instead of queueing.
    "ingest_max_inflight_mb": 0,
    # Query-dispatch pipeline (README "Query dispatch"). Fuse: hot read
    # plans (Count trees, BSI Sum/Min/Max) trace to ONE jitted device
    # program per query ("auto" resolves to on; "off" restores the
    # stepped path, bit-identical). Coalesce: concurrent dispatches of
    # the same plan signature batch into one launch within a sub-ms
    # window ("auto" batches only while a same-plan launch is in
    # flight; "on" always waits the window). Inline transfer: a solo
    # waiter steals its own device->host wave instead of hopping
    # through the resolver thread ("auto" steals only when the queue
    # has a single entry).
    "dispatch_fuse": "auto",
    "dispatch_coalesce": "auto",
    "dispatch_coalesce_us": 150.0,
    "inline_transfer": "auto",
    # Device residency: packed [S, K] index stacks for low-cardinality
    # rows ("auto" packs only rows at least 8x smaller than the dense
    # plane; bit-identical) and the pipelined async upload path for
    # non-resident leaf stacks.
    "residency_packed": "auto",
    "prefetch": "on",
    # Device key planes (pilosa_tpu/exec/keyplane): forward key
    # translation via a resident sorted-hash plane for large keyed
    # batches ("auto" probes on device only for batches of 256+ keys;
    # "off" keeps the lock-free host snapshot path only).
    "translate_planes": "auto",
    # Approximate analytics (pilosa_tpu/sketch): HLL precision for
    # Count(Distinct(...)) — 2^p registers, ~1.04/sqrt(2^p) relative
    # error — and the estimated cardinality below which the answer is
    # computed exactly instead (0 disables the exact fallback).
    "sketch_precision": 12,
    "sketch_exact_threshold": 1024,
    # Per-query cost profiles: retain the slowest N at /debug/queries
    # (0 disables the ring). profile_queries=False limits profiling to
    # explicit ?profile=true requests.
    "profile_ring_n": 64,
    "profile_queries": True,
}

#: knobs of the port alone, merged into the server's config.
_PORT_DEFAULTS = {
    # where the node's data and kernels live: "cuda" (raises without a
    # card) or "cpu" (the kernels' plain versions).
    "device": "cuda",
}

#: server flags (by argparse dest) of features later slices bring, each
#: with the ROADMAP.md Queue 1 slice that ports it.
_UNPORTED = {
    "scrub_interval": SLICE_CLUSTER,
    "peers": SLICE_CLUSTER, "replica_n": SLICE_CLUSTER, "join": SLICE_CLUSTER,
    "tls_ca_cert": SLICE_CLUSTER, "tls_skip_verify": SLICE_CLUSTER,
    "breaker_threshold": SLICE_CLUSTER, "breaker_cooldown": SLICE_CLUSTER,
    "hedge": SLICE_CLUSTER, "hedge_delay_ms": SLICE_CLUSTER,
    "hedge_budget_pct": SLICE_CLUSTER, "fence_stale_reads": SLICE_CLUSTER,
    "chaos_faults": SLICE_CLUSTER, "trace_endpoint": SLICE_CLUSTER,
    "device_reduce": SLICE_CLUSTER, "multiplex": SLICE_CLUSTER,
    "ingest_max_inflight_mb": SLICE_CLUSTER,
}


def _load_config(path: str | None, extra: dict | None = None) -> dict:
    cfg = dict(_DEFAULTS, **(extra or {}))
    if path:
        import tomllib
        with open(path, "rb") as f:
            for k, v in tomllib.load(f).items():
                cfg[k.replace("-", "_")] = v
    for k in cfg:
        env = os.environ.get(f"PILOSA_TPU_{k.upper()}")
        if env is not None:
            cur = cfg[k]
            if isinstance(cur, bool):
                cfg[k] = env.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                cfg[k] = int(env)
            elif isinstance(cur, float):
                cfg[k] = float(env)
            else:
                cfg[k] = env
    return cfg


def _refuse_unported(args, parser: argparse.ArgumentParser, cfg: dict) -> None:
    """Exit 2 (argparse's usage error) on a flag, or a config key other
    than its default, of a feature this slice does not carry."""
    for dest, slice_name in _UNPORTED.items():
        given = getattr(args, dest) != parser.get_default(dest)
        if given or cfg.get(dest) != _DEFAULTS.get(dest):
            flag = "--" + dest.replace("_", "-")
            parser.error(f"{flag} is not ported to pilosa_tpu_torch yet "
                         f"(ROADMAP.md Queue 1: {slice_name})")


def cmd_server(args, parser: argparse.ArgumentParser) -> int:
    cfg = _load_config(args.config, _PORT_DEFAULTS)
    _refuse_unported(args, parser, cfg)
    if args.bind:
        cfg["bind"] = args.bind
    if args.device:
        cfg["device"] = args.device
    if args.no_planner:
        cfg["planner"] = False
    if args.tls_cert:
        cfg["tls_cert"] = args.tls_cert
    if args.tls_key:
        cfg["tls_key"] = args.tls_key
    if args.qos_max_concurrent is not None:
        cfg["qos_max_concurrent"] = args.qos_max_concurrent
    if args.qos_max_queue is not None:
        cfg["qos_max_queue"] = args.qos_max_queue
    if args.qos_default_deadline is not None:
        cfg["qos_default_deadline"] = args.qos_default_deadline
    if args.qos_adaptive is not None:
        cfg["qos_adaptive"] = args.qos_adaptive == "on"
    if args.qos_tenant_rate is not None:
        cfg["qos_tenant_rate"] = args.qos_tenant_rate
    if args.qos_tenant_burst is not None:
        cfg["qos_tenant_burst"] = args.qos_tenant_burst
    if args.profile_ring is not None:
        cfg["profile_ring_n"] = args.profile_ring
    if args.profile_queries is not None:
        cfg["profile_queries"] = args.profile_queries
    if args.data_dir:
        cfg["data_dir"] = args.data_dir
    if args.max_op_n is not None:
        cfg["max_op_n"] = args.max_op_n
    if args.quarantine_keep_n is not None:
        cfg["quarantine_keep_n"] = args.quarantine_keep_n
    if args.wal_group_commit_ms is not None:
        cfg["wal_group_commit_ms"] = args.wal_group_commit_ms
    if args.import_pool_mb is not None:
        cfg["import_pool_mb"] = args.import_pool_mb
    if args.backup_interval is not None:
        cfg["backup_interval"] = args.backup_interval
    if args.archive_url is not None:
        cfg["archive_url"] = args.archive_url
    if args.backup_full_every is not None:
        cfg["backup_full_every"] = args.backup_full_every
    if args.backup_keep_chains is not None:
        cfg["backup_keep_chains"] = args.backup_keep_chains
    if args.ingest_transpose is not None:
        cfg["ingest_transpose"] = args.ingest_transpose
    if args.qos_warmup is not None:
        cfg["qos_warmup"] = args.qos_warmup
    if args.qos_warmup_shards is not None:
        cfg["qos_warmup_shards"] = args.qos_warmup_shards
    if args.plan_buckets is not None:
        cfg["plan_buckets"] = args.plan_buckets
    if args.result_cache_mb is not None:
        cfg["result_cache_mb"] = args.result_cache_mb
    if args.result_cache_ttl is not None:
        cfg["result_cache_ttl"] = args.result_cache_ttl
    if args.dispatch_fuse is not None:
        cfg["dispatch_fuse"] = args.dispatch_fuse
    if args.dispatch_coalesce is not None:
        cfg["dispatch_coalesce"] = args.dispatch_coalesce
    if args.dispatch_coalesce_us is not None:
        cfg["dispatch_coalesce_us"] = args.dispatch_coalesce_us
    if args.inline_transfer is not None:
        cfg["inline_transfer"] = args.inline_transfer
    if args.residency_packed is not None:
        cfg["residency_packed"] = args.residency_packed
    if args.prefetch is not None:
        cfg["prefetch"] = args.prefetch
    if args.translate_planes is not None:
        cfg["translate_planes"] = args.translate_planes
    if args.sketch_precision is not None:
        cfg["sketch_precision"] = args.sketch_precision
    if args.sketch_exact_threshold is not None:
        cfg["sketch_exact_threshold"] = args.sketch_exact_threshold
    if args.compile_cache_dir is not None:
        cfg["compile_cache_dir"] = args.compile_cache_dir

    from pilosa_tpu_torch.server.node import ServerNode
    node = ServerNode(
        bind=cfg["bind"],
        device=cfg["device"],
        use_planner=bool(cfg["planner"]),
        tls_cert=str(cfg["tls_cert"]) or None,
        tls_key=str(cfg["tls_key"]) or None,
        backup_interval=float(cfg["backup_interval"]),
        archive_url=str(cfg["archive_url"]) or None,
        backup_full_every=int(cfg["backup_full_every"]),
        backup_keep_chains=int(cfg["backup_keep_chains"]),
        qos_max_concurrent=int(cfg["qos_max_concurrent"]),
        qos_max_queue=int(cfg["qos_max_queue"]),
        qos_internal_reserve=int(cfg["qos_internal_reserve"]),
        qos_default_deadline=float(cfg["qos_default_deadline"]),
        qos_slow_query_ms=float(cfg["qos_slow_query_ms"]),
        qos_adaptive=bool(cfg["qos_adaptive"]),
        qos_tenant_rate=float(cfg["qos_tenant_rate"]),
        qos_tenant_burst=float(cfg["qos_tenant_burst"]),
        profile_ring_n=int(cfg["profile_ring_n"]),
        profile_queries=(str(cfg["profile_queries"]).lower()
                         in ("1", "true", "yes", "on")),
        data_dir=str(cfg["data_dir"]) or None,
        max_op_n=int(cfg["max_op_n"]),
        quarantine_keep_n=int(cfg["quarantine_keep_n"]),
        wal_group_commit_ms=float(cfg["wal_group_commit_ms"]),
        import_pool_mb=int(cfg["import_pool_mb"]),
        qos_warmup=str(cfg["qos_warmup"]),
        qos_warmup_shards=str(cfg["qos_warmup_shards"]),
        plan_buckets=str(cfg["plan_buckets"]) or "pow2",
        result_cache_mb=int(cfg["result_cache_mb"]),
        result_cache_ttl=float(cfg["result_cache_ttl"]),
        dispatch_fuse=str(cfg["dispatch_fuse"]) or "auto",
        dispatch_coalesce=str(cfg["dispatch_coalesce"]) or "auto",
        dispatch_coalesce_us=float(cfg["dispatch_coalesce_us"]),
        inline_transfer=str(cfg["inline_transfer"]) or "auto",
        residency_packed=str(cfg["residency_packed"]) or "auto",
        prefetch=str(cfg["prefetch"]) or "on",
        ingest_transpose=str(cfg["ingest_transpose"]) or "auto",
        translate_planes=str(cfg["translate_planes"]) or "auto",
        sketch_precision=int(cfg["sketch_precision"]),
        sketch_exact_threshold=int(cfg["sketch_exact_threshold"]),
        compile_cache_dir=str(cfg["compile_cache_dir"]) or None,
    )
    node.open()
    where = f", data dir {cfg['data_dir']}" if cfg["data_dir"] else ""
    print(f"pilosa-tpu-torch serving at {node.address} on "
          f"{node.holder.device}{where}", file=sys.stderr, flush=True)
    # Orchestrators stop nodes with SIGTERM; ctrl-C keeps its
    # KeyboardInterrupt path.
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        # A timed wait: the OS may deliver SIGTERM to any of the node's
        # threads, and Python runs the handler only when the main thread
        # next runs bytecode, which an untimed wait never does.
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        node.close()
    return 0


def cmd_check(args, parser: argparse.ArgumentParser) -> int:
    """Offline integrity check of a data dir (ctl/check.go:30): verify
    snapshot footer CRCs, WAL op checksums (torn tail vs mid-file
    corruption), and jsonl line frames; report quarantined evidence
    files. ``--repair`` sweeps stale ``*.tmp`` crash leftovers.
    ``--archive`` additionally (or instead) verifies a backup archive
    (directory or object-store URL) end to end. Exits non-zero when
    anything is BAD; the same lines as the JAX CLI's."""
    from pilosa_tpu_torch.storage.diskstore import read_snapshot
    from pilosa_tpu_torch.storage.integrity import LineCorruptError, parse_line
    from pilosa_tpu_torch.storage.wal import scan_wal
    if not args.data_dir and not args.archive:
        print("check: a data dir or --archive is required", file=sys.stderr)
        return 1
    bad = 0
    if args.archive:
        from pilosa_tpu_torch.backup import verify_archive
        res = verify_archive(args.archive)
        for prob in res["problems"]:
            print(f"BAD archive {prob}")
            bad += 1
        if res["ok"]:
            print(f"ok archive {args.archive} ({res['checked']} files, "
                  f"{res.get('backups', 0)} backup(s) verified)")
    for root, _, files in os.walk(args.data_dir or ""):
        for fn in sorted(files):
            p = os.path.join(root, fn)
            if fn.endswith(".wal"):
                info = scan_wal(p)
                if info["corrupt"]:
                    print(f"BAD wal  {p}: corrupt record mid-file "
                          f"({info['ops']} ops salvageable, "
                          f"{info['total_bytes'] - info['valid_bytes']} "
                          f"bytes damaged)")
                    bad += 1
                elif info["torn"]:
                    print(f"ok wal   {p} ({info['ops']} ops; torn tail of "
                          f"{info['total_bytes'] - info['valid_bytes']} "
                          f"bytes — normal crash shape, replay truncates)")
                else:
                    print(f"ok wal   {p} ({info['ops']} ops)")
            elif fn.endswith(".snap"):
                arrays, meta, status = read_snapshot(p)
                if status == "bad":
                    print(f"BAD snap {p}: {meta['error']}")
                    bad += 1
                elif status == "legacy":
                    print(f"ok snap  {p} ({len(arrays['row_ids'])} rows; "
                          f"legacy unframed — re-snapshot to checksum)")
                else:
                    print(f"ok snap  {p} ({meta['rows']} rows, "
                          f"{meta['bits']} bits, crc verified)")
            elif fn.endswith(".jsonl"):
                n_ok = n_legacy = n_bad = 0
                with open(p) as f:
                    for line in f:
                        line = line.rstrip("\n")
                        if not line.strip():
                            continue
                        try:
                            _, verified = parse_line(line)
                            if verified:
                                n_ok += 1
                            else:
                                n_legacy += 1
                        except LineCorruptError:
                            n_bad += 1
                if n_bad:
                    print(f"BAD jsonl {p}: {n_bad} corrupt line(s) "
                          f"({n_ok} verified, {n_legacy} unframed)")
                    bad += 1
                else:
                    print(f"ok jsonl {p} ({n_ok} verified, "
                          f"{n_legacy} unframed)")
            elif fn.endswith(".quarantine") or ".quarantine." in fn:
                print(f"quarantined {p} (preserved corruption evidence)")
            elif fn.endswith(".tmp"):
                if args.repair:
                    try:
                        os.remove(p)
                        print(f"repaired {p} (stale tmp removed)")
                    except OSError as e:
                        print(f"BAD tmp  {p}: cannot remove: {e}")
                        bad += 1
                else:
                    print(f"stale tmp {p} (crash leftover; "
                          f"--repair removes)")
    return 1 if bad else 0


def cmd_inspect(args, parser: argparse.ArgumentParser) -> int:
    """Per-fragment stats of a data dir (ctl/inspect.go analog)."""
    import numpy as np
    for root, _, files in os.walk(args.data_dir):
        for fn in sorted(files):
            if not fn.endswith(".snap"):
                continue
            p = os.path.join(root, fn)
            with np.load(p) as z:
                rows = len(z["row_ids"])
                bits = len(z["positions"])
            rel = os.path.relpath(p, args.data_dir)
            print(f"{rel}: rows={rows} bits={bits}")
    return 0


# -- client commands over HTTP (the JAX CLI's) --------------------------------


def _base_url(host: str, tls: bool = False) -> str:
    """Client base URL: an explicit scheme in --host wins, else --tls
    picks one."""
    if "://" in host:
        return host.rstrip("/")
    return ("https://" if tls else "http://") + host


def _tls_args(args) -> tuple[bool, object]:
    """(tls, ssl_context) for a client command; --tls-skip-verify implies
    --tls rather than silently degrading the connection to plaintext."""
    ctx = None
    if getattr(args, "tls_skip_verify", False):
        import ssl
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    tls = bool(getattr(args, "tls", False) or getattr(args, "tls_skip_verify", False))
    return tls, ctx


def _post(host: str, path: str, body: bytes, tls: bool = False, ctx=None) -> dict:
    req = urllib.request.Request(f"{_base_url(host, tls)}{path}", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60, context=ctx) as resp:
        return json.loads(resp.read() or b"{}")


def _get(host: str, path: str, tls: bool = False, ctx=None) -> dict:
    with urllib.request.urlopen(f"{_base_url(host, tls)}{path}",
                                timeout=60, context=ctx) as resp:
        return json.loads(resp.read() or b"{}")


def _import_modes(host: str, index: str, field: str, tls: bool = False,
                  ctx=None) -> tuple[bool, bool, bool]:
    """(value_mode, row_keys, column_keys) from the server's schema -- the
    reference's bufferers pick the import mode the same way
    (ctl/import.go:125-140: field.Options.Type / Keys). A failed schema
    fetch aborts the import rather than guess the mode."""
    schema = _get(host, "/schema", tls, ctx).get("indexes") or []
    for idx in schema:
        if idx.get("name") != index:
            continue
        col_keys = bool((idx.get("options") or {}).get("keys"))
        for f in idx.get("fields") or []:
            if f.get("name") == field:
                opts = f.get("options") or {}
                return opts.get("type") == "int", bool(opts.get("keys")), col_keys
        return False, False, col_keys
    return False, False, False


def cmd_import(args, parser: argparse.ArgumentParser) -> int:
    """CSV -> batched imports over HTTP, like ctl/import.go: parse, buffer,
    send a batch every ``--buffer-size`` lines. The mode follows the
    target field's schema: set and time fields take (row,col[,timestamp])
    lines, int fields (col,value), and a keyed index or field takes string
    keys in place of ids (reference ctl/import.go:125-140 + ImportK). The
    same requests as the JAX CLI's ``import``."""
    tls, ctx = _tls_args(args)
    try:
        value_mode, row_keys, col_keys = _import_modes(args.host, args.index, args.field,
                                                       tls=tls, ctx=ctx)
    except Exception as e:
        print(f"import: cannot read schema from {args.host}: {e}", file=sys.stderr)
        return 1
    rows, cols, vals, stamps = [], [], [], []
    has_ts = False

    def flush():
        nonlocal rows, cols, vals, stamps
        if not cols:
            return
        body: dict = {}
        if value_mode:
            body["values"] = vals
        else:
            body["rowKeys" if row_keys else "rowIDs"] = rows
            if has_ts:
                body["timestamps"] = stamps
        body["columnKeys" if col_keys else "columnIDs"] = cols
        _post(args.host, f"/index/{args.index}/field/{args.field}/import"
              + ("?clear=1" if args.clear else ""),
              json.dumps(body).encode(), tls=tls, ctx=ctx)
        rows, cols, vals, stamps = [], [], [], []

    def parse_id(tok: str, keyed: bool):
        return tok if keyed else int(tok)

    for path in args.files:
        f = sys.stdin if path == "-" else open(path)
        try:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split(",")
                if value_mode:
                    cols.append(parse_id(parts[0], col_keys))
                    vals.append(int(parts[1]))
                else:
                    rows.append(parse_id(parts[0], row_keys))
                    cols.append(parse_id(parts[1], col_keys))
                    if len(parts) > 2:
                        has_ts = True
                        stamps.append(parts[2])
                    else:
                        stamps.append(None)
                if len(cols) >= args.buffer_size:
                    flush()
        finally:
            if f is not sys.stdin:
                f.close()
    flush()
    return 0


def cmd_export(args, parser: argparse.ArgumentParser) -> int:
    """The field's bits as ``row,col`` CSV lines on stdout, shard by shard
    (keys in place of the ids of a keyed field or index); a shard with no
    fragment is skipped. The same requests as the JAX CLI's ``export``."""
    tls, ctx = _tls_args(args)
    base = _base_url(args.host, tls)
    shards = [args.shard] if args.shard is not None else None
    if shards is None:
        mx = _get(args.host, "/internal/shards/max", tls, ctx)["standard"].get(args.index, 0)
        shards = list(range(mx + 1))
    for shard in shards:
        url = f"{base}/export?index={args.index}&field={args.field}&shard={shard}"
        try:
            with urllib.request.urlopen(url, timeout=60, context=ctx) as r:
                sys.stdout.write(r.read().decode())
        except urllib.error.HTTPError as e:
            if e.code == 404:
                continue  # a sparse shard with no fragment
            raise
    return 0


def _poll_job(host: str, status_path: str, tls, ctx, what: str) -> int:
    """Follow a background backup/restore to completion via its status
    endpoint; prints the final status JSON and exits non-zero on
    failure."""
    while True:
        st = _get(host, status_path, tls=tls, ctx=ctx)
        state = st.get("state")
        if state in ("done", "failed", "idle"):
            break
        print(f"\r{what}: {state} {st.get('doneFragments', 0)}"
              f"/{st.get('totalFragments', 0)} fragments",
              end="", file=sys.stderr)
        time.sleep(0.2)
    print(file=sys.stderr)
    if state != "done":
        print(f"{what} {st.get('id', '')} failed: "
              f"{st.get('error', 'unknown error')}", file=sys.stderr)
        return 1
    print(json.dumps(st, indent=2))
    return 0


def cmd_backup(args, parser: argparse.ArgumentParser) -> int:
    """Drive a backup through a node's /backup endpoint and wait for it.
    The archive path is resolved on the SERVER, so point it at a
    directory the node can write."""
    tls, ctx = _tls_args(args)
    body: dict = {"archive": args.archive}
    if args.parent:
        body["parent"] = args.parent
    try:
        resp = _post(args.host, "/backup", json.dumps(body).encode(), tls=tls, ctx=ctx)
    except urllib.error.HTTPError as e:
        print(f"backup: {e.read().decode(errors='replace')}", file=sys.stderr)
        return 1
    print(f"backup {resp.get('id')} started", file=sys.stderr)
    return _poll_job(args.host, "/backup/status", tls, ctx, "backup")


def cmd_restore(args, parser: argparse.ArgumentParser) -> int:
    """Restore a backup onto the node behind --host and wait for it;
    --pitr-ops caps WAL replay for point-in-time recovery and --force
    overwrites clashing live indexes."""
    tls, ctx = _tls_args(args)
    body: dict = {"archive": args.archive}
    if args.id:
        body["id"] = args.id
    if args.force:
        body["force"] = True
    if args.pitr_ops is not None:
        body["pitrOps"] = args.pitr_ops
    try:
        resp = _post(args.host, "/restore", json.dumps(body).encode(), tls=tls, ctx=ctx)
    except urllib.error.HTTPError as e:
        print(f"restore: {e.read().decode(errors='replace')}", file=sys.stderr)
        return 1
    print(f"restore of {resp.get('id')} started", file=sys.stderr)
    return _poll_job(args.host, "/restore/status", tls, ctx, "restore")


def cmd_backup_verify(args, parser: argparse.ArgumentParser) -> int:
    """Offline end-to-end verification of a backup archive (directory or
    object-store URL): manifests, parent chains, per-file CRCs, snapshot
    footers, WAL records, and meta line frames. Exits 1 on any damage."""
    from pilosa_tpu_torch.backup import verify_archive
    res = verify_archive(args.archive, backup_id=args.id)
    for prob in res["problems"]:
        print(f"BAD {prob}")
    verdict = "ok" if res["ok"] else f"{len(res['problems'])} problem(s)"
    print(f"{args.archive}: {res['checked']} file(s) in "
          f"{res.get('backups', 1)} backup(s): {verdict}")
    return 0 if res["ok"] else 1


def cmd_config(args, parser: argparse.ArgumentParser) -> int:
    """The resolved config over the JAX CLI's table, as that CLI prints
    it."""
    print(json.dumps(_load_config(args.config), indent=2))
    return 0


def cmd_generate_config(args, parser: argparse.ArgumentParser) -> int:
    """The JAX CLI's default TOML config, line for line."""
    print('bind = "127.0.0.1:10101"\n'
          'data-dir = ""\n'
          'peers = ""\n'
          'join = ""\n'
          'replica-n = 1\n'
          'anti-entropy-interval = 10.0\n'
          'check-nodes-interval = 5.0\n'
          '# serve stale reads while quorum-fenced (writes stay fenced)\n'
          'fence-stale-reads = false\n'
          '# background integrity scrub cadence, seconds (0 disables)\n'
          'scrub-interval = 60.0\n'
          '# unattended backups: cadence (0 disables) + archive\n'
          '# (a directory or http(s)://host:port/bucket object store)\n'
          'backup-interval = 0.0\n'
          'archive-url = ""\n'
          'backup-full-every = 8\n'
          'backup-keep-chains = 2\n'
          '# WAL records per fragment before a snapshot triggers\n'
          'max-op-n = 10000\n'
          '# preserved *.quarantine evidence files per fragment '
          '(0 keeps all)\n'
          'quarantine-keep-n = 0\n'
          'tls-cert = ""\n'
          'tls-key = ""\n'
          'tls-ca-cert = ""\n'
          '# trace-endpoint = "http://127.0.0.1:4318/v1/traces"\n'
          '# tls-skip-verify = false\n'
          'planner = true\n'
          '# QoS: admission gate + shedding (0 disables the gate)\n'
          'qos-max-concurrent = 32\n'
          'qos-max-queue = 64\n'
          'qos-internal-reserve = 4\n'
          'qos-default-deadline = 0.0\n'
          'qos-slow-query-ms = 500.0\n'
          '# kernel warmup at boot ("" disables)\n'
          'qos-warmup = "count,topn,bsi"\n'
          'qos-warmup-shards = "1,8,32"\n'
          '# adaptive concurrency: qos-max-concurrent is the ceiling,\n'
          '# the operative limit is measured (AIMD)\n'
          'qos-adaptive = true\n'
          '# per-tenant token bucket, requests/s per API key or index\n'
          '# (0 disables; rejections are 429 + Retry-After)\n'
          'qos-tenant-rate = 0.0\n'
          'qos-tenant-burst = 0.0\n'
          '# per-peer circuit breaker: consecutive failures to open\n'
          '# (0 disables), cooldown before the half-open probe\n'
          'breaker-threshold = 5\n'
          'breaker-cooldown = 5.0\n'
          '# hedged reads on replicated legs (delay 0 = measured p95)\n'
          'hedge = true\n'
          'hedge-delay-ms = 0.0\n'
          'hedge-budget-pct = 5.0\n'
          '# chaos fault injection route (tests only; never production)\n'
          '# chaos-faults = false\n'
          '# persistent XLA compile cache ("" = <data-dir>/compile-cache,\n'
          '# "off" disables)\n'
          'compile-cache-dir = ""\n'
          '# plan-shape bucketing: "pow2" reuses compiled kernels across\n'
          '# shard counts, "none" pads only to the device mesh\n'
          'plan-buckets = "pow2"\n'
          '# plan-keyed result cache: budget in MB (0 disables) and TTL\n'
          '# backstop in seconds (0 = epoch invalidation only)\n'
          'result-cache-mb = 64\n'
          'result-cache-ttl = 0.0\n'
          '# device-side BSI bit-plane transpose for bulk value imports\n'
          'ingest-transpose = "auto"\n'
          '# WAL group-commit fsync window, ms (0 = fsync per append)\n'
          'wal-group-commit-ms = 0.0\n'
          '# import-stream in-flight budget, MB (0 = unbounded;\n'
          '# over budget replies 429 + Retry-After + applied count)\n'
          'ingest-max-inflight-mb = 0\n'
          '# query dispatch: fused one-program-per-query plans, same-plan\n'
          '# dispatch coalescing (window in microseconds), and inline\n'
          '# transfer resolution — all bit-identical on|off|auto knobs\n'
          'dispatch-fuse = "auto"\n'
          'dispatch-coalesce = "auto"\n'
          'dispatch-coalesce-us = 150.0\n'
          'inline-transfer = "auto"\n'
          '# device residency: packed index stacks for low-cardinality\n'
          '# rows (auto|on|off, bit-identical) and pipelined async\n'
          '# uploads for non-resident leaf stacks (on|off)\n'
          'residency-packed = "auto"\n'
          'prefetch = "on"\n'
          '# key translation: device-resident sorted-hash planes for\n'
          '# large keyed batches (auto = device probe for 256+ keys)\n'
          'translate-planes = "auto"\n'
          '# approximate analytics: HLL precision for Count(Distinct)\n'
          '# (2^p registers, ~1.04/sqrt(2^p) error) and the estimated\n'
          '# cardinality below which the answer is computed exactly\n'
          'sketch-precision = 12\n'
          'sketch-exact-threshold = 1024\n'
          '# per-query cost profiles: slowest-N retention ring served\n'
          '# at /debug/queries (0 disables); profile-queries = false\n'
          '# limits profiling to explicit ?profile=true requests\n'
          'profile-ring-n = 64\n'
          'profile-queries = true')
    return 0


def _client_parser(sub, name: str, help_: str) -> argparse.ArgumentParser:
    s = sub.add_parser(name, help=help_)
    s.add_argument("--host", default="127.0.0.1:10101",
                   help="host:port, or a full http(s)://host:port URL")
    s.add_argument("--tls", action="store_true",
                   help="use https (implied by an https:// --host)")
    s.add_argument("--tls-skip-verify", action="store_true")
    return s


def _server_parser(sub) -> argparse.ArgumentParser:
    """The JAX CLI's ``server`` flags (pilosa_tpu/cli.py:846), plus
    ``--device``."""
    s = sub.add_parser("server", help="run a standalone node")
    s.add_argument("--bind", default="")
    s.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where the node's data and kernels live "
                        "(default cuda; raises without a card)")
    s.add_argument("--data-dir", default="")
    s.add_argument("--peers", default="", help="comma-separated host:port")
    s.add_argument("--replica-n", type=int, default=0)
    s.add_argument("--no-planner", action="store_true")
    s.add_argument("--join", default="",
                   help="host:port of a running member to join")
    s.add_argument("--tls-cert", default="")
    s.add_argument("--tls-key", default="")
    s.add_argument("--tls-ca-cert", default="")
    s.add_argument("--tls-skip-verify", action="store_true")
    s.add_argument("--qos-max-concurrent", type=int, default=None,
                   help="concurrency gate on query dispatch (0 disables)")
    s.add_argument("--qos-max-queue", type=int, default=None,
                   help="bounded admission queue; excess load sheds w/ 503")
    s.add_argument("--qos-default-deadline", type=float, default=None,
                   help="default per-query deadline, seconds (0 = none)")
    s.add_argument("--qos-warmup", default=None,
                   help='kernel warmup set, e.g. "count,topn,bsi" '
                        '("" disables)')
    s.add_argument("--qos-warmup-shards", default=None,
                   help='shard-count buckets warmup runs, e.g. "1,8,32"')
    s.add_argument("--import-pool-mb", type=int, default=None)
    s.add_argument("--backup-interval", type=float, default=None)
    s.add_argument("--archive-url", default=None)
    s.add_argument("--backup-full-every", type=int, default=None)
    s.add_argument("--backup-keep-chains", type=int, default=None)
    s.add_argument("--scrub-interval", type=float, default=None)
    s.add_argument("--max-op-n", type=int, default=None)
    s.add_argument("--quarantine-keep-n", type=int, default=None)
    s.add_argument("--qos-adaptive", choices=("on", "off"), default=None,
                   help="measured concurrency limit under the "
                        "qos-max-concurrent ceiling (default on)")
    s.add_argument("--qos-tenant-rate", type=float, default=None,
                   help="per-tenant request rate, req/s per API key or "
                        "index (0 disables; rejections are 429)")
    s.add_argument("--qos-tenant-burst", type=float, default=None,
                   help="per-tenant burst size (0 = 2x rate)")
    s.add_argument("--breaker-threshold", type=int, default=None)
    s.add_argument("--breaker-cooldown", type=float, default=None)
    s.add_argument("--hedge", choices=("on", "off"), default=None)
    s.add_argument("--hedge-delay-ms", type=float, default=None)
    s.add_argument("--hedge-budget-pct", type=float, default=None)
    s.add_argument("--fence-stale-reads", action="store_true")
    s.add_argument("--chaos-faults", action="store_true")
    s.add_argument("--trace-endpoint", default="")
    s.add_argument("--compile-cache-dir", default=None)
    s.add_argument("--plan-buckets", choices=("pow2", "none"), default=None,
                   help="stack-height bucketing of the planner")
    s.add_argument("--result-cache-mb", type=int, default=None,
                   help="result cache size, MB (0 disables)")
    s.add_argument("--result-cache-ttl", type=float, default=None,
                   help="result cache entry TTL, seconds (0 = none)")
    s.add_argument("--device-reduce", choices=("on", "off", "auto"),
                   default=None)
    s.add_argument("--multiplex", choices=("on", "off"), default=None)
    s.add_argument("--ingest-transpose", choices=("on", "off", "auto"),
                   default=None)
    s.add_argument("--wal-group-commit-ms", type=float, default=None)
    s.add_argument("--ingest-max-inflight-mb", type=int, default=None)
    s.add_argument("--dispatch-fuse", choices=("on", "off", "auto"),
                   default=None)
    s.add_argument("--dispatch-coalesce", choices=("on", "off", "auto"),
                   default=None)
    s.add_argument("--dispatch-coalesce-us", type=float, default=None)
    s.add_argument("--inline-transfer", choices=("on", "off", "auto"),
                   default=None)
    s.add_argument("--residency-packed", choices=("on", "off", "auto"),
                   default=None)
    s.add_argument("--prefetch", choices=("on", "off"), default=None)
    s.add_argument("--translate-planes", choices=("on", "off", "auto"),
                   default=None)
    s.add_argument("--sketch-precision", type=int, default=None)
    s.add_argument("--sketch-exact-threshold", type=int, default=None)
    s.add_argument("--profile-ring", type=int, default=None,
                   help="retain the slowest N query cost profiles at "
                        "/debug/queries (default 64; 0 disables)")
    s.add_argument("--profile-queries", choices=("true", "false"),
                   default=None,
                   help="profile every query into the retention ring "
                        "(default true; false limits profiling to "
                        "?profile=true requests)")
    s.add_argument("--config", default=None)
    s.set_defaults(fn=cmd_server)
    return s


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="pilosa-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    _server_parser(sub)

    s = _client_parser(sub, "import", "bulk import CSV")
    s.add_argument("--buffer-size", type=int, default=100_000)
    s.add_argument("--clear", action="store_true")
    s.add_argument("index")
    s.add_argument("field")
    s.add_argument("files", nargs="+")
    s.set_defaults(fn=cmd_import)

    s = _client_parser(sub, "export", "export CSV")
    s.add_argument("--shard", type=int, default=None)
    s.add_argument("index")
    s.add_argument("field")
    s.set_defaults(fn=cmd_export)

    s = sub.add_parser("check", help="offline data-dir consistency check")
    s.add_argument("data_dir", nargs="?", default="")
    s.add_argument("--repair", action="store_true",
                   help="sweep stale .tmp crash leftovers")
    s.add_argument("--archive", default=None,
                   help="also verify a backup archive "
                        "(directory or object-store URL)")
    s.set_defaults(fn=cmd_check)

    s = _client_parser(sub, "backup", "back up the node to an archive")
    s.add_argument("--parent", default=None,
                   help="parent backup id: capture an incremental against it")
    s.add_argument("archive", help="archive directory (on the server)")
    s.set_defaults(fn=cmd_backup)

    s = _client_parser(sub, "restore", "restore a backup onto the node")
    s.add_argument("--id", default=None,
                   help="backup id (default: newest complete backup)")
    s.add_argument("--force", action="store_true",
                   help="overwrite live indexes with the same names")
    s.add_argument("--pitr-ops", type=int, default=None,
                   help="cap per-fragment WAL replay at this op offset "
                        "(point-in-time recovery)")
    s.add_argument("archive", help="archive directory (on the server)")
    s.set_defaults(fn=cmd_restore)

    s = sub.add_parser("backup-verify", help="offline archive verification")
    s.add_argument("--id", default=None,
                   help="verify one backup id (default: all complete "
                        "backups in the archive)")
    s.add_argument("archive", help="archive directory or object-store URL")
    s.set_defaults(fn=cmd_backup_verify)

    s = sub.add_parser("inspect", help="data-dir fragment stats")
    s.add_argument("data_dir")
    s.set_defaults(fn=cmd_inspect)

    s = sub.add_parser("config", help="print resolved config")
    s.add_argument("--config", default=None)
    s.set_defaults(fn=cmd_config)

    s = sub.add_parser("generate-config", help="print default TOML config")
    s.set_defaults(fn=cmd_generate_config)

    args = p.parse_args(argv)
    return args.fn(args, sub.choices[args.cmd])


if __name__ == "__main__":
    sys.exit(main())
