"""Command-line interface of the port: run a standalone node, and check
or inspect a data dir offline.

The port's counterpart of pilosa_tpu/cli.py's ``server``, ``check`` and
``inspect`` commands. ``server`` takes the same flags, plus ``--device``;
a flag of a feature this slice does not carry exits with status 2 and
names the ROADMAP.md slice that brings it. Config precedence is the JAX
package's: flags > env (``PILOSA_TPU_*``) > TOML file (``--config``).

Usage::

    python -m pilosa_tpu_torch.cli server --bind 127.0.0.1:10101 \
        [--device cuda|cpu] [--data-dir DIR]
    python -m pilosa_tpu_torch.cli check DIR [--repair]
    python -m pilosa_tpu_torch.cli inspect DIR

The JAX CLI's other commands (import, export, backup, restore,
backup-verify, config, generate-config) are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from pilosa_tpu_torch.errors import (
    SLICE_BACKUP,
    SLICE_CLUSTER,
    SLICE_EXECUTOR,
    SLICE_FIELDS,
    SLICE_KEYS,
)

#: the ported knobs and their CLI defaults (the JAX CLI's).
_DEFAULTS = {
    "bind": "127.0.0.1:10101",
    "device": "cuda",
    "planner": True,
    "tls_cert": "",
    "tls_key": "",
    # QoS: the gate is ON for the CLI server (0 disables), with an
    # adaptive limit under the qos_max_concurrent ceiling.
    "qos_max_concurrent": 32,
    "qos_max_queue": 64,
    "qos_internal_reserve": 4,
    "qos_default_deadline": 0.0,
    "qos_slow_query_ms": 500.0,
    "qos_adaptive": True,
    "qos_tenant_rate": 0.0,
    "qos_tenant_burst": 0.0,
    "profile_ring_n": 64,
    "profile_queries": True,
    "data_dir": "",
    # WAL records per fragment before a snapshot triggers.
    "max_op_n": 10_000,
    # preserved *.quarantine evidence files per fragment (0 keeps all).
    "quarantine_keep_n": 0,
    "wal_group_commit_ms": 0.0,
    "import_pool_mb": 512,
}

#: server flags (by argparse dest) of features later slices bring, each
#: with the ROADMAP.md Queue 1 slice that ports it.
_UNPORTED = {
    "backup_interval": SLICE_BACKUP, "archive_url": SLICE_BACKUP,
    "backup_full_every": SLICE_BACKUP, "backup_keep_chains": SLICE_BACKUP,
    "scrub_interval": SLICE_CLUSTER,
    "peers": SLICE_CLUSTER, "replica_n": SLICE_CLUSTER, "join": SLICE_CLUSTER,
    "tls_ca_cert": SLICE_CLUSTER, "tls_skip_verify": SLICE_CLUSTER,
    "breaker_threshold": SLICE_CLUSTER, "breaker_cooldown": SLICE_CLUSTER,
    "hedge": SLICE_CLUSTER, "hedge_delay_ms": SLICE_CLUSTER,
    "hedge_budget_pct": SLICE_CLUSTER, "fence_stale_reads": SLICE_CLUSTER,
    "chaos_faults": SLICE_CLUSTER, "trace_endpoint": SLICE_CLUSTER,
    "device_reduce": SLICE_CLUSTER, "multiplex": SLICE_CLUSTER,
    "ingest_max_inflight_mb": SLICE_CLUSTER,
    "qos_warmup": SLICE_EXECUTOR, "compile_cache_dir": SLICE_EXECUTOR,
    "plan_buckets": SLICE_EXECUTOR, "result_cache_mb": SLICE_EXECUTOR,
    "result_cache_ttl": SLICE_EXECUTOR, "dispatch_fuse": SLICE_EXECUTOR,
    "dispatch_coalesce": SLICE_EXECUTOR,
    "dispatch_coalesce_us": SLICE_EXECUTOR,
    "inline_transfer": SLICE_EXECUTOR, "prefetch": SLICE_EXECUTOR,
    "residency_packed": SLICE_FIELDS, "ingest_transpose": SLICE_FIELDS,
    "translate_planes": SLICE_KEYS, "sketch_precision": SLICE_KEYS,
    "sketch_exact_threshold": SLICE_KEYS,
}


def _load_config(path: str | None) -> dict:
    cfg = dict(_DEFAULTS)
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
    """Exit 2 (argparse's usage error) on a flag or config key of a
    feature this slice does not carry."""
    for dest, slice_name in _UNPORTED.items():
        given = getattr(args, dest) != parser.get_default(dest)
        if given or dest in cfg:
            flag = "--" + dest.replace("_", "-")
            parser.error(f"{flag} is not ported to pilosa_tpu_torch yet "
                         f"(ROADMAP.md Queue 1: {slice_name})")


def cmd_server(args, parser: argparse.ArgumentParser) -> int:
    cfg = _load_config(args.config)
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

    from pilosa_tpu_torch.server.node import ServerNode
    node = ServerNode(
        bind=cfg["bind"],
        device=cfg["device"],
        use_planner=bool(cfg["planner"]),
        tls_cert=str(cfg["tls_cert"]) or None,
        tls_key=str(cfg["tls_key"]) or None,
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
        stop.wait()
    except KeyboardInterrupt:
        pass
    finally:
        node.close()
    return 0


def cmd_check(args, parser: argparse.ArgumentParser) -> int:
    """Offline integrity check of a data dir (ctl/check.go:30): verify
    snapshot footer CRCs, WAL op checksums (torn tail vs mid-file
    corruption), and jsonl line frames; report quarantined evidence
    files. ``--repair`` sweeps stale ``*.tmp`` crash leftovers. Exits
    non-zero when anything is BAD; the same lines as the JAX CLI's."""
    from pilosa_tpu_torch.storage.diskstore import read_snapshot
    from pilosa_tpu_torch.storage.integrity import LineCorruptError, parse_line
    from pilosa_tpu_torch.storage.wal import scan_wal
    if args.archive:
        parser.error("--archive is not ported to pilosa_tpu_torch yet "
                     f"(ROADMAP.md Queue 1: {SLICE_BACKUP})")
    if not args.data_dir:
        print("check: a data dir or --archive is required", file=sys.stderr)
        return 1
    bad = 0
    for root, _, files in os.walk(args.data_dir):
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
    s.add_argument("--qos-warmup", default=None)
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
    s.add_argument("--plan-buckets", choices=("pow2", "none"), default=None)
    s.add_argument("--result-cache-mb", type=int, default=None)
    s.add_argument("--result-cache-ttl", type=float, default=None)
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

    s = sub.add_parser("check", help="offline data-dir consistency check")
    s.add_argument("data_dir", nargs="?", default="")
    s.add_argument("--repair", action="store_true",
                   help="sweep stale .tmp crash leftovers")
    s.add_argument("--archive", default=None,
                   help="also verify a backup archive (not ported yet)")
    s.set_defaults(fn=cmd_check)

    s = sub.add_parser("inspect", help="data-dir fragment stats")
    s.add_argument("data_dir")
    s.set_defaults(fn=cmd_inspect)

    args = p.parse_args(argv)
    return args.fn(args, sub.choices[args.cmd])


if __name__ == "__main__":
    sys.exit(main())
