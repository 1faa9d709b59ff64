"""The port's CLI over a data dir, against the JAX CLI.

``check`` and ``inspect`` print the same lines and exit with the same
codes as ``pilosa_tpu.cli`` on the same dir (clean, torn WAL tail,
mid-file corrupt WAL, bit-flipped and legacy snapshots, corrupt jsonl
lines, stale tmp files with and without ``--repair``); ``--archive``
exits 2 naming the backup slice; and ``server --data-dir`` boots, keeps
its writes across a SIGTERM restart, and reloads them.
"""

import os
import re
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pilosa_tpu import cli as j_cli
from pilosa_tpu_torch import cli
from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.core import FieldOptions, Holder
from pilosa_tpu_torch.storage import DiskStore, WalWriter
from pilosa_tpu_torch.storage.faults import corrupt_file
from pilosa_tpu_torch.storage.integrity import FOOTER_SIZE
from test_torch_server import Client

ROOT = Path(__file__).resolve().parent.parent


def _template(d: str) -> None:
    """Set and int fields over 2 shards, attrs, closed cleanly, then one
    more write left in a WAL."""
    h = Holder(device="cpu")
    store = DiskStore(d, h)
    store.open()
    idx = h.create_index("i")
    f = idx.create_field("f")
    f.import_bits([1, 1, 2], [3, SHARD_WIDTH + 5, 7])
    idx.create_field("v", FieldOptions(type="int", min=0, max=100)).import_values(
        [1, SHARD_WIDTH + 1], [5, 6])
    f.row_attr_store.set_attrs(1, {"k": "v"})
    store.close()
    store = DiskStore(d, h := Holder(device="cpu"))
    store.open()
    h.field("i", "f").set_bit(3, 9)
    store.save_schema()


def _damage(d: str, fault: str) -> None:
    fdir = os.path.join(d, "i", "f", "standard")
    if fault == "torn":
        wal = os.path.join(fdir, "0.wal")
        with open(wal, "r+b") as f:
            f.truncate(os.path.getsize(wal) - 3)
    elif fault == "midfile":
        wal = os.path.join(fdir, "0.wal")
        w = WalWriter(wal)
        w.append("add", [4], [11])
        w.close()
        with open(wal, "r+b") as f:
            f.seek(3)
            f.write(b"\xff\xff")
    elif fault == "bitflip":
        corrupt_file(os.path.join(fdir, "1.snap"), "bitflip")
    elif fault == "legacy":
        snap = os.path.join(fdir, "1.snap")
        data = open(snap, "rb").read()
        with open(snap, "wb") as f:
            f.write(data[:-FOOTER_SIZE])
    elif fault == "jsonl":
        p = os.path.join(d, "i", "f", "row_attrs.jsonl")
        with open(p, "a") as f:
            f.write("L1 5 00000000 hello\n")
    elif fault == "tmp":
        open(os.path.join(fdir, "0.snap.tmp"), "wb").close()
    elif fault == "quarantined":
        Path(fdir, "1.snap.quarantine").write_bytes(b"x")


def _run(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out


@pytest.fixture(scope="module")
def template(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli") / "template")
    _template(d)
    return d


@pytest.mark.parametrize("repair", [False, True])
@pytest.mark.parametrize("fault", ["none", "torn", "midfile", "bitflip", "legacy",
                                   "jsonl", "tmp", "quarantined"])
def test_check_matches_the_jax_cli(template, tmp_path, capsys, fault, repair):
    """Same lines, same exit code, on the same path (--repair changes the
    dir, so each CLI gets a fresh copy there)."""
    d = str(tmp_path / "data")
    argv = ["check", d] + (["--repair"] if repair else [])
    answers = []
    for main in (j_cli.main, cli.main):
        shutil.copytree(template, d)
        _damage(d, fault)
        answers.append(_run(main, argv, capsys))
        after = sorted(os.listdir(os.path.join(d, "i", "f", "standard")))
        answers[-1] += (after,)
        shutil.rmtree(d)
    assert answers[1] == answers[0]
    rc, out, _ = answers[1]
    assert rc == (1 if fault in ("midfile", "bitflip", "jsonl") else 0)
    assert "ok wal" in out and "ok jsonl" in out


@pytest.mark.parametrize("fault", ["none", "legacy"])
def test_inspect_matches_the_jax_cli(template, capsys, fault, tmp_path):
    d = str(tmp_path / "data")
    shutil.copytree(template, d)
    _damage(d, fault)
    want = _run(j_cli.main, ["inspect", d], capsys)
    got = _run(cli.main, ["inspect", d], capsys)
    assert got == want
    assert got[0] == 0 and "i/f/standard/1.snap: rows=1 bits=1" in got[1]


def test_check_without_a_dir_and_archive_flag(capsys):
    assert _run(cli.main, ["check"], capsys) == _run(j_cli.main, ["check"], capsys)
    with pytest.raises(SystemExit) as e:
        cli.main(["check", "/nonexistent", "--archive", "/tmp/a"])
    assert e.value.code == 2
    assert "backup and restore" in capsys.readouterr().err


def _serve(d: str, extra=()):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PILOSA_TPU_")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--device", "cpu",
         "--bind", "127.0.0.1:0", "--data-dir", d, "--import-pool-mb", "0", *extra],
        cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
    line = proc.stderr.readline()
    m = re.search(r"serving at http://127\.0\.0\.1:(\d+) on cpu, data dir ", line)
    assert m, line
    return proc, Client(int(m.group(1)))


def _stop(proc, sig=signal.SIGTERM):
    proc.send_signal(sig)
    return proc.wait(timeout=60)


def test_server_data_dir_survives_restart_and_kill(tmp_path):
    """``server --data-dir``: writes acknowledged over HTTP read back after
    a SIGTERM restart (flushed) and after a SIGKILL (from the WAL)."""
    d = str(tmp_path / "data")
    proc, c = _serve(d, ["--max-op-n", "100", "--quarantine-keep-n", "2"])
    try:
        assert c("POST", "/index/i")[0] == 200
        assert c("POST", "/index/i/field/f")[0] == 200
        assert c("POST", "/index/i/query", f"Set(7, f=1) Set({SHARD_WIDTH}, f=1)")[:2] == (
            200, b'{"results": [true, true]}\n')
        c.close()
        assert _stop(proc) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    assert os.path.exists(os.path.join(d, "i", "f", "standard", "1.snap"))

    proc, c = _serve(d)
    try:
        assert c("POST", "/index/i/query", "Row(f=1)")[1] == (
            b'{"results": [{"attrs": {}, "columns": [7, %d]}]}\n' % SHARD_WIDTH)
        cols = np.arange(5, 2000, 7)
        assert c("POST", "/index/i/field/f/import",
                 {"rowIDs": [2] * len(cols), "columnIDs": cols.tolist()})[0] == 200
        c.close()
        _stop(proc, signal.SIGKILL)  # no flush
    finally:
        if proc.poll() is None:
            proc.kill()

    proc, c = _serve(d)
    try:
        assert c("POST", "/index/i/query", "Count(Row(f=2)) Count(Row(f=1))")[1] == (
            b'{"results": [%d, 2]}\n' % len(cols))
        c.close()
        assert _stop(proc) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
