"""The node-to-node wire (pilosa_tpu_torch/server/wire.py) against the JAX
package's (pilosa_tpu/server/wire.py): every result frame type, v1 and v2,
encoded by either package is byte for byte the other's and decodes in the
other to the same results; the import, import-stream and mux envelopes
likewise; malformed frames raise ValueError; and the port's HTTP client
runs PTM1 mux legs against a JAX node."""

import json
import struct

import numpy as np
import pytest
import torch

from pilosa_tpu.core.row import Row as JRow
from pilosa_tpu.exec import result as jres
from pilosa_tpu.exec.executor import ExecOptions as JExecOptions
from pilosa_tpu.exec.ingest_transpose import set_mode as j_transpose_mode
from pilosa_tpu.server import wire as jwire
from pilosa_tpu.server.node import ServerNode as JServerNode
from pilosa_tpu.sketch import hll as jhll
from pilosa_tpu_torch.cluster.node import URI, Node
from pilosa_tpu_torch.config import SHARD_WIDTH
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.exec import result as tres
from pilosa_tpu_torch.obs import MemoryStats
from pilosa_tpu_torch.server import wire as twire
from pilosa_tpu_torch.server.httpclient import HTTPInternalClient
from pilosa_tpu_torch.sketch import hll as thll

SEED = 11


def _both(make):
    """(port object, JAX object) of one result, ``make(R, res, hll)`` called
    with each package's Row class, result module and hll module."""
    return make(Row, tres, thll), make(JRow, jres, jhll)


def _row(R, res, hll):
    rng = np.random.default_rng(SEED)
    cols = np.concatenate([rng.integers(0, 3 * SHARD_WIDTH, 5000),
                           [31, SHARD_WIDTH - 1, 2 * SHARD_WIDTH + 32 * 32767 + 31]])
    row = R.from_columns(cols.astype(np.uint64))
    row.attrs = {"color": "red", "n": 3}
    return row


def _pairs(n, keyed=False):
    def make(R, res, hll):
        return [res.Pair(id=i * 7, count=1000 - i, key=f"k{i}" if keyed else "")
                for i in range(n)]
    return make


def _groups(n, ragged=False):
    def make(R, res, hll):
        out = [res.GroupCount(group=[res.FieldRow(field="a", row_id=i % 5),
                                     res.FieldRow(field="b", row_id=i)], count=i + 1)
               for i in range(n)]
        if ragged:
            out.append(res.GroupCount(group=[res.FieldRow(field="a", row_id=9)], count=2))
        return out
    return make


CASES = {
    "row": _row,
    "row_empty": lambda R, res, hll: R(),
    "pairs_small": _pairs(3),
    "pairs_frame": _pairs(40),
    "pairs_keyed": _pairs(20, keyed=True),
    "groups_small": _groups(4),
    "groups_frame": _groups(40),
    "groups_ragged": _groups(20, ragged=True),
    "rowids_small": lambda R, res, hll: [1, 5, 9],
    "rowids_frame": lambda R, res, hll: list(range(0, 4000, 13)),
    "rowids_wide": lambda R, res, hll: [2**40 + i for i in range(20)],
    "valcount": lambda R, res, hll: res.ValCount(-12345, 77),
    "valcount_zero": lambda R, res, hll: res.ValCount(),
    "pair": lambda R, res, hll: res.Pair(id=4, count=9, key="x"),
    "hll": lambda R, res, hll: hll.sketch_values(np.arange(5000, dtype=np.int64) * 3, 12),
    "distinct": lambda R, res, hll: hll.DistinctValues(
        values=np.array([-5, 0, 7, 2**40], dtype=np.int64)),
    "simpartial": lambda R, res, hll: hll.SimPartial(
        ids=np.array([1, 3, 2**33], dtype=np.uint64), overlap=np.array([4, 0, 9]),
        selfcnt=np.array([10, 5, 9]), filtcnt=14),
    "scalar_int": lambda R, res, hll: 42,
    "scalar_bool": lambda R, res, hll: True,
    "scalar_none": lambda R, res, hll: None,
}


def _norm(r):
    """A package-neutral form of a result, for comparing decodes."""
    kind = type(r).__name__
    if kind == "Row":
        return ("row", [int(c) for c in r.columns()], r.attrs)
    if kind == "Pair":
        return ("pair", r.id, r.count, r.key)
    if kind == "ValCount":
        return ("valcount", r.val, r.count)
    if kind == "HLLSketch":
        return ("hll", r.p, np.asarray(r.regs).tobytes())
    if kind == "DistinctValues":
        return ("distinct", [int(v) for v in r.values])
    if kind == "SimPartial":
        return ("sim", [int(x) for x in r.ids], [int(x) for x in r.overlap],
                [int(x) for x in r.selfcnt], int(r.filtcnt))
    if kind == "GroupCount":
        return ("gc", [(f.field, f.row_id) for f in r.group], r.count)
    if isinstance(r, list):
        return [_norm(x) for x in r]
    return r


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_frames_byte_equal_both_ways(case, version):
    t_obj, j_obj = _both(CASES[case])
    extra = {"shardEpochs": {"0": 3, "2": 9}}
    t_bytes = twire.encode_frames([t_obj, t_obj], extra=extra, version=version)
    j_bytes = jwire.encode_frames([j_obj, j_obj], extra=extra, version=version)
    assert t_bytes == j_bytes
    # each package decodes the other's frame to the same results
    want = [_norm(j_obj)] * 2
    assert [_norm(r) for r in twire.decode_frames(j_bytes)] == want
    assert [_norm(r) for r in jwire.decode_frames(t_bytes)] == want
    res, head = twire.decode_frames_meta(j_bytes)
    assert head["shardEpochs"] == extra["shardEpochs"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_json_envelope_matches_jax(case):
    """The tagged JSON envelope (a remote leg's body without frames)."""
    t_obj, j_obj = _both(CASES[case])
    t_doc, j_doc = twire.encode_result(t_obj), jwire.encode_result(j_obj)
    assert json.dumps(t_doc) == json.dumps(j_doc)
    assert _norm(twire.decode_result(j_doc)) == _norm(jwire.decode_result(t_doc)) == _norm(j_obj)


def test_row_frame_decodes_onto_the_device(monkeypatch):
    """A row_frame's segments land on the decode's device through
    device_reduce.row_from_columns (int32 tensors under ``on``)."""
    monkeypatch.setenv("PILOSA_TPU_DEVICE_REDUCE", "on")
    t_obj, j_obj = _both(_row)
    (row,) = twire.decode_frames(jwire.encode_frames([j_obj]), device="cpu")
    assert all(isinstance(s, torch.Tensor) and s.dtype == torch.int32
               for s in row.segments.values())
    assert np.array_equal(row.columns(), j_obj.columns())


@pytest.mark.parametrize("req", [
    {"kind": "field", "index": "i", "field": "f", "shard": 3,
     "rowIDs": [1] * 50, "columnIDs": list(range(50)), "clear": False},
    {"kind": "field", "index": "i", "field": "f", "shard": 0,
     "rowIDs": [1, 2, 3], "columnIDs": [2**33, 5, 6], "timestamps": [None, 1577836800, None]},
    {"kind": "field", "index": "i", "field": "v", "shard": 1, "rowIDs": None,
     "columnIDs": [SHARD_WIDTH + 1, SHARD_WIDTH + 9], "values": [-4, 2**40], "clear": True},
    {"kind": "fragment", "index": "i", "field": "f", "view": "standard", "shard": 2,
     "rowIDs": [], "columnIDs": []},
])
def test_import_frames_byte_equal_both_ways(req):
    t_bytes, j_bytes = twire.encode_import(req), jwire.encode_import(req)
    assert t_bytes == j_bytes and twire.is_import_frame(t_bytes)

    def norm(d):
        return {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in d.items()}
    assert norm(twire.decode_import(j_bytes)) == norm(jwire.decode_import(t_bytes))
    chunks = twire.stream_preamble() + twire.stream_chunk(req) + twire.stream_end()
    assert chunks == jwire.stream_preamble() + jwire.stream_chunk(req) + jwire.stream_end()
    data = bytearray(chunks)

    def read(n):
        out = bytes(data[:n])
        del data[:n]
        return out
    assert list(twire.iter_stream_frames(read)) == [j_bytes]


def test_mux_envelopes_byte_equal_both_ways():
    legs = [{"index": "i", "query": "Count(Row(f=1))", "shards": [0, 1], "timeoutMs": 500},
            {"index": "i", "query": "Row(f=2)", "trace": "abc"}]
    assert twire.encode_mux_request(legs) == jwire.encode_mux_request(legs)
    assert twire.decode_mux_request(jwire.encode_mux_request(legs)) == legs
    frame = jwire.encode_frames([5])
    outcomes = [{"frame": frame}, {"status": 503, "error": "shed", "retryAfter": 1.5},
                {"status": 404, "error": "index not found"}]
    t_bytes, j_bytes = twire.encode_mux_response(outcomes), jwire.encode_mux_response(outcomes)
    assert t_bytes == j_bytes
    assert twire.decode_mux_response(j_bytes) == jwire.decode_mux_response(t_bytes)


def _corrupt_frames():
    good = jwire.encode_frames([JRow.from_columns([1, 2, 3]), list(range(40))])
    (hlen,) = struct.unpack_from("<I", good, 4)
    head = json.loads(good[8:8 + hlen])
    bad_len = dict(head)
    bad_len["results"] = [head["results"][0],
                          dict(head["results"][1], ids=dict(head["results"][1]["ids"], n=41))]
    bad_len = json.dumps(bad_len).encode()
    return {
        "magic": b"XXXX" + good[4:],
        "short": good[:6],
        "header_past_end": good[:4] + struct.pack("<I", 10**6) + good[8:],
        "header_not_json": good[:8] + b"\xff" * hlen + good[8 + hlen:],
        "header_not_object": b"PTF1" + struct.pack("<I", 2) + b"[]",
        "body_truncated": good[:-3],
        "array_length": b"PTF1" + struct.pack("<I", len(bad_len)) + bad_len + good[8 + hlen:],
        "unknown_type": jwire.encode_frames([]).replace(b'"results": []',
                                                        b'"results": [{"t": "zz"}]'),
    }


@pytest.mark.parametrize("what", sorted(_corrupt_frames()))
def test_malformed_frames_raise_value_error(what):
    data = _corrupt_frames()[what]
    errors = []
    for wire in (twire, jwire):
        with pytest.raises((ValueError, TypeError)) as e:
            wire.decode_frames(data)
        errors.append(type(e.value))
    assert errors[0] is errors[1]
    for dec in (twire.decode_import, twire.decode_mux_request, twire.decode_mux_response):
        with pytest.raises(ValueError):
            dec(b"PTZ9" + data[4:])


@pytest.fixture(scope="module")
def jax_node():
    """A standalone JAX node with bits in three shards."""
    j_transpose_mode("off")
    # No MeshPlanner: the legs below run from 8 threads at once, and XLA's
    # in-process CPU collectives do not survive concurrent programs.
    jn = JServerNode(bind="127.0.0.1:0", ingest_transpose="off", use_planner=False)
    jn.open()
    jn.api.create_index("i")
    jn.api.create_field("i", "f")
    rng = np.random.default_rng(SEED)
    cols = rng.integers(0, 3 * SHARD_WIDTH, 6000)
    rows = rng.integers(0, 4, 6000)
    jn.api.import_bits("i", "f", rows.tolist(), cols.tolist())
    yield jn
    jn.close()
    j_transpose_mode("auto")


@pytest.mark.parametrize("multiplex", [True, False])
def test_port_client_queries_a_jax_node(jax_node, multiplex):
    """The port's HTTPInternalClient runs remote legs against a JAX node:
    over the PTM1 channel (POST /internal/query-mux, concurrent legs to one
    peer batched) or one request a leg, frames decoded by the port."""
    from concurrent.futures import ThreadPoolExecutor

    client = HTTPInternalClient(device="cpu")
    client.multiplex = multiplex
    client.stats = MemoryStats()
    node = Node(id="j", uri=URI(host="127.0.0.1", port=jax_node.port))
    queries = ["Count(Row(f=1))", "Row(f=2)", "TopN(f, n=3)", "Rows(f)"] * 4
    try:
        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(lambda q: client.query_node_meta(
                node, "i", q, [0, 1, 2], remote=True), queries))
        for q, (res, epochs) in zip(queries, got):
            # a remote leg's raw results: TopN's first pass, Rows' bare ids
            want = jax_node.executor.execute("i", q, shards=[0, 1, 2],
                                             opt=JExecOptions(remote=True))
            assert _norm(res) == _norm(want), q
            assert sorted(epochs) == [0, 1, 2]
        assert bool(client._channels) == multiplex
        assert not client._mux_unsupported
        assert client.stats.counter_value("cluster.wireBytesIn") > 0
    finally:
        client.close()
