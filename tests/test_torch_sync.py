"""Anti-entropy and the scrubber in the port (pilosa_tpu_torch/cluster/
sync.py, scrub.py, and the fragment's block checksums) against the JAX
package's: ``checksum_blocks`` digests and ``block_data`` byte-equal on the
same fragments (row ids past 2^31, column bit 31, empty and full blocks, a
dense full row), ``merge_block`` on generated replica sets (majority and
even splits, the local copy in and out of the vote), and the JAX package's
syncer and scrubber drills (tests/test_cluster.py) on the port's
``LocalCluster``, tickers driven by hand. Exact everywhere."""

import numpy as np
import pytest

from pilosa_tpu.cluster.sync import merge_block as j_merge_block
from pilosa_tpu.core.fragment import Fragment as JFragment
from pilosa_tpu_torch.cluster.harness import LocalCluster
from pilosa_tpu_torch.cluster.scrub import Scrubber
from pilosa_tpu_torch.cluster.sync import HolderSyncer, merge_block
from pilosa_tpu_torch.config import HASH_BLOCK_SIZE, SHARD_WIDTH
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.obs.stats import MemoryStats

SEED = 31


def _frag_case(name: str, shard: int):
    """(row ids, absolute column ids) of one named fragment case."""
    rng = np.random.default_rng(SEED + len(name))
    base = shard * SHARD_WIDTH
    if name == "random":
        rows = rng.integers(0, 350, 4000)
        cols = base + rng.integers(0, SHARD_WIDTH, 4000)
    elif name == "high_rows":
        rows = np.array([2**31 - 1, 2**31, 2**31 + 5, 2**32 + 1, 2**40 + 7] * 40)
        cols = base + rng.integers(0, SHARD_WIDTH, len(rows))
    elif name == "full_block":
        # All 100 rows of block 3 hold bits; row 301 is a dense full row.
        rows = np.repeat(np.arange(300, 300 + HASH_BLOCK_SIZE), 20)
        cols = base + rng.integers(0, SHARD_WIDTH, len(rows))
        rows = np.concatenate([rows, np.full(SHARD_WIDTH, 301)])
        cols = np.concatenate([cols, base + np.arange(SHARD_WIDTH)])
    elif name == "edges":
        rows = np.array([0, 0, 99, 100, 199, 200])
        cols = base + np.array([0, SHARD_WIDTH - 1, 1, 2, 3, SHARD_WIDTH // 2])
    else:
        raise AssertionError(name)
    return rows.astype(np.uint64), cols.astype(np.uint64)


def _pair(name: str, shard: int):
    rows, cols = _frag_case(name, shard)
    jf = JFragment("i", "f", "standard", shard)
    tf = Fragment("i", "f", "standard", shard, "cpu")
    jf.bulk_import(rows.tolist(), cols.tolist())
    tf.bulk_import(rows, cols)
    return jf, tf, rows, cols


# Shard 2048 puts bit 31 in every absolute column id.
@pytest.mark.parametrize("shard", [0, 5, 2048])
@pytest.mark.parametrize("name", ["random", "high_rows", "full_block", "edges"])
def test_checksum_blocks_and_block_data_match_jax(name, shard):
    jf, tf, rows, cols = _pair(name, shard)
    want = jf.checksum_blocks()
    got = tf.checksum_blocks()
    assert got == want and len(got) >= 1
    for b in sorted(set(got)) + [max(got) + 1]:
        (jr, jc), (tr, tc) = jf.block_data(b), tf.block_data(b)
        assert tr.dtype == tc.dtype == np.uint64
        assert tr.tobytes() == jr.tobytes() and tc.tobytes() == jc.tobytes()
    # Clearing every bit of one block drops it from both digests: an
    # emptied row is skipped, never hashed as an empty frame.
    b0 = min(got)
    sel = (rows // HASH_BLOCK_SIZE) == b0
    jf.bulk_import(rows[sel].tolist(), cols[sel].tolist(), clear=True)
    tf.bulk_import(rows[sel], cols[sel], clear=True)
    assert tf.checksum_blocks() == jf.checksum_blocks()
    assert b0 not in tf.checksum_blocks()


def test_checksum_block_size_argument_matches_jax():
    jf, tf, _, _ = _pair("random", 3)
    for block_rows in (1, 7, 1000):
        assert tf.checksum_blocks(block_rows) == jf.checksum_blocks(block_rows)
        for b in (0, 2):
            assert [a.tobytes() for a in tf.block_data(b, block_rows)] == \
                [a.tobytes() for a in jf.block_data(b, block_rows)]


def _replica_sets(rng, n_nodes: int):
    universe_r = rng.integers(0, 6, 60).astype(np.uint64)
    universe_c = rng.integers(0, 3 * SHARD_WIDTH, 60).astype(np.uint64)
    out = []
    for _ in range(n_nodes):
        keep = rng.random(60) < rng.uniform(0.0, 1.0)
        out.append((universe_r[keep], universe_c[keep]))
    return out


@pytest.mark.parametrize("n_nodes", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("include_local", [True, False])
def test_merge_block_matches_jax(n_nodes, include_local):
    """Generated replica sets: even splits keep the bit (majority
    (n + 1) // 2), the quarantined-local form excludes the local copy."""
    rng = np.random.default_rng(SEED + 10 * n_nodes + include_local)
    for _ in range(25):
        sets = _replica_sets(rng, n_nodes)
        want = j_merge_block(sets[0], sets[1:], include_local=include_local)
        got = merge_block(sets[0], sets[1:], include_local=include_local)
        (wl, wc), wr = want
        (gl, gc), gr = got
        for a, b in ((wl, gl), (wc, gc)):
            assert [x.tobytes() for x in a] == [x.tobytes() for x in b]
        assert len(wr) == len(gr)
        for (ws, wcl), (gs, gcl) in zip(wr, gr):
            assert [x.tobytes() for x in ws] == [x.tobytes() for x in gs]
            assert [x.tobytes() for x in wcl] == [x.tobytes() for x in gcl]


def test_merge_block_even_split_keeps_the_bit():
    one = (np.array([1], np.uint64), np.array([9], np.uint64))
    none = (np.empty(0, np.uint64), np.empty(0, np.uint64))
    (lsets, lclears), remote = merge_block(none, [one])
    assert lsets[1].tolist() == [9] and lclears[0].tolist() == []
    assert remote[0][0][0].tolist() == [] and remote[0][1][0].tolist() == []


# -- the JAX package's drills on the port's cluster ---------------------------

def _cluster(n: int, replica_n: int) -> LocalCluster:
    lc = LocalCluster(n, replica_n=replica_n, device="cpu")
    lc.create_index("i")
    lc.create_field("i", "f")
    return lc


def test_holder_syncer_repairs_replicas():
    lc = _cluster(3, 2)
    lc.query("i", "Set(5, f=1) Set(6, f=1)")
    owners = lc[0].cluster.shard_nodes("i", 0)
    victim = lc.client.peers[owners[1].id]
    victim.holder.fragment("i", "f", "standard", 0).clear_bit(1, 6)
    primary = lc.client.peers[owners[0].id]
    syncer = HolderSyncer(primary.holder, primary.cluster, lc.client)
    assert syncer.sync_holder() >= 1
    assert victim.holder.fragment("i", "f", "standard", 0).contains(1, 6)
    # Converged: a second pass finds nothing to repair.
    assert syncer.sync_holder() == 0


def test_holder_syncer_repairs_attrs():
    lc = _cluster(3, 2)
    lc.query("i", "Set(5, f=1)")
    for cn in (lc[0], lc[1]):
        cn.holder.index("i").fields["f"].row_attr_store.set_attrs(1, {"name": "alpha"})
    lc[0].holder.index("i").column_attr_store.set_attrs(5, {"city": "x"})
    node2 = lc[2]
    assert node2.holder.index("i").fields["f"].row_attr_store.attrs(1) == {}
    syncer = HolderSyncer(node2.holder, node2.cluster, lc.client)
    assert syncer.sync_holder() >= 1
    assert node2.holder.index("i").fields["f"].row_attr_store.attrs(1) == {"name": "alpha"}
    assert node2.holder.index("i").column_attr_store.attrs(5) == {"city": "x"}


def test_holder_syncer_repairs_a_fragment_a_replica_lacks():
    """A replica without the fragment (its LookupError) gets every block."""
    lc = _cluster(2, 2)
    lc.query("i", "Set(7, f=2)")
    lc[1].holder.field("i", "f").views["standard"].delete_fragment(0)
    syncer = HolderSyncer(lc[0].holder, lc[0].cluster, lc.client)
    assert syncer.sync_holder() >= 1
    assert lc[1].holder.fragment("i", "f", "standard", 0).contains(2, 7)


def test_sync_merge_discards_plan_when_write_races():
    lc = _cluster(2, 2)
    lc.query("i", "Set(5, f=1)")
    lc[1].holder.fragment("i", "f", "standard", 0).bulk_import([1], [7])

    class _RacingClient:
        """The first block-data fetch runs beside a Clear: a stale read."""

        def __init__(self, inner):
            self._inner = inner
            self._fired = False

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def fragment_block_data(self, *a, **kw):
            if not self._fired:
                self._fired = True
                lc.query("i", "Clear(5, f=1)")
            return self._inner.fragment_block_data(*a, **kw)

    HolderSyncer(lc[0].holder, lc[0].cluster, _RacingClient(lc.client)).sync_holder()
    for node in (lc[0], lc[1]):
        frag = node.holder.fragment("i", "f", "standard", 0)
        assert 5 not in frag.row(1).columns().tolist(), node.id


class _NoDiskStore:
    """The scrubber's store surface on the paths these drills take."""

    class quarantine:
        @staticmethod
        def keys():
            return []

        @staticmethod
        def get(key):
            return None

    @staticmethod
    def _all_keys():
        return []


def test_scrubber_repairs_dirty_shard_after_replica_rejoin():
    lc = _cluster(2, 2)
    lc.query("i", "Set(1, f=1)")
    lc.down("node1")
    lc.query("i", "Set(2, f=1)")  # node1 misses this one
    lc.up("node1")
    assert len(lc[0].cluster.dirty_shards) == 1
    stale = lc[1].holder.fragment("i", "f", "standard", 0)
    assert stale.row(1).columns().tolist() == [1]
    scrub = Scrubber(lc[0].holder, lc[0].cluster, lc.client, _NoDiskStore())
    out = scrub.scrub_pass()
    assert out["mismatch"] >= 1
    assert len(lc[0].cluster.dirty_shards) == 0
    assert stale.row(1).columns().tolist() == [1, 2]


def test_scrubber_skips_shard_this_node_no_longer_owns():
    lc = _cluster(2, 1)
    shard = next(s for s in range(16)
                 if all(n.id != "node0" for n in lc[0].cluster.shard_nodes("i", s)))
    col = shard * SHARD_WIDTH + 5
    lc.query("i", f"Set({col}, f=1)")
    owner_frag = lc[1].holder.fragment("i", "f", "standard", shard)
    assert owner_frag.row(1).columns().tolist() == [col]
    v = lc[0].holder.index("i").field("f").create_view_if_not_exists("standard")
    v.create_fragment_if_not_exists(shard).bulk_import([1, 1], [col, col + 1])
    lc[0].cluster.dirty_shards.mark("i", shard)
    out = Scrubber(lc[0].holder, lc[0].cluster, lc.client, _NoDiskStore()).scrub_pass()
    assert out["mismatch"] == 0
    assert owner_frag.row(1).columns().tolist() == [col]


def test_scrubber_repairs_a_quarantined_fragment_from_replicas(tmp_path):
    """A data-dir node whose snapshot fails verification at boot: the
    shard routes to its replica, and one scrub pass rebuilds the local
    copy from replica consensus (its own bits out of the vote) and
    releases the quarantine."""
    from pilosa_tpu_torch.storage.quarantine import STATE_ROUTED

    dirs = [str(tmp_path / f"n{i}") for i in range(2)]
    lc = LocalCluster(2, replica_n=2, device="cpu", data_dirs=dirs)
    lc.create_index("i")
    lc.create_field("i", "f")
    lc.query("i", "Set(3, f=1) Set(9, f=1)")
    for cn in lc.nodes:
        cn.store.snapshot_fragment(("i", "f", "standard", 0))
        cn.store.close()
    snap = next(p for p in (tmp_path / "n1").rglob("*") if p.suffix == ".snap"
                and p.parent.name == "standard" and p.parent.parent.name == "f")
    raw = bytearray(snap.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    snap.write_bytes(bytes(raw))
    lc2 = LocalCluster(2, replica_n=2, device="cpu", data_dirs=dirs)
    b = lc2[1]
    key = ("i", "f", "standard", 0)
    assert b.store.quarantine.get(key)["state"] == STATE_ROUTED
    assert b.holder.fragment(*key) is None
    stats = MemoryStats()
    b.scrubber.stats = stats
    b.scrubber.scrub_pass()
    assert b.store.quarantine.get(key) is None
    assert b.holder.fragment(*key).row(1).columns().tolist() == [3, 9]
    assert stats.counter_value("integrity.repaired") == 1
    for cn in lc2.nodes:
        cn.store.close()


def test_checksums_are_kept_until_the_fragment_changes(monkeypatch):
    """An anti-entropy tick asks every owned fragment for its digests: the
    port computes them once a generation, and a write moves them."""
    jf, tf, rows, cols = _pair("random", 1)
    calls = []
    real = Fragment.rows_snapshot
    monkeypatch.setattr(Fragment, "rows_snapshot",
                        lambda self: calls.append(1) or real(self))
    first = tf.checksum_blocks()
    assert tf.checksum_blocks() == first and len(calls) == 1
    assert tf.checksum_blocks(7) == jf.checksum_blocks(7) and len(calls) == 2
    tf.set_bit(3, SHARD_WIDTH + 17)
    jf.set_bit(3, SHARD_WIDTH + 17)
    assert tf.checksum_blocks() == jf.checksum_blocks() != first
    assert len(calls) == 3
