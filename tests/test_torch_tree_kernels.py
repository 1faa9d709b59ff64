"""The tree and shift kernels' plain versions against the JAX package, on
the CPU, exact.

- ``shift_left``: the plain version (and the host half,
  ``bitops.np_shift_left``) against ``pilosa_tpu.ops.bitops.shift_left``
  at every ``n`` the card checks, on words with all-ones and bit-31 words.
- ``tree_count``: random postfix tapes against a numpy evaluation; the
  wrapper's checks; its cutting of tapes past the kernel's limits into
  sub-tapes (run here with the plain version standing in for a launch).
- the planner's count and bitmap programs: random call trees from
  tests/test_generative.py's generator (Not and Shift included), on 3
  seeds, lowered by the port's ``Planner`` to one op tape over leaf planes
  and counted by the plain ``tree_count``, against the JAX ``_eval_node`` +
  ``bitops.count`` under ``jax.jit`` on the same leaf stacks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.config import SHARD_WIDTH
from pilosa_tpu.core import Holder as JHolder
from pilosa_tpu.ops import bitops as jbitops
from pilosa_tpu.parallel import MeshPlanner, make_mesh
from pilosa_tpu.parallel.planner import _eval_node as j_eval_node
from pilosa_tpu.pql import parse as j_parse
from pilosa_tpu_torch.core import Holder as THolder
from pilosa_tpu_torch.ops import bitops, kernels
from pilosa_tpu_torch.parallel import Planner
from pilosa_tpu_torch.pql import parse as t_parse
from test_generative import FIELDS, ROWS, _gen_tree
from test_torch_kernels import _t, _words

SHIFTS = [0, 1, 31, 32, 33, 1000, SHARD_WIDTH - 1, SHARD_WIDTH]
OPS = ["and", "or", "xor", "andnot"]
_NP_OPS = {"and": np.bitwise_and, "or": np.bitwise_or, "xor": np.bitwise_xor,
           "andnot": lambda a, b: a & ~b}


@pytest.fixture(autouse=True)
def _launch_counts_stay_zero():
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values())


# -- shift_left ---------------------------------------------------------------


@pytest.mark.parametrize("n", SHIFTS)
@pytest.mark.parametrize("shape", [(3, SHARD_WIDTH // 32), (SHARD_WIDTH // 32,)],
                         ids=["stack", "row"])
def test_shift_left_matches_jax(rng, n, shape):
    w = _words(rng, shape)
    w.reshape(-1)[-1] = 0xFFFFFFFF  # the top bit must fall off
    want = np.asarray(jbitops.shift_left(jnp.asarray(w), n))
    got = kernels.shift_left(_t(w), n)
    assert got.shape == tuple(shape) and got.dtype == torch.int32
    assert got.numpy().view(np.uint32).tobytes() == want.tobytes()
    assert bitops.np_shift_left(w, n).tobytes() == want.tobytes()


def test_shift_left_refuses(rng):
    a = _t(_words(rng, (2, 64)))
    for bad in (-1, -33):
        with pytest.raises(ValueError, match="non-negative"):
            kernels.shift_left(a, bad)
        with pytest.raises(ValueError, match="non-negative"):
            bitops.np_shift_left(a.numpy().view(np.uint32), bad)
    with pytest.raises(TypeError):
        kernels.shift_left(a, True)
    with pytest.raises(TypeError):
        kernels.shift_left(a.to(torch.int64), 1)
    with pytest.raises(ValueError):
        kernels.shift_left(a.to("meta"), 1)


def test_shift_left_of_a_sliced_row(rng):
    """A row sliced out of a stack (its own stride) and a strided 2-D view
    shift like their copies."""
    w = _words(rng, (4, 96))
    a = _t(w)
    for view in (a[2], a[:, 1:65], a[::2]):
        want = kernels.shift_left_plain(view.contiguous(), 37)
        assert torch.equal(kernels.shift_left(view, 37), want)


# -- tree_count ---------------------------------------------------------------


def _random_tape(rng, n_leaves: int, n_ops: int) -> list:
    """A valid postfix tape: random leaves (repeats allowed) and ops."""
    tape, depth = [], 0
    while n_ops or depth != 1:
        if depth >= 2 and (n_ops == 0 or rng.random() < 0.5):
            tape.append(OPS[int(rng.integers(0, 4))])
            depth -= 1
        else:
            tape.append(int(rng.integers(0, n_leaves)))
            depth += 1
            n_ops = max(0, n_ops - 1)
    return tape


def _np_eval(tape, leaves):
    stack = []
    for tok in tape:
        if isinstance(tok, str):
            b = stack.pop()
            stack.append(_NP_OPS[tok](stack.pop(), b))
        else:
            stack.append(leaves[tok])
    return stack[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_count_plain_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    leaves = [_words(rng, (5, 256)) for _ in range(6)] + [_words(rng, (256,))]
    for n in (1, 2, 3, 4, 9, 20):
        tape = _random_tape(rng, len(leaves), n)
        want = np.broadcast_to(_np_eval(tape, leaves), (5, 256))
        counts, plane = kernels.tree_count([_t(x) for x in leaves], tape, plane=True)
        assert plane.numpy().view(np.uint32).tobytes() == want.tobytes()
        assert counts.tolist() == [int(np.unpackbits(r.view(np.uint8)).sum())
                                   for r in want]
        assert torch.equal(kernels.tree_count([_t(x) for x in leaves], tape), counts)


@pytest.mark.parametrize("tape,err", [
    ([0, "and"], "two operands"), ([0, 1], "not 1"), ([0, 7, "or"], "out of range"),
    ([0, 1, "nand"], "unknown tape op"), ([], "not 1"), ([True], "out of range"),
])
def test_tree_count_refuses_bad_tapes(rng, tape, err):
    leaves = [_t(_words(rng, (2, 64))) for _ in range(2)]
    with pytest.raises(ValueError, match=err):
        kernels.tree_count(leaves, tape)


def test_tree_count_refuses_bad_leaves(rng):
    a = _t(_words(rng, (2, 64)))
    with pytest.raises(ValueError, match="word axes"):
        kernels.tree_count([a, _t(_words(rng, (2, 32)))], [0, 1, "and"])
    with pytest.raises(ValueError, match="broadcast"):
        kernels.tree_count([a, _t(_words(rng, (3, 64)))], [0, 1, "and"])
    with pytest.raises(ValueError):
        kernels.tree_count([], [0])
    with pytest.raises(TypeError):
        kernels.tree_count([a.to(torch.int64)], [0])
    with pytest.raises(ValueError):
        kernels.tree_count([a.to("meta")], [0])


def test_tape_past_the_limits_is_cut_into_sub_tapes(rng, monkeypatch):
    """A tape past the kernel's leaf, length and stack limits is cut into
    sub-tapes that each fit; evaluated with the plain version standing in
    for each launch, the result equals the whole tape's."""
    leaves = [_t(_words(rng, (3, 64))) for _ in range(kernels.TREE_MAX_LEAVES + 4)]
    layouts = [kernels._row_layout(x, torch.Size([3]), "x") for x in leaves]
    deep = list(range(12)) + ["xor"] * 11          # stack depth 12
    wide = [0]
    for i in range(1, len(leaves)):                # 20 distinct leaves
        wide += [i, OPS[i % 4]]
    long_ = [0]
    for i in range(40):                            # 81 instructions
        long_ += [i % 5, OPS[i % 4]]
    launched = []

    def fake_launch(node, lv, lay, lead, plane):
        assert kernels._fits(node)
        launched.append(kernels._tree_needs(node))
        return kernels.tree_count_plain(lv, kernels._postfix(node), plane)

    monkeypatch.setattr(kernels, "_launch_tree", fake_launch)
    for tape in (deep, wide, long_):
        node = kernels._parse_tape(tape, len(leaves))
        assert not kernels._fits(node)
        lv, lay = list(leaves), list(layouts)
        launched.clear()
        fitted = kernels._fit_tree(node, lv, lay, torch.Size([3]))
        assert kernels._fits(fitted) and launched
        got = kernels.tree_count_plain(lv, kernels._postfix(fitted), True)
        want = kernels.tree_count_plain(leaves, tape, True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- the planner's programs against the JAX tree evaluator --------------------


N_SHARDS = 3


def _data(seed: int):
    """Seeded (field, row) -> columns over 3 shards, and existence."""
    rng = np.random.default_rng(seed)
    cols_domain = N_SHARDS * SHARD_WIDTH
    bits = {}
    for field in FIELDS:
        n = 3000
        bits[field] = (rng.choice(ROWS, n).astype(np.uint64),
                       rng.integers(0, cols_domain, n).astype(np.uint64))
    exists = np.unique(np.concatenate([c for _, c in bits.values()]
                                      + [rng.integers(0, cols_domain, 2000)
                                         .astype(np.uint64)]))
    return bits, exists


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("seed", [11, 29, 47])
def test_planner_programs_match_jax_eval_node(mesh, seed, mode, monkeypatch):
    # Both packages in one residency mode: dense leaves only (off), or
    # every leaf that fits packed (on), expanded inside the programs.
    monkeypatch.setenv("PILOSA_TPU_RESIDENCY_PACKED", mode)
    bits, exists = _data(seed)
    jh, th = JHolder(), THolder(device="cpu")
    for h in (jh, th):
        idx = h.create_index("g")
        for field, (rows, cols) in bits.items():
            idx.create_field(field).import_bits(rows, cols)
        idx.add_existence(exists)
    jp, tp = MeshPlanner(jh, mesh), Planner(th)
    jidx, tidx = jh.index("g"), th.index("g")
    shards = tuple(range(N_SHARDS))
    rng = np.random.default_rng(seed)
    for _ in range(25):
        q, _ = _gen_tree(rng, depth=3)
        jleaves, tleaves = [], []
        jsig = jp._signature(jidx, j_parse(q).calls[0], jleaves, shards)
        tsig = tp._signature(tidx, t_parse(q).calls[0], tleaves, shards)
        assert tleaves == jleaves and tsig == jsig, q
        jargs = [jp._fetch_leaf(jidx, leaf, shards) for leaf in jleaves]
        targs = [tp._fetch_leaf(tidx, leaf, shards) for leaf in tleaves]
        want = np.asarray(jax.jit(
            lambda *a, _s=jsig: jbitops.count(j_eval_node(_s, a)))(*jargs))
        got = tp._compiled(("count",) + tsig, tsig, "per_shard")(*targs)
        # The JAX stacks pad to the 8-device mesh, the port's to 4 rows:
        # the shard rows must agree, and every pad row count 0.
        assert got[:N_SHARDS].tolist() == want[:N_SHARDS].tolist(), q
        assert not got[N_SHARDS:].any() and not want[N_SHARDS:].any(), q
        want_plane = np.asarray(jax.jit(lambda *a, _s=jsig: j_eval_node(_s, a))(*jargs))
        got_plane = tp._compiled(("row",) + tsig, tsig, None)(*targs)
        assert (got_plane[:N_SHARDS].numpy().view(np.uint32).tobytes()
                == want_plane[:N_SHARDS].astype(np.uint32).tobytes()), q
