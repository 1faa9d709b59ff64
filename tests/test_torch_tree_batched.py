"""tree_count_batched's wave plan on the CPU, exact.

The staged body of csrc/tree_kernels.cu reads each distinct leaf of a slot
group once and evaluates every slot of the group through its slot map. The
plan it runs on is made on the host (``kernels.leaf_keys``,
``group_leaves``), so it is held here: records are keyed on the full
(base, row stride, rows) triple, the map rebuilds every slot's leaf list,
no group exceeds the kernel's limits (what its shared-memory ring stages),
and the coalescer's largest wave (32 slots of 16 distinct leaves) is
grouped. The count evaluated through the plan -- each group's
distinct leaves, each slot's leaves picked by its map, the plain tree
evaluator -- equals ``tree_count_batched_plain`` and the JAX ``jax.vmap``
of ``_eval_node`` + ``bitops.count`` over the stacked slots, on 3 seeds
with shared, broadcast ``[W]`` and disjoint leaves. The kernel itself runs
only on the card; chip_smoke.py holds it to ``tree_count_batched_plain``
on the same kinds of wave.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import bitops as jbitops
from pilosa_tpu.parallel.planner import _eval_node as j_eval_node
from pilosa_tpu_torch.ops import kernels
from test_torch_kernels import _t, _words

W = 2048
SEEDS = [0, 1, 2]
#: the batched kernel's limits (csrc/tree_kernels.cu kMaxGroupLeaves,
#: kMaxGroupSlots).
MAX_GROUP_LEAVES, MAX_GROUP_SLOTS = 32, 32
TREE_CU = Path(kernels.__file__).resolve().parent.parent / "csrc" / "tree_kernels.cu"
_TREES = [
    # (JAX planner signature over leaf slots, port tape over the same leaves)
    (("intersect", (("leaf", 0), ("leaf", 1), ("leaf", 2))), [0, 1, "and", 2, "and"]),
    (("xor", (("union", (("leaf", 0), ("leaf", 1))), ("difference", (("leaf", 2),
                                                                      ("leaf", 0))))),
     [0, 1, "or", 2, 0, "andnot", "xor"]),
]


@pytest.fixture(autouse=True)
def _launch_counts_stay_zero():
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values())
    assert not any(kernels.TREE_BATCH_LEAVES.values())


def _wave(rng, kind: str, n_slots: int = 8, rows: int = 4):
    """8 slots of 3 leaves: ``shared`` as the card's timed wave (slot z
    pushes a[z], b[z], a[z + 1], and slot 5 slot 3's b: 15 distinct of 24),
    ``broadcast`` with one ``[W]`` leaf every slot pushes, ``disjoint`` with
    no leaf shared."""
    def plane():
        return _t(_words(rng, (rows, W)))

    if kind == "disjoint":
        return [[plane() for _ in range(3)] for _ in range(n_slots)]
    a = [plane() for _ in range(n_slots)]
    b = [plane() for _ in range(n_slots)]
    if kind == "shared":
        b[5] = b[3]
        return [[a[z], b[z], a[(z + 1) % n_slots]] for z in range(n_slots)]
    w = _t(_words(rng, (W,)))
    return [[a[z], w, b[z]] for z in range(n_slots)]


def _keys(tables):
    return [kernels.leaf_keys(ls) for ls in tables]


def _check_plan(keys, plan, max_leaves):
    """The plan's groups cover the slots in order within the limits, and its
    map rebuilds every slot's leaf records."""
    assert len(set(plan.leaves)) == len(plan.leaves) == len({k for ks in keys for k in ks})
    assert [lo for lo, _, _ in plan.groups] == [0] + [hi for _, hi, _ in plan.groups[:-1]]
    assert plan.groups[-1][1] == len(keys)
    for lo, hi, ls in plan.groups:
        assert 0 < hi - lo <= kernels.TREE_BATCH_GROUP_SLOTS == MAX_GROUP_SLOTS
        assert 0 < len(ls) <= max_leaves <= MAX_GROUP_LEAVES
        assert len(set(ls)) == len(ls)
        for z in range(lo, hi):
            assert [plan.leaves[ls[i]] for i in plan.local[z]] == list(keys[z])


def _eval_through_plan(tables, tape, plan) -> torch.Tensor:
    """What the staged body computes: per group, its distinct leaves (the
    stage), and per slot the tape over the leaves its map picks."""
    by_key = {k: x for ls, ks in zip(tables, _keys(tables)) for x, k in zip(ls, ks)}
    out = []
    for lo, hi, ls in plan.groups:
        stage = [by_key[plan.leaves[d]] for d in ls]
        for z in range(lo, hi):
            out.append(kernels.tree_count_plain([stage[i] for i in plan.local[z]], tape))
    return torch.stack(out)


def test_keys_on_the_full_triple():
    """Views of one storage at other offsets or strides are other leaves;
    two view objects of the same rows are one; a [W] leaf every slot
    pushes is one leaf, though it shares its base with a stack view."""
    s = _t(_words(np.random.default_rng(7), (7, W)))
    w = s[0]
    tables = [[s[0:3], s[1:4], w], [s[0:3], s[0:6:2], w], [s[1:4], s[0:3], w]]
    keys = _keys(tables)
    assert keys[0][0] == keys[1][0] == keys[2][1]           # s[0:3], three views
    assert keys[0][1] == keys[2][0]                         # s[1:4], two views
    assert keys[0][0][0] == keys[1][1][0] == w.data_ptr()   # one base ...
    assert keys[1][1] != keys[0][0] != keys[0][2]           # ... other strides, rows
    assert keys[0][1][1:] == keys[0][0][1:] and keys[0][1] != keys[0][0]  # offsets
    assert keys[0][2] == (w.data_ptr(), 0, 1)
    plan = kernels.group_leaves(keys, 32)
    assert len(plan.leaves) == 4 and len(plan.groups) == 1
    _check_plan(keys, plan, 32)
    np.testing.assert_array_equal(
        _eval_through_plan(tables, [0, 1, "and", 2, "xor"], plan).numpy(),
        kernels.tree_count_batched_plain(tables, [0, 1, "and", 2, "xor"]).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["shared", "broadcast", "disjoint"])
def test_slot_map_rebuilds_every_slot(seed, kind):
    tables = _wave(np.random.default_rng(seed), kind)
    keys = _keys(tables)
    plan = kernels.group_leaves(keys)
    want = {"shared": 15, "broadcast": 17, "disjoint": 24}[kind]
    assert len(plan.leaves) == want and len(plan.groups) == 1
    _check_plan(keys, plan, want)


@pytest.mark.parametrize("n_slots,n_leaves,share", [
    (1, 1, 1), (8, 3, 1), (8, 3, 2), (32, 3, 4), (32, 16, 1), (32, 16, 2),
    (32, 16, 32), (17, 11, 3), (5, 16, 1)])
def test_groups_fit_the_budget(n_slots, n_leaves, share):
    """Synthetic records (no tensors): slot z's leaf k is leaf (z // share,
    k), every share-th slot a new set, plus one record every slot pushes.
    Every group stays within the kernel's limits, and a group closes only
    when the next slot would take it past one of them."""
    keys = [[(16 * (1000 * (z // share) + k), 4, 8) for k in range(n_leaves - 1)]
            + [(16, 0, 1)] for z in range(n_slots)]
    plan = kernels.group_leaves(keys)
    widest = max(len(ls) for _, _, ls in plan.groups)
    _check_plan(keys, plan, widest)
    assert widest <= kernels.TREE_BATCH_GROUP_LEAVES
    for (lo, hi, ls), (nlo, _, _) in zip(plan.groups, plan.groups[1:]):
        grown = set(ls) | {plan.leaves.index(k) for k in keys[nlo]}
        assert (hi - lo == kernels.TREE_BATCH_GROUP_SLOTS
                or len(grown) > kernels.TREE_BATCH_GROUP_LEAVES)


def test_worst_case_wave_is_grouped():
    """The coalescer's largest wave, 32 slots of 16 distinct leaves each
    (512 leaves), is one table: groups of at most the cap's leaves, the
    kernel's tables laid out as csrc/tree_kernels.cu reads them."""
    keys = [[(16 * (16 * z + k + 1), 4, 1024) for k in range(16)] for z in range(32)]
    plan = kernels.group_leaves(keys)
    cap = kernels.TREE_BATCH_GROUP_LEAVES
    assert len(plan.leaves) == 512
    assert len(plan.groups) == 512 // (cap // 16 * 16)
    _check_plan(keys, plan, cap)
    table = kernels._batch_table(plan)
    n_recs, n_groups = len(plan.leaves), len(plan.groups)
    n_gleaves = sum(len(ls) for _, _, ls in plan.groups)
    assert len(table) == 3 * n_recs + 4 * n_groups + n_gleaves + 32 * 16
    groups = np.array(table[3 * n_recs:3 * n_recs + 4 * n_groups]).reshape(-1, 4)
    gleaves = table[3 * n_recs + 4 * n_groups:][:n_gleaves]
    lmap = np.array(table[-32 * 16:]).reshape(32, 16)
    for g, (lo, hi, glo, ghi) in enumerate(groups):
        for z in range(lo, hi):
            recs = [tuple(table[3 * gleaves[glo + i]:3 * gleaves[glo + i] + 3])
                    for i in lmap[z]]
            assert recs == keys[z] and all(i < ghi - glo for i in lmap[z])


def test_plan_caps_are_the_kernels():
    """The host plan's caps are the limits the kernel's shared arrays are
    sized for, and its leaf cap is what the ring stages at the narrowest
    tile."""
    src = TREE_CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int(?:64_t)? {name} = (\d+)", src).group(1))

    stage_bytes = int(re.search(r"kStageBytes = (\d+) \* 1024", src).group(1)) * 1024
    assert const("kMaxGroupSlots") == kernels.TREE_BATCH_GROUP_SLOTS == MAX_GROUP_SLOTS
    assert (stage_bytes // (const("kStages") * 4 * const("kMinTile"))
            == kernels.TREE_BATCH_GROUP_LEAVES == MAX_GROUP_LEAVES)
    assert f"static_assert(kMaxGroupLeaves == {kernels.TREE_BATCH_GROUP_LEAVES}," in src


def test_one_slot_past_the_cap_is_refused():
    keys = [[(16 * (k + 1), 4, 8) for k in range(5)]]
    with pytest.raises(ValueError, match="distinct leaves"):
        kernels.group_leaves(keys, 4)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["shared", "broadcast", "disjoint"])
@pytest.mark.parametrize("tree", range(len(_TREES)), ids=["3-leaf", "mixed"])
@pytest.mark.parametrize("cap", [None, 4], ids=["plan", "groups of 4 leaves"])
def test_count_through_the_plan_matches_jax_vmap(seed, kind, tree, cap):
    """The wave counted through its plan (one group, or groups of at most 4
    leaves) equals the plain batched count and the JAX vmap of the count
    program over the stacked slots."""
    sig, tape = _TREES[tree]
    tables = _wave(np.random.default_rng(seed), kind)
    keys = _keys(tables)
    plan = kernels.group_leaves(keys) if cap is None else kernels.group_leaves(keys, cap)
    _check_plan(keys, plan, cap or len(plan.leaves))
    got = _eval_through_plan(tables, tape, plan)
    assert got.shape == (8, 4) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  kernels.tree_count_batched_plain(tables, tape).numpy())
    stacked = [jnp.asarray(np.stack([ls[k].numpy() for ls in tables])) for k in range(3)]
    want = jax.jit(jax.vmap(lambda *a: jbitops.count(j_eval_node(sig, a))))(*stacked)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_every_slot_is_checked():
    """Slots after the first are held to slot 0's shapes and to the word
    checks of a single leaf, before either path runs."""
    rng = np.random.default_rng(3)
    a, b = _t(_words(rng, (4, W))), _t(_words(rng, (4, W)))
    tape = [0, 1, "and"]
    with pytest.raises(TypeError, match="slot 1 leaf 1"):
        kernels.tree_count_batched([[a, b], [a, b.to(torch.int64)]], tape)
    with pytest.raises(ValueError, match="slot 1 leaf 0"):
        kernels.tree_count_batched([[a, b], [a.t().contiguous().t(), b]], tape)
    with pytest.raises(ValueError, match="slot 2 leaf 0"):
        kernels.tree_count_batched([[a, b], [b, a], [a[:3], b]], tape)
    with pytest.raises(ValueError, match="slot 1 has 1 leaves"):
        kernels.tree_count_batched([[a, b], [a]], tape)
    wave = [[a, b[1]], [b, a[0]]]  # a [W] leaf against [4, W] ones
    np.testing.assert_array_equal(kernels.tree_count_batched(wave, tape).numpy(),
                                  kernels.tree_count_batched_plain(wave, tape).numpy())
