"""The port's sparse-upload stack builder against the JAX package, on the CPU.

- ``assemble_stack`` (through its plain version, as every CPU tensor runs
  it) against the JAX ``_assemble_stack`` bit for bit, on the edge cases
  that ``chip_smoke.py`` also holds the CUDA kernel to on the card
  (``chip_smoke.ASSEMBLE_CASES``): one row, no dense rows, no COO words,
  a row neither dense nor COO, words 0 and W - 1, all-ones and
  bit-31-only words, words out of order within a row, an odd width, a
  row both dense and COO.
- the planner's packed arguments (its sparse upload turned on, as on the
  card) against the kernel's contract at 3 shard counts: ``ci``
  non-decreasing, padding aimed one past the stack, distinct words, the
  stack allocated at ``[S_pad, W]`` with no trash row.
- the wrapper raises on COO words that are not grouped by row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pilosa_tpu.config import SHARD_WIDTH
from pilosa_tpu.core import Holder as JHolder
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.parallel import MeshPlanner, make_mesh
from pilosa_tpu.parallel.planner import _assemble_stack as j_assemble_stack
from pilosa_tpu_torch.core import Holder as THolder
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel import Planner

W = SHARD_WIDTH // 32


def _i32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


@pytest.fixture(autouse=True)
def _launch_counts_stay_zero():
    """Every CPU call takes the plain version: no kernel launch is counted."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("case", chip_smoke.ASSEMBLE_CASES)
def test_assemble_stack_edge_cases_match_jax(case):
    didx, dmat, ci, cw, cv, s_pad = chip_smoke.assemble_case(case)
    words = dmat.shape[1]
    # The JAX function builds W = 32768 words a row: a narrower case rides
    # in the first `words` of them, the rest zeros.
    jmat = np.zeros((dmat.shape[0], W), dtype=np.uint32)
    jmat[:, :words] = dmat
    want = np.asarray(j_assemble_stack(jnp.asarray(didx), jnp.asarray(jmat),
                                       jnp.asarray(ci), jnp.asarray(cw),
                                       jnp.asarray(cv), s_pad=s_pad))
    assert not want[:, words:].any()
    got = kernels.assemble_stack(_i32(didx), _i32(dmat), _i32(ci), _i32(cw), _i32(cv), s_pad)
    assert got.shape == (s_pad, words) and got.dtype == torch.int32
    assert got.numpy().view(np.uint32).tobytes() == np.ascontiguousarray(want[:, :words]).tobytes()
    # Every real word landed (the case is not all zeros by accident).
    real = ci < s_pad
    np.testing.assert_array_equal(got.numpy().view(np.uint32)[ci[real], cw[real]], cv[real])


@pytest.mark.parametrize("n_shards", [1, 5, 11])
def test_planner_packs_to_assemble_contract(n_shards, mesh, monkeypatch):
    """The planner's sparse upload packs (didx, dmat, ci, cw, cv) as the
    kernel requires, and the stack it builds equals the dense upload's
    and answers as the JAX planner does."""
    rng = np.random.default_rng(n_shards)
    # Per shard: a sparse row (1-2048 bits), a dense one (9000 bits), or
    # none; shard 0 always sparse, so every stack has COO words.
    kinds = ["sparse"] + list(rng.choice(["sparse", "dense", "none"], n_shards - 1))
    cols = [rng.choice(SHARD_WIDTH, int(rng.integers(1, 2049)) if k == "sparse" else 9000,
                       replace=False) + s * SHARD_WIDTH
            for s, k in enumerate(kinds) if k != "none"]
    cols = np.concatenate(cols).astype(np.uint64)

    def load(h):
        h.create_index("up").create_field("f").import_bits(
            np.ones(len(cols), dtype=np.uint64), cols)

    jh, th = JHolder(), THolder(device="cpu")
    load(jh)
    load(th)
    dense, sparse = Planner(th), Planner(th)
    monkeypatch.setattr(sparse, "_sparse_upload_enabled", lambda: True)
    seen = []
    real_assemble = kernels.assemble_stack

    def assemble(*args):
        seen.append(args)
        return real_assemble(*args)

    monkeypatch.setattr(kernels, "assemble_stack", assemble)
    shards = tuple(range(n_shards))
    tidx = th.index("up")
    got = sparse._stack_rows(tidx, "f", "standard", 1, shards)
    assert torch.equal(got, dense._stack_rows(tidx, "f", "standard", 1, shards))
    (didx, dmat, ci, cw, cv, s_pad), = seen
    assert s_pad == sparse._pad(n_shards)
    # No trash row: the stack is all of its storage.
    assert got.shape == (s_pad, W)
    assert got.untyped_storage().nbytes() == s_pad * W * 4
    ci, cw, didx = ci.numpy(), cw.numpy(), didx.numpy()
    assert (np.diff(ci) >= 0).all()
    real = ci < s_pad
    assert (ci[~real] == s_pad).all() and real.sum() > 0
    assert ((cw[real] >= 0) & (cw[real] < W)).all()
    assert len(set(zip(ci[real].tolist(), cw[real].tolist()))) == real.sum()
    dense_real = didx[didx < s_pad]
    assert (didx[didx >= s_pad] == s_pad).all()
    assert len(set(dense_real.tolist())) == len(dense_real)
    assert sorted(dense_real.tolist()) == [s for s, k in enumerate(kinds) if k == "dense"]
    assert not set(dense_real.tolist()) & set(ci[real].tolist())
    assert dmat.shape == (len(didx), W)
    split = sparse.upload_split_ms()
    assert {"gather", "pin", "fill"} <= set(split) and all(v >= 0 for v in split.values())
    jex = JExecutor(jh, planner=MeshPlanner(jh, mesh))
    tex = TExecutor(th, planner=sparse)
    assert (tex.execute("up", "Count(Row(f=1))", cache=False)
            == jex.execute("up", "Count(Row(f=1))", cache=False) == [len(cols)])
    for p in (dense, sparse, jex.planner):
        p.close()


@pytest.mark.parametrize("ci", [[0, 2, 1, 8], [1, 1, 0, 0], [8, 0, 0, 8]],
                         ids=["rows-out-of-order", "descending", "pad-first"])
def test_assemble_stack_rejects_ungrouped_rows(ci):
    dmat = torch.zeros((0, 64), dtype=torch.int32)
    didx = torch.zeros(0, dtype=torch.int32)
    ci = torch.tensor(ci, dtype=torch.int32)
    cw = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="non-decreasing"):
        kernels.assemble_stack(didx, dmat, ci, cw, cw.clone(), 8)
