"""Hand data over to the port: fill a port ``Holder`` from uint32 words.

The data counterpart of carrying weights across. It takes only numpy, so
any producer of dense rows (the JAX package's ``Fragment.row_words``, a
file, a generator) can load the port with the same bits.
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.view import VIEW_STANDARD


def load_fragment_words(holder: Holder, index: str, field: str, shard: int,
                        row_ids, words: np.ndarray) -> None:
    """Replace rows ``row_ids`` of the standard-view fragment
    (``index``, ``field``, ``shard``) with ``words[i]``, a uint32 block of
    ``WORDS_PER_SHARD`` words per row. The index and set field are created
    when absent."""
    words = np.asarray(words)
    if words.dtype != np.uint32:
        raise TypeError(f"words must be uint32, got {words.dtype}")
    row_ids = [int(r) for r in row_ids]
    if words.ndim != 2 or words.shape[0] != len(row_ids):
        raise ValueError(f"words must be [len(row_ids), W], got {words.shape} "
                         f"for {len(row_ids)} rows")
    idx = holder.create_index_if_not_exists(index)
    view = idx.create_field_if_not_exists(field).create_view_if_not_exists(
        VIEW_STANDARD)
    frag = view.create_fragment_if_not_exists(int(shard))
    for rid, w in zip(row_ids, words):
        frag.set_row_words(rid, w)
