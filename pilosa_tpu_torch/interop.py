"""Hand data over to the port: fill a port ``Holder`` from uint32 words and
key-translation entries.

The data counterpart of carrying weights across. It takes only numpy and
plain Python values, so any producer of dense rows (the JAX package's
``Fragment.row_words``, a file, a generator) can load the port with the
same bits, and any holder with the JAX package's shape (``index_names``,
``index(name).options.keys``, ``translate_store.entries_since``) can hand
over its key maps with the same ids.
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch.core.field import FIELD_TYPE_INT, FieldOptions
from pilosa_tpu_torch.core.fragment import BSI_EXISTS_BIT
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import IndexOptions
from pilosa_tpu_torch.core.view import VIEW_STANDARD, view_bsi_name


def load_fragment_words(holder: Holder, index: str, field: str, shard: int,
                        row_ids, words: np.ndarray, view: str = VIEW_STANDARD) -> None:
    """Replace rows ``row_ids`` of the fragment (``index``, ``field``,
    ``view``, ``shard``) with ``words[i]``, a uint32 block of
    ``WORDS_PER_SHARD`` words per row. The index and a set field are
    created when absent."""
    words = np.asarray(words)
    if words.dtype != np.uint32:
        raise TypeError(f"words must be uint32, got {words.dtype}")
    row_ids = [int(r) for r in row_ids]
    if words.ndim != 2 or words.shape[0] != len(row_ids):
        raise ValueError(f"words must be [len(row_ids), W], got {words.shape} "
                         f"for {len(row_ids)} rows")
    idx = holder.create_index_if_not_exists(index)
    frag = idx.create_field_if_not_exists(field).create_view_if_not_exists(
        view).create_fragment_if_not_exists(int(shard))
    for rid, w in zip(row_ids, words):
        frag.set_row_words(rid, w)


def load_bsi_planes(holder: Holder, index: str, field: str, shard: int,
                    planes: np.ndarray, options: FieldOptions) -> None:
    """Load one shard of an int field: ``planes`` is ``[2 + depth, W]``
    uint32 words (exists, sign, then magnitude bit i at ``planes[2 + i]``,
    values relative to the field's base) into the field's
    ``bsig_<field>`` view. The index and the int field (with ``options``)
    are created when absent; the field's bit depth grows to ``depth``."""
    planes = np.asarray(planes)
    if planes.ndim != 2 or planes.shape[0] < 2:
        raise ValueError(f"planes must be [2 + depth, W], got {planes.shape}")
    idx = holder.create_index_if_not_exists(index)
    f = idx.field(field)
    if f is None:
        if options.type != FIELD_TYPE_INT:
            raise ValueError(f"options must be an int field's, got {options.type!r}")
        f = idx.create_field(field, options)
    bsig = f._require_bsi()
    f._grow_bit_depth(planes.shape[0] - 2)
    load_fragment_words(holder, index, field, shard,
                        range(BSI_EXISTS_BIT, BSI_EXISTS_BIT + len(planes)), planes,
                        view=view_bsi_name(bsig.name))


def load_translate_entries(holder: Holder, index: str, field: str | None,
                           entries) -> None:
    """Apply ``entries``, (id, key) pairs, to the translate store of the
    index (``field=None``, its column keys) or of one of its fields (row
    keys), keeping the ids. The index (keyed) is created when absent; the
    field must exist."""
    idx = holder.index(index) or holder.create_index(index, IndexOptions(keys=True))
    target = idx if field is None else idx.field(field)
    if target is None:
        raise ValueError(f"field not found: {index}/{field}")
    target.translate_store.apply_entries([(int(i), str(k)) for i, k in entries])


def copy_translate_stores(src, holder: Holder) -> None:
    """Copy every translate store of ``src`` -- a holder of the JAX
    package's shape -- into the port ``holder``: each index's keys option
    and column keys, and each field's keys option and row keys, with their
    ids. The indexes and fields must exist in ``holder`` (load the schema
    first)."""
    for name in src.index_names():
        s_idx, d_idx = src.index(name), holder.index(name)
        if d_idx is None:
            raise ValueError(f"index not found in the port holder: {name}")
        d_idx.options.keys = bool(s_idx.options.keys)
        load_translate_entries(holder, name, None, s_idx.translate_store.entries_since(0))
        for fname, f in s_idx.fields.items():
            d_f = d_idx.field(fname)
            if d_f is None:
                raise ValueError(f"field not found in the port holder: {name}/{fname}")
            d_f.options.keys = bool(f.options.keys)
            load_translate_entries(holder, name, fname, f.translate_store.entries_since(0))
