"""View — one slice of a field, holding fragments keyed by shard.

The port's counterpart of pilosa_tpu/core/view.py, standard view only
(time and BSI views come with ROADMAP.md Queue 1's BSI/time slice).
Reference: view.go (names :36-44, CreateFragmentIfNotExists :263, setBit
:367).
"""

from __future__ import annotations

import threading

import torch

from pilosa_tpu_torch.config import DEFAULT_CACHE_SIZE, SHARD_WIDTH
from pilosa_tpu_torch.core.fragment import Fragment

VIEW_STANDARD = "standard"


class View:
    """Container of per-shard fragments for one layout of one field."""

    def __init__(self, index: str, field: str, name: str, device: torch.device,
                 cache_type: str = "ranked", cache_size: int = DEFAULT_CACHE_SIZE,
                 epoch=None):
        self.index = index
        self.field = field
        self.name = name
        self.device = device
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.epoch = epoch
        self.fragments: dict[int, Fragment] = {}
        self._lock = threading.RLock()

    def fragment(self, shard: int) -> Fragment | None:
        return self.fragments.get(shard)

    def create_fragment_if_not_exists(self, shard: int) -> Fragment:
        with self._lock:
            frag = self.fragments.get(shard)
            if frag is None:
                frag = Fragment(self.index, self.field, self.name, shard,
                                self.device, cache_type=self.cache_type,
                                cache_size=self.cache_size, epoch=self.epoch)
                self.fragments[shard] = frag
                # Registration changes the shard set even with zero bits;
                # the index's available_shards() memo keys on the epoch.
                if self.epoch is not None:
                    self.epoch.bump()
            return frag

    def available_shards(self) -> set[int]:
        return set(self.fragments)

    def set_bit(self, row_id: int, column_id: int) -> bool:
        frag = self.create_fragment_if_not_exists(column_id // SHARD_WIDTH)
        return frag.set_bit(row_id, column_id)

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        frag = self.fragment(column_id // SHARD_WIDTH)
        return frag.clear_bit(row_id, column_id) if frag else False

    def __repr__(self):
        return f"View({self.index}/{self.field}/{self.name} shards={sorted(self.fragments)})"
