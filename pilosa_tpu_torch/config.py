"""Build-time-ish constants (the port's own copy of pilosa_tpu/config.py).

Both packages read the same ``PILOSA_TPU_SHARD_WIDTH_EXP``, so a process
that imports both agrees on the shard width.

The reference selects its shard width with build tags
(``shardwidth/20.go:19`` picks 2^20 among 2^16..2^32). We take it from the
environment once at import time — the shard width shapes every compiled
kernel, so it must be fixed for the life of the process, exactly like a
build tag.
"""

import os

# Reference: fragment.go:51-53 (ShardWidth = 1 << shardWidthExponent),
# shardwidth/20.go:19 (default exponent 20).
_DEFAULT_EXPONENT = 20

# Capped at 30 (reference goes to 32): count kernels accumulate per-row in
# int32, which holds up to 2^31-1 set bits — one 2^30-bit row can never
# overflow it, 2^31+ could.
_exp = int(os.environ.get("PILOSA_TPU_SHARD_WIDTH_EXP",
                          str(_DEFAULT_EXPONENT)))
if not (16 <= _exp <= 30):
    raise ValueError("PILOSA_TPU_SHARD_WIDTH_EXP must be in [16, 30]")

#: Number of columns per shard. Reference: fragment.go:53.
SHARD_WIDTH = 1 << _exp

#: Bits per storage word. The dense bitmap word is 32 bits, as in the JAX
#: package (2x u32 replaces the reference's uint64 containers,
#: roaring/roaring.go:55); on the device it is held as an int32 bit pattern.
WORD_BITS = 32

#: uint32 words per shard row (the dense on-device row block).
WORDS_PER_SHARD = SHARD_WIDTH // WORD_BITS

#: Words per 2^16-bit "container span" — retained only for roaring
#: import/export compatibility (reference container width, roaring.go:55).
CONTAINER_BITS = 1 << 16
WORDS_PER_CONTAINER = CONTAINER_BITS // WORD_BITS

#: A host-side row representation flips from sorted-positions ("sparse") to
#: dense words once the position array (uint64 per entry) would outweigh the
#: dense block (4*WORDS_PER_SHARD bytes): at WORDS_PER_SHARD/2 entries.
DENSE_CUTOFF = WORDS_PER_SHARD // 2

#: Snapshot the fragment once this many WAL ops accumulate.
#: Reference: MaxOpN = 10,000 (fragment.go:84).
MAX_OP_N = 10_000

#: Default TopN cache size kept for API compatibility (field.go:48). Our
#: TopN is exact (device top_k over the row-popcount vector) so this only
#: bounds reported candidates, never accuracy.
DEFAULT_CACHE_SIZE = 50_000

#: Cluster hash partitions. Reference: defaultPartitionN (cluster.go:44).
DEFAULT_PARTITION_N = 256

#: Rows per checksum block for anti-entropy. Reference: HashBlockSize
#: (fragment.go:81).
HASH_BLOCK_SIZE = 100

#: Reference time format (pilosa.go TimeFormat "2006-01-02T15:04").
TIME_FORMAT = "%Y-%m-%dT%H:%M"

#: Existence-tracking field name. Reference: existenceFieldName (holder.go:46).
EXISTENCE_FIELD_NAME = "_exists"


def shard_width_exponent() -> int:
    return SHARD_WIDTH.bit_length() - 1
