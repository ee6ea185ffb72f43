"""Status-bit algebra of the non-blocking buddy system (paper §III-A).

A copy of `repro/core/bits.py`: every node of the allocator tree carries
a 5-bit status mask

    bit 0  OCC_RIGHT  — right sub-tree partially/fully occupied
    bit 1  OCC_LEFT   — left  sub-tree partially/fully occupied
    bit 2  COAL_RIGHT — a release is in flight in the right sub-tree
    bit 3  COAL_LEFT  — a release is in flight in the left  sub-tree
    bit 4  OCC        — this exact node has been reserved by an allocation

The helpers use only `&`, `|`, `~`, `<<`, `>>`, so they work on Python
integers and integer tensors alike.  `csrc/nbbs_pool_step.cu` repeats
the constants; `tests/test_torch_alloc.py` holds both copies equal.
"""

from __future__ import annotations

OCC_RIGHT = 0x1
OCC_LEFT = 0x2
COAL_RIGHT = 0x4
COAL_LEFT = 0x8
OCC = 0x10
BUSY = OCC | OCC_LEFT | OCC_RIGHT  # 0x13

# All five status bits — used to mask a node's full state out of packed words.
STATUS_MASK = OCC | OCC_LEFT | OCC_RIGHT | COAL_LEFT | COAL_RIGHT  # 0x1F
STATUS_BITS = 5

# Fibonacci multiplicative hashing constant (2^32 / golden ratio).  The
# single source of truth for home-shard routing: the device pool
# (`core/pool.home_shard`) and the host KV manager
# (`memory/kv_cache.PagedKVManager.home_shard`) both hash requester ids
# with it, so host and device always agree on "home".  Lives here (and
# not in core/pool.py) so jax-free host modules can import it.
FIB_HASH = 2654435761


def mod2(child):
    """1 for a right child (odd index), 0 for a left child (even index)."""
    return child & 1


def clean_coal(val, child):
    """Clear the coalescing bit of the branch that contains `child`."""
    return val & ~(COAL_LEFT >> mod2(child))


def mark(val, child):
    """Set the occupancy bit of the branch that contains `child`."""
    return val | (OCC_LEFT >> mod2(child))


def unmark(val, child):
    """Clear both coalescing and occupancy bits of `child`'s branch."""
    return val & ~((OCC_LEFT | COAL_LEFT) >> mod2(child))


def is_coal(val, child):
    """True iff the coalescing bit of `child`'s branch is set."""
    return (val & (COAL_LEFT >> mod2(child))) != 0


def is_occ_buddy(val, child):
    """True iff the occupancy bit of `child`'s *buddy* branch is set."""
    return (val & (OCC_RIGHT << mod2(child))) != 0


def is_coal_buddy(val, child):
    """True iff the coalescing bit of `child`'s *buddy* branch is set."""
    return (val & (COAL_RIGHT << mod2(child))) != 0


def is_free(val):
    """True iff the node is neither reserved nor partially occupied.

    Note coalescing bits do NOT make a node busy (paper §III-A): a node
    with only coalescing bits set is in a transient release state and is
    still rejected by the allocation CAS, which requires the word to be
    exactly zero.
    """
    return (val & BUSY) == 0


def level_of(n: int) -> int:
    """Tree level of node index `n` (root = index 1 = level 0)."""
    return n.bit_length() - 1


def level_first(level: int) -> int:
    """First node index of `level`."""
    return 1 << level


def level_nodes(level: int) -> int:
    """Number of nodes at `level`."""
    return 1 << level
