"""The page pool's invariants, read from what the engine holds once a
drain has synchronised it: its block tables, each lane's context and the
allocator's tree words.

The cells run one shard of the unpacked NBBS tree: one int32 status word
per node, the root at 1, the children of n at 2n and 2n+1, so page p is
the leaf word 2^depth + p.  Bit 0x10 (OCC) marks a node reserved by an
allocation.  The engine claims pages one leaf at a time, so no interior
node is ever reserved, and a page is held exactly when its leaf has OCC.
"""

from __future__ import annotations

import numpy as np

OCC = 0x10


def page_checks(tree: np.ndarray, tables: np.ndarray, ctx: np.ndarray,
                live: np.ndarray, page_tokens: int, num_pages: int) -> dict:
    """Counts that are zero on a sound pool:

    pages_mapped_twice   page ids beyond their first in all block tables
    pages_out_of_range   table entries outside [0, num_pages)
    pages_leaked         pages reserved in the tree that no table maps
    pages_not_reserved   pages a table maps that the tree holds free
    interior_reserved    interior nodes reserved (no allocation spans two pages)
    lanes_misfit         live lanes whose table is not a prefix of
                         ceil(ctx / page_tokens) pages, and empty lanes
                         that map any page
    """
    depth = int(num_pages).bit_length() - 1
    leaves = tree[1 << depth: 2 << depth]
    interior = tree[1: 1 << depth]
    mapped = tables[tables >= 0]
    in_range = mapped[(mapped >= 0) & (mapped < num_pages)]
    uniq = np.unique(in_range)
    reserved = np.nonzero(leaves & OCC)[0]
    misfit = 0
    for lane in range(tables.shape[0]):
        row = tables[lane]
        n = int((row >= 0).sum())
        want = -(-int(ctx[lane]) // page_tokens) if live[lane] else 0
        prefix = bool((row[:n] >= 0).all())
        misfit += int(n != want or not prefix)
    return {
        "pages_mapped_twice": int(in_range.size - uniq.size),
        "pages_out_of_range": int(mapped.size - in_range.size),
        "pages_leaked": int(np.setdiff1d(reserved, uniq).size),
        "pages_not_reserved": int(np.setdiff1d(uniq, reserved).size),
        "interior_reserved": int((interior & OCC).astype(bool).sum()),
        "lanes_misfit": misfit,
    }
