"""Trie statistics report (counterpart of ``fastqdedup_tpu/stats.py``).

Produces the same DEBUG text the reference prints (node-size histogram per
trie layer plus a node/suffix/total memory split — capability of reference
``__init__.py:133-157``), but computed here as a numpy column reduction over
the raw-stats matrix rather than running Python accumulators row by row.
"""

from typing import Iterable, List

import numpy as np

from .trie import Trie

_NODE_HEADER_BYTES = 8    # per-node fixed cost in the reference model
_NODE_SLOT_BYTES = 8      # per-child-slot cost (8 + 8*width bytes/node)


def _row(cells: Iterable) -> str:
    return "".join(f"{cell:10}" for cell in cells) + "\n"


def trie_stats(trie: Trie) -> str:
    """Layer histogram + memory breakdown as one formatted string."""
    width = len(trie.alphabet) + 1
    matrix = np.asarray(trie.raw_stats(), dtype=np.int64).reshape(-1, width)
    per_layer = matrix.sum(axis=1)
    per_size = matrix.sum(axis=0)

    lines: List[str] = [
        "layer     terminal  "
        + "".join(f"{size:10}" for size in range(1, width)) + "     total\n"
    ]
    for layer, row in enumerate(matrix):
        lines.append(_row([str(layer), *row.tolist(), int(per_layer[layer])]))
    lines.append(_row(["total", *per_size.tolist(), int(per_layer.sum())]))

    slot_costs = _NODE_HEADER_BYTES + _NODE_SLOT_BYTES * np.arange(width)
    node_bytes = int(slot_costs @ per_size)
    total_bytes = trie.memory_size()
    gib = float(1 << 30)
    lines.append(f"Node memory usage: {node_bytes / gib:.2} GiB\n")
    lines.append(f"Suffix memory usage: {(total_bytes - node_bytes) / gib:.2}"
                 f" GiB\n")
    lines.append(f"Total memory usage: {total_bytes / gib:.2} GiB\n")
    return "".join(lines)
