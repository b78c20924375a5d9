"""API-compatible ``Trie`` facade over the dense clustering engine.

Counterpart of ``fastqdedup_tpu/trie.py``, over the port's engine.

The reference's ``Trie`` (_triemodule.c) is both a data structure and an
algorithm: a memory-compact radix trie whose ``pop_cluster`` walks out one
connected component of the within-distance relation per call.  On the
device the winning formulation is dense (see ``engine.py``), so this class
keeps the *contract* of the C type — the ``_trie.pyi`` surface:
``add_sequence``, ``contains_sequence``, ``pop_cluster``,
``number_of_sequences``, ``alphabet``, ``memory_size``, ``raw_stats`` —
while the distance work runs through the batched kernels.

A lightweight host radix structure is still maintained, purely for parity of
the *observable* bookkeeping the reference exposes:

* dynamic alphabet growth order (characters register only when they become a
  child edge, not while buried inside a stored radix suffix — pinned by
  tests/test_trie.py:150-158 of the reference);
* ``raw_stats`` / ``memory_size`` layer histograms (reference
  _triemodule.c:909-964), reported as the sizes the equivalent C trie would
  allocate;
* the deterministic "first sequence in alphabet index order" seed choice of
  ``pop_cluster`` (_triemodule.c:510-551).

Cluster membership is computed once per generation by the engine and served
per pop; this preserves output equivalence (components are disjoint, so
popping them in any interleaving yields the same partition) while turning
the reference's O(N * walk) loop into batched device work.
"""

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .engine import build_clusters, contains_within
from .ops.encode import EncodeTable


class _Node:
    """Internal radix-trie node (host bookkeeping only)."""
    __slots__ = ("children", "count", "suffix", "suffix_count")

    def __init__(self):
        self.children: Dict[int, "_Node"] = {}
        self.count = 0                    # sequences ending exactly here
        self.suffix: Optional[bytes] = None  # radix leaf payload
        self.suffix_count = 0

    def is_empty(self) -> bool:
        return (not self.children and self.count == 0
                and self.suffix is None)


class Trie:
    """Drop-in replacement for ``fastqdedup._trie.Trie``."""

    def __init__(self, alphabet: str = ""):
        self._table = EncodeTable(alphabet)
        self._root = _Node()
        self._root_is_vacant_leaf = True
        self._number_of_sequences = 0
        self._counts: Dict[bytes, int] = {}
        # Cached cluster partition for pop_cluster; invalidated on mutation
        # or when pop_cluster is called with different distance parameters.
        self._cluster_cache: Optional[List] = None
        self._cluster_cache_params: Optional[Tuple[int, bool]] = None
        self._cluster_of_key: Dict[bytes, int] = {}
        # Cached (keys list, query encode table) for contains_sequence:
        # rebuilt lazily after mutations, so probe loops pay O(N) once,
        # not per call.
        self._query_cache: Optional[Tuple[List[bytes], EncodeTable]] = None

    # ------------------------------------------------------------------ #
    # Mutation

    def add_sequence(self, sequence: str) -> None:
        if not isinstance(sequence, str):
            raise TypeError("sequence must be a str")
        if not sequence.isascii():
            raise ValueError("Only ASCII strings are allowed")
        key = sequence.encode("ascii")
        self._insert_structure(key)
        self._counts[key] = self._counts.get(key, 0) + 1
        self._number_of_sequences += 1
        self._cluster_cache = None
        self._query_cache = None

    def _register(self, byte: int) -> None:
        if self._table.table[byte] == 0xFF:
            self._table.add(byte)

    def _insert_structure(self, key: bytes) -> None:
        """Insert into the host radix structure, mirroring the reference's
        alphabet-registration and node-shape behavior
        (_triemodule.c:222-288)."""
        node = self._root
        rest = key
        if self._root_is_vacant_leaf and node.is_empty():
            node.suffix = rest
            node.suffix_count = 1
            self._root_is_vacant_leaf = False
            return
        while True:
            if node.suffix is not None:
                if node.suffix == rest:
                    node.suffix_count += 1
                    return
                # Explode the radix leaf: push the stored suffix one level
                # down (registering its first character), then continue
                # inserting the new sequence (_triemodule.c:241-260).
                old_suffix, old_count = node.suffix, node.suffix_count
                node.suffix, node.suffix_count = None, 0
                if not old_suffix:
                    node.count += old_count
                else:
                    self._register(old_suffix[0])
                    child = _Node()
                    child.suffix = old_suffix[1:]
                    child.suffix_count = old_count
                    node.children[old_suffix[0]] = child
                continue
            if not rest:
                node.count += 1
                return
            first = rest[0]
            child = node.children.get(first)
            if child is None:
                self._register(first)
                child = _Node()
                child.suffix = rest[1:]
                child.suffix_count = 1
                node.children[first] = child
                return
            node = child
            rest = rest[1:]

    def _delete_structure(self, key: bytes) -> int:
        """Remove all occurrences of ``key``; returns its count.

        Prunes empty branches like TrieNode_DeleteSequence
        (_triemodule.c:301-363)."""
        path: List[Tuple[_Node, int]] = []
        node = self._root
        rest = key
        while True:
            if node.suffix is not None and node.suffix == rest:
                count = node.suffix_count
                node.suffix, node.suffix_count = None, 0
                break
            if not rest:
                if node.count == 0:
                    raise LookupError(f"Sequence not found: {key!r}")
                count = node.count
                node.count = 0
                break
            child = node.children.get(rest[0])
            if child is None:
                raise LookupError(f"Sequence not found: {key!r}")
            path.append((node, rest[0]))
            node, rest = child, rest[1:]
        # Prune now-empty nodes bottom-up.
        child_node = node
        for parent, byte in reversed(path):
            if child_node.is_empty():
                del parent.children[byte]
                child_node = parent
            else:
                break
        if self._root.is_empty():
            self._root_is_vacant_leaf = True
        return count

    # ------------------------------------------------------------------ #
    # Queries

    @property
    def alphabet(self) -> str:
        return self._table.as_string()

    @property
    def number_of_sequences(self) -> int:
        return self._number_of_sequences

    def contains_sequence(self, sequence: str, max_distance: int = 0,
                          use_edit_distance: bool = False) -> bool:
        if not isinstance(sequence, str):
            raise TypeError("sequence must be a str")
        key = sequence.encode("ascii")
        if max_distance == 0 and not use_edit_distance:
            return key in self._counts
        if key in self._counts:
            return True
        if self._query_cache is None:
            self._query_cache = (list(self._counts), self._query_table())
        keys, table = self._query_cache
        return contains_within(keys, key, max_distance,
                               use_edit_distance, table=table)

    def _query_table(self) -> EncodeTable:
        """Encode table covering every byte present in stored keys (the
        public alphabet may lag behind, since suffix bytes are unregistered
        until they become edges)."""
        table = EncodeTable()
        table.extend_from(np.frombuffer(
            b"".join(self._counts) or b"\x00", dtype=np.uint8))
        return table

    # ------------------------------------------------------------------ #
    # Clustering

    def _alphabet_sort_key(self, key: bytes) -> List[int]:
        # Order by alphabet registration index; bytes never registered sort
        # after all registered ones, by raw value (deterministic).
        table = self._table.table
        return [int(table[b]) if table[b] != 0xFF else 256 + b for b in key]

    def _first_sequence(self) -> bytes:
        """The first stored key in alphabet-index walk order, i.e. the seed
        the reference's TrieNode_GetSequence would return
        (_triemodule.c:510-551)."""
        return min(self._counts, key=self._alphabet_sort_key)

    def pop_cluster(self, max_distance: int,
                    use_edit_distance: bool = False
                    ) -> List[Tuple[int, str]]:
        """Remove and return one connected within-distance cluster as
        ``[(count, sequence), ...]`` (reference _triemodule.c:778-897).

        The full partition is computed on first call (device kernels) and
        served per-call; components are disjoint so the partition is
        identical to the reference's incremental extraction.
        """
        if not self._counts:
            raise LookupError("Trie is empty")
        params = (max_distance, use_edit_distance)
        if self._cluster_cache is None or \
                self._cluster_cache_params != params:
            keys = list(self._counts)
            counts = [self._counts[k] for k in keys]
            clusters = build_clusters(keys, counts, max_distance,
                                      use_edit_distance,
                                      table=self._query_table())
            self._cluster_cache = clusters
            self._cluster_cache_params = params
            self._cluster_of_key = {}
            for index, cluster in enumerate(clusters):
                for k in cluster.keys:
                    self._cluster_of_key[k] = index
        seed = self._first_sequence()
        cluster = self._cluster_cache[self._cluster_of_key[seed]]
        members = sorted(cluster.keys, key=self._alphabet_sort_key)
        members.remove(seed)
        members.insert(0, seed)
        result: List[Tuple[int, str]] = []
        for key in members:
            count = self._counts.pop(key)
            self._number_of_sequences -= count
            self._delete_structure(key)
            self._cluster_of_key.pop(key, None)
            result.append((count, key.decode("ascii")))
        self._query_cache = None
        return result

    def pop_all_clusters(self, max_distance: int,
                         use_edit_distance: bool = False
                         ) -> Iterator[List[Tuple[int, str]]]:
        """Drain the trie cluster by cluster (bulk-friendly extension)."""
        while self._counts:
            yield self.pop_cluster(max_distance, use_edit_distance)

    # ------------------------------------------------------------------ #
    # Stats (reference Trie.raw_stats / Trie.memory_size,
    # _triemodule.c:909-964; consumed by trie_stats, __init__.py:133-157)

    def raw_stats(self) -> List[List[int]]:
        """Per-depth histogram of node widths the equivalent C trie would
        have: column 0 counts terminal (leaf) nodes, column w counts
        internal nodes of width w (width = highest child index + 1)."""
        layer_size = len(self._table.chars) + 1
        stats: List[List[int]] = []

        def visit(node: _Node, depth: int) -> None:
            while len(stats) <= depth:
                stats.append([0] * layer_size)
            if node.children:
                width = 1 + max(int(self._table.table[b])
                                for b in node.children)
                stats[depth][min(width, layer_size - 1)] += 1
            else:
                stats[depth][0] += 1
            for byte in node.children:
                visit(node.children[byte], depth + 1)

        if not (self._root.is_empty() and self._root_is_vacant_leaf):
            visit(self._root, 0)
        return stats

    def memory_size(self) -> int:
        """Bytes the equivalent reference trie would allocate:
        8 + 8 * width per node plus stored suffix payloads."""
        total = 0

        def visit(node: _Node) -> None:
            nonlocal total
            if node.children:
                width = 1 + max(int(self._table.table[b])
                                for b in node.children)
            else:
                width = 0
            total += 8 + 8 * width
            if node.suffix is not None:
                total += len(node.suffix)
            for child in node.children.values():
                visit(child)

        visit(self._root)
        return total
