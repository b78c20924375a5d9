"""Byte <-> small-alphabet index encoding and bit-packing.

The engine stores unique check-keys as dense uint8 matrices of alphabet
indices.  Small indices enable two kernel families:

* one-hot int8 expansion -> MXU matmul (match counting) in
  :mod:`fastqdedup_tpu.ops.hamming`;
* 4-bit packing into uint32 lanes -> XOR + popcount on the VPU (Pallas).

The reference instead walked a radix trie keyed on raw bytes
(_triemodule.c:222-288); index encoding plays the role of its dynamic
Alphabet (struct at _triemodule.c:32-36).
"""

from typing import List, Optional, Tuple

import numpy as np

UNASSIGNED = 0xFF


class EncodeTable:
    """Dynamic byte -> dense index mapping (max 254 symbols, like the
    reference Alphabet, _triemodule.c:22)."""

    def __init__(self, seed: str = ""):
        self.table = np.full(256, UNASSIGNED, dtype=np.uint8)
        self.chars: List[int] = []
        for char in seed.encode("latin-1"):
            self.add(char)

    def add(self, byte: int) -> int:
        if self.table[byte] != UNASSIGNED:
            raise ValueError(f"{chr(byte)} was repeated")
        if len(self.chars) >= 254:
            raise ValueError("Alphabet size exceeds maximum of 254")
        index = len(self.chars)
        self.table[byte] = index
        self.chars.append(byte)
        return index

    def extend_from(self, data: np.ndarray) -> None:
        """Register any bytes present in ``data`` that are still unmapped.

        Presence is collected with a 256-slot scatter, not np.unique —
        np.unique SORTS its input, which at a 3 GB key matrix costs
        minutes; the scatter is one linear pass."""
        seen = np.zeros(256, dtype=bool)
        seen[data.reshape(-1)] = True
        self.extend_from_presence(seen)

    def extend_from_presence(self, seen: np.ndarray) -> None:
        """Register the byte values flagged in a 256-slot presence bitmap
        (ascending byte order).  Used when presence was collected during
        pass 1 (native accumulator) so the merged key table never needs
        rescanning."""
        for byte in np.flatnonzero(seen):
            if self.table[byte] == UNASSIGNED:
                index = len(self.chars)
                if index >= 254:
                    raise ValueError("Alphabet size exceeds maximum of 254")
                self.table[byte] = index
                self.chars.append(int(byte))

    @property
    def size(self) -> int:
        return len(self.chars)

    def as_string(self) -> str:
        return bytes(self.chars).decode("latin-1")

    def encode(self, data: np.ndarray) -> np.ndarray:
        """Map a uint8 byte array to index space, growing as needed."""
        self.extend_from(data)
        if data.nbytes >= (16 << 20):
            from ..runtime import big_empty
            out = big_empty(data.shape, dtype=np.uint8)
            np.take(self.table, data, out=out)
            return out
        return self.table[data]

    def decode(self, indices: np.ndarray) -> np.ndarray:
        lut = np.array(self.chars, dtype=np.uint8)
        return lut[indices]


def keys_to_matrix(keys: List[bytes],
                   table: Optional[EncodeTable] = None
                   ) -> Tuple[np.ndarray, EncodeTable]:
    """Stack equal-length byte keys into an index matrix [N, L] uint8."""
    if not keys:
        return np.zeros((0, 0), dtype=np.uint8), table or EncodeTable()
    length = len(keys[0])
    raw = np.frombuffer(b"".join(keys), dtype=np.uint8)
    matrix = raw.reshape(len(keys), length)
    if table is None:
        table = EncodeTable()
    return table.encode(matrix), table


def pack_nibbles(indices: np.ndarray, lanes: int) -> np.ndarray:
    """Pack index matrix [N, L] (values < 16) into uint32 lanes [N, lanes].

    Each uint32 holds 8 bases, low nibble first.  Padding positions beyond L
    are filled with 0xF, a value outside the DNA alphabet, so padded lanes of
    two different-length keys never spuriously match (the caller only packs
    equal-length groups, where padding compares equal and contributes no
    mismatches... padding equal keys' tails identically keeps XOR zero).
    """
    n, length = indices.shape
    if (indices >= 16).any():
        raise ValueError("pack_nibbles requires alphabet indices < 16")
    padded = np.full((n, lanes * 8), 0xF, dtype=np.uint32)
    padded[:, :length] = indices
    packed = np.zeros((n, lanes), dtype=np.uint32)
    for nib in range(8):
        packed |= padded[:, nib::8] << (4 * nib)
    return packed
