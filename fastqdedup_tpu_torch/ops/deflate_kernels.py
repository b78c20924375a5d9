"""Hand-written Hopper kernel that deflates BGZF members, with its plain
NumPy version and launch counter.

It replaces no TPU kernel: the JAX package compresses its outputs on the
host (``fastqdedup_tpu/io/bgzf.py``).  It was added because the port's
pass 3 waits on the host's compressor threads while the card idles; the
CUDA source is ``csrc/deflate.cu`` (the note at its top says what bounds
it on the H100 and how its design answers that).

* :func:`deflate_members` — a window of input bytes cut into members of
  ``BLOCK_SIZE`` bytes (the last one shorter) -> each member as one
  complete BGZF member (gzip header with the BSIZE field, one deflate
  block, CRC-32 and ISIZE) at a stride of ``OUT_STRIDE`` bytes, and each
  member's length.

The rule both versions apply, byte for byte:

1. **Matches.**  Every position ``p <= n - 4`` hashes its 4 bytes ``v``
   (little-endian) as ``(v * 0x1E35A7BD mod 2**32) >> 17``.  Its
   candidate is the nearest earlier position with the same hash.  A
   candidate within 32,768 bytes whose 4 bytes equal ``v`` gives a match
   of the common length, at most 258 and at most ``n - p``; a match of
   length 4 farther than 4,096 bytes is dropped (its codes cost more
   than four literals).
2. **Parse.**  Greedy from position 0: a match where there is one, else
   a literal.
3. **Codes.**  One dynamic-Huffman block.  Each table (literal/length
   with one end-of-block, distance, code length) gets at least two used
   symbols (the lowest unused ones get a count of 1), Huffman lengths
   from the two-queue construction over symbols sorted by (count,
   symbol) that takes a leaf before a node of equal weight, limited to
   15 (7 for code lengths) by moving leaves down (miniz's rule), handed
   out again shortest to the most frequent.  Code lengths are written
   as one run-length sequence over both tables (16, 17, 18 as libdeflate
   uses them).
4. **Fallback.**  Where that block would be longer than the member's
   bytes plus 5, the member is one stored block.

The output is deterministic and inflates with every gzip reader; its
size is within a few tenths of a percent of libdeflate's level 1 on
FASTQ (``tests/test_torch_deflate.py``).  A wrapper given CPU tensors
computes the plain version; given CUDA tensors it launches the kernel or
raises, never falling back.
"""

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from .kernel_lib import check_cuda, check_status, count_launch, library

BLOCK_SIZE = 65280            # input bytes of a full member (bgzip's)
OUT_STRIDE = 65536            # bytes a member may take in the output
HASH_BITS = 15
WINDOW = 32768
MAX_MATCH = 258
TOO_FAR = 4096                # a length-4 match farther than this is dropped

LAUNCHES: Dict[str, int] = {"deflate_members": 0}

_LEN_BASE = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27,
                      31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195,
                      227, 258], np.int64)
_LEN_EXTRA = np.array([0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4
                      + [5] * 4 + [0], np.int64)
_DIST_BASE = np.array([1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
                       193, 257, 385, 513, 769, 1025, 1537, 2049, 3073,
                       4097, 6145, 8193, 12289, 16385, 24577], np.int64)
_DIST_EXTRA = np.array([0, 0] + [i // 2 - 1 for i in range(2, 30)],
                       np.int64)
_LEN_CODE = np.searchsorted(_LEN_BASE, np.arange(MAX_MATCH + 1),
                            side="right") - 1
_DIST_CODE = np.searchsorted(_DIST_BASE, np.arange(WINDOW + 1),
                             side="right") - 1
_CL_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1,
             15]
_BGZF_HEADER = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                b"\x06\x00BC\x02\x00")


def reset_launches() -> None:
    """Set every count in ``LAUNCHES`` to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _matches(b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(length, distance) of the match at each position, 0 where none."""
    n = len(b)
    length = np.zeros(n, np.int64)
    dist = np.zeros(n, np.int64)
    m = n - 3
    if m <= 0:
        return length, dist
    w = b.astype(np.uint32)
    v = w[:m] | (w[1:m + 1] << 8) | (w[2:m + 2] << 16) | (w[3:m + 3] << 24)
    h = (v * np.uint32(0x1E35A7BD)) >> np.uint32(32 - HASH_BITS)
    order = np.argsort(h, kind="stable")
    same = h[order[1:]] == h[order[:-1]]
    p, c = order[1:][same].astype(np.int64), order[:-1][same].astype(np.int64)
    keep = (p - c <= WINDOW) & (v[p] == v[c])
    p, c = p[keep], c[keep]
    cap = np.minimum(MAX_MATCH, n - p)
    got = np.full(len(p), 4, np.int64)
    live = np.flatnonzero(got < cap)
    while len(live):
        live = live[b[p[live] + got[live]] == b[c[live] + got[live]]]
        got[live] += 1
        live = live[got[live] < cap[live]]
    keep = (got > 4) | (p - c <= TOO_FAR)
    length[p[keep]] = got[keep]
    dist[p[keep]] = (p - c)[keep]
    return length, dist


def _greedy(length: np.ndarray) -> np.ndarray:
    """Token start positions of the greedy parse."""
    starts: List[int] = []
    steps = np.maximum(length, 1).tolist()
    p, n = 0, len(steps)
    while p < n:
        starts.append(p)
        p += steps[p]
    return np.array(starts, np.int64)


def huffman_lengths(freq: np.ndarray, limit: int) -> np.ndarray:
    """Code lengths of one table under the module's rule (step 3)."""
    freq = np.array(freq, np.int64)
    k = 0
    while np.count_nonzero(freq) < 2:
        if freq[k] == 0:
            freq[k] = 1
        k += 1
    used = np.flatnonzero(freq)
    syms = used[np.lexsort((used, freq[used]))]
    n = len(syms)
    weight = freq[syms].tolist() + [0] * (n - 1)
    parent = [0] * (2 * n - 1)
    leaf, node = 0, n
    for new in range(n, 2 * n - 1):
        picks = []
        for _ in range(2):
            if leaf < n and (node >= new or weight[leaf] <= weight[node]):
                picks.append(leaf)
                leaf += 1
            else:
                picks.append(node)
                node += 1
        weight[new] = weight[picks[0]] + weight[picks[1]]
        parent[picks[0]] = parent[picks[1]] = new
    depth = [0] * (2 * n - 1)
    for i in range(2 * n - 3, -1, -1):
        depth[i] = depth[parent[i]] + 1
    count = [0] * (limit + 1)
    for d in depth[:n]:
        count[min(d, limit)] += 1
    if max(depth[:n]) > limit:
        total = sum(count[i] << (limit - i) for i in range(1, limit + 1))
        while total != 1 << limit:
            count[limit] -= 1
            for i in range(limit - 1, 0, -1):
                if count[i]:
                    count[i] -= 1
                    count[i + 1] += 2
                    break
            total -= 1
    lengths = np.zeros(len(freq), np.int64)
    j = n
    for bits in range(1, limit + 1):
        for _ in range(count[bits]):
            j -= 1
            lengths[syms[j]] = bits
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical codes of ``lengths``, bit-reversed for an LSB-first
    stream (RFC 1951, 3.2.2)."""
    count = np.bincount(lengths, minlength=16)
    count[0] = 0
    next_code = [0] * 17
    code = 0
    for bits in range(1, 16):
        code = (code + int(count[bits - 1])) << 1
        next_code[bits] = code
    codes = np.zeros(len(lengths), np.int64)
    for sym, bits in enumerate(lengths.tolist()):
        if bits:
            c = next_code[bits]
            next_code[bits] += 1
            codes[sym] = int(format(c, f"0{bits}b")[::-1], 2)
    return codes


def _run_lengths(lens: List[int]) -> List[Tuple[int, int, int]]:
    """(symbol, extra value, extra bits) coding ``lens`` with the
    code-length alphabet."""
    items: List[Tuple[int, int, int]] = []
    s, n = 0, len(lens)
    while s < n:
        x = lens[s]
        e = s + 1
        while e < n and lens[e] == x:
            e += 1
        if x == 0:
            while e - s >= 11:
                extra = min(e - s - 11, 127)
                items.append((18, extra, 7))
                s += 11 + extra
            if e - s >= 3:
                extra = min(e - s - 3, 7)
                items.append((17, extra, 3))
                s += 3 + extra
        elif e - s >= 4:
            items.append((x, 0, 0))
            s += 1
            while e - s >= 3:
                extra = min(e - s - 3, 3)
                items.append((16, extra, 2))
                s += 3 + extra
        while s < e:
            items.append((x, 0, 0))
            s += 1
    return items


def _pack_bits(values: np.ndarray, bits: np.ndarray) -> bytes:
    """The fields (value, bit count) one after another, LSB first."""
    total = int(bits.sum())
    starts = np.repeat(np.cumsum(bits) - bits, bits)
    shift = np.arange(total) - starts
    stream = (np.repeat(values, bits) >> shift) & 1
    return np.packbits(stream.astype(np.uint8), bitorder="little").tobytes()


def deflate_plain(data: bytes) -> bytes:
    """One raw deflate stream for ``data`` (at most ``BLOCK_SIZE`` bytes)
    under the module's rule."""
    b = np.frombuffer(bytes(data), np.uint8)
    n = len(b)
    length, dist = _matches(b)
    starts = _greedy(length)
    tok_len, tok_dist = length[starts], dist[starts]
    is_match = tok_len > 0
    len_code = _LEN_CODE[np.where(is_match, tok_len, 3)]
    dist_code = _DIST_CODE[np.where(is_match, tok_dist, 1)]
    lit = np.where(is_match, 257 + len_code, b[starts])
    lfreq = np.bincount(lit, minlength=286)
    lfreq[256] += 1
    llen = huffman_lengths(lfreq, 15)
    dlen = huffman_lengths(np.bincount(dist_code[is_match], minlength=30), 15)
    hlit = max(257, int(np.flatnonzero(llen).max()) + 1)
    hdist = max(1, int(np.flatnonzero(dlen).max()) + 1)
    items = _run_lengths(llen[:hlit].tolist() + dlen[:hdist].tolist())
    clen = huffman_lengths(np.bincount([i[0] for i in items], minlength=19),
                           7)
    hclen = 19
    while hclen > 4 and clen[_CL_ORDER[hclen - 1]] == 0:
        hclen -= 1
    lcodes, dcodes, ccodes = (canonical_codes(llen), canonical_codes(dlen),
                              canonical_codes(clen))
    head = [(1, 1), (2, 2), (hlit - 257, 5), (hdist - 1, 5), (hclen - 4, 4)]
    head += [(int(clen[_CL_ORDER[i]]), 3) for i in range(hclen)]
    for sym, extra, extra_bits in items:
        head.append((int(ccodes[sym]), int(clen[sym])))
        head.append((extra, extra_bits))
    m = is_match
    fields_v = np.stack([
        lcodes[lit], np.where(m, tok_len - _LEN_BASE[len_code], 0),
        np.where(m, dcodes[dist_code], 0),
        np.where(m, tok_dist - _DIST_BASE[dist_code], 0)], 1).ravel()
    fields_b = np.stack([
        llen[lit], np.where(m, _LEN_EXTRA[len_code], 0),
        np.where(m, dlen[dist_code], 0),
        np.where(m, _DIST_EXTRA[dist_code], 0)], 1).ravel()
    values = np.concatenate([np.array([f[0] for f in head], np.int64),
                             fields_v, [lcodes[256]]])
    bits = np.concatenate([np.array([f[1] for f in head], np.int64),
                           fields_b, [llen[256]]])
    if (int(bits.sum()) + 7) // 8 > n + 5:
        return struct.pack("<BHH", 1, n, n ^ 0xFFFF) + bytes(data)
    return _pack_bits(values, bits)


def bgzf_member_plain(data: bytes) -> bytes:
    """One BGZF member holding ``data`` under the module's rule."""
    payload = deflate_plain(data)
    return (_BGZF_HEADER + struct.pack("<H", 18 + len(payload) + 8 - 1)
            + payload + struct.pack("<II", zlib.crc32(data), len(data)))


def members_of(total: int) -> int:
    """How many members a window of ``total`` bytes holds."""
    return -(-total // BLOCK_SIZE)


def deflate_members_plain(data: np.ndarray, total: int, out: np.ndarray,
                          out_len: np.ndarray) -> None:
    """Plain version of the kernel: the members of ``data[:total]`` into
    ``out`` (``OUT_STRIDE`` bytes each) and their lengths into
    ``out_len``."""
    for i in range(members_of(total)):
        member = bgzf_member_plain(
            data[i * BLOCK_SIZE:min(total, (i + 1) * BLOCK_SIZE)].tobytes())
        out[i * OUT_STRIDE:i * OUT_STRIDE + len(member)] = \
            np.frombuffer(member, np.uint8)
        out_len[i] = len(member)


def scratch_bytes(members: int) -> int:
    """Bytes of device scratch the kernel takes for ``members``."""
    return members * OUT_STRIDE * 2


def deflate_members(data: torch.Tensor, total: int, out: torch.Tensor,
                    out_len: torch.Tensor, scratch: torch.Tensor) -> None:
    """Deflate the members of ``data[:total]``: member i, the bytes
    ``[i * BLOCK_SIZE, min(total, (i + 1) * BLOCK_SIZE))``, becomes one
    BGZF member at ``out[i * OUT_STRIDE:]``, its length ``out_len[i]``.

    ``data``, ``out``: uint8, ``out_len``: int32, ``scratch``: uint8 of
    at least :func:`scratch_bytes` (the card's candidate positions),
    contiguous, on one device.  On the card the call is one launch on the
    current stream and does not wait; on the CPU it runs the plain
    version (``scratch`` unused)."""
    members = members_of(total)
    if not 0 < total <= data.numel() or data.dtype != torch.uint8 \
            or out.dtype != torch.uint8 or out_len.dtype != torch.int32 \
            or out.numel() < members * OUT_STRIDE \
            or out_len.numel() < members:
        raise ValueError(
            f"deflate_members: expected uint8 data of at least {total} "
            f"bytes, uint8 out of {members} x {OUT_STRIDE} and int32 "
            f"lengths of {members}, got {data.dtype} {data.numel()}, "
            f"{out.dtype} {out.numel()}, {out_len.dtype} {out_len.numel()}")
    if data.device.type == "cpu":
        deflate_members_plain(data.numpy(), total, out.numpy(),
                              out_len.numpy())
        return
    check_cuda("deflate_members", data, out, out_len, scratch)
    if scratch.numel() < scratch_bytes(members):
        raise ValueError(f"deflate_members: scratch needs "
                         f"{scratch_bytes(members)} bytes")
    if data.data_ptr() % 16:
        raise ValueError("deflate_members: data must be 16-byte aligned")
    lib = library()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        status = lib.fqd_deflate_members(
            data.data_ptr(), total, out.data_ptr(), out_len.data_ptr(),
            scratch.data_ptr(), stream)
    check_status("deflate_members", status)
    count_launch(LAUNCHES, "deflate_members")
