"""Hand-written Hopper kernels for Hamming distance, with their plain
PyTorch versions and launch counters.

Counterpart of ``fastqdedup_tpu/ops/pallas_hamming.py``.  Three wrappers
replace its three Pallas kernels; the CUDA source is ``csrc/hamming.cu``:

* :func:`bucket_within_packed` — per-bucket all-pairs ``Hamming <= d``,
  uint8 ``[K, S, Lp]`` -> bitpacked uint8 ``[K, S, S/8]``;
* :func:`within_tile_packed` — all-pairs ``Hamming <= d`` between two row
  sets, uint8 ``[N, L]`` x ``[M, L]`` -> bitpacked uint8 ``[N, M/8]``;
* :func:`rowwise_within_packed` — paired nibble-packed rows,
  ``[P, lanes]`` x 2 -> bool ``[P, 1]``;
  :func:`rowwise_within_packed_indexed` is the same over int32 index
  pairs into one resident ``[n, lanes]`` matrix (the pair-list route's
  entry; it counts under ``rowwise_within_packed``).

The first two are one computation (a packed all-pairs tile) and share
one entry point.  ``alphabet_pad`` alone picks its route: from 5 to 8
(DNA) the match counts are an int8 one-hot product on the tensor cores
(``wgmma``), thresholded and bit-packed in registers; any other alphabet
takes a SIMT kernel that compares 4 symbols per word.  The tensor-core
route is bound by int8 operations, the SIMT route by integer
instructions, the paired rowwise kernel by device-memory bytes.  The
indexed rowwise entry's bound counts 8 B of indices a pair and each
distinct row once, but it gathers two rows a pair from L2: a warp takes
32 consecutive pairs, a group of threads shares each pair so that one
load asks for contiguous pieces of several rows, and a thread issues the
loads of up to 16 pairs before the arithmetic (``csrc/rowwise.cuh``).  The note at the top
of ``hamming.cu`` says what holds each below its bound.
Packed outputs hold 8 columns per byte in little bit order.  A symbol
matches only where ``a == b`` and ``a < alphabet_pad``, so the pad symbol
0xFF matches nothing.  The all-pairs kernel takes N and M in multiples of
128 and Lp in multiples of 16 (every caller pads so), reads only the
columns below ``length``, and expects the pad symbol in the rest.

A wrapper given a CPU tensor computes the plain PyTorch version (the
tests run it against the Pallas kernels); given a CUDA tensor it
launches the kernel or raises — it never falls back.  ``LAUNCHES``
counts kernel launches per wrapper.

The kernel library (every ``csrc/*.cu``) is compiled with ``nvcc`` on
first use, into ``fastqdedup_tpu_torch/build/`` (see :mod:`.kernel_lib`).
"""

from typing import Dict, Tuple

import torch

from .kernel_lib import check_cuda, check_status, count_launch, library

# Rows of the padded pair lists callers hand the rowwise kernel come in
# multiples of this (the JAX package's block size; the CUDA kernel itself
# takes any P).
ROW_BLOCK = 8192

# Granularity of the all-pairs kernel: a thread block computes 128 output
# rows by 128 output columns, and reads rows 16 symbols at a time.
_TILE = 128
_WIDTH_UNIT = 16

_PAD_SYMBOL = 0xFF  # outside every padded alphabet: matches nothing

LAUNCHES: Dict[str, int] = {
    "bucket_within_packed": 0,
    "within_tile_packed": 0,
    "rowwise_within_packed": 0,
}

def reset_launches() -> None:
    """Set every count in ``LAUNCHES`` to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _pad_dims(length: int, alphabet_size: int) -> Tuple[int, int]:
    """(Lp, Ap): the row width padded to a multiple of 16 and the alphabet
    bound a symbol must stay under to match.  The same geometry as the
    JAX package's kernels: Ap is exactly 5 for the DNA alphabet, larger
    alphabets round up to multiples of 4 (capped below the pad symbol)."""
    if alphabet_size <= 5:
        a_pad = 5
    else:
        a_pad = -(-alphabet_size // 4) * 4
    a_pad = min(a_pad, 255)
    l_pad = max(-(-length // 16) * 16, 16)
    return l_pad, a_pad


# --------------------------------------------------------------------- #
# Packed all-pairs tile (kernels 1 and 2)


def match_counts_plain(a: torch.Tensor, b: torch.Tensor,
                       alphabet_pad: int) -> torch.Tensor:
    """float32 [B, N, M]: positions where ``a == b`` and ``a <
    alphabet_pad``, for uint8 rows ``a`` [B, N, L] and ``b`` [B, M, L].

    One-hot rows (symbols at or above ``alphabet_pad`` one-hot to zero)
    and a batched float32 product.  Exact: every term is 0 or 1 and the
    sums stay far below 2^24, so float32 — or TF32 — loses nothing."""
    symbols = torch.arange(alphabet_pad, device=a.device, dtype=torch.int16)

    def one_hot(x: torch.Tensor) -> torch.Tensor:
        oh = x.to(torch.int16).unsqueeze(-1) == symbols
        return oh.to(torch.float32).reshape(x.shape[0], x.shape[1], -1)

    return torch.bmm(one_hot(a), one_hot(b).transpose(1, 2))


def pack_bits(within: torch.Tensor) -> torch.Tensor:
    """uint8 [..., ceil(M/8)]: bool [..., M] packed 8 columns per byte,
    little bit order."""
    m = within.shape[-1]
    m8 = -(-m // 8) * 8
    if m8 != m:
        within = torch.nn.functional.pad(within, (0, m8 - m))
    bits = within.reshape(*within.shape[:-1], m8 // 8, 8).to(torch.int32)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                           device=within.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def pairs_within_plain(a: torch.Tensor, b: torch.Tensor, length: int,
                       max_distance: int, alphabet_pad: int
                       ) -> torch.Tensor:
    """Plain PyTorch version of the all-pairs kernel: uint8
    [B, N, ceil(M/8)], bit k of byte c set where
    ``length - matches(a_i, b_{8c+k}) <= max_distance``."""
    matches = match_counts_plain(a, b, alphabet_pad)
    return pack_bits((length - matches) <= max_distance)


def _pairs_within_launch(name: str, a: torch.Tensor, b: torch.Tensor,
                         length: int, max_distance: int,
                         alphabet_pad: int) -> torch.Tensor:
    check_cuda(name, a, b)
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise ValueError(f"{name}: expected uint8 rows")
    batch, n, l_pad = a.shape
    m = b.shape[1]
    if b.shape[0] != batch or b.shape[2] != l_pad:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not pair")
    if n % _TILE or m % _TILE or l_pad % _WIDTH_UNIT:
        raise ValueError(f"{name}: rows and columns must be multiples of "
                         f"{_TILE}, width of {_WIDTH_UNIT}; got "
                         f"N={n} M={m} Lp={l_pad}")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{name}: tensor data must be 16-byte aligned")
    if not 0 < alphabet_pad <= 255:
        raise ValueError(f"{name}: alphabet_pad {alphabet_pad} out of range")
    out = torch.empty((batch, n, m // 8), dtype=torch.uint8, device=a.device)
    if out.numel() == 0:
        return out
    lib = library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = lib.fqd_pairs_within_packed(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, n, m, l_pad,
            n * l_pad, m * l_pad, int(length), int(max_distance),
            int(alphabet_pad), stream)
    check_status(name, status)
    count_launch(LAUNCHES, name)
    return out


def bucket_within_packed(batch: torch.Tensor, length: int,
                         max_distance: int,
                         alphabet_pad: int) -> torch.Tensor:
    """uint8 [K, S, S//8]: per-bucket all-pairs Hamming <= max_distance,
    bitpacked along the last axis (little bit order).

    Replaces ``pallas_hamming.bucket_within_packed`` (both its grouped
    and its tiled body).  ``batch``: uint8 [K, S, Lp] alphabet indices
    with 0xFF padding (rows, and every column from ``length`` on); pad
    rows match nothing unless ``length <= max_distance``.  ``length`` is
    the real compared width, not Lp.  On the card S must be a multiple of
    128 and Lp of 16."""
    if batch.device.type == "cpu":
        return pairs_within_plain(batch, batch, length, max_distance,
                                  alphabet_pad)
    return _pairs_within_launch("bucket_within_packed", batch, batch,
                                length, max_distance, alphabet_pad)


def within_tile_packed(a: torch.Tensor, b: torch.Tensor,
                       alphabet_size: int,
                       max_distance: int) -> torch.Tensor:
    """uint8 [N, M//8]: bitpacked all-pairs Hamming <= max_distance
    between uint8 rows ``a`` [N, L] and ``b`` [M, L] (little bit order
    along columns).  Replaces ``pallas_hamming.within_tile_packed``; N
    and M must be multiples of 128 on the card (callers pad)."""
    length = a.shape[1]
    l_pad, a_pad = _pad_dims(length, alphabet_size)
    if l_pad != length:
        a = torch.nn.functional.pad(a, (0, l_pad - length),
                                    value=_PAD_SYMBOL)
        b = torch.nn.functional.pad(b, (0, l_pad - length),
                                    value=_PAD_SYMBOL)
    if a.device.type == "cpu":
        return pairs_within_plain(a[None], b[None], length, max_distance,
                                  a_pad)[0]
    return _pairs_within_launch("within_tile_packed", a[None].contiguous(),
                                b[None].contiguous(), length, max_distance,
                                a_pad)[0]


# --------------------------------------------------------------------- #
# Rowwise packed XOR + popcount (kernel 3)


def rowwise_within_plain(a: torch.Tensor, b: torch.Tensor,
                         max_distance: int) -> torch.Tensor:
    """Plain PyTorch version of the rowwise kernel: bool [P, 1].

    torch has no unsigned 32-bit shifts or popcount, so the lanes widen
    to int64 and are masked back to 32 bits after the XOR.  Each nibble
    collapses to its low bit; multiplying by 0x11111111 sums the eight
    nibble bits into bits 28-31 (no nibble sum exceeds 8, so nothing
    carries across)."""
    x = torch.bitwise_xor(a.to(torch.int64), b.to(torch.int64)) & 0xFFFFFFFF
    x = x | (x >> 2)
    x = x | (x >> 1)
    x = x & 0x11111111
    per_lane = ((x * 0x11111111) >> 28) & 0xF
    return (per_lane.sum(dim=1, keepdim=True) <= max_distance)


def rowwise_within_packed(a: torch.Tensor, b: torch.Tensor,
                          max_distance: int) -> torch.Tensor:
    """bool [P, 1]: paired-row packed Hamming <= max_distance.

    ``a``/``b``: [P, lanes] nibble-packed rows (8 symbols per 32-bit lane,
    see ``encode.pack_nibbles``) held as int32, which the kernel reads as
    unsigned.  Replaces ``pallas_hamming.rowwise_within_packed``."""
    if a.device.type == "cpu":
        return rowwise_within_plain(a, b, max_distance)
    name = "rowwise_within_packed"
    check_cuda(name, a, b)
    if a.dtype != torch.int32 or b.dtype != torch.int32 \
            or a.shape != b.shape or a.dim() != 2:
        raise ValueError(f"{name}: expected two int32 [P, lanes] tensors")
    p, lanes = a.shape
    out = torch.empty((p, 1), dtype=torch.bool, device=a.device)
    lib = library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = lib.fqd_rowwise_within_packed(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), p, lanes,
            int(max_distance), stream)
    check_status(name, status)
    count_launch(LAUNCHES, name)
    return out


def rowwise_within_packed_indexed(packed: torch.Tensor, gi: torch.Tensor,
                                  gj: torch.Tensor,
                                  max_distance: int) -> torch.Tensor:
    """bool [P, 1]: packed Hamming(packed[gi_p], packed[gj_p]) <=
    max_distance.

    ``packed``: int32 [n, lanes] resident nibble-packed rows; ``gi``/``gj``:
    int32 [P] row indices in [0, n).  On the card the kernel reads the
    rows through the indices (one launch, no gather; the caller checks
    the range, as for ``edit_kernels.banded_within_edit_distance_indexed``);
    on the CPU the rows are gathered with ``index_select``, which refuses
    an index out of range, and the plain version runs.  The counterpart
    of the JAX package's ``jnp.take`` + ``rowwise_within_packed`` in one
    jitted program; counts under ``rowwise_within_packed``."""
    if packed.device.type == "cpu":
        return rowwise_within_plain(packed.index_select(0, gi),
                                    packed.index_select(0, gj), max_distance)
    name = "rowwise_within_packed"
    check_cuda(name, packed, gi, gj)
    if packed.dtype != torch.int32 or packed.dim() != 2 \
            or gi.dtype != torch.int32 or gj.dtype != torch.int32 \
            or gi.dim() != 1 or gi.shape != gj.shape:
        raise ValueError(f"{name}: expected an int32 [n, lanes] matrix and "
                         f"two int32 [P] index vectors")
    p = gi.shape[0]
    out = torch.empty((p, 1), dtype=torch.bool, device=packed.device)
    if p == 0:
        return out
    lib = library()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        status = lib.fqd_rowwise_within_packed_indexed(
            packed.data_ptr(), gi.data_ptr(), gj.data_ptr(), out.data_ptr(),
            p, packed.shape[1], int(max_distance), stream)
    check_status(name, status)
    count_launch(LAUNCHES, name)
    return out
