"""BGZF (blocked gzip) writing.

BGZF is the blocked-gzip variant used across genomics (bgzip/htslib):
every <=64 KiB block is an independent, fully valid gzip member whose
FEXTRA field records the compressed block length.  Any gzip reader can
decompress a BGZF file, but a BGZF-aware reader can discover block
boundaries WITHOUT inflating and decompress blocks in parallel — the
native chunk parser (native/_fastq_io.c) does exactly that, which makes
ingest scale across host cores instead of being bound by single-thread
zlib inflate (~45 MB/s of compressed input).

This module provides the writer side: on the host in pure Python (zlib
or libdeflate raw deflate + hand-built member framing), and on a CUDA
card (:class:`DeviceBgzfWriter`, the port's deflate kernel).  Outputs
are deterministic (no mtime); the two routes cut the stream into the
same members, and their members inflate to the same bytes.
"""

import ctypes
import os
import struct
import threading
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import IO, Dict, List, Union

from ..utils import trace

# Maximum uncompressed payload per block (matches bgzip: 65536 - 256
# safety margin so level-0/incompressible data still fits the u16 BSIZE).
BLOCK_SIZE = 65280

# The canonical 28-byte BGZF EOF marker (an empty block), byte-identical
# to htslib's.
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


# libdeflate (when installed) deflates FASTQ-like data ~1.8x faster than
# zlib at the same level with a slightly better ratio; loaded lazily with
# zlib as the fallback.  Compressor handles are not thread-safe, so each
# writer-pool thread gets its own via thread-local storage.
_LD_LIB = None
_LD_TRIED = False
_ld_tls = threading.local()


def _libdeflate():
    global _LD_LIB, _LD_TRIED
    if not _LD_TRIED:
        _LD_TRIED = True
        if os.environ.get("FASTQDEDUP_LIBDEFLATE") != "0":
            try:
                lib = ctypes.CDLL("libdeflate.so.0")
                lib.libdeflate_alloc_compressor.restype = ctypes.c_void_p
                lib.libdeflate_alloc_compressor.argtypes = [ctypes.c_int]
                lib.libdeflate_deflate_compress.restype = ctypes.c_size_t
                lib.libdeflate_deflate_compress.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                    ctypes.c_void_p, ctypes.c_size_t]
                lib.libdeflate_crc32.restype = ctypes.c_uint32
                lib.libdeflate_crc32.argtypes = [
                    ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t]
                _LD_LIB = lib
            except OSError:
                _LD_LIB = None
    return _LD_LIB


def _ld_compress(data: bytes, level: int):
    """(raw_deflate_payload, crc32) via libdeflate, or None to fall back."""
    lib = _libdeflate()
    if lib is None:
        return None
    comp = getattr(_ld_tls, "comp", None)
    if comp is None or _ld_tls.level != level:
        handle = lib.libdeflate_alloc_compressor(level)
        if not handle:
            return None
        _ld_tls.comp = comp = handle
        _ld_tls.level = level
    buf = getattr(_ld_tls, "buf", None)
    if buf is None:
        _ld_tls.buf = buf = ctypes.create_string_buffer(
            2 * BLOCK_SIZE + 1024)
    n = lib.libdeflate_deflate_compress(comp, data, len(data),
                                        buf, len(buf))
    if n == 0:
        return None
    return buf.raw[:n], lib.libdeflate_crc32(0, data, len(data))


def compress_block(data: bytes, compresslevel: int = 1) -> bytes:
    """One BGZF member containing ``data`` (<= BLOCK_SIZE bytes)."""
    trace.count("bytes.deflate.host", len(data))
    ld = _ld_compress(data, compresslevel)
    if ld is not None:
        payload, crc = ld
    else:
        co = zlib.compressobj(compresslevel, zlib.DEFLATED, -15)
        payload = co.compress(data) + co.flush()
        crc = zlib.crc32(data)
    bsize = 18 + len(payload) + 8 - 1
    if bsize >= 1 << 16:
        raise ValueError("incompressible block exceeds BGZF frame size")
    header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"  # no mtime
              b"\x06\x00BC\x02\x00" + struct.pack("<H", bsize))
    trailer = struct.pack("<II", crc, len(data) & 0xFFFFFFFF)
    return header + payload + trailer


class BgzfWriter:
    """File-like BGZF writer (binary), deterministic output."""

    def __init__(self, file: Union[str, IO[bytes]],
                 compresslevel: int = 1):
        if isinstance(file, str):
            self._file: IO[bytes] = open(file, "wb")
            self._owns = True
        else:
            self._file = file
            self._owns = False
        self._level = compresslevel
        self._pending = bytearray()

    def write(self, data) -> int:
        self._pending += bytes(data)
        while len(self._pending) >= BLOCK_SIZE:
            block = bytes(self._pending[:BLOCK_SIZE])
            del self._pending[:BLOCK_SIZE]
            self._file.write(compress_block(block, self._level))
        return len(data)

    def close(self) -> None:
        if self._file is None:
            return
        if self._pending:
            self._file.write(compress_block(bytes(self._pending),
                                            self._level))
            self._pending.clear()
        self._file.write(BGZF_EOF)
        if self._owns:
            self._file.close()
        self._file = None  # type: ignore[assignment]

    def __enter__(self) -> "BgzfWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _BlockSlot:
    """Reusable input/output staging for one in-flight block.

    A fixed ring of slots makes the writer allocation-free at steady
    state: the input block is copied into ``raw`` (64 KiB memcpy — the
    caller's buffer is then immediately reusable), and the compressor
    emits the complete BGZF member straight into ``out`` (header +
    deflate payload + trailer, no intermediate bytes objects).
    """

    __slots__ = ("raw", "out", "length")

    def __init__(self) -> None:
        self.raw = bytearray(BLOCK_SIZE)
        self.out = bytearray(BLOCK_SIZE + 2048)
        self.length = 0


def _compress_into_slot(slot: _BlockSlot, n: int, level: int) -> _BlockSlot:
    """Compress ``slot.raw[:n]`` into ``slot.out`` as one BGZF member."""
    lib = _libdeflate()
    payload_len = 0
    src = memoryview(slot.raw)[:n]
    if lib is not None:
        comp = getattr(_ld_tls, "comp", None)
        if comp is None or _ld_tls.level != level:
            handle = lib.libdeflate_alloc_compressor(level)
            if handle:
                _ld_tls.comp = comp = handle
                _ld_tls.level = level
            else:
                comp = None
        if comp is not None:
            in_buf = (ctypes.c_char * n).from_buffer(slot.raw)
            out_buf = (ctypes.c_char * len(slot.out)).from_buffer(slot.out)
            in_addr = ctypes.addressof(in_buf)
            payload_len = lib.libdeflate_deflate_compress(
                comp, in_addr, n,
                ctypes.addressof(out_buf) + 18, len(slot.out) - 26)
            if payload_len:
                crc = lib.libdeflate_crc32(0, in_addr, n)
    if not payload_len:
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        payload = co.compress(src) + co.flush()
        payload_len = len(payload)
        slot.out[18:18 + payload_len] = payload
        crc = zlib.crc32(src)
    bsize = 18 + payload_len + 8 - 1
    if bsize >= 1 << 16:
        raise ValueError("incompressible block exceeds BGZF frame size")
    slot.out[:16] = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                     b"\x06\x00BC\x02\x00")
    struct.pack_into("<H", slot.out, 16, bsize)
    struct.pack_into("<II", slot.out, 18 + payload_len,
                     crc, n & 0xFFFFFFFF)
    slot.length = 18 + payload_len + 8
    return slot


class ParallelBgzfWriter:
    """BGZF writer that compresses blocks on a thread pool.

    Because the logical stream is sliced into the same fixed-size blocks
    as :class:`BgzfWriter` and each block compresses independently at a
    fixed level, the output bytes are identical to the serial writer's —
    parallelism changes wall time, never content.  Deflate releases the
    GIL, so blocks compress genuinely concurrently; completed blocks are
    written strictly in submission order.  All staging goes through a
    fixed slot ring (see :class:`_BlockSlot`), so steady-state writes
    allocate nothing — on hosts with lazily-backed memory, per-run
    allocation churn here measured ~56 MB of fresh page mappings per
    1M-read output, each GiB of which can cost seconds to back.  This is
    the output-side twin of the native parser's parallel BGZF inflate
    (native/_fastq_io.c).
    """

    def __init__(self, file: Union[str, IO[bytes]],
                 compresslevel: int = 1, threads: int = 0):
        if isinstance(file, str):
            self._file: IO[bytes] = open(file, "wb")
            self._owns = True
        else:
            self._file = file
            self._owns = False
        self._level = compresslevel
        workers = threads or min(4, os.cpu_count() or 1)
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._futures: deque = deque()
        self._slots: deque = deque(
            _BlockSlot() for _ in range(4 * workers))
        self._tail = bytearray()  # partial trailing block between writes

    def _drain(self, block: bool) -> None:
        while self._futures and (block or self._futures[0].done()):
            slot = self._futures.popleft().result()
            self._file.write(memoryview(slot.out)[:slot.length])
            self._slots.append(slot)
            block = False  # only force out one when over the cap

    def _submit(self, view, n: int) -> None:
        """Copy ``view[:n]`` into a free slot and enqueue compression."""
        self._drain(block=not self._slots)
        slot = self._slots.popleft()
        trace.count("bytes.deflate.host", n)
        slot.raw[:n] = view[:n]
        self._futures.append(
            self._pool.submit(_compress_into_slot, slot, n, self._level))

    def write(self, data) -> int:
        view = memoryview(data).cast("B")
        total = len(view)
        pos = 0
        if self._tail:
            take = min(BLOCK_SIZE - len(self._tail), total)
            self._tail += view[:take]
            pos = take
            if len(self._tail) < BLOCK_SIZE:
                return total
            self._submit(memoryview(self._tail), BLOCK_SIZE)
            self._tail.clear()
        while total - pos >= BLOCK_SIZE:
            self._submit(view[pos:], BLOCK_SIZE)
            pos += BLOCK_SIZE
        if pos < total:
            self._tail += view[pos:]
        return total

    def close(self) -> None:
        if self._file is None:
            return
        try:
            if self._tail:
                self._submit(memoryview(self._tail), len(self._tail))
                self._tail.clear()
            self._drain(block=False)
            while self._futures:
                slot = self._futures.popleft().result()
                self._file.write(memoryview(slot.out)[:slot.length])
            self._file.write(BGZF_EOF)
        finally:
            self._pool.shutdown(wait=False)
            if self._owns:
                self._file.close()
            self._file = None  # type: ignore[assignment]

    def __enter__(self) -> "ParallelBgzfWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# Members in one window of the card writer: one block each, so 128 fill
# all but 4 of an H100's 132 SMs in one wave; 128 x 65,280 input bytes
# and 128 x 65,536 output bytes are each at most 8 MiB (PyTorch's pinned
# allocator rounds a block up to a power of two).
DEVICE_WINDOW_MEMBERS = 128
# Windows one writer keeps in flight: the card compresses some while the
# caller fills the next.
DEVICE_WINDOWS = 3

_windows: Dict[object, List["_DeviceWindow"]] = {}
_streams: Dict[object, object] = {}
_windows_lock = threading.Lock()


class _DeviceWindow:
    """One window of the card writer: pinned host buffers for the input
    and the members, their device twins, the kernel's scratch, and the
    event that marks the members back on the host.  Windows live in a
    pool per device for the life of the process.  On the CPU device
    (tests) the host buffers are the device's and nothing is pinned."""

    def __init__(self, device) -> None:
        import torch

        from ..ops.deflate_kernels import OUT_STRIDE, scratch_bytes

        members = DEVICE_WINDOW_MEMBERS
        card = device.type == "cuda"

        def pair(size, dtype):
            host = torch.empty(size, dtype=dtype, pin_memory=card)
            return host, (torch.empty(size, dtype=dtype, device=device)
                          if card else host)

        self.host_in, self.dev_in = pair(members * BLOCK_SIZE, torch.uint8)
        self.host_out, self.dev_out = pair(members * OUT_STRIDE, torch.uint8)
        self.host_len, self.dev_len = pair(members, torch.int32)
        self.scratch = torch.empty(scratch_bytes(members) if card else 0,
                                   dtype=torch.uint8, device=device)
        self.event = torch.cuda.Event() if card else None
        self.in_view = self.host_in.numpy()
        self.out_view = memoryview(self.host_out.numpy())
        self.fill = 0


def _take_window(device) -> _DeviceWindow:
    with _windows_lock:
        pool = _windows.setdefault(device, [])
        if pool:
            return pool.pop()
    return _DeviceWindow(device)


def _give_back(window: _DeviceWindow, device) -> None:
    window.fill = 0
    with _windows_lock:
        _windows.setdefault(device, []).append(window)


def _stream(device):
    """The process's stream for the card writer on ``device`` (None on
    the CPU device)."""
    import torch

    if device.type != "cuda":
        return None
    with _windows_lock:
        if device not in _streams:
            _streams[device] = torch.cuda.Stream(device=device)
        return _streams[device]


def prepare_device_windows(device) -> None:
    """Allocate one writer's windows on ``device`` ahead of its first
    write (the warm-up's step)."""
    held = [_take_window(device) for _ in range(DEVICE_WINDOWS)]
    for window in held:
        _give_back(window, device)


class DeviceBgzfWriter:
    """BGZF writer that deflates its members on a CUDA card.

    The logical stream is cut into the members of :class:`BgzfWriter`,
    at the same offsets.  Writes fill a pinned window of
    ``DEVICE_WINDOW_MEMBERS`` members; a full window is copied to the
    card, deflated by ``ops.deflate_kernels.deflate_members`` (one launch
    on this writer's stream) and its members copied back, while the
    caller fills the next window.  Members reach the file in order when
    a window is retired: after each submit, every window whose members
    are back; the oldest, once ``DEVICE_WINDOWS`` are in flight; all at
    :meth:`close` (the waits are the span ``pass3.deflate_wait``).
    Windows come from a pool per device that lives as long as the
    process, so steady-state writes allocate nothing.  Members inflate to the stream's bytes; their compressed
    bytes are the kernel's, not the host compressor's.
    """

    def __init__(self, file: Union[str, IO[bytes]], device) -> None:
        if isinstance(file, str):
            self._file: IO[bytes] = open(file, "wb")
            self._owns = True
        else:
            self._file = file
            self._owns = False
        self._device = device
        self._stream = _stream(device)
        self._current: "_DeviceWindow | None" = None
        self._inflight: deque = deque()

    def write(self, data) -> int:
        import numpy as np

        src = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
        pos, total = 0, len(src)
        while pos < total:
            if self._current is None:
                while len(self._inflight) >= DEVICE_WINDOWS:
                    self._retire()
                self._current = _take_window(self._device)
            window = self._current
            take = min(len(window.in_view) - window.fill, total - pos)
            window.in_view[window.fill:window.fill + take] = \
                src[pos:pos + take]
            window.fill += take
            pos += take
            if window.fill == len(window.in_view):
                self._submit()
                while self._inflight and self._inflight[0].event is not None \
                        and self._inflight[0].event.query():
                    self._retire()  # members back: write them now
        return total

    def _submit(self) -> None:
        """Copy the current window up, deflate it, copy its members
        back; nothing waits."""
        import torch

        from ..ops.deflate_kernels import OUT_STRIDE, deflate_members, \
            members_of
        from ..ops.kernel_lib import in_warmup

        window, self._current = self._current, None
        n = window.fill
        out = members_of(n) * OUT_STRIDE
        try:
            if window.event is None:  # the CPU device: the plain version
                deflate_members(window.dev_in, n, window.dev_out,
                                window.dev_len, window.scratch)
            else:
                with torch.cuda.device(self._device), \
                        torch.cuda.stream(self._stream):
                    window.dev_in[:n].copy_(window.host_in[:n],
                                            non_blocking=True)
                    deflate_members(window.dev_in, n, window.dev_out,
                                    window.dev_len, window.scratch)
                    window.host_out[:out].copy_(window.dev_out[:out],
                                                non_blocking=True)
                    window.host_len.copy_(window.dev_len, non_blocking=True)
                    window.event.record(self._stream)
        except BaseException:
            if self._stream is not None:
                self._stream.synchronize()
            _give_back(window, self._device)
            raise
        if not in_warmup():
            trace.count("bytes.deflate.device", n)
        self._inflight.append(window)

    def _retire(self) -> None:
        """Wait for the oldest window's members and write them."""
        from ..ops.deflate_kernels import OUT_STRIDE, members_of

        window = self._inflight.popleft()
        try:
            if window.event is not None:
                with trace.span("pass3.deflate_wait"):
                    window.event.synchronize()
            lengths = window.host_len[:members_of(window.fill)].tolist()
            for i, length in enumerate(lengths):
                self._file.write(
                    window.out_view[i * OUT_STRIDE:i * OUT_STRIDE + length])
        finally:
            _give_back(window, self._device)

    def close(self) -> None:
        if self._file is None:
            return
        try:
            if self._current is not None:
                if self._current.fill:
                    self._submit()
                else:
                    _give_back(self._current, self._device)
                    self._current = None
            while self._inflight:
                self._retire()
            self._file.write(BGZF_EOF)
        finally:
            while self._inflight:  # after an error: free, do not write
                window = self._inflight.popleft()
                if window.event is not None:
                    window.event.synchronize()
                _give_back(window, self._device)
            if self._owns:
                self._file.close()
            self._file = None  # type: ignore[assignment]

    def __enter__(self) -> "DeviceBgzfWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
