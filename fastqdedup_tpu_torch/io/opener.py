"""Transparent (de)compressed file opening.

Stands in for the reference's ``xopen`` dependency
(/root/reference/src/fastqdedup/__init__.py:54-57, 197-198): files ending in
``.gz``, ``.bz2``, ``.xz``, or ``.zst`` are opened through the matching
codec stream; everything else is plain binary.  Output compression defaults
to level 1 like the reference's ``xopen(..., compresslevel=1)``.  Gzip
writes produce BGZF (blocked gzip — readable by every gzip tool,
block-parallel to produce and to re-ingest) with no mtime and fixed
blocking, so outputs are deterministic byte-for-byte across runs and across
single-/multi-host execution.  Where the port's device is a CUDA card, a
level-1 gzip write deflates its members on the card
(:class:`.bgzf.DeviceBgzfWriter`): the same members inflate to the same
records, and the compressed bytes are the card's.
"""

import gzip
import io
from typing import IO, Optional


def _zstd_module():
    """The available zstandard implementation, or None.

    Python 3.14 ships ``compression.zstd``; earlier interpreters may have
    the third-party ``zstandard`` package.  Neither is a hard dependency —
    ``.zst`` files simply raise a clear error when no backend exists.
    """
    try:
        from compression import zstd  # type: ignore[import-not-found]
        return zstd
    except ImportError:
        pass
    try:
        import zstandard
        return zstandard
    except ImportError:
        return None


def _open_zstd(filename: str, mode: str, compresslevel: Optional[int]):
    backend = _zstd_module()
    if backend is None:
        raise ImportError(
            f"cannot open {filename!r}: no zstandard backend is installed "
            f"(need Python >= 3.14 'compression.zstd' or the 'zstandard' "
            f"package)")
    if hasattr(backend, "open"):  # compression.zstd / zstandard both
        if "r" in mode:
            return backend.open(filename, "rb")
        return backend.open(filename, "wb")
    raise ImportError(f"unsupported zstandard backend for {filename!r}")


def _deflate_device(level: int):
    """The CUDA device a level-1 gzip write deflates on: the device the
    port's kernels run on (``runtime.device()``), or None for the host's
    compressor (a CPU device, no card, another level)."""
    import torch

    if level != 1 or not torch.cuda.is_available():
        return None
    from ..runtime import device

    dev = device()
    return dev if dev.type == "cuda" else None


def deflates_on_card(filename: str,
                     compresslevel: Optional[int] = 1) -> bool:
    """Whether :func:`xopen` gives a write of ``filename`` at
    ``compresslevel`` the card writer."""
    return filename.endswith(".gz") and \
        _deflate_device(compresslevel or 1) is not None


def xopen(filename: str, mode: str = "rb", *,
          compresslevel: Optional[int] = 1,
          threads: int = 0) -> IO[bytes]:
    """Open ``filename`` for binary reading or writing, transparently
    decoding/encoding by file extension (.gz/.bz2/.xz/.zst).

    ``threads`` is accepted for xopen API compatibility and ignored (the
    reference itself always passes threads=0).
    """
    if "b" not in mode:
        mode += "b"
    level = compresslevel or 1
    reading = "r" in mode
    if not reading and "w" not in mode and "a" not in mode:
        raise ValueError(f"Unsupported mode: {mode}")

    if filename.endswith(".gz"):
        if reading:
            return io.BufferedReader(
                gzip.open(filename, "rb"))  # type: ignore[arg-type]
        if "a" not in mode:
            # Blocked gzip (BGZF), compressed on a thread pool: valid
            # input for any gzip reader, deterministic (fixed blocking,
            # no mtime), and block-parallel to both write here and
            # re-ingest later (the native parser inflates BGZF blocks
            # concurrently).  Matches how production genomics data is
            # stored (bgzip).  On a card, the card deflates.
            dev = _deflate_device(level)
            if dev is not None:
                from .bgzf import DeviceBgzfWriter
                return DeviceBgzfWriter(  # type: ignore[return-value]
                    filename, dev)
            from .bgzf import ParallelBgzfWriter
            return ParallelBgzfWriter(  # type: ignore[return-value]
                filename, level)
        raw = open(filename, mode)
        return gzip.GzipFile(filename="", mode=mode, fileobj=raw,
                             compresslevel=level,
                             mtime=0)  # type: ignore[return-value]
    if filename.endswith(".bz2"):
        import bz2
        if reading:
            return io.BufferedReader(
                bz2.open(filename, "rb"))  # type: ignore[arg-type]
        return bz2.open(filename, mode,
                        compresslevel=level)  # type: ignore[return-value]
    if filename.endswith(".xz"):
        import lzma
        if reading:
            return io.BufferedReader(
                lzma.open(filename, "rb"))  # type: ignore[arg-type]
        # preset 1 ~ fast, mirroring the level-1 default for gz
        return lzma.open(filename, mode,
                         preset=level)  # type: ignore[return-value]
    if filename.endswith(".zst"):
        result = _open_zstd(filename, mode, level)
        if reading:
            return io.BufferedReader(result)  # type: ignore[arg-type]
        return result
    if reading:
        return open(filename, "rb", buffering=1024 * 1024)
    return open(filename, mode, buffering=1024 * 1024)
