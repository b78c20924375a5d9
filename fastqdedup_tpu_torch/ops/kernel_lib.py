"""Build and bind the port's CUDA kernel library.

Every ``csrc/*.cu`` source compiles into one shared library with a plain
C interface, ``fastqdedup_tpu_torch/build/libfqd_kernels.so``, loaded
with ctypes.  Each source compiles to an object in its own ``nvcc``
process, all started together, and one more ``nvcc`` links them.  The
library is rebuilt when the sha256 over all sources and the headers
beside them (``csrc/*.cuh``) differs from the stamp beside it; the first
wrapper call on a CUDA tensor builds it.

The wrappers count their launches through :func:`count_launch`.  A
thread inside :func:`counting_as_warmup` (the warm-up module's launches)
counts into ``WARMUP_LAUNCHES`` instead, so a wrapper's own ``LAUNCHES``
holds the launches of real work only.
"""

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(_BUILD, "libfqd_kernels.so")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_lib = None
# The prewarm thread and the run's own thread may both reach library().
_lib_lock = threading.Lock()

# Launches made while warming up, by wrapper name.
WARMUP_LAUNCHES: Dict[str, int] = {}
_warmup_count_lock = threading.Lock()
_counting = threading.local()


@contextlib.contextmanager
def counting_as_warmup():
    """Within the block, this thread's launches count in
    ``WARMUP_LAUNCHES`` and not in the wrappers' ``LAUNCHES``."""
    _counting.warmup = True
    try:
        yield
    finally:
        _counting.warmup = False


def in_warmup() -> bool:
    """Whether the calling thread is inside :func:`counting_as_warmup`."""
    return getattr(_counting, "warmup", False)


def count_launch(launches: Dict[str, int], name: str) -> None:
    """Add one launch of ``name``: to ``launches`` (the wrapper module's
    counter), or to ``WARMUP_LAUNCHES`` inside :func:`counting_as_warmup`."""
    if in_warmup():
        with _warmup_count_lock:
            WARMUP_LAUNCHES[name] = WARMUP_LAUNCHES.get(name, 0) + 1
    else:
        launches[name] += 1


def sources() -> List[str]:
    """Every CUDA source of the library, sorted by name."""
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the port's kernels need the "
                           "CUDA toolkit to build")
    return path


def _digest(paths: List[str]) -> str:
    h = hashlib.sha256()
    for path in paths:
        h.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build_kernels() -> Tuple[str, str]:
    """Compile and link ``csrc/*.cu`` unless the built library matches
    the sources' sha256; returns (library path, compiler log).  The
    library is written to a temporary name and moved into place
    atomically."""
    srcs = sources()
    digest = _digest(srcs + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))))
    stamp = LIB_PATH + ".sha256"
    if os.path.exists(LIB_PATH) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return LIB_PATH, ""
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    log: List[str] = []
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmpdir:
        objects = [os.path.join(tmpdir, os.path.basename(s) + ".o")
                   for s in srcs]
        procs = [subprocess.Popen(
            [nvcc, *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objects)]
        failed = []
        for src, proc in zip(srcs, procs):
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} "
                              f"({proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = os.path.join(tmpdir, "lib.so")
        link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", tmp, *objects],
                              capture_output=True, text=True)
        log.append(link.stdout + link.stderr)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp, LIB_PATH)
    with open(stamp + f".{os.getpid()}.tmp", "w") as f:
        f.write(digest)
    os.replace(stamp + f".{os.getpid()}.tmp", stamp)
    return LIB_PATH, "".join(log)


def library() -> ctypes.CDLL:
    """The built library with every entry point's argument types set
    (pointers and the stream as ``c_void_p``, so none is cut to 32
    bits)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path, _ = build_kernels()
        lib = ctypes.CDLL(path)
        p = ctypes.c_void_p
        i = ctypes.c_int
        i64 = ctypes.c_int64
        lib.fqd_pairs_within_packed.argtypes = [
            p, p, p, i, i, i, i, i64, i64, i, i, i, p]
        lib.fqd_pairs_within_packed.restype = i
        lib.fqd_rowwise_within_packed.argtypes = [p, p, p, i64, i, i, p]
        lib.fqd_rowwise_within_packed.restype = i
        lib.fqd_rowwise_within_packed_indexed.argtypes = [
            p, p, p, p, i64, i, i, p]
        lib.fqd_rowwise_within_packed_indexed.restype = i
        lib.fqd_empty.argtypes = [i, i, p]
        lib.fqd_empty.restype = i
        lib.fqd_banded_within_edit.argtypes = [
            p, p, p, p, p, p, p, i64, i, i, p]
        lib.fqd_banded_within_edit.restype = i
        lib.fqd_deflate_members.argtypes = [p, i64, p, p, p, p]
        lib.fqd_deflate_members.restype = i
        lib.fqd_error_string.argtypes = [i]
        lib.fqd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_status(name: str, status: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        message = library().fqd_error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{status} ({message})")


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Refuse tensors a kernel cannot take: off the card, strided,
    misaligned, or on different cards."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CPU or CUDA tensors, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: tensor data must be 4-byte aligned")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
