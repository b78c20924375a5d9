"""On-demand compiler for the native host-I/O library.

The port shares the one C source with the JAX package,
``fastqdedup_tpu/native/_fastq_io.c``, unchanged: it compiles its own
``native/_fastq_io_port.c``, which includes that source by path and adds
the entries only the port calls (the JAX package is not imported: its
``__init__`` pulls in jax).  The library is built into
``fastqdedup_tpu_torch/build/`` the first time the native path is
imported, and again whenever either source is newer than the build.
"""

import os
import subprocess
import sysconfig

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SHARED = os.path.join(os.path.dirname(_ROOT), "fastqdedup_tpu", "native",
                       "_fastq_io.c")
_SRC = os.path.join(_ROOT, "native", "_fastq_io_port.c")
_LIB = os.path.join(_ROOT, "build", "_fastq_io.so")


def library_path() -> str:
    """Path to the built shared library, compiling it if needed."""
    for src in (_SRC, _SHARED):
        if not os.path.exists(src):
            raise ImportError(f"native FASTQ parser source not found: {src}")
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= max(
            os.path.getmtime(_SRC), os.path.getmtime(_SHARED)):
        return _LIB
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    cc = sysconfig.get_config_var("CC") or os.environ.get("CC") or "cc"
    # Unique temp name + atomic replace: concurrent processes may build
    # simultaneously without clobbering each other's output.
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = cc.split() + ["-O3", "-pthread", "-shared", "-fPIC", "-o",
                        tmp, _SRC, "-lz", "-ldl"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, _LIB)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise ImportError(
            f"could not build native FASTQ parser: {detail}") from e
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    return _LIB
