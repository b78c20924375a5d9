"""Two-process runs of the port over torch.distributed, for the tests.

Each run starts two fresh interpreters with ``PYTHONPATH`` set to the
repository alone and ``jax`` made unimportable, so the children can only
pass on the port's own code.  They rendezvous through
``initialize_distributed`` on a free localhost port, assert that the
process group really has two members, run the caller's body, and check
whether the TCP socket mesh came up.  A run that outlives its timeout
kills both children and fails.
"""

import os
import socket
import subprocess
import sys
import textwrap
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """\
import sys
sys.modules["jax"] = None
pid = int(sys.argv[1])
from fastqdedup_tpu_torch.parallel.distributed import (
    initialize_distributed, process_shape)
from fastqdedup_tpu_torch.parallel.transport import get_mesh
initialize_distributed("127.0.0.1:{port}", 2, pid)
assert process_shape() == (pid, 2), process_shape()
"""

_EPILOGUE = """
mesh_up = get_mesh() is not None
assert mesh_up == {want_mesh!r}, ("TCP mesh up", mesh_up)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_two_processes(tmp_path, body: str, env=None,
                      timeout: float = 240.0) -> None:
    """Run ``body`` (Python source that may use ``pid``) in two processes
    of one torch.distributed job on the CPU device.  ``env`` adds to the
    children's environment; ``FASTQDEDUP_TCP_TRANSPORT=0`` there means
    the gloo collective path, and the epilogue then asserts that no
    socket mesh was built."""
    child_env = dict(os.environ)
    child_env.pop("XLA_FLAGS", None)
    child_env.update({"PYTHONPATH": REPO, "FASTQDEDUP_TORCH_DEVICE": "cpu",
                      "OMP_NUM_THREADS": "1"})
    child_env.update(env or {})
    want_mesh = child_env.get("FASTQDEDUP_TCP_TRANSPORT") != "0"
    driver = tmp_path / "driver.py"
    driver.write_text(_PRELUDE.format(port=free_port())
                      + textwrap.dedent(body)
                      + _EPILOGUE.format(want_mesh=want_mesh))
    logs = [tmp_path / f"child{p}.log" for p in range(2)]
    procs = []
    try:
        for p in range(2):
            with open(logs[p], "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(driver), str(p)], env=child_env,
                    stdout=log, stderr=subprocess.STDOUT, cwd=tmp_path))
        deadline = time.monotonic() + timeout
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, \
            log.read_text(errors="replace")[-3000:]
