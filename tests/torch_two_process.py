"""Two-process runs of the port over torch.distributed, for the tests.

Each run starts two fresh interpreters with ``PYTHONPATH`` set to the
repository alone and ``jax`` made unimportable, so the children can only
pass on the port's own code.  They rendezvous through
``initialize_distributed`` on a free localhost port, assert that the
process group really has two members, run the caller's body, and check
whether the TCP socket mesh came up.  A run that outlives its timeout
kills both children and fails.

The port is found free here and bound later by the first child, so
another process (a test on another worker) may take it in between; a
run whose children report the port taken (``EADDRINUSE``) is started
again on a new port, at most ``PORT_ATTEMPTS`` times in all.
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


PORT_ATTEMPTS = 3


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_was_taken(output: str) -> bool:
    """Whether a child failed because its port was bound by another
    process first (TCPStore's and the socket layer's words for it)."""
    return "EADDRINUSE" in output or "ddress already in use" in output


def run_two_processes(tmp_path, body: str, env=None,
                      timeout: float = 240.0, check: bool = True):
    """Run ``body`` (Python source that may use ``pid``) in two processes
    of one torch.distributed job on the CPU device.  ``env`` adds to the
    children's environment; ``FASTQDEDUP_TCP_TRANSPORT=0`` there means
    the gloo collective path, and the epilogue then asserts that no
    socket mesh was built.  Returns ``[(exit code, output), ...]`` by
    process; with ``check`` both must have exited 0.  A child still
    running at the timeout is killed and the call raises."""
    child_env = dict(os.environ)
    child_env.pop("XLA_FLAGS", None)
    child_env.update({"PYTHONPATH": REPO, "FASTQDEDUP_TORCH_DEVICE": "cpu",
                      "OMP_NUM_THREADS": "1"})
    child_env.update(env or {})
    want_mesh = child_env.get("FASTQDEDUP_TCP_TRANSPORT") != "0"
    for _ in range(PORT_ATTEMPTS):
        results = _run_once(tmp_path, body, child_env, want_mesh, timeout)
        if all(code == 0 for code, _ in results) or not any(
                port_was_taken(text) for _, text in results):
            break
    if check:
        for code, text in results:
            assert code == 0, text[-3000:]
    return results


def _run_once(tmp_path, body: str, child_env: dict, want_mesh: bool,
              timeout: float):
    """One run on a new port.  A child that fails because the port was
    taken ends the run at once: its peer would wait out the store's
    timeout."""
    child = tmp_path / "child.py"
    child.write_text(_PRELUDE.format(port=free_port())
                      + textwrap.dedent(body)
                      + _EPILOGUE.format(want_mesh=want_mesh))
    logs = [tmp_path / f"child{p}.log" for p in range(2)]
    procs = []
    try:
        for p in range(2):
            with open(logs[p], "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(child), str(p)], env=child_env,
                    stdout=log, stderr=subprocess.STDOUT, cwd=tmp_path))
        deadline = time.monotonic() + timeout
        while any(proc.poll() is None for proc in procs):
            if time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(str(child), timeout)
            if any(proc.returncode not in (None, 0) and port_was_taken(
                    log.read_text(errors="replace"))
                   for proc, log in zip(procs, logs)):
                break
            time.sleep(0.1)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [(proc.returncode, log.read_text(errors="replace"))
            for proc, log in zip(procs, logs)]
