"""Direct TCP mesh between torch.distributed processes for host-side bytes.

Counterpart of ``fastqdedup_tpu/parallel/transport.py``.  The key-table
merge moves hundreds of megabytes of HOST data (key payloads, metadata
columns) between processes.  The gloo collective path
(parallel/distributed.py) pads every exchange to fixed 8 MiB chunks and
stages each chunk through an ``[H, chunk]`` buffer; plain TCP sockets
between the same processes carry each stream at its true size straight
into its destination arrays, with no per-chunk dispatch.

This module builds a full socket mesh lazily on first use:

* every process publishes ``ip:port`` of a listener through the job's
  ``TCPStore`` (the store that bootstrapped the process group, so no
  extra discovery infrastructure);
* lower pids accept, higher pids connect (one duplex socket per pair);
* collective calls are issued in the same order by every process
  (they replace collectives), so stream framing plus a per-call tag is
  enough — no message ids, no reordering.

This is the host data plane only.  Anything that fails (no store,
sockets blocked) disables the mesh for the process lifetime and callers
fall back to the gloo collective path.
"""

import datetime
import os
import socket
import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

_FRAME = struct.Struct("<QQ")  # (tag, payload_bytes)
_SOCK_BUF = 4 << 20


class TcpMesh:
    """One duplex TCP connection to every other process."""

    def __init__(self, pid: int, nproc: int,
                 peers: Dict[int, socket.socket]):
        self.pid = pid
        self.nproc = nproc
        self.peers = peers
        self.calls = 0
        self._lock = threading.Lock()

    # -- wire helpers ---------------------------------------------------

    @staticmethod
    def _send_stream(sock: socket.socket, tag: int,
                     buf: memoryview) -> None:
        sock.sendall(_FRAME.pack(tag, len(buf)))
        if len(buf):
            sock.sendall(buf)

    @staticmethod
    def _recv_exact(sock: socket.socket, view: memoryview) -> None:
        while len(view):
            n = sock.recv_into(view)
            if n == 0:
                raise ConnectionError("peer closed during exchange")
            view = view[n:]

    @classmethod
    def _recv_stream(cls, sock: socket.socket, tag: int,
                     segments: List[Tuple[np.ndarray, int]]) -> None:
        """Receive one framed stream, scattering it into ``segments``
        — a list of ``(uint8_view, stream_start)`` destinations sorted
        by start, exactly the layout the collective scatter path uses.
        Bytes outside every segment are discarded (padding)."""
        head = bytearray(_FRAME.size)
        cls._recv_exact(sock, memoryview(head))
        got_tag, size = _FRAME.unpack(bytes(head))
        if got_tag != tag:
            raise RuntimeError(
                f"transport desync: expected call tag {tag}, got {got_tag}")
        pos = 0
        scratch: Optional[bytearray] = None
        for view, start in segments:
            if start > pos:
                skip = start - pos
                if scratch is None or len(scratch) < min(skip, 1 << 20):
                    scratch = bytearray(min(skip, 1 << 20))
                while skip:
                    step = min(skip, len(scratch))
                    cls._recv_exact(sock, memoryview(scratch)[:step])
                    skip -= step
                pos = start
            take = min(len(view), size - pos)
            if take > 0:
                cls._recv_exact(sock, memoryview(view.reshape(-1))[:take])
                pos += take
        if pos < size:
            skip = size - pos
            if scratch is None:
                scratch = bytearray(min(skip, 1 << 20))
            while skip:
                step = min(skip, len(scratch))
                cls._recv_exact(sock, memoryview(scratch)[:step])
                skip -= step

    # -- collectives ----------------------------------------------------

    def allgather_blobs(self, data: bytes) -> List[bytes]:
        """All-gather small byte blobs; returns one blob per process in
        pid order.  Doubles as a barrier with ``data=b""``."""
        with self._lock:
            tag = self.calls
            self.calls += 1
            out: List[Optional[bytes]] = [None] * self.nproc
            out[self.pid] = data
            errors: List[BaseException] = []

            def recv_from(h: int) -> None:
                try:
                    sock = self.peers[h]
                    head = bytearray(_FRAME.size)
                    self._recv_exact(sock, memoryview(head))
                    got_tag, size = _FRAME.unpack(bytes(head))
                    if got_tag != tag:
                        raise RuntimeError(
                            f"transport desync: expected call tag {tag}, "
                            f"got {got_tag}")
                    body = bytearray(size)
                    self._recv_exact(sock, memoryview(body))
                    out[h] = bytes(body)
                except BaseException as exc:
                    errors.append(exc)

            threads = [threading.Thread(target=recv_from, args=(h,),
                                        daemon=True)
                       for h in self.peers]
            for t in threads:
                t.start()
            try:
                for sock in self.peers.values():
                    self._send_stream(sock, tag, memoryview(data))
            except BaseException as exc:
                errors.append(exc)
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
            return out  # type: ignore[return-value]

    def allgather_scatter(self, local: np.ndarray,
                          dests: List[List[Tuple[np.ndarray, int]]]
                          ) -> None:
        """All-gather ``local`` (uint8), scattering each host's stream
        into ``dests[h]`` segment views (ascending ``stream_start``
        order, the same layout the collective scatter path uses);
        ``dests[self.pid]`` is filled by local memcpy.  Streams carry
        their true size — no padding crosses the wire.  Deadlock-free by
        construction: every process drains all inbound streams on
        receiver threads BEFORE it starts sending, so no send can block
        forever on a full peer buffer."""
        with self._lock:
            tag = self.calls
            self.calls += 1
            buf = memoryview(np.ascontiguousarray(local).view(np.uint8))
            errors: List[BaseException] = []

            def recv_from(h: int) -> None:
                try:
                    self._recv_stream(self.peers[h], tag, dests[h])
                except BaseException as exc:
                    errors.append(exc)

            recv_threads = [threading.Thread(target=recv_from, args=(h,),
                                             daemon=True)
                            for h in self.peers]
            for t in recv_threads:
                t.start()
            # Interleave sends across peers in 4 MiB slices so no single
            # peer waits for a full sequential send of everyone else's
            # buffer (socket buffers absorb the slices; sendall releases
            # the GIL so receivers make progress concurrently).
            try:
                for h, sock in self.peers.items():
                    sock.sendall(_FRAME.pack(tag, len(buf)))
                step = 4 << 20
                for off in range(0, len(buf), step):
                    piece = buf[off:off + step]
                    for sock in self.peers.values():
                        sock.sendall(piece)
            except BaseException as exc:
                errors.append(exc)
            for t in recv_threads:
                t.join()
            if errors:
                raise errors[0]
            # Local stream: direct memcpy into own destination views.
            size = len(buf)
            for view, start in dests[self.pid]:
                take = min(len(view), size - start)
                if take > 0:
                    flat = view.reshape(-1)
                    flat[:take] = np.frombuffer(
                        buf, dtype=np.uint8, count=take, offset=start)


    def close(self) -> None:
        """Close every peer socket.  Peers blocked in a mesh collective
        wake with ConnectionError/EOF instead of hanging — this is the
        fail-fast path when one host dies mid-run."""
        for sock in self.peers.values():
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


_mesh: Optional[TcpMesh] = None
_mesh_failed = False
_mesh_lock = threading.Lock()


def abort_mesh() -> None:
    """Tear down the mesh after a fatal error so PEER hosts fail fast.

    Without this, a host that dies while others are parked in a
    collective deadlocks the job: the survivors wait forever on sockets
    the dying host still holds open (its interpreter may block at exit
    on the process group's shutdown, which in turn waits for the
    survivors).  Closing the sockets breaks the cycle — survivors
    get ConnectionError, propagate it, and every process reaches the
    shutdown barrier.  Safe to call when no mesh exists."""
    global _mesh, _mesh_failed
    with _mesh_lock:
        if _mesh is not None:
            _mesh.close()
            _mesh = None
        _mesh_failed = True


def _detect_ip(coordinator: Optional[str]) -> str:
    """The address peers can reach this host at.

    Routing trick: connecting a UDP socket (no packets sent) to the
    coordinator reveals which local interface the cluster network uses.
    """
    override = os.environ.get("FASTQDEDUP_HOST_IP")
    if override:
        return override
    if coordinator:
        host = coordinator.rsplit(":", 1)[0]
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
                probe.connect((host, 1))
                return probe.getsockname()[0]
        except OSError:
            pass
    return "127.0.0.1"


def _build_mesh() -> Optional[TcpMesh]:
    from .distributed import job_store, process_shape

    store, coordinator = job_store()
    if store is None:
        return None
    pid, nproc = process_shape()
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind(("0.0.0.0", 0))
    listener.listen(nproc)
    port = listener.getsockname()[1]
    ip = _detect_ip(coordinator)
    store.set(f"fastqdedup/tcp/{pid}", f"{ip}:{port}")

    def tune(sock: socket.socket) -> None:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, _SOCK_BUF)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, _SOCK_BUF)

    peers: Dict[int, socket.socket] = {}
    try:
        # Deterministic pairing: pid connects out to every LOWER pid and
        # accepts one connection from every HIGHER pid; a one-byte-pair
        # handshake identifies the dialer.
        for q in range(pid):
            key = f"fastqdedup/tcp/{q}"
            store.wait([key], datetime.timedelta(seconds=60))
            addr = store.get(key).decode()
            host, p = addr.rsplit(":", 1)
            sock = socket.create_connection((host, int(p)), timeout=60)
            tune(sock)
            sock.sendall(struct.pack("<H", pid))
            peers[q] = sock
        for _ in range(nproc - 1 - pid):
            sock, _ = listener.accept()
            tune(sock)
            raw = bytearray(2)
            TcpMesh._recv_exact(sock, memoryview(raw))
            (q,) = struct.unpack("<H", bytes(raw))
            peers[q] = sock
    except BaseException:
        for sock in peers.values():
            sock.close()
        listener.close()
        raise
    listener.close()
    return TcpMesh(pid, nproc, peers)


def get_mesh() -> Optional[TcpMesh]:
    """The process's TCP mesh, built on first call; None when disabled,
    single-process, or the build failed (fallback: gloo collectives)."""
    global _mesh, _mesh_failed
    if _mesh is not None:
        return _mesh
    if _mesh_failed or os.environ.get("FASTQDEDUP_TCP_TRANSPORT") == "0":
        return None
    with _mesh_lock:
        if _mesh is not None or _mesh_failed:
            return _mesh
        try:
            from .distributed import process_shape
            if process_shape()[1] == 1:
                _mesh_failed = True
                return None
            mesh = _build_mesh()
        except BaseException:
            import logging
            logging.getLogger("fastqdedup").debug(
                "TCP transport unavailable; host exchanges use the "
                "gloo collective path", exc_info=True)
            _mesh_failed = True
            return None
        if mesh is None:
            _mesh_failed = True
            return None
        # Close sockets at interpreter exit: a peer still draining its
        # last collective sees clean EOF after the buffered bytes (TCP
        # FIN follows delivered data), never an indefinite block.
        import atexit
        atexit.register(mesh.close)
        _mesh = mesh
        return _mesh
