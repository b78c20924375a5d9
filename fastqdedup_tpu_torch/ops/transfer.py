"""Host-device copies that do not hold the host.

The port's counterpart of the JAX package's asynchronous transfers:
``jax.device_put``, which returns before its copy lands, and
``copy_to_host_async``, which starts a device-to-host copy that a later
read waits for.  On a CUDA device an upload is built in pinned
(page-locked) host memory and issued with ``non_blocking=True`` on the
device's current stream, so the host goes on at once and every later
launch on that stream reads the copy only after it has landed.  A result
comes back into a pinned host tensor, ``non_blocking`` as well, with an
event recorded behind the copy; :func:`host_array` waits on that event
before it hands the bytes out, so no result is read early.

Torch's caching host allocator records the stream of every
``non_blocking`` copy that reads or writes a pinned block, and hands the
block out again only after that copy has completed: a staging tensor may
be dropped as soon as its copy is issued.

On the CPU device nothing is pinned (``pin_memory=True`` needs CUDA),
an upload is the host tensor itself and a host copy is the tensor as it
is: the bytes are those of a plain ``.to(device)`` and ``.cpu()``.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import trace


def staging(shape, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """An empty host tensor to build an upload to ``dev`` in: pinned
    when ``dev`` is a CUDA device."""
    return torch.empty(shape, dtype=dtype, pin_memory=dev.type == "cuda")


def upload(host: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``host`` on ``dev``.  On a CUDA device the copy is issued on the
    device's current stream with ``non_blocking=True``: from pinned
    memory it returns before the copy is done.  On the CPU device it is
    ``host`` itself.  Counts the bytes sent in ``bytes.h2d``."""
    if dev.type == "cuda":
        trace.count("bytes.h2d", host.nbytes)
    return host.to(dev, non_blocking=True)


class HostCopy(NamedTuple):
    """A device-to-host copy in flight: the host tensor it fills and the
    event recorded behind it (None when nothing was copied)."""

    host: torch.Tensor
    event: Optional["torch.cuda.Event"]


def start_host_copy(tensor: torch.Tensor) -> HostCopy:
    """Start copying ``tensor`` to the host and return at once.  On a
    CUDA device the copy goes into a pinned tensor on the device's
    current stream, an event behind it; a CPU tensor is taken as it is.
    Counts the bytes copied in ``bytes.d2h``."""
    if tensor.device.type != "cuda":
        return HostCopy(tensor, None)
    trace.count("bytes.d2h", tensor.nbytes)
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    with torch.cuda.device(tensor.device):
        host.copy_(tensor, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    return HostCopy(host, event)


def host_array(copy: HostCopy) -> np.ndarray:
    """The copied tensor as a numpy array, once its copy has completed:
    the wait is the span ``device.wait``."""
    if copy.event is not None:
        with trace.span("device.wait"):
            copy.event.synchronize()
    return copy.host.numpy()
