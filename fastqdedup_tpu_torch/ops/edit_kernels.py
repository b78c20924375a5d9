"""Hand-written Hopper kernel for Levenshtein verification, with its
plain PyTorch version and launch counter.

Counterpart of ``fastqdedup_tpu/ops/pallas_edit.py``: the wrappers
replace its kernel ``banded_within_edit_distance``; the CUDA source is
``csrc/edit.cu`` (see the note at its top for what bounds the kernel on
the H100 and how the design answers it).  The kernel decides the
predicate without the band scan: a warp copies the rows of its 32 pairs
into shared memory at once, then each lane runs furthest-reaching
diagonals on its pair, matches extended 16 symbols a step
(``csrc/edit_lv.cuh``, which also builds for the host:
tests/test_torch_edit_core.py).  It answers every input as the plain
version does.

* :func:`banded_within_edit_distance` — per pair of rows,
  ``lev(a_p[:la_p], b_p[:lb_p]) <= d``: uint8 ``[P, L]`` x 2 and int32
  lengths ``[P]`` x 2 -> bool ``[P, 1]``;
* :func:`banded_within_edit_distance_indexed` — the same over index
  pairs into one resident key matrix, rows gathered inside the kernel.

A wrapper given CPU tensors computes the plain PyTorch version
(:func:`banded_within_plain`, which the tests run against the Pallas
kernel); given CUDA tensors it launches the kernel or raises — it never
falls back.  Both call one C entry point, ``fqd_banded_within_edit``,
and one ``__global__`` serves every d (the diagonals live in shared
memory at run-time width, so the wrapper allocates only the output);
both wrappers count under one name in ``LAUNCHES``.  A width or distance
whose single pair outgrows a block's shared memory (about 2 L + 9 d
bytes above 227 KB, with d < L) is refused with CUDA's invalid-value
error.
"""

from typing import Dict

import torch

from .kernel_lib import check_cuda, check_status, count_launch, library

INF = 1 << 20  # the Pallas kernel's _INF

LAUNCHES: Dict[str, int] = {"banded_within_edit_distance": 0}


def reset_launches() -> None:
    """Set every count in ``LAUNCHES`` to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def banded_within_plain(a: torch.Tensor, len_a: torch.Tensor,
                        b: torch.Tensor, len_b: torch.Tensor,
                        max_distance: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: bool [P, 1].

    The banded DP of ``pallas_edit._banded_body``, vectorised over pairs:
    a Python loop over the rows i = 1..L of the padded width, the W =
    2d + 1 band cells unrolled.  ``band[k]`` holds dp[i][j] with j = i -
    d + k.  The same rules: INF = 1 << 20; row 0 is j (INF for j < 0); a
    cell is INF where j < 1 or j > lb, then the cell j == 0 is i; b is
    read at clip(j - 1, 0, L - 1); the answer is taken as the scan passes
    i == la, from band index lb - la + d (INF outside [0, W)); la == 0
    answers lb.  Pad bytes never reach an answer."""
    d = max_distance
    w = 2 * d + 1
    p, length = a.shape
    la = len_a.to(torch.int32)
    lb = len_b.to(torch.int32)
    a32 = a.to(torch.int32)
    b32 = b.to(torch.int32)

    def const(value: int) -> torch.Tensor:
        return torch.full((p,), value, dtype=torch.int32, device=a.device)

    inf = const(INF)
    band = [const(k - d) if k - d >= 0 else inf for k in range(w)]
    result = torch.where(la == 0, lb, inf)
    for i in range(1, length + 1):
        ai = a32[:, i - 1]
        new = []
        left = None  # insertion predecessor dp[i][j-1]
        for k in range(w):
            j = i - d + k  # the same for every pair
            if j < 1:
                # Invalid cell; dp[i][0] = i on the left band edge.
                best = const(i) if j == 0 else inf
            else:
                jc = min(max(j - 1, 0), length - 1)
                best = band[k] + (ai != b32[:, jc]).to(torch.int32)
                if k + 1 < w:
                    best = torch.minimum(best, band[k + 1] + 1)
                if left is not None:
                    best = torch.minimum(best, left + 1)
                best = torch.where(j > lb, inf, best)
            left = best
            new.append(best)
        band = new
        target = lb - la + d
        gathered = inf
        for k in range(w):
            gathered = torch.where(target == k, band[k], gathered)
        result = torch.where(la == i, gathered, result)
    return (result <= d).unsqueeze(1)


def _launch(name: str, a: torch.Tensor, len_a: torch.Tensor,
            b: torch.Tensor, len_b: torch.Tensor, ci, cj, p: int,
            max_distance: int) -> torch.Tensor:
    tensors = [a, len_a, b, len_b] + [t for t in (ci, cj) if t is not None]
    check_cuda(name, *tensors)
    if a.dtype != torch.uint8 or b.dtype != torch.uint8 \
            or a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"{name}: expected two uint8 [rows, L] tensors of "
                         f"one width, got {tuple(a.shape)}/{a.dtype} and "
                         f"{tuple(b.shape)}/{b.dtype}")
    if len_a.dtype != torch.int32 or len_b.dtype != torch.int32 \
            or len_a.shape != (a.shape[0],) or len_b.shape != (b.shape[0],):
        raise ValueError(f"{name}: lengths must be int32, one per row")
    if any(t.dtype != torch.int32 or t.shape != (p,)
           for t in (ci, cj) if t is not None):
        raise ValueError(f"{name}: indices must be int32 [P]")
    if ci is None and not a.shape[0] == b.shape[0] == p:
        raise ValueError(f"{name}: a and b must hold one row per pair")
    out = torch.empty((p, 1), dtype=torch.bool, device=a.device)
    if p == 0:
        return out
    lib = library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = lib.fqd_banded_within_edit(
            a.data_ptr(), len_a.data_ptr(), b.data_ptr(), len_b.data_ptr(),
            None if ci is None else ci.data_ptr(),
            None if cj is None else cj.data_ptr(), out.data_ptr(), p,
            a.shape[1], min(int(max_distance), 2**31 - 1), stream)
    check_status(name, status)
    count_launch(LAUNCHES, "banded_within_edit_distance")
    return out


def _check_distance(max_distance: int) -> None:
    if max_distance < 0:
        raise ValueError(f"max_distance must be >= 0, got {max_distance}")


def banded_within_edit_distance(a: torch.Tensor, len_a: torch.Tensor,
                                b: torch.Tensor, len_b: torch.Tensor,
                                max_distance: int) -> torch.Tensor:
    """bool [P, 1]: lev(a_p[:la_p], b_p[:lb_p]) <= max_distance.

    ``a``/``b``: uint8 [P, L], any padding past the lengths;
    ``len_a``/``len_b``: int32 [P] in [0, L].  Pairs with |la - lb| >
    max_distance are False.  Replaces
    ``pallas_edit.banded_within_edit_distance``; the card takes any P."""
    _check_distance(max_distance)
    if a.device.type == "cpu":
        return banded_within_plain(a, len_a, b, len_b, max_distance)
    return _launch("banded_within_edit_distance", a, len_a, b, len_b,
                   None, None, a.shape[0], max_distance)


def banded_within_edit_distance_indexed(keys: torch.Tensor,
                                        lens: torch.Tensor,
                                        ci: torch.Tensor, cj: torch.Tensor,
                                        max_distance: int) -> torch.Tensor:
    """bool [P, 1]: lev(keys[ci_p], keys[cj_p]) <= max_distance.

    ``keys``: uint8 [n, L] resident key matrix, ``lens``: int32 [n];
    ``ci``/``cj``: int32 [P] row indices in [0, n) (the caller checks).
    On the card the kernel reads the rows through the indices (one
    launch, no gather); on the CPU the rows are gathered and the plain
    version runs."""
    _check_distance(max_distance)
    if keys.device.type == "cpu":
        ci64, cj64 = ci.long(), cj.long()
        return banded_within_plain(keys[ci64], lens[ci64], keys[cj64],
                                   lens[cj64], max_distance)
    return _launch("banded_within_edit_distance", keys, lens, keys, lens,
                   ci, cj, ci.shape[0], max_distance)
