"""Device-side phred -> average error rate reduction.

Counterpart of ``fastqdedup_tpu/ops/phred.py`` (the equivalent of
_fastqmodule.c:38-76): a 128-entry error-rate LUT gather plus a masked
mean per record, in float32 torch ops on the run's device.  The
pipeline's pass-1 quality filter uses it when
``FASTQDEDUP_DEVICE_QUALITY=1`` (see pipeline.py); the default is the
bit-exact float64 host reduction in ``quality``, which preserves the
reference's IEEE rounding sequence on threshold comparisons and its
strict character-range validation.
"""

import numpy as np
import torch

from ..quality import DEFAULT_PHRED_OFFSET, SCORE_TO_ERROR_RATE

_LUT_F32 = SCORE_TO_ERROR_RATE.astype(np.float32)

# Width of the column windows the row sum adds up one after another.
_WINDOW = 32


def _row_sums(values: torch.Tensor) -> torch.Tensor:
    """float32 [B] sums of the rows of ``values`` [B, L], added in one
    fixed order: rows of at most 32 columns left to right; longer rows
    zero-padded on both sides (the smaller half first) to whole 32-column
    windows, each window summed left to right, then the window sums left
    to right.  That is the order of the JAX package's reduction on the
    CPU (XLA splits a long row into 32-wide windows), so the two
    packages round alike, and every step is one float32 add, so the CPU
    and the card agree bit for bit."""
    b, length = values.shape
    acc = torch.zeros(b, dtype=torch.float32, device=values.device)
    if length <= _WINDOW:
        for j in range(length):
            acc = acc + values[:, j]
        return acc
    width = -(-length // _WINDOW) * _WINDOW
    left = (width - length) // 2
    padded = torch.nn.functional.pad(values, (left, width - length - left))
    windows = padded.reshape(b, width // _WINDOW, _WINDOW)
    partial = torch.zeros(windows.shape[:2], dtype=torch.float32,
                          device=values.device)
    for j in range(_WINDOW):
        partial = partial + windows[:, :, j]
    for k in range(partial.shape[1]):
        acc = acc + partial[:, k]
    return acc


def batch_average_error_rate_device(
        scores: torch.Tensor, lengths: torch.Tensor,
        phred_offset: int = DEFAULT_PHRED_OFFSET) -> torch.Tensor:
    """float32 [B] average error rates over padded phred byte rows.

    ``scores``: uint8 [B, Lmax]; ``lengths``: int [B] valid prefix sizes,
    both on one device.  Padding bytes are masked out of the mean; an
    empty row's rate is NaN (0/0), as in the reference.
    """
    lmax = scores.shape[1]
    idx = (scores.to(torch.int64) - phred_offset) & 0x7F
    rates = torch.from_numpy(_LUT_F32).to(scores.device)[idx]
    mask = torch.arange(lmax, device=scores.device)[None, :] < \
        lengths.to(torch.int64)[:, None]
    totals = _row_sums(torch.where(mask, rates, 0.0))
    return totals / lengths.to(torch.float32)


def quality_filter_mask(scores: torch.Tensor, lengths: torch.Tensor,
                        max_average_error_rate: float,
                        phred_offset: int = DEFAULT_PHRED_OFFSET
                        ) -> torch.Tensor:
    """bool [B]: True for records that PASS the quality filter.

    The reference discards on ``rate > threshold`` (__init__.py:247-249),
    which KEEPS records whose rate is NaN (empty quality string: 0.0/0.0,
    _fastqmodule.c:73-75) — so the pass mask is ``~(rate > threshold)``,
    not ``rate <= threshold``.  The threshold is compared as float32."""
    rates = batch_average_error_rate_device(scores, lengths, phred_offset)
    threshold = torch.tensor(np.float32(max_average_error_rate),
                             device=rates.device)
    return ~(rates > threshold)
