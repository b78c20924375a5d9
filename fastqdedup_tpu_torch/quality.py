"""Phred quality handling: average per-base error rate.

Behavioral parity target: the reference's C extension
(``/root/reference/src/fastqdedup/_fastqmodule.c:38-76``) which computes the
arithmetic mean of ``10 ** (-Q / 10)`` over a phred ASCII string using a
128-entry double LUT, validating every character against
``[phred_offset, 126]``.  The scalar :func:`average_error_rate` here is the
drop-in API; :func:`batch_average_error_rate` is the vectorized host path used
by the pipeline (bit-exact to the sequential C loop: it accumulates in float64
in left-to-right order via ``np.cumsum``).  The TPU-resident version lives in
``fastqdedup_tpu.ops.phred``.
"""

from typing import Optional

import numpy as np

DEFAULT_PHRED_OFFSET = 33
MAXIMUM_PHRED_SCORE = 126

# 10 ** -(score / 10) for score 0..127, matching the reference's generated
# header (/root/reference/score_to_error_rate.py).
SCORE_TO_ERROR_RATE = np.array(
    [10.0 ** -(i / 10) for i in range(128)], dtype=np.float64
)


def average_error_rate(phred_scores: str, *,
                       phred_offset: int = DEFAULT_PHRED_OFFSET) -> float:
    """Average per-base error rate of an ASCII phred string.

    Matches ``_fastqmodule.c:38-76``: raises ValueError for non-ASCII input
    and for characters outside ``[phred_offset, 126]``; an empty string
    yields NaN (0.0 / 0.0 in the C code).
    """
    if not isinstance(phred_scores, str):
        raise TypeError("phred_scores must be a str, got "
                        f"{type(phred_scores).__name__}")
    if not phred_scores.isascii():
        raise ValueError("phred_scores must be ASCII encoded.")
    if not 0 <= phred_offset <= 255:
        raise ValueError("phred_offset must be in the range 0-255")
    total = 0.0
    max_score = MAXIMUM_PHRED_SCORE - phred_offset
    for char in phred_scores:
        # Mimic the C uint8 subtraction: chars below the offset wrap around
        # and fail the same range check (_fastqmodule.c:64-71).
        score = (ord(char) - phred_offset) & 0xFF
        if score > max_score:
            raise ValueError(
                f"Character {char} outside of valid phred range "
                f"('{chr(phred_offset)}' to '{chr(MAXIMUM_PHRED_SCORE)}')")
        total += float(SCORE_TO_ERROR_RATE[score])
    if not phred_scores:
        return float("nan")
    return total / len(phred_scores)


def validate_phred_array(scores: np.ndarray,
                         phred_offset: int = DEFAULT_PHRED_OFFSET,
                         mask: Optional[np.ndarray] = None) -> None:
    """Raise ValueError if any (unmasked) byte is outside the phred range."""
    bad = (scores < phred_offset) | (scores > MAXIMUM_PHRED_SCORE)
    if mask is not None:
        bad &= mask
    if bad.any():
        char = int(scores[np.unravel_index(np.argmax(bad), bad.shape)])
        raise ValueError(
            f"Character {chr(char)} outside of valid phred range "
            f"('{chr(phred_offset)}' to '{chr(MAXIMUM_PHRED_SCORE)}')")


def ragged_average_error_rate(qual_data: np.ndarray,
                              offsets: np.ndarray,
                              phred_offset: int = DEFAULT_PHRED_OFFSET
                              ) -> np.ndarray:
    """float64 [N] mean error rate per record of a ragged quality batch.

    Uses the native C reduction when available (sequential float64
    accumulation, bit-identical to _fastqmodule.c:58-75); otherwise pads and
    runs the vectorized fallback.
    """
    if 0 <= phred_offset <= MAXIMUM_PHRED_SCORE:
        try:
            from .native.loader import average_error_rates_native
            return average_error_rates_native(qual_data, offsets,
                                              phred_offset)
        except ImportError:
            pass
    from .utils.ragged import pad_to_matrix
    matrix, lengths = pad_to_matrix(qual_data, offsets, fill=phred_offset)
    return batch_average_error_rate(matrix, lengths, phred_offset)


def batch_average_error_rate(scores: np.ndarray,
                             lengths: np.ndarray,
                             phred_offset: int = DEFAULT_PHRED_OFFSET,
                             validate: bool = True) -> np.ndarray:
    """Vectorized average error rate over a padded batch of phred bytes.

    ``scores``: uint8 array of shape [B, Lmax] (padding bytes arbitrary).
    ``lengths``: int array [B] of valid prefix lengths per row.

    Returns float64 [B].  Accumulation is float64 left-to-right per row
    (``np.cumsum``), which reproduces the reference C loop's IEEE rounding
    sequence exactly (_fastqmodule.c:63-75), so threshold comparisons made on
    the result are bit-identical to the reference.
    """
    if scores.ndim != 2:
        raise ValueError("scores must be 2-D [batch, max_length]")
    lmax = scores.shape[1]
    mask = np.arange(lmax, dtype=lengths.dtype)[None, :] < lengths[:, None]
    if validate:
        validate_phred_array(scores, phred_offset, mask)
    idx = (scores.astype(np.int16) - phred_offset) & 0x7F
    rates = SCORE_TO_ERROR_RATE[idx]
    rates[~mask] = 0.0
    totals = np.cumsum(rates, axis=1)[:, -1] if lmax else np.zeros(len(scores))
    with np.errstate(invalid="ignore", divide="ignore"):
        return totals / lengths
