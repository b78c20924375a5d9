"""The device quality filter (ops/phred.py) against the JAX package's.

Both compute a float32 LUT gather and a masked mean per record; the port
adds in the order the JAX package's reduction takes on the CPU, so rates
and pass masks are compared exactly, including thresholds that sit
exactly on a rate.
"""

import numpy as np
import pytest
import torch

from fastqdedup_tpu.ops import phred as jax_phred
from fastqdedup_tpu_torch.ops import phred as torch_phred


def _rows(seed, b, width):
    rng = np.random.default_rng(seed)
    scores = rng.integers(33, 33 + 42, (b, width)).astype(np.uint8)
    lengths = rng.integers(0, width + 1, b).astype(np.int32)
    lengths[::17] = 0  # empty quality strings: rate NaN, kept
    scores[np.arange(width)[None, :] >= lengths[:, None]] = 33
    return scores, lengths


@pytest.mark.parametrize("width", [0, 1, 20, 32, 33, 100, 151, 300])
def test_rates_match_jax_bitwise(width):
    scores, lengths = _rows(width, 2000, width)
    want = np.asarray(jax_phred.batch_average_error_rate_device(
        scores, lengths))
    got = torch_phred.batch_average_error_rate_device(
        torch.from_numpy(scores), torch.from_numpy(lengths)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)  # NaN equals NaN here


@pytest.mark.parametrize("width", [12, 100, 151])
def test_quality_filter_mask_matches_jax(width):
    """Thresholds: the reference's 0.001, and float32 rates of the rows
    themselves, so some rows sit exactly on the threshold (kept: the
    filter drops only ``rate > threshold``); NaN rows are kept."""
    scores, lengths = _rows(100 + width, 3000, width)
    # Rows of all-Q30 quality: their float32 mean lands on or next to
    # the float32 of 0.001.
    scores[1::11] = 33 + 30
    lengths[1::11] = width
    rates = np.asarray(jax_phred.batch_average_error_rate_device(
        scores, lengths))
    finite = rates[np.isfinite(rates)]
    thresholds = [0.001, float(np.median(finite)), float(finite[7])]
    for threshold in thresholds:
        want = np.asarray(jax_phred.quality_filter_mask(
            scores, lengths, np.float32(threshold)))
        got = torch_phred.quality_filter_mask(
            torch.from_numpy(scores), torch.from_numpy(lengths),
            threshold).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[lengths == 0].all()
        assert 0 < got.sum() < len(got)
    on_threshold = rates == np.float32(thresholds[2])
    assert on_threshold.any()
