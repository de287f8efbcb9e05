"""The codec's quality metrics (the port's copy of
rspt_tpu/utils/metrics.py): CR, original over compressed bytes
(rspt_test.cpp:86), PRDN, the normalised percentage RMS difference
against the mean-removed original (rspt_test.cpp:98-111), the mean being
the reference's average_32, and throughput."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..ops import torch_ops as tops


def compression_ratio(original_bytes: int, compressed_bytes: int) -> float:
    return original_bytes / compressed_bytes


def prdn(original: np.ndarray, decoded: np.ndarray) -> float:
    """PRDN in percent of channel-major (channels, samples) int32 arrays;
    0 when the original is constant in every channel."""
    orig = np.asarray(original, np.float64)
    dec = np.asarray(decoded, np.float64)
    mse = float(((orig - dec) ** 2).sum())
    means = tops.average32_host(
        np.asarray(original, np.int32).astype(np.int64).sum(axis=1),
        orig.shape[1])
    origg = 0.0
    for ch in range(orig.shape[0]):
        origg += float(((orig[ch] - float(means[ch])) ** 2).sum())
    if origg == 0:
        return 0.0
    return float(np.sqrt(mse / origg) * 100.0)


def throughput(nbytes: int, seconds: float) -> Dict[str, float]:
    return {"bytes": nbytes, "seconds": seconds,
            "gbps": nbytes / seconds / 1e9}
