"""The generators repeat from a seed and differ across seeds."""

import json

import torch

from benchmark.traffic import ecg


def signal(root):
    return json.loads((root / "benchmark/configs/mitdb.json").read_text()
                      )["signal"]


def test_records_repeat_and_differ(root):
    sig = signal(root)
    big = 2 ** 31 + 12345
    a = ecg.records(sig, 2, 2, 3000, 360.0, big, "cpu")
    b = ecg.records(sig, 2, 2, 3000, 360.0, big, "cpu")
    c = ecg.records(sig, 2, 2, 3000, 360.0, big + 1, "cpu")
    assert a.shape == (4, 3000) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.min() >= 0 and a.max() <= 2047
    assert torch.equal(a, a.round())

