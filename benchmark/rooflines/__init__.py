"""The card's peaks (h100.json) and, a module a layer, the bytes and
operations each kernel needs for a call at given shapes: each input byte
read once and each output byte written once."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("h100.json")).read_text())


def share_pct(bytes_: float, seconds: float, flops: float = 0.0):
    """The least time the card could take (the larger of bytes over the
    HBM peak and operations over the float32 peak) as a percentage of
    ``seconds``; None when nothing was timed."""
    if seconds <= 0:
        return None
    least = max(bytes_ / PEAKS["hbm_bytes_per_s"],
                flops / PEAKS["fp32_flops_per_s"])
    return 100.0 * least / seconds
