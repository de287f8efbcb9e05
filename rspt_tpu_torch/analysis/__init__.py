"""Signal analysis: the host peak detectors and rolling median
(counterparts of rspt_tpu/analysis/peaks.py and rolling_median.py) and
their batch paths on the device (torch_peaks.py, the counterpart of
jax_peaks.py; the rolling medians' torch paths)."""

from .peaks import (PeakDetector, PeakDetector1stOrder,
                    PeakDetectorOffline)
from .rolling_median import (RollingWindowMedian, rolling_median,
                             torch_rolling_median,
                             torch_rolling_median_large)
from .torch_peaks import detect_batch, detect_offline_batch

__all__ = ["PeakDetector", "PeakDetector1stOrder", "PeakDetectorOffline",
           "RollingWindowMedian", "detect_batch", "detect_offline_batch",
           "rolling_median", "torch_rolling_median",
           "torch_rolling_median_large"]
