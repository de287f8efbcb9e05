"""Filters of the streaming path: the Butterworth designs and the
streaming IIR (counterparts of rspt_tpu/filters/design.py and
streaming.py)."""

from .design import (FilterKind, FilterType, butterworth_1st,
                     butterworth_2nd, butterworth_bandpass_1st,
                     butterworth_bandpass_2nd, create_filter_iir)
from .streaming import IirFilter, new_iir

__all__ = ["FilterKind", "FilterType", "IirFilter", "butterworth_1st",
           "butterworth_2nd", "butterworth_bandpass_1st",
           "butterworth_bandpass_2nd", "create_filter_iir", "new_iir"]
