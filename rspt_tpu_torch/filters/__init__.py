"""Filters: the Butterworth designs, the streaming host filters (IIR,
FIR, delay) and the batched device filters (counterparts of
rspt_tpu/filters/design.py, streaming.py and jax_filters.py; the last is
``filters.torch_filters``, imported on use)."""

from .design import (FilterKind, FilterType, butterworth_1st,
                     butterworth_2nd, butterworth_bandpass_1st,
                     butterworth_bandpass_2nd, create_filter_iir)
from .streaming import Delay, FirFilter, IirFilter, new_fir, new_iir

__all__ = ["Delay", "FilterKind", "FilterType", "FirFilter", "IirFilter",
           "butterworth_1st", "butterworth_2nd", "butterworth_bandpass_1st",
           "butterworth_bandpass_2nd", "create_filter_iir", "new_fir",
           "new_iir"]
