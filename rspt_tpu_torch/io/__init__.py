"""Ingest staging of the streaming path (counterpart of rspt_tpu/io)."""

from .ring import ContinuousRing, IoBuffer

__all__ = ["ContinuousRing", "IoBuffer"]
