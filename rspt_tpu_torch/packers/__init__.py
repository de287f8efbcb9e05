"""Packer factories of the port (counterpart of rspt_tpu.packers.tpu's).

Only the lossless xdelta_hzr packer is ported so far (ROADMAP.md).
"""

from .gpu import GpuXdeltaHzrPacker, PackerConfig

__all__ = ["GpuXdeltaHzrPacker", "PackerConfig", "new_xdelta_hzr"]


def new_xdelta_hzr(bytes_per_sample: int, nr_channels: int, nr_samples: int,
                   nr_bytes_to_encode: int, device=None,
                   device_decode: bool = False) -> GpuXdeltaHzrPacker:
    """Lossless xdelta_hzr packer on ``device`` (default: the CUDA card;
    raises if there is none). device_decode: entropy-decode on the
    device instead of the host."""
    return GpuXdeltaHzrPacker(bytes_per_sample, nr_channels, nr_samples,
                              nr_bytes_to_encode, device=device,
                              device_decode=device_decode)
