"""Packer factories of the port (counterpart of rspt_tpu.packers.tpu's,
tpu.py:1121-1134, and of the host factories' plane_backend,
host.py:275-290). Each packer runs on ``device`` (default: the CUDA
card; raises if there is none; ``device="cpu"`` runs the kernels' plain
PyTorch versions); device_decode entropy-decodes hzr planes on the
device instead of the host; encoder (parallel.mesh.ShardedHzrEncoder)
runs pass 2 over a mesh's shards; plane_backend 'lz4' or 'lz4hc' codes
the planes as LZ4 blocks in the host runtime (greedy, or hash chains
with lazy matching; container.PLANE_LZ4 in the method byte) after the
packer's pass 1 on the device, and takes no encoder. Every packer
decodes hzr and LZ4 containers alike. The DCT packer takes no
``device_transform`` flag: on the card its exact transform is the device
transform.
"""

from .gpu import (GpuDctPacker, GpuHadamardPacker, GpuHzrPacker,
                  GpuXdeltaHzrPacker, PackerConfig)

__all__ = ["GpuDctPacker", "GpuHadamardPacker", "GpuHzrPacker",
           "GpuXdeltaHzrPacker", "PackerConfig", "new_dct", "new_hadamard",
           "new_hzr", "new_xdelta_hzr"]


def new_hzr(bytes_per_sample: int, nr_channels: int, nr_samples: int,
            device=None, device_decode: bool = False,
            encoder=None, plane_backend: str = "hzr") -> GpuHzrPacker:
    """Lossless 4-plane packer, no preprocessing (method byte 0)."""
    return GpuHzrPacker(bytes_per_sample, nr_channels, nr_samples,
                        device=device, device_decode=device_decode,
                        encoder=encoder, plane_backend=plane_backend)


def new_xdelta_hzr(bytes_per_sample: int, nr_channels: int, nr_samples: int,
                   nr_bytes_to_encode: int, device=None,
                   device_decode: bool = False, encoder=None,
                   plane_backend: str = "hzr") -> GpuXdeltaHzrPacker:
    """Lossless xdelta packer (method byte 0), starting at
    nr_bytes_to_encode planes and growing as the payloads need."""
    return GpuXdeltaHzrPacker(bytes_per_sample, nr_channels, nr_samples,
                              nr_bytes_to_encode, device=device,
                              device_decode=device_decode, encoder=encoder,
                              plane_backend=plane_backend)


def new_dct(bytes_per_sample: int, nr_channels: int, nr_samples: int,
            device=None, device_decode: bool = False,
            encoder=None, plane_backend: str = "hzr") -> GpuDctPacker:
    """Lossy DCT packer (method byte 1, 2 planes, quality 128) with the
    reference's exact transform; any nr_samples >= 1."""
    return GpuDctPacker(bytes_per_sample, nr_channels, nr_samples,
                        device=device, device_decode=device_decode,
                        encoder=encoder, plane_backend=plane_backend)


def new_hadamard(bytes_per_sample: int, nr_channels: int, nr_samples: int,
                 device=None, device_decode: bool = False,
                 encoder=None, plane_backend: str = "hzr"
                 ) -> GpuHadamardPacker:
    """Lossy Walsh-Hadamard packer (method byte 2, 3 planes, quality 1);
    raises ValueError unless nr_samples is a power of two (1 included)."""
    return GpuHadamardPacker(bytes_per_sample, nr_channels, nr_samples,
                             device=device, device_decode=device_decode,
                             encoder=encoder, plane_backend=plane_backend)
