"""Packer factories of the port (counterpart of rspt_tpu.packers', with
the engine argument of rspt_tpu/packers/__init__.py:22-90, and of the
host factories' plane_backend, host.py:275-290).

engine="cuda" (the default): the card packers of packers/gpu.py. Each
runs on ``device`` (default: the CUDA card; raises if there is none;
``device="cpu"`` runs the kernels' plain PyTorch versions);
device_decode entropy-decodes hzr planes on the device instead of the
host; encoder (parallel.mesh.ShardedHzrEncoder) runs pass 2 over a
mesh's shards. engine="native": the all-host engine of
packers/native.py, every stage in the port's C++ host runtime, with
``nthreads`` threads (0: one a hardware thread); it takes none of the
card's options. The reference's "host" engine (numpy) is not ported: its
counterpart is engine="cuda" with device="cpu". There is no "auto": the
reference's picks the host whenever its runtime builds, which would move
the port's default off the card.

plane_backend 'lz4' or 'lz4hc' codes the planes as LZ4 blocks in the
host runtime (greedy, or hash chains with lazy matching;
container.PLANE_LZ4 in the method byte), after the card packers' pass 1
on the device; it takes no encoder. Every packer of either engine
decodes hzr and LZ4 containers alike, and the engines' containers are
byte-identical. The DCT packer takes no ``device_transform`` flag: on
the card its exact transform is the device transform.
"""

from .gpu import (GpuDctPacker, GpuHadamardPacker, GpuHzrPacker,
                  GpuXdeltaHzrPacker, PackerConfig)
from .native import (NativeDctPacker, NativeHadamardPacker, NativeHzrPacker,
                     NativeXdeltaHzrPacker)

__all__ = ["GpuDctPacker", "GpuHadamardPacker", "GpuHzrPacker",
           "GpuXdeltaHzrPacker", "NativeDctPacker", "NativeHadamardPacker",
           "NativeHzrPacker", "NativeXdeltaHzrPacker", "PackerConfig",
           "new_dct", "new_hadamard", "new_hzr", "new_xdelta_hzr"]

ENGINES = ("cuda", "native")


def _native(engine: str, device, device_decode: bool, encoder,
            nthreads) -> bool:
    """True for the native engine, False for the card's; raises on any
    other engine and on an option the chosen engine does not take."""
    if engine == "cuda":
        if nthreads is not None:
            raise ValueError("nthreads= sets the native engine's threads; "
                             "engine='cuda' takes none")
        return False
    if engine != "native":
        hint = (" (the reference's numpy engine; its counterpart is "
                "engine='cuda', device='cpu')" if engine == "host" else "")
        raise ValueError(f"engine {engine!r} is not one of {ENGINES}{hint}")
    given = [name for name, v in (("device", device is not None),
                                  ("device_decode", device_decode),
                                  ("encoder", encoder is not None)) if v]
    if given:
        raise ValueError(f"{', '.join(given)}: options of the card's packers;"
                         f" engine='native' takes none")
    return True


def new_hzr(bytes_per_sample: int, nr_channels: int, nr_samples: int,
            device=None, device_decode: bool = False, encoder=None,
            plane_backend: str = "hzr", engine: str = "cuda",
            nthreads=None):
    """Lossless 4-plane packer, no preprocessing (method byte 0)."""
    if _native(engine, device, device_decode, encoder, nthreads):
        return NativeHzrPacker(bytes_per_sample, nr_channels, nr_samples,
                               nthreads=nthreads or 0,
                               plane_backend=plane_backend)
    return GpuHzrPacker(bytes_per_sample, nr_channels, nr_samples,
                        device=device, device_decode=device_decode,
                        encoder=encoder, plane_backend=plane_backend)


def new_xdelta_hzr(bytes_per_sample: int, nr_channels: int, nr_samples: int,
                   nr_bytes_to_encode: int, device=None,
                   device_decode: bool = False, encoder=None,
                   plane_backend: str = "hzr", engine: str = "cuda",
                   nthreads=None):
    """Lossless xdelta packer (method byte 0), starting at
    nr_bytes_to_encode planes and growing as the payloads need."""
    if _native(engine, device, device_decode, encoder, nthreads):
        return NativeXdeltaHzrPacker(bytes_per_sample, nr_channels,
                                     nr_samples, nr_bytes_to_encode,
                                     nthreads=nthreads or 0,
                                     plane_backend=plane_backend)
    return GpuXdeltaHzrPacker(bytes_per_sample, nr_channels, nr_samples,
                              nr_bytes_to_encode, device=device,
                              device_decode=device_decode, encoder=encoder,
                              plane_backend=plane_backend)


def new_dct(bytes_per_sample: int, nr_channels: int, nr_samples: int,
            device=None, device_decode: bool = False, encoder=None,
            plane_backend: str = "hzr", engine: str = "cuda",
            nthreads=None):
    """Lossy DCT packer (method byte 1, 2 planes, quality 128) with the
    reference's exact transform; any nr_samples >= 1."""
    if _native(engine, device, device_decode, encoder, nthreads):
        return NativeDctPacker(bytes_per_sample, nr_channels, nr_samples,
                               nthreads=nthreads or 0,
                               plane_backend=plane_backend)
    return GpuDctPacker(bytes_per_sample, nr_channels, nr_samples,
                        device=device, device_decode=device_decode,
                        encoder=encoder, plane_backend=plane_backend)


def new_hadamard(bytes_per_sample: int, nr_channels: int, nr_samples: int,
                 device=None, device_decode: bool = False, encoder=None,
                 plane_backend: str = "hzr", engine: str = "cuda",
                 nthreads=None):
    """Lossy Walsh-Hadamard packer (method byte 2, 3 planes, quality 1);
    raises ValueError unless nr_samples is a power of two (1 included)."""
    if _native(engine, device, device_decode, encoder, nthreads):
        return NativeHadamardPacker(bytes_per_sample, nr_channels,
                                    nr_samples, nthreads=nthreads or 0,
                                    plane_backend=plane_backend)
    return GpuHadamardPacker(bytes_per_sample, nr_channels, nr_samples,
                             device=device, device_decode=device_decode,
                             encoder=encoder, plane_backend=plane_backend)
