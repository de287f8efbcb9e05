"""The signal-packer container (the port's counterpart of
rspt_tpu/packers/container.py).

Layout (reference: lib_rspt/lib_signalpacker/signal_packer_base.cpp):
    [method: 1 byte]
    [optional packer header (e.g. per-channel means)]
    per plane k in 0..nr_planes-1:
        [u32le length of the plane's stream] [stream]

Plane k holds byte k (LSB first) of every value of the channel-major
int32 workspace (base.cpp:40-68). The low 6 bits of the method byte are
the packer type (0, 1, 2); bit 0x40 (PLANE_LZ4) marks planes coded as
LZ4 blocks instead of hzr streams, so a decoder dispatches on the byte
alone (container.py:38-39 of the reference).
"""

from __future__ import annotations

PLANE_LZ4 = 0x40
METHOD_MASK = 0x3F
PLANE_BACKENDS = ("hzr", "lz4", "lz4hc")


def container(method: int, header: bytes, streams) -> bytes:
    """The container of the method byte, the header and the plane
    streams."""
    parts = [bytes([method]), header]
    for stream in streams:
        parts.append(len(stream).to_bytes(4, "little"))
        parts.append(stream)
    return b"".join(parts)
