"""rspt_tpu_torch — the PyTorch/CUDA port of rspt_tpu for NVIDIA Hopper.

A second package beside the JAX one (which stays the reference). It
imports torch and numpy, never jax and nothing of ``rspt_tpu``; each
Pallas TPU kernel on a ported path is a CUDA C++ kernel for sm_90a
(``ops/csrc``), built with nvcc at first use and bound with ctypes.

Quick start (on a CUDA card; pass ``device="cpu"`` to run the kernels'
plain PyTorch versions instead)::

    from rspt_tpu_torch import packers
    p = packers.new_xdelta_hzr(4, 12, 34199, 3)   # bps, ch, n, planes
    comp = p.compress(native_bytes)
    out, consumed = p.decompress(comp)

Every packer factory takes ``plane_backend='hzr'`` (the default),
``'lz4'`` or ``'lz4hc'``: LZ4 planes are coded in the port's host
runtime (``native``) after pass 1 on the card, and every packer decodes
both kinds of container. The streaming path (BASELINE config 5) is
``rspt_tpu_torch.pipeline``: ``StreamingCodec(StreamConfig(...))
.push(native_bytes)`` gives frames. The batch signal ops are
``filters.torch_filters`` (``iir_apply``, ``fir_apply``) and
``analysis`` (``detect_batch``, ``detect_offline_batch``, the rolling
medians). ``parallel`` shards the hzr block codec over cards or
processes (``make_mesh``, ``ShardedHzrEncoder``, ``ShardedHzrDecoder``).
``containers`` holds the host tensors and JSON configs (``Tensor``,
``to_torch(device)``), ``utils.metrics`` CR, PRDN and throughput.

Streams and containers are byte-identical to ``rspt_tpu``'s.
"""

from . import packers  # noqa: F401

__version__ = "0.1.0"
__all__ = ["packers", "formats", "hzr", "ops", "native", "filters", "io",
           "pipeline", "analysis", "parallel", "containers", "utils"]
