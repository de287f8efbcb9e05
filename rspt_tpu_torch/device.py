"""Where the port's entry points run: the card unless the caller names a
device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device; no silent CPU
    fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rspt_tpu_torch: no CUDA device; pass device='cpu' to run "
                "the kernels' plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)
