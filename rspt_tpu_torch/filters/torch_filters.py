"""Batched filtering on the card — the port's counterpart of
rspt_tpu/filters/jax_filters.py.

The recurrence of a direct-form-I IIR (iir_filter.cpp:81-107)

    y[t] = Σ_i d[i]·x[t−i]  −  Σ_{i≥1} n[i]·y[t−i]

runs in the port's kernels (ops/cuda_kernels.py): ``mode="scan"`` in S1
``iir_scan`` (one thread a row, serial in T, the reference's filter_opt
order: in float64 the host runtime's bits), ``mode="assoc"`` in S2
``iir_assoc`` (tiles of ``IIR_TILE`` samples over the card, their start
states carried by the companion matrix's powers: close to the serial
result, not its bits, as JAX's associative scan). ``fir_apply`` runs S3.
``iir_warmup_state`` is m×m binary exponentiation in torch ops.

State layout (as jax_filters.py's, so a JAX state resumes here): ``zi``
and the returned state are ``(xz, yz)``, each ``(..., p − 1)``: the last
p − 1 inputs and outputs, index 0 the newest (``IirFilter``'s
``xz[:p-1]`` / ``yz[:p-1]``). numpy arrays (a JAX ``zf``) or tensors; they
move to the device. ``fir_apply``'s ``window`` is ``(..., ks)``, the
oldest first, and its ``window_out`` the last ks samples of window then
x. One difference: with T < p − 1 the state out here is the true newest-
first history; jax_filters.py's ``xz_out`` (:128) then mixes the old
history's order.

Entry points take ``device=None`` (the card, or they raise without one;
``device="cpu"`` runs the kernels' plain versions) and return tensors on
that device. Dtypes: a float32 or float64 input keeps its type, a
non-float one becomes float32 (jax_filters.py:84). A second deliberate
difference: a float16 or bfloat16 input raises TypeError, since S1-S3
take float32 and float64 only (JAX filters it in the half type).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import cuda_kernels as ck
from ..utils import tracing

IIR_TILE = 512      # S2's samples a tile


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return a.to(dev) if isinstance(a, torch.Tensor) \
        else torch.from_numpy(np.array(a)).to(dev)


def _float_type(t: torch.Tensor) -> torch.dtype:
    if t.dtype in (torch.float32, torch.float64):
        return t.dtype
    if t.is_floating_point():
        raise TypeError(f"the kernels take float32 or float64, got {t.dtype}")
    return torch.float32


def _rows(t: torch.Tensor, width: int) -> torch.Tensor:
    return t.reshape(-1, width).contiguous()


def iir_apply(x, n: Sequence[float], d: Sequence[float],
              zi: Optional[Tuple] = None, mode: str = "assoc", device=None):
    """Filter x (..., T) through the IIR (n = feedback, d = feedforward;
    2..8 coefficients on the card). zi: optional (xz, yz), each (..., p−1),
    the newest first. Returns (y, (xz_out, yz_out)) on the device
    (jax_filters.iir_apply, :68-131)."""
    with tracing.span("iir_apply"):
        if mode not in ("scan", "assoc"):
            raise ValueError(f"mode must be 'scan' or 'assoc', got {mode!r}")
        m = ck.check_iir_coefficients(n, d) - 1
        dev = resolve_device(device)
        x = _tensor(x, dev)
        dtype = _float_type(x)
        x = x.to(dtype)
        lead, T = x.shape[:-1], x.shape[-1]
        if zi is None:
            xz = x.new_zeros(lead + (m,))
            yz = x.new_zeros(lead + (m,))
        else:
            xz, yz = (_tensor(z, dev).to(dtype) for z in zi)
        if T == 0:      # nothing to filter, no launch: the state passes on
            y = x.new_empty(lead + (0,))
        else:
            args = (_rows(x, T), n, d, _rows(xz, m), _rows(yz, m))
            y = (ck.iir_scan(*args) if mode == "scan"
                 else ck.iir_assoc(*args, IIR_TILE)).reshape(lead + (T,))
        xz_out = torch.cat([xz.flip(-1), x], -1)[..., -m:].flip(-1)
        yz_out = torch.cat([yz.flip(-1), y], -1)[..., -m:].flip(-1)
        return y, (xz_out, yz_out)


def fir_apply(x, kernel, window=None, device=None):
    """FIR with the reference's warm-up (fir_filter.cpp:41-60): output t
    is the kernel's dot product over the last ks inputs, and 0 for the
    first ks outputs when no prior window is given. x: (..., T); window:
    (..., ks) prior samples, the oldest first, or None. Returns (y,
    window_out) on the device (jax_filters.fir_apply, :134-162)."""
    dev = resolve_device(device)
    x = _tensor(x, dev)
    dtype = _float_type(x)
    x = x.to(dtype)
    k = _tensor(np.asarray(kernel, np.float64), dev).to(dtype).reshape(-1)
    ks = k.numel()
    lead, T = x.shape[:-1], x.shape[-1]
    w = None if window is None else _tensor(window, dev).to(dtype)
    y = x.new_empty(lead + (0,)) if T == 0 else ck.fir_apply(
        _rows(x, T), k, None if w is None else _rows(w, ks))
    if w is None:
        w = x.new_zeros(lead + (ks,))
    return y.reshape(lead + (T,)), torch.cat([w, x], -1)[..., -ks:]


def iir_warmup_state(x0, n: Sequence[float], d: Sequence[float], iters: int,
                     device=None):
    """State after the reference's 4·sr constant-input warm-up
    (iir_filter.cpp:109-113) in O(log iters) matrix squarings, in
    jax_filters.py's order (:165-203): s_K = A^K·s₀ + (Σ_{j<K} A^j)·b, from a
    zero state. x0: (...,) the constant sample. Returns (xz, yz) for
    iir_apply, on the device."""
    with tracing.span("iir_warmup_state"):
        dev = resolve_device(device)
        x0 = _tensor(x0, dev)
        dtype = torch.float64 if x0.dtype == torch.float64 else torch.float32
        x0 = x0.to(dtype)
        m = len(n) - 1
        u = x0 * float(np.sum(np.asarray(d, np.float64)))
        b = x0.new_zeros(x0.shape + (m,))
        b[..., 0] = u
        # a copy from pageable memory: the host waits for the stream
        with tracing.sync("companion_copy", dev):
            A = torch.from_numpy(ck.companion_matrix(n)).to(dev, dtype)
        cur_M = A.expand(x0.shape + (m, m))
        acc_v = torch.zeros_like(b)
        cur_v = b
        k = int(iters)
        while k > 0:
            if k & 1:
                acc_v = torch.einsum("...ij,...j->...i", cur_M, acc_v) + cur_v
            cur_v = torch.einsum("...ij,...j->...i", cur_M, cur_v) + cur_v
            cur_M = torch.einsum("...ij,...jk->...ik", cur_M, cur_M)
            k >>= 1
        xz = x0[..., None].expand(x0.shape + (m,)).contiguous()
        return xz, acc_v
