"""Sharded exact int32 scans (counterpart of rspt_tpu/parallel/scans.py).

The reference's delta and xor scans run over the whole flattened signal
(utils.cpp:193-236), so over shards the scan state crosses shard
boundaries. Each shard runs its local scan with torch_ops and takes one
int32 carry:

* delta_encode / xor_encode: the last element of the previous shard;
* delta_decode (prefix sum) / xor_decode (prefix xor): the exclusive
  fold of the earlier shards' totals.

The carries go through the host: one int32 a local shard, and across
processes one all_gather of them over the mesh's gloo group. All
arithmetic wraps as two's complement int32, as the host oracles
(numpy_ops) do, bit for bit. A sharded array is a list of equal-length
(n,) int32 tensors, one a local shard on its device, in the mesh's
shard order: ``shard`` cuts a whole array so (its length a multiple of
the global shard count), ``gather`` joins one back on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import torch_ops as tops
from .mesh import Mesh, allgather


def make_sharded_scans(mesh: Mesh):
    """The scan functions over ``mesh``'s shards: delta_encode,
    xor_encode, delta_decode, xor_decode (each a list of per-shard
    tensors in, a list out), shard and gather."""

    def check(parts):
        if len(parts) != mesh.local:
            raise ValueError(f"need {mesh.local} shards, got {len(parts)}")
        if len({p.numel() for p in parts}) != 1 or any(
                p.dtype != torch.int32 or p.dim() != 1 for p in parts):
            raise ValueError("shards: equal-length 1-D int32 tensors")
        return parts[0].numel() > 0

    def edges(values):
        """One int32 of each local shard → every shard's, on the host."""
        return allgather(mesh, torch.cat([v.cpu() for v in values]).numpy())

    def encoder(local_scan):
        def encode(parts):
            if not check(parts):
                return [p.clone() for p in parts]
            last = edges([p[-1:] for p in parts])
            return [local_scan(torch.cat([p.new_tensor(
                [int(last[g - 1]) if g else 0]), p]))[1:]
                for p, g in zip(parts, mesh.shard_ids())]
        return encode

    def delta_decode(parts):
        if not check(parts):
            return [p.clone() for p in parts]
        local = [tops.delta_decode(p) for p in parts]
        totals = edges([x[-1:] for x in local]).astype(np.int64)
        return [tops.offset32(x, int(totals[:g].sum()))
                for x, g in zip(local, mesh.shard_ids())]

    def xor_decode(parts):
        if not check(parts):
            return [p.clone() for p in parts]
        local = [tops.xor_decode(p) for p in parts]
        totals = edges([x[-1:] for x in local])
        return [x ^ int(np.bitwise_xor.reduce(totals[:g], initial=0))
                for x, g in zip(local, mesh.shard_ids())]

    def shard(x):
        """This process's shards of a whole (n,) int32 array."""
        x = torch.as_tensor(np.asarray(x, np.int32).reshape(-1))
        if x.numel() % mesh.size:
            raise ValueError(f"length {x.numel()} does not divide over "
                             f"{mesh.size} shards")
        m = x.numel() // mesh.size
        return [x[g * m:(g + 1) * m].to(d)
                for d, g in zip(mesh.devices, mesh.shard_ids())]

    def gather(parts):
        """The whole (n,) int32 array of every shard, on the host."""
        return torch.from_numpy(allgather(
            mesh, torch.cat([p.cpu() for p in parts]).numpy()))

    return {
        "delta_encode": encoder(tops.delta_encode),
        "xor_encode": encoder(tops.xor_encode),
        "delta_decode": delta_decode,
        "xor_decode": xor_decode,
        "shard": shard,
        "gather": gather,
    }
