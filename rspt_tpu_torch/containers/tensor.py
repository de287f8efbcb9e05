"""1-4D typed tensors with JSON round-trip (the port's copy of
rspt_tpu/containers/tensor.py).

The counterpart of lib_rspt/lib_zaxtensor/ZaxTensor.h: device math uses
torch tensors, so this class is a thin, numpy-backed host container
holding the reference's *API surface* — resize / reshape / view /
squeeze / unsqueeze (ZaxTensor.h:1297-1417), zero-copy wrap of external
byte buffers (a_wrap_around_bytes, :1211-1214), JSON (de)serialization
(:1460-1477) and JSON shape inference (get_dimensions,
ZaxTensor.cpp:31-56) — plus ``to_torch()``, the hand-off to the card.
The nested-row-pointer access style (``t.d2d[i][j]``) maps to numpy
indexing (``t.a[i, j]``) with ``d1..d4`` shape aliases.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device


def get_dimensions(text: str) -> List[int]:
    """Infer nested-array dimensions from JSON text
    (ZaxTensor.cpp:31-56)."""
    v = json.loads(text)
    dims: List[int] = []
    while isinstance(v, list):
        dims.append(len(v))
        if not v:
            break
        v = v[0]
    return dims


class Tensor:
    """Typed 1–4D tensor in contiguous memory."""

    MAX_DIMS = 4

    def __init__(self, *shape, dtype=np.float32, json_text: Optional[str] = None):
        self.dtype = np.dtype(dtype)
        if json_text is not None:
            self.a = np.zeros(0, self.dtype)
            self.from_json(json_text)
            return
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if len(shape) > self.MAX_DIMS:
            raise ValueError("max 4 dimensions")
        self.a = np.zeros(shape if shape else 0, self.dtype)

    # -- shape aliases matching the reference's d1..d4 fields --
    @property
    def d1(self):
        return self.a.shape[0] if self.a.ndim >= 1 else 0

    @property
    def d2(self):
        return self.a.shape[1] if self.a.ndim >= 2 else 0

    @property
    def d3(self):
        return self.a.shape[2] if self.a.ndim >= 3 else 0

    @property
    def d4(self):
        return self.a.shape[3] if self.a.ndim >= 4 else 0

    def shape(self):
        return list(self.a.shape)

    def data(self) -> np.ndarray:
        return self.a.reshape(-1)

    def size_bytes(self) -> int:
        return self.a.nbytes

    # -- mutation (ZaxTensor.h:1297-1417) --
    def resize(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if len(shape) > self.MAX_DIMS:
            raise ValueError("max 4 dimensions")
        self.a = np.zeros(shape, self.dtype)
        return self

    def reshape(self, *shape):
        self.a = self.a.reshape(shape)
        return self

    def view(self, *shape) -> "Tensor":
        t = Tensor(dtype=self.dtype)
        t.a = self.a.reshape(shape)
        return t

    def squeeze(self):
        self.a = np.squeeze(self.a)
        return self

    def unsqueeze(self, axis: int = 0):
        self.a = np.expand_dims(self.a, axis)
        return self

    @classmethod
    def wrap_around_bytes(cls, buf, shape: Sequence[int], dtype) -> "Tensor":
        """Zero-copy wrap of an external buffer
        (a_wrap_around_bytes ctor, ZaxTensor.h:1211-1214)."""
        t = cls(dtype=dtype)
        t.a = np.frombuffer(buf, dtype=dtype).reshape(tuple(shape))
        return t

    def to_torch(self, device=None) -> torch.Tensor:
        """Device hand-off: a copy of the values as a torch tensor on the
        card, or on the device the caller names; raises without a card
        unless a device is named."""
        return torch.from_numpy(np.ascontiguousarray(self.a)).to(
            resolve_device(device), copy=True)

    # -- JSON (ZaxTensor.h:1460-1477) --
    def to_json(self) -> str:
        return json.dumps(self.a.tolist())

    def from_json(self, text: str):
        dims = get_dimensions(text)
        v = np.asarray(json.loads(text), self.dtype)
        self.a = v.reshape(dims) if dims else v
        return self

    # -- numpy niceties --
    def __getitem__(self, i):
        return self.a[i]

    def __setitem__(self, i, v):
        self.a[i] = v

    def __eq__(self, other):
        o = other.a if isinstance(other, Tensor) else other
        return bool(np.array_equal(self.a, o))

    def __repr__(self):
        return f"Tensor{tuple(self.a.shape)}<{self.dtype}>"


class ArrayOfTensors:
    """Resizable list of tensors with element-wise equality and JSON
    round-trip (ZaxTensor.h:1491-1528 `array_of_tensors`)."""

    def __init__(self, factory=None, size: int = 0):
        self._factory = factory or tensor_i32
        self.m_data = [self._factory() for _ in range(size)]

    def __getitem__(self, idx: int):
        return self.m_data[idx]

    def __setitem__(self, idx: int, value):
        self.m_data[idx] = value

    def resize(self, size: int):
        n = len(self.m_data)
        if size < n:
            del self.m_data[size:]
        else:
            self.m_data.extend(self._factory() for _ in range(size - n))

    def size(self) -> int:
        return len(self.m_data)

    def __len__(self) -> int:
        return len(self.m_data)

    def __eq__(self, other) -> bool:
        if len(self) != len(other):
            return False
        return all(a == b for a, b in zip(self.m_data, other.m_data))

    # JSON: the reference serializes m_data as the top-level value
    # (JSON_PROPERTY(m_data, "^"))
    def to_json(self) -> str:
        return "[%s]" % ", ".join(t.to_json() for t in self.m_data)

    def from_json(self, text: str):
        items = json.loads(text)
        self.m_data = [self._factory().from_json(json.dumps(v))
                       for v in items]
        return self


def _alias(dtype):
    def make(*shape, **kw):
        return Tensor(*shape, dtype=dtype, **kw)
    return make


# aliases matching ZaxTensor.h:1482-1489
tensor_f32 = _alias(np.float32)
tensor_f64 = _alias(np.float64)
tensor_i32 = _alias(np.int32)
tensor_ui32 = _alias(np.uint32)
tensor_ui8 = _alias(np.uint8)
tensor_i8 = _alias(np.int8)
tensor_ui16 = _alias(np.uint16)
tensor_i16 = _alias(np.int16)
