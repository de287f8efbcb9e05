"""Declarative JSON-serializable config objects (the port's copy of
rspt_tpu/containers/jsoncfg.py).

The reference generates to/from-JSON via macro reflection
(ZAX_JSON_SERIALIZABLE, lib_rspt/lib_zaxtensor/ZaxJsonParser.h:885-1013).
The Python-native equivalent: annotate fields with ``json_property`` on
a ``JsonSerializable`` subclass; nested JsonSerializable / Tensor /
numpy values round-trip automatically. Used for packer/filter/pipeline
configs so runs are reproducible from a single JSON blob.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

from .tensor import Tensor


def json_property(default=None, name: str = None):
    """Field marker (mirrors JSON_PROPERTY, ZaxJsonParser.h:970-1013)."""
    return _JsonProperty(default, name)


class _JsonProperty:
    __slots__ = ("default", "name")

    def __init__(self, default, name):
        self.default = default
        self.name = name


class JsonSerializable:
    """Subclass with class-level ``x = json_property(...)`` fields."""

    def __init__(self, json_text: str = None, **kw):
        for key, prop in self._props().items():
            v = kw.get(key, prop.default)
            setattr(self, key, v() if callable(v) else v)
        if json_text is not None:
            self.from_json(json_text)

    @classmethod
    def _props(cls) -> Dict[str, _JsonProperty]:
        out = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, _JsonProperty):
                    out[k] = v
        return out

    def _encode(self, v) -> Any:
        if isinstance(v, JsonSerializable):
            return v.to_dict()
        if isinstance(v, Tensor):
            return v.a.tolist()
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, (np.integer, np.floating)):
            return v.item()
        if isinstance(v, (list, tuple)):
            return [self._encode(x) for x in v]
        return v

    def to_dict(self) -> Dict[str, Any]:
        return {(p.name or k): self._encode(getattr(self, k))
                for k, p in self._props().items()}

    def to_json(self, indent=None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def from_dict(self, d: Dict[str, Any]):
        for k, p in self._props().items():
            key = p.name or k
            if key not in d:
                continue
            cur = getattr(self, k, None)
            v = d[key]
            if isinstance(cur, JsonSerializable):
                cur.from_dict(v)
            elif isinstance(cur, Tensor):
                cur.a = np.asarray(v, cur.dtype)
            elif isinstance(cur, np.ndarray):
                setattr(self, k, np.asarray(v, cur.dtype))
            else:
                setattr(self, k, v)
        return self

    def from_json(self, text: str):
        return self.from_dict(json.loads(text))

    def __eq__(self, other):
        return isinstance(other, JsonSerializable) \
            and self.to_dict() == other.to_dict()
