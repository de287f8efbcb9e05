"""The port's host containers (rspt_tpu_torch.containers) and
utils.metrics.throughput against rspt_tpu's: the JSON text of the same
tensor or config must equal the reference's character for character.
Inputs are made with numpy from a seed."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)

from rspt_tpu import containers as rcon  # noqa: E402
from rspt_tpu.containers import tensor as rten  # noqa: E402
from rspt_tpu.utils import metrics as rmet  # noqa: E402
from rspt_tpu_torch import containers as pcon  # noqa: E402
from rspt_tpu_torch.containers import tensor as pten  # noqa: E402
from rspt_tpu_torch.utils import metrics as pmet  # noqa: E402

ALIASES = ("tensor_f32", "tensor_f64", "tensor_i32", "tensor_ui32",
           "tensor_ui8", "tensor_i8", "tensor_ui16", "tensor_i16")
SHAPES = ((), (0,), (5,), (3, 0), (2, 3), (2, 3, 4), (1, 2, 0, 3),
          (2, 1, 3, 2))


def _values(dtype, shape, rng):
    """Seeded values over the dtype's range (floats with a fraction)."""
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return (rng.standard_normal(shape) * 1e3).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, endpoint=True,
                        dtype=np.int64).astype(dt)


def _pair(alias, shape, rng):
    """The same values in a reference and a port tensor of one alias."""
    ref, port = getattr(rcon, alias)(*shape), getattr(pcon, alias)(*shape)
    ref.a[...] = port.a[...] = _values(ref.dtype, ref.a.shape, rng)
    return ref, port


def test_exports_match_reference():
    """The package exports what rspt_tpu.containers exports."""
    names = {n for n in vars(rcon) if not n.startswith("_")} - {
        "tensor", "jsoncfg"}
    assert names <= set(vars(pcon))
    assert set(ALIASES) <= names


@pytest.mark.parametrize("alias", ALIASES)
def test_tensor_json_equals_reference(alias):
    """Every alias at 0-4-D shapes, empty arrays included: to_json text
    equal to the reference's; from_json of it gives the same values,
    shape and dtype on both sides (the values written, where the shape
    survives JSON); get_dimensions agrees."""
    rng = np.random.default_rng(len(alias))
    for shape in SHAPES:
        ref, port = _pair(alias, shape, rng)
        text = ref.to_json()
        assert port.to_json() == text, shape
        back = getattr(pcon, alias)(json_text=text)
        rback = getattr(rcon, alias)(json_text=text)
        assert back.a.dtype == rback.a.dtype == ref.dtype
        assert back.shape() == rback.shape()
        np.testing.assert_array_equal(back.a, rback.a)
        # the reference's get_dimensions stops at the first empty list, so
        # (1, 2, 0, 3) reads back as (1, 2, 0) on both sides
        if 0 not in shape[:-1]:
            assert back == port
        assert pcon.get_dimensions(text) == rcon.get_dimensions(text)
        assert (port.d1, port.d2, port.d3, port.d4) == (
            ref.d1, ref.d2, ref.d3, ref.d4)


def test_tensor_api_equals_reference():
    """resize, reshape, view, squeeze, unsqueeze, data, size_bytes,
    indexing, equality and repr as the reference's."""
    rng = np.random.default_rng(1)
    ref, port = _pair("tensor_i16", (3, 4), rng)
    for t in (ref, port):
        t[1, 2] = 42
        t.unsqueeze(0)
    assert port.shape() == ref.shape() == [1, 3, 4]
    assert port.to_json() == ref.to_json()
    assert port.view(12).to_json() == ref.view(12).to_json()
    for t in (ref, port):
        t.squeeze().reshape(4, 3)
    assert port.to_json() == ref.to_json()
    np.testing.assert_array_equal(port.data(), ref.data())
    assert port.size_bytes() == ref.size_bytes() == 24
    assert repr(port) == repr(ref)
    assert port == ref.a and not (port == ref.a + 1)
    for t in (ref, port):
        t.resize(2, 2)
    assert port.to_json() == ref.to_json()
    with pytest.raises(ValueError):
        port.resize(1, 1, 1, 1, 1)
    with pytest.raises(ValueError):
        pcon.tensor_f32(1, 1, 1, 1, 1)


def test_get_dimensions_nested():
    """JSON shape inference on nested and ragged text, as the
    reference's."""
    for text in ("[]", "[[]]", "[[[1, 2]], [[3, 4]]]", "[[1], [2, 3]]",
                 "5", "[[[[0]]]]", json.dumps(np.zeros((2, 0, 3)).tolist()),
                 '{"a": 1}'):
        assert pcon.get_dimensions(text) == rcon.get_dimensions(text), text


def test_array_of_tensors_equals_reference():
    """ArrayOfTensors: the same resize and indexing steps on both sides
    give equal JSON; from_json round-trips and equality follows the
    elements."""
    rng = np.random.default_rng(2)
    arrs = [mod.ArrayOfTensors(mod.tensor_i32, 2) for mod in (rten, pten)]
    vals = _values(np.int32, (3,), rng)
    for arr in arrs:
        arr[0].resize(3)
        arr[0].a[:] = vals
        arr.resize(4)
        arr[2].resize(2, 2)
        arr[2][1, 1] = 7
    assert arrs[1].to_json() == arrs[0].to_json()
    assert arrs[1].size() == len(arrs[1]) == 4
    other = pten.ArrayOfTensors(pten.tensor_i32)
    other.from_json(arrs[0].to_json())
    assert other == arrs[1] and other.to_json() == arrs[0].to_json()
    other[2][0, 0] = 8
    assert not (other == arrs[1])
    arrs[1].resize(1)
    assert arrs[1].size() == 1 and not (arrs[1] == other)
    f64 = [mod.ArrayOfTensors(mod.tensor_f64, 3) for mod in (rten, pten)]
    assert f64[1].to_json() == f64[0].to_json()


def _configs(mod):
    """A nested JsonSerializable with a Tensor field, an ndarray field, a
    renamed field and numpy scalars, from one containers module."""
    class Filter(mod.JsonSerializable):
        taps = mod.json_property(lambda: mod.tensor_f64(3))
        order = mod.json_property(2)

    class Cfg(mod.JsonSerializable):
        bps = mod.json_property(4)
        channels = mod.json_property(12, name="nr_channels")
        name = mod.json_property("xdelta_hzr")
        gains = mod.json_property(lambda: np.zeros(2, np.float32))
        rate = mod.json_property(np.float64(360.0))
        planes = mod.json_property(np.int32(3))
        filt = mod.json_property(Filter)
        sizes = mod.json_property((1, 2))

    return Cfg


def test_json_serializable_equals_reference():
    """The nested config's JSON text (compact and indented) equals the
    reference's; each side reads the other's text back."""
    cfgs = []
    for mod in (rcon, pcon):
        c = _configs(mod)(channels=3)
        c.filt.taps.a[:] = [0.25, -1.5, 3.125]
        c.gains = _values(np.float32, (2,), np.random.default_rng(3))
        cfgs.append(c)
    ref, port = cfgs
    assert port.to_json() == ref.to_json()
    assert port.to_json(indent=2) == ref.to_json(indent=2)
    back = _configs(pcon)(json_text=ref.to_json())
    assert back == port and back.to_json() == ref.to_json()
    assert back.channels == 3 and back.filt.taps.a.dtype == np.float64
    assert back.gains.dtype == np.float32
    rback = _configs(rcon)(json_text=port.to_json())
    assert rback.to_json() == port.to_json()
    assert _configs(pcon)() != port


def test_wrap_around_bytes_shares_memory():
    """wrap_around_bytes is a view of the caller's buffer: a write to the
    buffer shows in the tensor."""
    buf = bytearray(np.arange(12, dtype=np.int32).tobytes())
    t = pcon.Tensor.wrap_around_bytes(buf, (3, 4), np.int32)
    r = rcon.Tensor.wrap_around_bytes(buf, (3, 4), np.int32)
    assert t.a[2, 3] == 11 and t.to_json() == r.to_json()
    assert np.shares_memory(t.a, np.frombuffer(buf, np.uint8))
    buf[0:4] = (99).to_bytes(4, "little")
    assert t.a[0, 0] == 99


def test_to_torch(monkeypatch):
    """to_torch(device="cpu") is a copy with the values and dtype;
    to_torch() raises without a card."""
    rng = np.random.default_rng(4)
    for alias in ALIASES:
        _, port = _pair(alias, (2, 3), rng)
        t = port.to_torch(device="cpu")
        assert t.device.type == "cpu" and tuple(t.shape) == (2, 3)
        assert t.dtype == torch.from_numpy(port.a).dtype
        np.testing.assert_array_equal(t.numpy(), port.a)
        assert not np.shares_memory(t.numpy(), port.a)
    view = pcon.tensor_i32(4, 6).view(6, 4)
    view.a = view.a.T
    np.testing.assert_array_equal(view.to_torch("cpu").numpy(), view.a)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcon.tensor_f32(2).to_torch()


@pytest.mark.parametrize("nbytes,seconds", [(1_641_552, 0.0045),
                                            (0, 1.0), (7, 3e-9)])
def test_throughput_equals_reference(nbytes, seconds):
    assert pmet.throughput(nbytes, seconds) == rmet.throughput(nbytes,
                                                               seconds)
