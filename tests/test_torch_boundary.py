"""The port's boundaries: what importing it loads, what its entry
points do without a card, and that chip_smoke.py refuses to report
without one."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)

from rspt_tpu_torch import packers as gpack  # noqa: E402
from rspt_tpu_torch import pipeline as gpipe  # noqa: E402
from rspt_tpu_torch.hzr import gpu_decoder, torch_coder  # noqa: E402
from rspt_tpu_torch.native import _build as native_build  # noqa: E402
from rspt_tpu_torch.native import bindings as native  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_neither_jax_nor_rspt_tpu():
    """The port's modules import no jax and nothing of rspt_tpu, nor do a
    stream encode (pack_blocks' plain version), a DCT compress, a
    filtered streaming push (compress_many), both batch peak detectors,
    a FIR, the rolling medians, and a sharded encode and decode on 4 CPU
    shards through them."""
    code = (
        "import sys\n"
        "import rspt_tpu_torch\n"
        "from rspt_tpu_torch.packers import gpu\n"
        "from rspt_tpu_torch.hzr import gpu_decoder, pyref, sidecar, "
        "torch_coder, walk\n"
        "from rspt_tpu_torch.ops import _build, cuda_kernels, torch_ops\n"
        "from rspt_tpu_torch.formats import crc32c, hzr_constants\n"
        "from rspt_tpu_torch.native import _build as native_build, "
        "bindings\n"
        "from rspt_tpu_torch.utils import metrics\n"
        "from rspt_tpu_torch import filters, io, pipeline\n"
        "from rspt_tpu_torch.filters import design, streaming\n"
        "from rspt_tpu_torch.io import ring\n"
        "cfg = pipeline.StreamConfig(2, 2, 64, filter_coeffs=("
        "[1.0, -0.5], [0.5, 0.5]))\n"
        "c = pipeline.StreamingCodec(cfg, device='cpu')\n"
        "assert len(c.push(bytes(2 * 2 * 64 * 3))) == 3\n"
        "from rspt_tpu_torch.packers import GpuDctPacker, new_dct\n"
        "assert len(new_dct(4, 2, 3, device='cpu').compress(bytes(24))) > 7\n"
        "assert torch_coder.encode(b'ab' * 99, device='cpu')[:4] == "
        "(198).to_bytes(4, 'little')\n"
        "import numpy as np\n"
        "from rspt_tpu_torch import analysis\n"
        "from rspt_tpu_torch.analysis import peaks, rolling_median, "
        "torch_peaks\n"
        "from rspt_tpu_torch.filters import torch_filters\n"
        "x = np.sin(np.arange(800) / 9.0) ** 8 * 500\n"
        "assert analysis.detect_batch(x, 360.0, device='cpu')[0].shape == "
        "(800,)\n"
        "assert len(analysis.detect_offline_batch(x[None], 360.0, "
        "return_indexes=True, device='cpu')[3]) == 1\n"
        "assert torch_filters.fir_apply(x, [0.5, 0.5], device='cpu')[0]"
        ".shape == (800,)\n"
        "assert float(analysis.torch_rolling_median_large(x, 40, 8, "
        "device='cpu')[-1]) == float(np.float32(analysis.rolling_median("
        "x.astype(np.float32), 40)[-1]))\n"
        "from rspt_tpu_torch.parallel import ShardedHzrDecoder, "
        "ShardedHzrEncoder, make_mesh, make_sharded_scans, mesh, scans\n"
        "m = make_mesh(['cpu'] * 4)\n"
        "data = np.random.default_rng(0).integers(0, 9, 150000)"
        ".astype(np.uint8).tobytes()\n"
        "st = ShardedHzrEncoder(m).encode(data)\n"
        "assert st == torch_coder.encode(data, device='cpu')\n"
        "assert ShardedHzrDecoder(m).decode_many([st]) == [data]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'rspt_tpu' or m.startswith('rspt_tpu.')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_sources_import_neither_jax_nor_rspt_tpu():
    """No module of the port, not chip_smoke.py, not the card tests'
    module it takes its edge inputs from and not kernel_ab.py or
    wall_ab.py names jax or rspt_tpu in an import statement (a lazy
    import inside a function included)."""
    bad_import = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|rspt_tpu)(?![\w])", re.M)
    files = [os.path.join(REPO, n) for n in (
        "chip_smoke.py", "kernel_ab.py", "wall_ab.py",
        os.path.join("tests", "test_torch_cuda.py"))]
    for root, _, names in os.walk(os.path.join(REPO, "rspt_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            hits = bad_import.findall(f.read())
        assert not hits, (path, hits)


def test_default_device_raises_without_card(monkeypatch):
    """No device argument and no card: the factory raises, it does not
    fall back to the CPU; so does make_mesh() with no devices named."""
    from rspt_tpu_torch.parallel import make_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert make_mesh(["cpu"] * 2).devices == [torch.device("cpu")] * 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpack.new_xdelta_hzr(4, 2, 100, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpack.new_xdelta_hzr(4, 2, 100, 3, device_decode=True)
    for make in (gpack.new_hzr, gpack.new_hadamard, gpack.new_dct):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(4, 2, 128)
        assert make(4, 2, 128, device="cpu").device.type == "cpu"
    assert gpack.new_xdelta_hzr(4, 2, 100, 3, device="cpu").nr_planes == 3


def test_streaming_raises_without_card(monkeypatch):
    """StreamingCodec and StreamingDecoder with no device and no card
    raise; with device="cpu" they run on the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gpipe.StreamConfig(4, 2, 100)
    for make in (gpipe.StreamingCodec, gpipe.StreamingDecoder):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(cfg)
        assert make(cfg, device="cpu").packer.device.type == "cpu"


def test_signal_ops_raise_without_card(monkeypatch):
    """The batch signal ops with no device and no card raise; with
    device="cpu" they run on the plain versions."""
    from rspt_tpu_torch import analysis
    from rspt_tpu_torch.filters import torch_filters as tf
    x = np.sin(np.arange(500) / 9.0) ** 8 * 500
    calls = {
        "iir_apply": lambda **kw: tf.iir_apply(x, [1.0, -0.5], [0.5, 0.5],
                                               **kw),
        "fir_apply": lambda **kw: tf.fir_apply(x, [0.5, 0.5], **kw),
        "iir_warmup_state": lambda **kw: tf.iir_warmup_state(
            x[:2], [1.0, -0.5], [0.5, 0.5], 100, **kw),
        "detect_batch": lambda **kw: analysis.detect_batch(x, 360.0, **kw),
        "detect_offline_batch": lambda **kw: analysis.detect_offline_batch(
            x, 360.0, **kw),
        "torch_rolling_median": lambda **kw: analysis.torch_rolling_median(
            x, 5, **kw),
        "torch_rolling_median_large":
            lambda **kw: analysis.torch_rolling_median_large(x, 40, 8, **kw),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        assert call(device="cpu") is not None, name


def test_decoder_raises_without_card(monkeypatch):
    """gpu_decoder.decode_many with no device and no card raises; with
    device="cpu" it decodes on the plain versions."""
    stream = torch_coder.encode(b"\x01\x02" * 50, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpu_decoder.decode_many([stream])
    assert gpu_decoder.decode_many([stream], device="cpu") == [b"\x01\x02" * 50]


def test_encode_raises_without_card(monkeypatch):
    """torch_coder.encode with no device and no card raises; with
    device="cpu" it encodes on the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_coder.encode(b"\x01\x02" * 50)
    assert len(torch_coder.encode(b"", device="cpu")) == 4


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """chip_smoke.py exits nonzero and prints no result line with no
    visible card, and alone in a directory without the repo."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_runtime_loaded_is_the_ports():
    """A process that compresses and decompresses through the port (host
    and device decode, on the CPU) has the port's runtime library mapped
    and not the reference's."""
    code = (
        "import numpy as np\n"
        "from rspt_tpu_torch import packers\n"
        "nat = np.arange(3000, dtype='<i4').tobytes()\n"
        "p = packers.new_xdelta_hzr(4, 3, 1000, 3, device='cpu')\n"
        "c = p.compress(nat)\n"
        "assert p.decompress(c)[0] == nat\n"
        "d = packers.new_xdelta_hzr(4, 3, 1000, 3, device='cpu', "
        "device_decode=True)\n"
        "assert d.decompress(c)[0] == nat\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'librspt_torch_native.so' in maps\n"
        "assert 'librspt_native.so' not in maps\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_native_engine_process_loads_neither_jax_nor_reference_runtime():
    """A process that compresses and decompresses through every packer of
    engine="native" (hzr and LZ4 planes) and pushes a span through the
    fused streaming route has the port's runtime mapped and not the
    reference's, imports no jax and nothing of rspt_tpu, and never
    initialises CUDA."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch\n"
        "from rspt_tpu_torch import packers, pipeline\n"
        "nat = np.arange(3 * 256, dtype='<i4').tobytes()\n"
        "for be in ('hzr', 'lz4'):\n"
        "    for p in (packers.new_xdelta_hzr(4, 3, 256, 1, engine='native',"
        " plane_backend=be),\n"
        "              packers.new_hzr(4, 3, 256, engine='native', "
        "plane_backend=be),\n"
        "              packers.new_dct(4, 3, 256, engine='native', "
        "plane_backend=be),\n"
        "              packers.new_hadamard(4, 3, 256, engine='native', "
        "plane_backend=be)):\n"
        "        c = p.compress(nat)\n"
        "        assert len(p.decompress(c)[0]) == len(nat)\n"
        "cfg = pipeline.StreamConfig(2, 2, 64, filter_coeffs=("
        "[1.0, -0.5], [0.5, 0.5]))\n"
        "codec = pipeline.StreamingCodec(cfg, packer=packers.new_xdelta_hzr("
        "2, 2, 64, 3, engine='native'))\n"
        "assert len(codec.push(bytes(2 * 2 * 64 * 3))) == 3\n"
        "assert codec.stage_seconds.keys() == {'span'}\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'librspt_torch_native.so' in maps\n"
        "assert 'librspt_native.so' not in maps\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'rspt_tpu' or m.startswith('rspt_tpu.')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_runtime_build_failure_raises(tmp_path, monkeypatch, compiler):
    """A build in a fresh directory with a compiler that is not there, or
    that fails, raises RuntimeError: from build() and from the first
    load."""
    cxx = {"missing": str(tmp_path / "no-such-g++"),
           "failing": shutil.which("false") or "/bin/false"}[compiler]
    with pytest.raises(RuntimeError):
        native_build.build(tmp_path / "direct", cxx)
    monkeypatch.setattr(native_build, "BUILD_ROOT", tmp_path / "root")
    monkeypatch.setattr(native_build, "CXX", cxx)
    native_build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError):
            native_build.load_library()
    finally:
        native_build.load_library.cache_clear()
    assert not list((tmp_path / "root").glob("*/*.so"))


SIGNAL_KERNELS = ("iir_scan", "iir_assoc", "fir_apply", "peak_gate")


@pytest.mark.parametrize("path", ["compress", "decompress", "device_decode",
                                  "encode", "compress_many", "stream",
                                  *SIGNAL_KERNELS])
def test_no_python_fallback(monkeypatch, path):
    """When the runtime cannot be had, the main path raises: no entry
    point falls back to the Python versions (the streaming codec's IIR
    neither: its push raises before the packer runs). Nor does a batch
    signal kernel's wrapper given a tensor it takes for a card's when the
    kernels' library cannot be had: it raises, and its plain version is
    never called."""
    if path in SIGNAL_KERNELS:
        from rspt_tpu_torch.ops import cuda_kernels as ck
        x = torch.ones((2, 64))
        z = torch.zeros((2, 2))
        args = {"iir_scan": (x, [1.0, -0.5, 0.1], [0.5, 0.5, 0.1], z, z),
                "iir_assoc": (x, [1.0, -0.5, 0.1], [0.5, 0.5, 0.1], z, z,
                              16),
                "fir_apply": (x, torch.ones(3), None),
                "peak_gate": (x, x, 36, 0.9, 1.0)}[path]

        def no_library():
            raise RuntimeError("kernels unavailable")

        def no_plain(*a, **kw):
            raise AssertionError("plain version called")

        monkeypatch.setattr(ck, "_on_cuda", lambda *t: True)
        monkeypatch.setattr(ck, "_lib", no_library)
        monkeypatch.setattr(ck, path + "_plain", no_plain)
        with pytest.raises(RuntimeError, match="kernels unavailable"):
            getattr(ck, path)(*args)
        return
    nat = np.arange(3000, dtype="<i4").tobytes()
    p = gpack.new_xdelta_hzr(4, 3, 1000, 3, device="cpu",
                             device_decode=path == "device_decode")
    comp = p.compress(nat) if path not in ("compress",
                                           "compress_many") else None
    codec = gpipe.StreamingCodec(gpipe.StreamConfig(
        4, 3, 1000, filter_coeffs=([1.0, -0.5], [0.5, 0.5])), packer=p)

    def unavailable():
        raise RuntimeError("runtime unavailable")

    monkeypatch.setattr(native, "_lib", unavailable)
    with pytest.raises(RuntimeError, match="runtime unavailable"):
        if path == "compress":
            p.compress(nat)
        elif path == "compress_many":
            p.compress_many([nat, nat])
        elif path == "stream":
            codec.push(nat)
        elif path == "encode":
            torch_coder.encode(nat, device="cpu")
        else:
            p.decompress(comp)
