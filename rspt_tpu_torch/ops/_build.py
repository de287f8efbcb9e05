"""Build the port's CUDA kernels (``ops/csrc/*.cu``) into one shared
library and load it with ctypes.

Each ``.cu`` file compiles to an object with its own ``nvcc`` process,
all started together, and the objects link into
``build/torch_kernels/<hash>/librspt_torch_kernels.so`` at the root of
the checkout. The hash covers every source and header and the flags, so
an edited kernel rebuilds and an unchanged one loads at once. The build
runs at first use (never on import): the first caller of a kernel on a
CUDA tensor pays it. ptxas's register and shared-memory report for each
kernel is kept beside the library as ``ptxas.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "librspt_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME / $CUDA_PATH, then $PATH, then the toolkit's
    default prefix."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    cus, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(out_dir: Path) -> Path:
    """Compile every source in parallel, link, and move the result into
    out_dir atomically (a concurrent build of the same hash wins
    harmlessly). Raises with nvcc's output if any step fails."""
    nvcc = find_nvcc()
    cus, _ = _sources()
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=out_dir.name + ".", dir=out_dir.parent))
    try:
        procs = []
        for cu in cus:
            obj = tmp / (cu.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(cu),
                   "-o", str(obj)]
            procs.append((cu, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cu, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {cu.name}\n{out}")
            if proc.returncode != 0:
                failed.append(cu.name)
        (tmp / "ptxas.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        try:
            os.replace(tmp, out_dir)
        except OSError:
            if not (out_dir / LIB_NAME).exists():
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return out_dir / LIB_NAME


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The kernels' library, built first if this source hash has none."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if not lib.exists():
        lib = build(out_dir)
    return ctypes.CDLL(str(lib))
