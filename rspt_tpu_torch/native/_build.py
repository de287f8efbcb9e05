"""Build the port's host runtime (``native/rspt_torch_native.cpp``) with
g++ and load it with ctypes.

The library goes to
``build/torch_native/<hash>/librspt_torch_native.so`` at the root of
the checkout. The hash covers the source and the flags, so an edited
source rebuilds and an unchanged one loads at once. The build runs at
first use (never on import), in a temporary directory that is moved
into place atomically, so processes that build at once do no harm. No
``-march=native``: the hash cannot see the machine, and the CRC picks
its instruction at run time. A failed build raises with g++'s output.
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

SRC = Path(__file__).resolve().with_name("rspt_torch_native.cpp")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_native"
LIB_NAME = "librspt_torch_native.so"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-fPIC", "-shared",
             "-pthread")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return h.hexdigest()[:16]


def build(out_dir: Path, cxx: str = CXX) -> Path:
    """Compile the source into out_dir (a concurrent build of the same
    hash wins harmlessly). Raises RuntimeError with the compiler's
    output if it fails or cannot be run."""
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=out_dir.name + ".", dir=out_dir.parent))
    try:
        try:
            r = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o",
                                str(tmp / LIB_NAME)],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            raise RuntimeError(f"{cxx} could not be run: {e}") from e
        if r.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SRC.name}:\n{r.stdout}")
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
    """The runtime's library, built first if this source hash has none."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if not lib.exists():
        lib = build(out_dir, CXX)
    return ctypes.CDLL(str(lib))
