"""Design A/B of two of the port's CUDA kernels on one card.

    python3 kernel_ab.py [--rounds 3]

Builds variants of ops/csrc/compact.cu and ops/csrc/place_literals.cu,
each the committed source with some of its tile constants (or one
line) replaced, into one shared library apiece (nvcc, sm_90a, all at
once), and times each variant's kernel at the main path's shapes (the
chip_smoke inputs: BASELINE config 2's pass 1 for compact_tokens, its
device decode's emissions for place_literals) beside the library call
that computes the same function, in turns, by torch.profiler device
time (median of 30 launches a round; medians over the rounds printed).
Variants marked "diag" drop work (their output is not the function's)
to show what the rest costs; every other variant is first checked bit
for bit against the plain version. Prints the card's name and power
limit and one JSON line of the medians. Needs a CUDA card and nvcc;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "rspt_tpu_torch" / "ops" / "csrc"

COMPACT = {   # name: (replacements, diag)
    "tile4096_t512": ({}, False),
    "tile4096_t256": ({"kThreads = 512;": "kThreads = 256;",
                       "kRounds = 8;": "kRounds = 16;"}, False),
    "tile2048_t256": ({"kThreads = 512;": "kThreads = 256;"}, False),
    "tile4096_t1024": ({"kThreads = 512;": "kThreads = 1024;",
                        "kRounds = 8;": "kRounds = 4;"}, False),
    "tile8192_t512": ({"kRounds = 8;": "kRounds = 16;"}, False),
}
# a lane's kSub threads on neighbouring threads of a warp instead of in
# kSub different warps
_ADJ = {"  const int lane = threadIdx.x % kLanes;\n"
        "  const int r0 = threadIdx.x / kLanes * kRows;":
        "  const int lane = threadIdx.x / kSub;\n"
        "  const int r0 = threadIdx.x % kSub * kRows;"}
PLACE = {
    "chunk16_sub2_split16": ({}, False),
    "chunk16_sub1_split16": ({"kSub = 2;": "kSub = 1;"}, False),
    "chunk8_sub1_split32": ({"kChunk = 16;": "kChunk = 8;",
                             "kSplit = 16;": "kSplit = 32;",
                             "kSub = 2;": "kSub = 1;"}, False),
    "chunk8_sub2_split32": ({"kChunk = 16;": "kChunk = 8;",
                             "kSplit = 16;": "kSplit = 32;"}, False),
    "chunk16_sub2_split8": ({"kSplit = 16;": "kSplit = 8;"}, False),
    "chunk32_sub2_split8": ({"kChunk = 16;": "kChunk = 32;",
                             "kSplit = 16;": "kSplit = 8;"}, False),
    "chunk32_sub4_split8": ({"kChunk = 16;": "kChunk = 32;",
                             "kSplit = 16;": "kSplit = 8;",
                             "kSub = 2;": "kSub = 4;"}, False),
    "chunk16_sub2_split16_lanes64": ({"kLanes = 128;": "kLanes = 64;"},
                                     False),
    "diag_no_walk": ({"    if (live) {": "    if (live && n < 0) {"}, True),
    "diag_no_stores": ({
        "    atomicOr(words + w, bits);":
        "    if (bits == 0x5a5a5a5au) atomicOr(words + w, bits);",
        "        if (flush && !first) words[cur] = bits;":
        "        if (flush && !first && bits == 0x5a5a5a5au) words[cur] = bits;"},
        True),
}


def variant_source(src: str, repl: dict) -> str:
    for old, new in repl.items():
        if src.count(old) != 1:
            raise ValueError(f"variant text not found once: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(kernels, out_dir: Path):
    """{(kernel, variant): ctypes library}, every variant compiled by its
    own nvcc, all started together."""
    from rspt_tpu_torch.ops import _build
    nvcc = _build.find_nvcc()
    procs = {}
    for cu, variants in kernels.items():
        src = (CSRC / cu).read_text()
        for name, (repl, _) in variants.items():
            path = out_dir / f"{Path(cu).stem}_{name}.cu"
            path.write_text(variant_source(src, repl))
            lib = path.with_suffix(".so")
            cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(CSRC), "-shared",
                   "-o", str(lib), str(path)]
            procs[(cu, name)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{out}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from rspt_tpu_torch import packers
    from rspt_tpu_torch.hzr import gpu_decoder as gd
    from rspt_tpu_torch.hzr import torch_coder as tc
    from rspt_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    stream = torch.cuda.current_stream().cuda_stream
    ch, ns = 12, 34199
    _, native = cs.make_ecg(ch, ns)
    words = torch.from_numpy(np.frombuffer(native, "<i4").copy()).to(dev)
    x = cs.kernel_inputs(ck, tc, words, ns, ch, 3)
    tokw, bases, T = x["tokw"], x["bases"], x["plan"].T
    huff = torch.from_numpy(x["plan"].ntok > 0).to(dev)
    tok_huff = tokw[huff]
    valid_huff = ((tok_huff >> 27) & 1) != 0
    p = packers.new_xdelta_hzr(4, ch, ns, 3)
    comp = p.compress(native)
    _, streams, _ = p._streams(comp, p.nr_planes, 0)
    la, dargs, total, _ = cs.decode_inputs(gd, streams, dev)
    emis, counts, _, stats = ck.hzr_decode(*dargs)
    steps, base, limit, live = cs.place_inputs(gd, la, counts, stats, dev)
    nt, S = emis.shape[:2]
    # the library yardstick: one index_put_ of the pre-masked literals
    em = emis.reshape(nt, -1, 1024)
    s_ix = torch.arange(em.shape[1], device=dev)[None, :, None]
    e_pos = base.reshape(nt, 1, 1024).long() + (em >> 9)
    lit = ((s_ix < steps.reshape(-1, 1, 1)) & ((em & 0x1FF) != 0)
           & live.reshape(nt, 1, 1024) & (e_pos < limit.reshape(nt, 1, 1024)))
    lit_pos, lit_val = e_pos[lit], (em[lit] & 0xFF).to(torch.uint8)
    lib_out = torch.zeros(total, dtype=torch.uint8, device=dev)

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        libs = build_variants({"compact.cu": COMPACT,
                               "place_literals.cu": PLACE}, Path(tmp))
        P, I = ctypes.c_void_p, ctypes.c_int
        for (cu, _), lib in libs.items():
            if cu == "compact.cu":
                lib.rspt_compact_tiles.argtypes = [I]
                lib.rspt_compact_tiles.restype = I
                lib.rspt_compact_tokens.argtypes = [P] * 4 + [I] * 4 + [P]
                lib.rspt_compact_tokens.restype = I
            else:
                lib.rspt_place_literals.argtypes = [P] * 6 + [I] * 3 + [P]
                lib.rspt_place_literals.restype = I

        def compact(lib):
            nstate = 1 + tokw.shape[0] * lib.rspt_compact_tiles(tokw.shape[1])
            buf = torch.zeros(T + nstate, dtype=torch.int32, device=dev)
            err = lib.rspt_compact_tokens(
                tokw.data_ptr(), bases.data_ptr(), buf.data_ptr(),
                buf[T:].data_ptr(), tokw.shape[0], tokw.shape[1], T, 0,
                stream)
            assert err == 0, err
            return buf[:T]

        def place(lib):
            out = torch.zeros(total, dtype=torch.uint8, device=dev)
            err = lib.rspt_place_literals(
                emis.data_ptr(), steps.data_ptr(), base.data_ptr(),
                limit.data_ptr(), live.data_ptr(), out.data_ptr(), nt, S,
                total, stream)
            assert err == 0, err
            return out

        runs = {}   # name: (fn, profiler kernel name or None)
        want_c = ck.compact_tokens_plain(tokw, bases, T)
        want_p = ck.place_literals_plain(
            emis, steps, base, limit, live,
            torch.zeros(total, dtype=torch.uint8, device=dev))
        for (cu, name), lib in libs.items():
            kind, fn, want, table = (
                ("compact_tokens", compact, want_c, COMPACT)
                if cu == "compact.cu" else
                ("place_literals", place, want_p, PLACE))
            run = (lambda fn=fn, lib=lib: fn(lib))
            if not table[name][1]:
                cs.equal(f"{kind}/{name}", run(), want)
            runs[f"{kind}/{name}"] = (run, kind + "_kernel")
        runs["compact_tokens/library masked_select"] = (
            lambda: torch.masked_select(tok_huff, valid_huff), None)
        runs["place_literals/library index_put_"] = (
            lambda: lib_out.index_put_((lit_pos,), lit_val), None)
        torch.cuda.synchronize()
        times = {name: [] for name in runs}
        for _ in range(args.rounds):
            for name, (fn, kname) in runs.items():
                times[name].append(cs.device_ms(fn, kernel=kname)
                                   or cs.cuda_ms(fn))
    med = {name: statistics.median(ts) for name, ts in times.items()}
    for name, ts in times.items():
        print(f"{name}: median {med[name]:.6f} ms, rounds "
              f"{[round(t, 6) for t in ts]}", flush=True)
    print(smi)
    print(json.dumps({"kernel_ab_ms": med, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
