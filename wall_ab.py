"""Wall-time A/B of the port's packers between two checkouts on one card.

    python3 wall_ab.py DIR_A DIR_B [--rounds 6] [--calls 7]

Each round runs one process per checkout, in turns (A B, then B A), and
each process imports its checkout's rspt_tpu_torch and times, at
chip_smoke.py's shapes (BASELINE config 2's 12 x 34,199 ECG, config 3's
2^14 cut), the compress and host decompress of the hzr, xdelta_hzr (3
planes) and Hadamard packers, and decompress(device_decode=True) of
xdelta_hzr, and the batch detectors at chip_smoke phase 16's 12 x 2^20
float32 (`detect_batch`, and `detect_offline_batch`'s device part:
`offline_filters` and its three copies to the host): the median wall of
`calls` calls each, after one warm-up call, every call ended by a
synchronise. Prints each side's median over
the rounds with [min, max], the card's name and power limit, and one
JSON line of the medians. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def child(calls: int) -> None:
    """Time the packers of the checkout in the working directory."""
    sys.path.insert(0, str(Path.cwd()))
    import torch

    from chip_smoke import make_ecg, wall_times
    from rspt_tpu_torch import packers

    ch, ns, n3 = 12, 34199, 2 ** 14
    _, native = make_ecg(ch, ns)
    nat3 = native[:n3 * ch * 4]
    cases = {
        "hzr": (packers.new_hzr(4, ch, ns), None, native),
        "xdelta_hzr": (packers.new_xdelta_hzr(4, ch, ns, 3),
                       packers.new_xdelta_hzr(4, ch, ns, 3,
                                              device_decode=True), native),
        "hadamard": (packers.new_hadamard(4, ch, n3), None, nat3)}
    out = {}
    for name, (p, pdd, x) in cases.items():
        comp = p.compress(x)
        p.decompress(comp)
        torch.cuda.synchronize()
        out[f"{name} compress"] = statistics.median(
            wall_times(lambda: p.compress(x), calls))
        out[f"{name} decompress"] = statistics.median(
            wall_times(lambda: p.decompress(comp), calls))
        if pdd is not None:
            pdd.decompress(comp)
            out[f"{name} device-decode decompress"] = statistics.median(
                wall_times(lambda: pdd.decompress(comp), calls))
    from rspt_tpu_torch.analysis import torch_peaks
    sig, _ = make_ecg(ch, 1 << 20)
    xs = torch.from_numpy(sig.astype("float32")).cuda()

    def offline_device():
        moved, _, _, base = torch_peaks.offline_filters(xs, 360.0)
        moved.cpu(), xs.cpu().numpy().astype("float64"), base.cpu()

    for name, fn in (("detect_batch",
                      lambda: torch_peaks.detect_batch(xs, 360.0)),
                     ("detect_offline_batch device part", offline_device)):
        fn()
        torch.cuda.synchronize()
        out[name] = statistics.median(wall_times(fn, calls))
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--calls", type=int, default=7)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    if args.child:
        child(args.calls)
        return 0
    if len(args.dirs) != 2:
        ap.error("need two checkouts: DIR_A DIR_B")
    times = {d: {} for d in args.dirs}
    for r in range(args.rounds):
        order = args.dirs if r % 2 == 0 else args.dirs[::-1]
        for d in order:
            res = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--child",
                 "--calls", str(args.calls)],
                cwd=d, capture_output=True, text=True, check=True)
            for k, v in json.loads(res.stdout.splitlines()[-1]).items():
                times[d].setdefault(k, []).append(v)
    med = {}
    for d, ts in times.items():
        for k, v in ts.items():
            med[f"{d.name}: {k}"] = statistics.median(v)
            print(f"{d.name}: {k} {statistics.median(v):.5f} s "
                  f"[{min(v):.5f}, {max(v):.5f}] over {len(v)} rounds")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"wall_ab_s": med, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
