"""The readings a cell's limits are set from, on the card at the cell's
own size, all in one process:

    python3 benchmark/calibrate.py --workload mitdb.qrs \\
        --seeds 12 --control-seeds 3 --fault-seeds 3 [--seconds 1] [--out FILE]

Each reading is a whole run of the harness (harness.measure: set-up from
the seed, a window of ``--seconds``, the check), on a seed of its own:
``--seeds`` runs of the program as it is (the lower end of a limit);
``--control-seeds`` runs with the runner's CONTROL (the reference in the
next lower precision) put in the program's place (the upper end); and,
on ``--fault-seeds`` seeds, a run with each of the runner's FAULTS
planted under the timed path. Every control and fault run has to come
out not correct; the script exits 1 where one does not. One JSON line a
reading; with --out the whole list as JSON too. The benchmark's own runs
never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

from benchmark import manifest  # noqa: E402  (json only: no torch yet)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--out")
    a = p.parse_args(argv)
    manifest.hold_threads()
    import torch

    from benchmark import harness
    cell = manifest.resolve(ROOT, a.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    mod = manifest.load("runners", cell.mix["runner"])
    rows, sound = [], True
    seeds = iter(a.first_seed + 7919 * i for i in range(1 << 20))

    def reading(kind, plant=None, **kw):
        nonlocal sound
        seed = next(seeds)
        t0 = time.perf_counter()
        r = harness.measure(cell, argparse.Namespace(
            seed=seed, seconds=a.seconds, trace=0), dev, harness.card(0),
            plant)
        gc.unfreeze()
        gc.collect()
        torch.cuda.empty_cache()
        if kind != "program" and r["correct"]:
            sound = False
        kw.update(kind=kind, seed=seed, correct=r["correct"],
                  attempted=r["attempted"], checks=r["checks"],
                  seconds=time.perf_counter() - t0, device=r["device"],
                  cell=a.workload)
        rows.append(kw)
        print(json.dumps(kw), flush=True)

    for _ in range(a.seeds):
        reading("program")
    for _ in range(a.control_seeds):
        reading("control", mod.CONTROL)
    for _ in range(a.fault_seeds):
        for name, plant in mod.FAULTS.items():
            reading("fault", plant, fault=name)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(rows, indent=1))
    if not sound:
        print("calibrate: a control or fault run came out correct",
              file=sys.stderr)
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
