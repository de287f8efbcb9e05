"""The benchmark's run of one cell: set-up, the measured window (or the
traced one), the check of what the timed path produced, and the result.

A run
1. exits 2, printing no result, without the port in the checkout or
   without as many CUDA cards as the cell asks for: it never falls back to
   the CPU;
2. builds the mix's runner (benchmark/runners/<runner>.py), which makes
   its inputs from --seed on the card and warms every shape the window
   takes, then collects and freezes the garbage collector's objects so
   that no collection of set-up's falls in the window; ``setup_s`` runs
   from the process's start to the end of that;
3. with --trace 0 runs the runner's steps, one after another (a closed
   loop), for --seconds, and reports the cell's end-to-end metrics; with
   --trace 1 traces the mix's ``trace_seconds`` of steps (benchmark/
   trace.py) and reports the cell's per-layer metrics, each read by its
   reader (manifest.reader), with the device's busy time, the window and
   a breakdown;
4. reads the card's memory peak, then has the runner free the program's
   state and compare what the timed steps produced with the plain
   reference (benchmark/reference/): each number beside its limit, on
   standard error last and under ``checks``, the last key of the result;
5. exits 4, printing no result, if jax, jaxlib, flax or the JAX package
   was loaded by then (top-level module names compared whole);
6. prints the result as the last line of standard output.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

from . import manifest, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "rspt_tpu")
PORT = "rspt_tpu_torch"


def process_seconds() -> float:
    """Seconds since this process started (Linux: /proc/self/stat's start
    time against /proc/uptime)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card(index: int = 0) -> dict:
    """The card's name and power limit (nvidia-smi), as every result
    names them."""
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(index)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index),
             "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


def _fail(msg: str, code: int) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def run(cell: manifest.Cell, args) -> int:
    chips = int(cell.workload["chips"])
    if importlib.util.find_spec(PORT) is None:
        return _fail(f"the port ({PORT}) is not in this checkout", 2)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return _fail(f"{cell.name} needs {chips} CUDA card(s), found {n}; "
                     "no CPU fallback", 2)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result = measure(cell, args, dev, card(0))
    found = forbidden_modules()
    if found:
        return _fail(f"modules loaded that the benchmark may not load: "
                     f"{found}", 4)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(cell: manifest.Cell, args, dev: torch.device, device: dict,
            plant=None) -> dict:
    """Steps 2-4 on ``dev``: the result, without printing it. ``plant``,
    where given, is put under the timed path once set-up is done: it
    takes the runner's ``entry`` and returns the one the window calls (the
    control and the faults that benchmark/calibrate.py and the tests run
    through a whole run)."""
    mix = cell.mix
    torch.set_num_threads(manifest.THREADS)
    runner = manifest.load("runners", mix["runner"]).Runner(
        cell.config, mix, args.seed, dev)
    if plant is not None:
        runner.entry = plant(runner.entry)
    _sync(dev)
    gc.collect()
    gc.freeze()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = process_seconds()

    metrics, extra = {}, {}
    before = runner.attempted
    if args.trace:
        tr = trace.traced(runner.step, float(mix["trace_seconds"]),
                          runner.reset_counters, runner.counters)
        view = RunView(cell, tr)
        for m in cell.per_layer:
            value = manifest.reader(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        extra["breakdown"] = {"device_ops": tr.top_ops(10),
                              "idle_gaps": tr.idle_gaps(10)}
    else:
        runner.reset_counters()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            runner.step()
        elapsed = time.perf_counter() - t0
        values = dict(runner.end_to_end(elapsed), setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    attempted = runner.attempted - before
    _sync(dev)
    device.update(count=int(cell.workload["chips"]),
                  memory_peak_bytes=(torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else 0))

    checks = runner.check()
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": attempted,
              "failed": runner.failed, "metrics": metrics, "device": device}
    result.update(extra)
    result["checks"] = checks
    return result


class RunView:
    """What a per-layer metric's reader sees: the cell, its configuration
    and mix, and the kept trace with the runner's counters of it."""

    def __init__(self, cell: manifest.Cell, tr: trace.Trace):
        self.cell, self.config, self.mix = cell, cell.config, cell.mix
        self.trace = tr
        self.counters = tr.counters
        self.steps = tr.steps
