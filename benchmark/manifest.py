"""BENCHMARK.json and the files it names, read with json alone (run.py
sets the host's thread settings before torch is imported).

A cell is one entry of ``workloads``. Its configuration is the file that
the ``configs`` entry names; its traffic mix is
``benchmark/mixes/<traffic>.json``, whose ``runner`` names
``benchmark/runners/<runner>.py``; each per-layer metric is read by
``benchmark/metrics/<metric name>.py``, or, where there is no such file,
by the reader of the name before its first dot (``device_idle_pct.qrs``
by ``device_idle_pct.py``), which serves the metric in every cell. A cell reports the end-to-end
metrics that list it (or list no cells) and the per-layer metrics that
list it (or list no cells and move an end-to-end metric it reports).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import List

BENCH = Path(__file__).resolve().parent
# Host threads of torch, OpenMP, MKL and OpenBLAS in a run: the run's own
# host work (torch's host ops, the check's numpy) is small, and one thread
# keeps it from competing with the program's host threads (the steadiest
# setting of the thread study in PERF.md).
THREADS = 1


def hold_threads() -> None:
    """Hold the host's thread pools to THREADS: call before torch or
    numpy is imported (the harness sets torch's own count again)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(root: Path, workload: str) -> Cell:
    """The cell named ``workload`` with its files loaded; raises
    LookupError for a name BENCHMARK.json does not hold."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise LookupError(f"no workload {workload!r} in BENCHMARK.json; "
                          f"there are {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((BENCH / "mixes" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(workload, w, config, mix, e2e, per_layer)


def load(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {kind} file {path.name} under benchmark/")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The module whose ``read(run)`` gives the per-layer ``metric``."""
    if (BENCH / "metrics" / f"{metric}.py").is_file():
        return load("metrics", metric)
    return load("metrics", metric.split(".", 1)[0])
