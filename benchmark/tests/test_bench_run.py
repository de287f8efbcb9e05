"""A run of the harness without its look for a card, on the CPU at a
small size (the kernels' plain versions): the result's last line, the
control and each planted fault coming out not correct, and the modules
the harness loads."""

import argparse
import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness, manifest


CELLS = [w["name"] for w in json.loads(
    (manifest.BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


def small(root, cell):
    """The cell at a size the CPU's plain versions run in seconds."""
    c = manifest.resolve(root, cell)
    c.config = dict(c.config, records=2, samples=6000)
    c.mix = dict(c.mix, warm_jobs=1)
    return c


def runner_module(root, cell):
    return manifest.load("runners", manifest.resolve(root, cell).mix["runner"])


def args(seed=2 ** 31 + 77, seconds=0.5):
    return argparse.Namespace(seed=seed, seconds=seconds, trace=0)


@pytest.mark.parametrize("cell", CELLS)
def test_result_keys_and_correct(root, cell):
    c = small(root, cell)
    r = harness.measure(c, args(), torch.device("cpu"), {"platform": "cpu"})
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    r = harness.measure(small(root, cell), args(seed=4242),
                        torch.device("cpu"), {"platform": "cpu"},
                        runner_module(root, cell).CONTROL)
    assert r["correct"] is False


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in CELLS
    for fault in runner_module(manifest.BENCH.parent, cell).FAULTS])
def test_fault_under_the_timed_path_is_not_correct(root, cell, fault):
    r = harness.measure(small(root, cell), args(), torch.device("cpu"),
                        {"platform": "cpu"},
                        runner_module(root, cell).FAULTS[fault])
    assert r["correct"] is False


def test_forbidden_names_are_whole(monkeypatch):
    clean = {m: mod for m, mod in sys.modules.items()
             if m.split(".")[0] not in harness.FORBIDDEN}
    monkeypatch.setattr(sys, "modules", dict(clean))
    sys.modules["rspt_tpu_torch.probe"] = json
    sys.modules["jaxtyping"] = json
    assert harness.forbidden_modules() == []
    sys.modules["rspt_tpu.packers"] = json
    sys.modules["jax.numpy"] = json
    assert harness.forbidden_modules() == ["jax", "rspt_tpu"]


def test_harness_loads_no_jax(root):
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from benchmark import harness, manifest, calibrate\n"
        "spec = json.load(open(%r))\n"
        "for w in spec['workloads']:\n"
        "    c = manifest.resolve(harness.manifest.BENCH.parent, w['name'])\n"
        "    manifest.load('runners', c.mix['runner'])\n"
        "    [manifest.reader(m['name']) for m in c.per_layer]\n"
        "import benchmark.reference.qrs, rspt_tpu_torch.analysis.torch_peaks\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        % (str(root), str(root / "BENCHMARK.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=root)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "rspt_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "rspt_tpu"}


def test_no_result_without_the_port(root, tmp_path):
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "mitdb.qrs", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""
