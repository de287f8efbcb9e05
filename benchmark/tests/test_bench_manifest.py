"""BENCHMARK.json keeps to its contract's shapes, and every cell finds its
configuration, mix, runner and metric readers by name."""

import json
import re

import pytest

from benchmark import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def spec(root):
    return json.loads((root / "BENCHMARK.json").read_text())


def test_top_level_keys(root):
    s = spec(root)
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)
    for p in s["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert (root / p).is_dir() and not p.endswith("_torch")
    assert (root / s["command"][1]).is_file()
    assert len((root / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys(root):
    s = spec(root)
    names = ([c["name"] for c in s["configs"]]
             + [w["name"] for w in s["workloads"]]
             + [m["name"] for m in s["end_to_end"] + s["per_layer"]])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in s[group]]
        assert len(got) == len(set(got)), group
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in s["end_to_end"]}
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (manifest.BENCH.parent / "BENCHMARK.json").read_text())["workloads"]])
def test_cell_resolves(root, cell):
    c = manifest.resolve(root, cell)
    assert c.config and c.mix
    assert hasattr(manifest.load("runners", c.mix["runner"]), "Runner")
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported
        assert callable(manifest.reader(m["name"]).read)


def test_unknown_cell_raises(root):
    with pytest.raises(LookupError):
        manifest.resolve(root, "no.such-cell")


def test_reader_by_whole_name_then_by_stem():
    assert manifest.reader("iir_assoc_roofline").__name__.endswith(
        "iir_assoc_roofline")
    assert manifest.reader("device_idle_pct.some-cell").__name__.endswith(
        "device_idle_pct")
    with pytest.raises(LookupError):
        manifest.reader("no_such_metric.qrs")
