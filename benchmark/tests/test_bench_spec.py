"""Every piece of the benchmark is found by its name, and BENCHMARK.json
agrees with the files it names."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import spec, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", spec.names("workloads"))
def test_workload_loads_by_name(name):
    c = spec.cell(name)
    assert c["chips"] in (1, 4)
    assert c["traffic_mix"]["kind"] in traffic.E2E
    from benchmark.harness import serve, train

    judged = train if c["traffic_mix"]["kind"] == "train" else serve
    assert c["check"]["limits"] and set(c["check"]["limits"]) <= set(
        judged.NUMBERS)


@pytest.mark.parametrize("name", spec.names("configs"))
def test_config_loads_by_name(name):
    c = spec.config(name)
    assert {"source", "reduced", "assumed", "config"} <= set(c)


@pytest.mark.parametrize("name", spec.names("metrics"))
def test_metric_loads_by_name(name):
    m = spec.metric(name)
    assert m.SOURCE in ("device_trace", "program_span", "program_counter",
                        "host_clock")
    assert m.MOVES in traffic.E2E.values()
    assert m.read({}) is None          # nothing to read: no number


def test_benchmark_json_names_the_files():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert set(cells) <= set(spec.names("workloads"))
    for name, w in cells.items():
        f = spec.cell(name)
        assert (f["config"], f["traffic"], f["chips"], f["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
    for c in BENCH["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        mod = spec.metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"])
        for w in m["workloads"]:
            kind = spec.cell(w)["traffic_mix"]["kind"]
            assert traffic.E2E[kind] == m["moves"]
            assert w in e2e[m["moves"]].get("workloads", [w])


def test_a_new_cell_is_a_new_file(tmp_path):
    """A workload file added to a copy is listed and loads, no code
    edited."""
    copy = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", copy,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    src = json.loads((copy / "workloads" / "word-resnet50.synth-bulk.json")
                     .read_text())
    (copy / "workloads" / "word-resnet50.synth-small.json").write_text(
        json.dumps(dict(src, why="a new cell")))
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from benchmark.harness import spec;"
            "print(spec.names('workloads'));"
            "print(spec.cell('word-resnet50.synth-small')['why'])")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, check=True).stdout
    assert "word-resnet50.synth-small" in out and "a new cell" in out


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_per_layer_readers_follow_benchmark_json(name):
    """A cell reads exactly the per-layer metrics whose entry lists it."""
    c = spec.cell(name)
    e2e = traffic.E2E[c["traffic_mix"]["kind"]]
    want = {m["name"] for m in BENCH["per_layer"]
            if name in m.get("workloads", [name]) and m["moves"] == e2e}
    assert set(spec.metrics_of(name, e2e)) == want and want
