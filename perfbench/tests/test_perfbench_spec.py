"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""

import json
import re
import shutil

import pytest

from perfbench import spec
from _perfbench_tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        moved = e2e[m["moves"]]
        for c in m.get("workloads", []):
            assert c in cells and c in moved.get("workloads", cells)
    for w in BENCH["workloads"]:
        reported = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in BENCH["per_layer"])
        assert w["chips"] == 1


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(cell):
    c = spec.load_cell(ROOT, cell)
    assert c.traffic["runner"] in ("train", "extract")
    spec.runner(c.traffic["runner"])
    assert {"dataset", "pipeline", "trainer"} <= set(c.config)
    assert c.limits, "every cell compares against limits"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_resolves_by_name(metric):
    assert callable(spec.metric_reader(metric))


def test_config_files_are_the_repository_configs():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        repo = json.loads((ROOT / cfg["repo_file"]).read_text())
        for section in ("dataset", "pipeline", "trainer"):
            assert cfg[section] == repo[section], (c["name"], section)


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A later change adds a cell with a configuration, a traffic mix and a
    metric of its own by adding files; nothing under perfbench changes."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="ngp_dummy",
                                 file="perfbench/configs/ngp_dummy.json"))
    shutil.copy(tmp_path / "perfbench/configs/ngp_occ13.json",
                tmp_path / "perfbench/configs/ngp_dummy.json")
    bench["workloads"].append({"name": "dummy.cell", "config": "ngp_dummy",
                               "traffic": "dummy.mix", "chips": 1, "why": "a test"})
    (tmp_path / "perfbench/traffic/dummy.mix.json").write_text(
        (ROOT / "perfbench/traffic/extract.l1c.json").read_text())
    (tmp_path / "perfbench/workloads/dummy.cell.json").write_text('{"limits": {"sigma_gap": 1}}')
    (tmp_path / "perfbench/metrics/dummy_ms.extract.py").write_text(
        "def read(run):\n    return 1.0\n")
    bench["per_layer"].append({"name": "dummy_ms.extract", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "extraction",
                               "moves": "setup_s", "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(tmp_path, "dummy.cell")
    assert cell.traffic["runner"] == "extract" and cell.limits == {"sigma_gap": 1}
    assert [m["name"] for m in cell.per_layer][-1] == "dummy_ms.extract"
    assert spec.metric_reader("dummy_ms.extract", tmp_path)(None) == 1.0
    assert spec.load_cell(tmp_path, "occ13.train.real").config["name"] == "ngp_occ13"
