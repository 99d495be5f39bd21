"""The benchmark's specification, found by name: ``BENCHMARK.json`` at the
checkout's root names the cells, configurations and metrics; each cell has
``perfbench/workloads/<cell>.json`` (its limits), each traffic mix
``perfbench/traffic/<traffic>.json`` (the parameters its runner,
``perfbench/runners/<runner>.py``, reads), each configuration the file that
``BENCHMARK.json`` gives, and each metric ``perfbench/metrics/<metric>.py``
(its reader). Adding a cell, a configuration or a metric adds files; no
file here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    limits: dict  # compared number -> limit
    config: dict  # the configuration file, as run
    traffic: dict
    end_to_end: list  # BENCHMARK.json entries of the metrics the cell reports
    per_layer: list
    root: Path = HERE.parent


def load_benchmark(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def load_cell(root: Path, name: str, bench: dict | None = None) -> Cell:
    """Everything a run of cell ``name`` reads."""
    root = Path(root)
    bench = load_benchmark(root) if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "perfbench" / "workloads" / f"{name}.json") as f:
        cell_file = json.load(f)
    with open(root / "perfbench" / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (_reports(m, name) if "workloads" in m else m["moves"] in names)]
    return Cell(name, entry, cell_file.get("limits", {}), config, traffic, e2e, layer, root)


def runner(name: str):
    """The module ``perfbench/runners/<name>.py``."""
    return importlib.import_module(f"perfbench.runners.{name}")


def metric_reader(name: str, root: Path = HERE.parent):
    """``read`` of ``perfbench/metrics/<name>.py`` under ``root`` (names may
    hold dots)."""
    path = Path(root) / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
