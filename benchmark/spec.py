"""The benchmark's definition, found by name: `BENCHMARK.json` at the
root of the checkout, and for a cell its own file
(`benchmark/workloads/<cell>.json`: the limits of its check), its traffic
mix (`benchmark/traffic/<traffic>.json`), its configuration's file (the
`file` of its `configs` entry) and the reader of each metric it reports
(`benchmark/metrics/<metric>.py`, a function `read(run)`)."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple

HERE = Path(__file__).resolve().parent


class Spec(NamedTuple):
    root: Path
    cell: dict             # the cell's entry in BENCHMARK.json
    workload: dict         # the traffic mix's parameters and the cell's own file
    config: dict           # the configuration's file
    end_to_end: List[dict]   # the end-to-end metrics this cell reports
    per_layer: List[dict]    # the per-layer metrics this cell reports


def _reports(metric: dict, cell: str) -> bool:
    """A metric is reported by the cells its `workloads` list, or by every
    cell where it has none."""
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path, cell_name: str) -> Spec:
    """The spec of cell `cell_name` under `root`. Raises FileNotFoundError
    or KeyError where a name does not resolve."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no cell {cell_name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    own = json.loads((root / "benchmark" / "workloads" / f"{cell_name}.json").read_text())
    if own["config"] != cell["config"] or own["traffic"] != cell["traffic"]:
        raise ValueError(f"{cell_name}: the workload file's config and traffic differ from "
                         f"BENCHMARK.json's")
    traffic = json.loads((root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    workload = {**traffic, **own}
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell_name)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, cell_name)]
    return Spec(root, cell, workload, config, e2e, per_layer)


def reader(root: Path, metric: str) -> Callable:
    """The `read` function of `benchmark/metrics/<metric>.py` under `root`."""
    path = Path(root) / "benchmark" / "metrics" / f"{metric}.py"
    name = "benchmark_metric_" + metric.replace(".", "_")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    if mod_spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def all_cells(root: Path) -> Dict[str, Spec]:
    bench = json.loads((Path(root) / "BENCHMARK.json").read_text())
    return {c["name"]: load(root, c["name"]) for c in bench["workloads"]}
